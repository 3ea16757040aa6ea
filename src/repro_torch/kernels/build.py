"""Build and bind the port's CUDA kernels; count their launches.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``: one ``nvcc``
process per source, all started together, then one link into a shared
library with a plain C interface that ``ctypes`` loads. The library lands in
``<checkout>/build/repro_torch_kernels/`` under a name hashed from the
sources and flags, so an edited source rebuilds and an unchanged one loads
what is there. Nothing builds at import: the first launch builds.

Every C entry point takes its pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception. Each kernel wrapper owns a :class:`Counter`: ``launches`` counts
kernel launches, ``plain_calls`` the calls its plain PyTorch version served
(CPU tensors only), ``meta_calls`` the shape-only calls on meta tensors
(``flash_refresh``'s, for the dry run's ``--flash-refresh``).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
L = ctypes.c_longlong
# C signatures of csrc/*.cu, in argument order
SIGNATURES = {
    # q k v o q_pos q_seg kv_pos kv_seg kv_valid ws | K RG G Tq Tkv
    # kv_head_stride dh dtype | scale softcap | causal window is_local splits
    # | stream
    "repro_flash_varlen": [P] * 10 + [I] * 8 + [F, F] + [I] * 4 + [P],
    # q k seg out | R K Rq T dh | k_head_stride k_token_stride | dtype |
    # stream
    "repro_head_score_varlen": [P] * 4 + [I] * 5 + [L] * 2 + [I, P],
    # q k out | B K Rq S dh | k_batch_stride k_head_stride k_token_stride |
    # dtype | stream
    "repro_head_score": [P] * 3 + [I] * 5 + [L] * 3 + [I, P],
    # q k v mask o m s | B K R T Sm dh dtype | scale softcap | stream
    "repro_packed_flash_attention": [P] * 7 + [I] * 7 + [F, F] + [P],
    # q k v o q_pos kv_pos kv_valid | B K RG Sq S dh dtype | scale softcap |
    # causal window is_local | stream
    "repro_flash_refresh": [P] * 7 + [I] * 7 + [F, F] + [I, I, I] + [P],
    # h w valid part_m part_idx part_s idx m s | T D V v_split n_splits
    # w_layout_vd dtype | softcap | stream
    "repro_logit_argmax": [P] * 9 + [I] * 7 + [F] + [P],
    # xdt dA B C reset cap_rows y captured final states carry gram | T H P
    # N R | stream
    "repro_ssm_segment_scan": [P] * 12 + [I] * 5 + [P],
}

DTYPE_CODES = {"float32": 0, "bfloat16": 1}
H100_SMS = 132        # the SM count kernels size their grids by off the card


class Counter:
    """Launch and plain-version call counts of one kernel wrapper, and the
    shape-only calls a wrapper with a meta branch served (the dry run's)."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self.plain_calls = 0
        self.meta_calls = 0


COUNTERS: Dict[str, Counter] = {}


def counter(name: str) -> Counter:
    c = COUNTERS.get(name)
    if c is None:
        c = COUNTERS[name] = Counter(name)
    return c


def reset_counters() -> None:
    for c in COUNTERS.values():
        c.launches = 0
        c.plain_calls = 0
        c.meta_calls = 0


_lib = None
_lock = threading.Lock()
build_seconds = 0.0
build_log = ""


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the card")
    return path


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (or find) the shared library; returns its path."""
    global build_seconds, build_log
    sources = sorted(CSRC.glob("*.cu"))
    tag = _source_hash()
    out = BUILD_DIR / f"librepro_kernels_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in sources:
        obj = BUILD_DIR / f"{src.stem}_{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, _, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"== {src.name} (rc={proc.returncode})\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in procs],
         "-lcudart"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    if link.returncode != 0:
        raise RuntimeError(f"link failed:\n{link.stdout}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def dtype_code(t) -> int:
    name = str(t.dtype).replace("torch.", "")
    if name not in DTYPE_CODES:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[name]


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (asked once a device)."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def require_tma(name: str, *tensors) -> None:
    """TMA reads a tensor from a 16-byte aligned base (its rows are whole
    16-byte units at every head_dim the kernels take)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the bfloat16 kernel loads by TMA and "
                             f"needs 16-byte aligned tensors")


def require_cuda(name: str, *tensors) -> None:
    """The wrappers' argument check for the kernel path: every tensor on
    one CUDA device and contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA "
                             f"device, got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
