"""What holds ``csrc/head_score.cu`` back on the card: the kernel with one
part dropped at a time.

    PYTHONPATH=src python -m repro_torch.launch.head_score_parts

Builds the kernel's source as it stands and four variants of it, each with
one part removed by a text substitution (checked to apply): the key loads,
the products of the owners' rows (and with them the kernel's wait for the
keys, which nothing else reads), the score stores, and everything (an empty
kernel: the launch alone). Each goes into its own library under
``build/head_score_parts/``. Times each in bfloat16 at rows 3 and 8's
shapes (llada-8b's Refresh stream, R = 4 slots in T = 1024 and R = 12 in
T = 4096, the keys the [K, T, dh] view of [T, K, dh]; zamba2-7b's dh = 112;
the padded B = 4, S = 256): device time of calls queued behind a sleep
kernel, warm (one input set, 20 calls) and cold (rotating over sets past
100 MB, so each call's bytes come from device memory). Only the whole
kernel computes the scores; it is checked against the plain version first.
Prints one JSON object, with the card as nvidia-smi names it.
"""
from __future__ import annotations

import ctypes
import itertools
import json
import subprocess

import torch

from repro_torch.kernels import build
from repro_torch.kernels import select_pack as SP
from repro_torch.kernels.flash_varlen import PAD_SEG

OUT = build.BUILD_DIR.parent / "head_score_parts"
KEYS_FROM = "  const T* kb = static_cast<const T*>(p.k)"
KEYS_TO = "  H::cp_async_commit();\n\n  // owners"
STORE = "  auto store = [&](int r0, int r1, bool scores) {\n"
PRODUCT = "for (int s0 = 0; s0 < ks; s0 += 4)"
START = "  const int tid = threadIdx.x;\n"


def variants(src: str) -> dict:
    keys = src[src.index(KEYS_FROM):src.index(KEYS_TO)]
    out = {"whole": src,
           "no_key_load": src.replace(keys, ""),
           "no_product": src.replace(PRODUCT,
                                     "for (int s0 = 0; s0 < 0; s0 += 4)"),
           "no_store": src.replace(STORE, STORE + "    if (p.R >= 0) return;\n"),
           "empty": src.replace(START, "  if (p.R >= 0) return;\n" + START)}
    for name, text in out.items():
        assert name == "whole" or text != src, f"{name}: no substitution"
    return out


def libraries(src: str) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants(src).items():
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I",
             str(build.CSRC), str(cu), "-o", str(OUT / f"{name}.so"),
             "-lcudart"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        for fn in ("repro_head_score_varlen", "repro_head_score"):
            getattr(lib, fn).argtypes = build.SIGNATURES[fn]
        libs[name] = lib
    return libs


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one call, the calls queued behind a sleep kernel."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("head_score_parts times the card; no CUDA device")
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    libs = libraries((build.CSRC / "head_score.cu").read_text())

    def varlen(lens, T, dh=128, K=32, Rq=8):
        seg = torch.tensor(sum(([j] * n for j, n in enumerate(lens)), [])
                           + [PAD_SEG] * (T - sum(lens)), dtype=torch.int32,
                           device=dev)
        q = torch.randn((len(lens), K, Rq, dh), generator=g, device=dev)
        k = torch.randn((T, K, dh), generator=g, device=dev)
        return q.to(bf), k.to(bf).permute(1, 0, 2), seg

    def varlen_call(lib, q, k, seg):
        R, K, Rq, dh = q.shape
        out = torch.empty((R, K, k.shape[1]), device=dev)
        build.check(lib.repro_head_score_varlen(
            q.data_ptr(), k.data_ptr(), seg.data_ptr(), out.data_ptr(), R, K,
            Rq, k.shape[1], dh, k.stride(0), k.stride(1), 1, stream), "whole")
        return out

    def padded(B=4, S=256, dh=128, K=32, Rq=8):
        q = torch.randn((B, K, Rq, dh), generator=g, device=dev)
        k = torch.randn((B, S, K, dh), generator=g, device=dev)
        return q.to(bf), k.to(bf).permute(0, 2, 1, 3)

    def padded_call(lib, q, k):
        B, K, Rq, dh = q.shape
        out = torch.empty((B, K, k.shape[2]), device=dev)
        build.check(lib.repro_head_score(
            q.data_ptr(), k.data_ptr(), out.data_ptr(), B, K, Rq, k.shape[2],
            dh, *k.stride()[:3], 1, stream), "whole")
        return out

    shapes = {
        "row 3, llada-8b R=4 T=1024": (
            lambda: varlen([256, 250, 240, 230], 1024), varlen_call,
            SP.head_score_varlen_plain),
        "row 3, llada-8b R=12 T=4096": (
            lambda: varlen([333] * 12, 4096), varlen_call,
            SP.head_score_varlen_plain),
        "row 3, zamba2-7b R=4 T=1024 dh=112": (
            lambda: varlen([256, 250, 240, 230], 1024, dh=112), varlen_call,
            SP.head_score_varlen_plain),
        "row 8, llada-8b B=4 S=256": (padded, padded_call,
                                       SP.head_score_plain),
    }
    result = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()}
    for shape, (make, call, plain) in shapes.items():
        first = make()
        per_set = sum(t.numel() * t.element_size() for t in first)
        sets = [first] + [make() for _ in range(int(100e6 // per_set) + 1)]
        out, ref = call(libs["whole"], *first), plain(*first)
        fin = torch.isfinite(ref)
        assert torch.equal(torch.isinf(out), torch.isinf(ref)), shape
        assert (out[fin] - ref[fin]).abs().max().item() < 1e-2, shape
        row = {}
        for name, lib in libs.items():
            turn = itertools.cycle(sets)
            row[name] = {
                "warm_us": 1e3 * device_ms(lambda: call(lib, *first)),
                "cold_us": 1e3 * device_ms(lambda: call(lib, *next(turn)),
                                           iters=max(20, 2 * len(sets)))}
        result[shape] = row
        print(shape, json.dumps(row), flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
