"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. environment: torch / CUDA / nvcc versions and the card, as nvidia-smi
     reports its name and power limit;
  2. build: the kernels from src/repro_torch/kernels/csrc with nvcc for
     sm_90a (one nvcc per source, all started together);
  3. each kernel against its plain PyTorch version on the card, at a small
     float32 shape with every mask flag, and at the main paths' full-width
     shapes (llada-8b, bfloat16: Refresh streams up to the token bucket of
     max_num_batched_tokens, one max_num_logits chunk and the serving
     buckets T = 8 and 40 for the logit stage; zamba2-7b, bfloat16: the
     shared block's causal attention at head_dim 112; the float32 SSD scan
     at zamba2-7b's and mamba2-130m's widths; the padded path's kernels at
     llada-8b's padded Reuse, padded prefill (also with a ragged kv_valid
     tail and a request with no valid key) and padded Refresh scoring;
     the dense archs' heads: rows 1-3 at gemma-2b's head_dim 256 on one
     KV head and at gemma2-27b's G = 2 with softcap 50 and a window of 64
     that cuts, row 1 at qwen2.5-14b's G = 5 and qwen2-72b's H = 64, K =
     8, row 4 on gemma2-27b's tied 256,000-row head with softcap 30, rows
     6-8 at gemma-2b's head_dim 256; the MoE archs' heads: rows 1-3 at
     phi3.5-moe's K = 8, G = 4 and qwen3-moe's 64 heads on K = 4, row 4 on
     their untied heads, V = 32,064 and 151,936; the modality frontends:
     rows 1 and 3 over Refresh segments of 256 prefix rows and up to 256
     text tokens (S + F = 512 rows a segment), row 2 at their Reuse, at
     musicgen-medium's MHA (H = K = 24, head_dim 64) and internvl2-76b's
     64 heads on K = 8, row 4 on musicgen-medium's V = 2048 head (D =
     1536) and internvl2-76b's D = 8192, V = 128,256, row 6 at
     musicgen-medium's padded Reuse (K = 24, dh 64); zamba2-7b's padded
     path:
     row 6 at its baselines' Reuse with the shared block's causal mask rows
     (T = 248 and 128, rows that see no cached key), row 7 at its causal
     prefill),
     with the kernel's time, the plain version's, one PyTorch library
     call's where one computes the same function (a yardstick the port
     never calls), the least time the card could take (bound_ms) and, for
     the logit and flash_refresh kernels, the achieved rate (TB/s of the
     head, TFLOP/s); for the varlen kernels, packed_flash_attention and the
     SSD scan the device time alone of the kernel (and of the library call
     where there is one: calls queued behind a sleep kernel) and the
     wrapper's host µs a call; for the varlen kernels also the split count
     of their split-KV grid, the achieved rate (TFLOP/s of flash_varlen,
     TB/s of flash_varlen_cross) and the cross kernel's device time at
     other split counts; for the head-score kernels (also at the paper's
     geometry, R = 12 slots in T = 4096) the device time warm and with a
     cold L2 (calls rotating over input sets past 100 MB, the library
     call's too), the TB/s of the cold time, the wrapper's host µs, and the
     device time and host µs of the model-layer call (ops.head_score_varlen
     / ops.head_score), which hands over the keys as a strided view, no
     copy;
  4. a small end-to-end check: three iterations of reduced llada-8b and of
     reduced zamba2-7b under dllm-serve, of reduced llada-8b and zamba2-7b
     under sparse-dllm (the padded path), of reduced phi3.5-moe (G = 4)
     under dllm-serve, of reduced gemma2-27b (two KV heads) and of reduced
     gemma-2b (head_dim 256, also under sparse-dllm), of reduced
     musicgen-medium and internvl2-76b (their frontend payloads drawn from
     the engine's seed) under dllm-serve, on the card against the same
     iterations on the CPU (the plain versions);
  5. footprint: each llada-8b system's memory plan (the offline profiler)
     at 24 GB and at the card's memory, and the logit stage's peak bytes
     measured in each C1 mode at 128 and 4000 rows beside the plan's bill;
     graphs: the full llada-8b and zamba2-7b under dllm-serve and
     sparse-dllm, phi3.5-moe at 24 of its 32 layers and the full
     gemma2-27b, gemma-2b and musicgen-medium under dllm-serve, and the
     full llada-8b at the profiles' own logit modes (monolithic under
     fast-dllm, chunked under dllm-serve: torch ops, no kernel), on the
     modeled clock, by an engine
     whose stage entries are captured CUDA graphs and by one running the
     same entries eagerly, on the same weights: ids, counters, modeled
     clock and launches identical, nothing built after warmup (warmup
     seconds, captures, the graph pool's bytes and the plan's activation
     reservation logged);
     serve: run_serve of the full llada-8b, zamba2-7b, mamba2-130m,
     qwen2.5-14b, gemma2-27b and gemma-2b (random bfloat16 weights from a
     seed), and of phi3.5-moe at 24 of its 32 layers and qwen3-moe at 8
     of its 94 and internvl2-76b at 24 of its 80 (the whole does not fit
     the card; ``LAYERS``), and of the full musicgen-medium, through the
     dllm-serve profile, and through the padded path: the full llada-8b
     under the three baselines fast-dllm, dllm-cache and sparse-dllm,
     zamba2-7b under fast-dllm and sparse-dllm, mamba2-130m under
     dllm-cache, gemma-2b under sparse-dllm and musicgen-medium under
     fast-dllm (its padded Refresh and Reuse carry the 256-row prefix),
     with the kernels, at the
     launcher's defaults (the pipelined loop, the captured stage entries),
     on the wall clock, each sized by the offline profiler at the card's
     memory (its plan and the graph pool's bytes logged); then one padded
     prefill each of the full llada-8b, gemma-2b and zamba2-7b (at block
     64, so its scan runs its own chunk of 64) through the flash_refresh
     kernel, held against the same call without it. Each path runs with
     the launch
     counts zeroed just before it and read just after; every request must
     finish, every kernel of the path must have launched (warmup's eager
     runs and the run's graph replays), nothing may be built after warmup,
     and no plain version may have run;
  6. the kernels line, the card line, and the result line.

Without a CUDA device, or without the rest of the repository beside it, the
script exits non-zero before printing any result.

    python3 chip_smoke.py --kernels-only

runs phases 1-3 alone and prints the kernels line without launch counts and
without the result line: copied into another checkout, it times that
tree's kernels by this script's method.
"""
from __future__ import annotations

import gc
import itertools
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")   # long logs
# torch.compile (flex_attention, the softcapped rows' library call) keeps
# its caches inside the checkout and compiles in this process
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(OUT_DIR, "inductor")
os.environ["TRITON_CACHE_DIR"] = os.path.join(OUT_DIR, "triton")
os.environ["TORCHINDUCTOR_COMPILE_THREADS"] = "1"

import torch  # noqa: E402

PEAK_BYTES_S = 3.35e12            # H100 SXM HBM3
PEAK_OPS_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
SLEEP_CYCLES = 40_000_000         # ~20 ms of device backlog at H100 clocks


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3,
            queued: bool = False) -> float:
    """Mean time of ``fn`` over ``iters`` calls, CUDA events around a loop
    the host enqueues: where the host's enqueue of a call outlasts its
    device work, this reads the host. With ``queued`` the calls wait behind
    a sleep kernel, so the device runs them back to back and the events
    time its work alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def host_us(fn, n: int = 200) -> float:
    """Host microseconds to enqueue one call of ``fn`` (no sync inside)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def cold_ms(fn, sets) -> float:
    """Device ms of one ``fn(*inputs)``, the calls queued and rotating over
    ``sets``, which together outgrow the card's 50 MB L2 (``cold_sets``):
    each call reads its inputs from device memory, as the first call on a
    fresh input does."""
    calls = [lambda s=s: fn(*s) for s in sets]
    turn = itertools.cycle(calls)
    return time_ms(lambda: next(turn)(), iters=max(20, 2 * len(sets)),
                   queued=True)


def cold_sets(nbytes_a_set: float) -> int:
    """Input sets whose bytes together pass 100 MB, twice the L2."""
    return int(100e6 // nbytes_a_set) + 2


def bound(ops: float, nbytes: float, dtype) -> tuple:
    t_ops = ops / PEAK_OPS_S[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def stream(lens, pad, dev):
    from repro_torch.kernels.flash_varlen import PAD_SEG
    seg = torch.cat([torch.full((n,), j, dtype=torch.int32)
                     for j, n in enumerate(lens)]
                    + [torch.full((pad,), PAD_SEG, dtype=torch.int32)])
    pos = torch.cat([torch.arange(n, dtype=torch.int32) for n in lens]
                    + [torch.zeros(pad, dtype=torch.int32)])
    return seg.to(dev), pos.to(dev), (seg != PAD_SEG).to(dev)


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def gqa_heads(q, G):
    """Token-major GQA rows [..., K, T·G, dh] as query heads [..., K·G, T,
    dh] (head k·G + g reads KV head k), for SDPA's enable_gqa."""
    *lead, K, RG, dh = q.shape
    T = RG // G
    return (q.reshape(*lead, K, T, G, dh).transpose(-3, -2)
            .reshape(*lead, K * G, T, dh))


def flex_library(dev, qh, k, v, keep, softcap, G):
    """One call of PyTorch's ``flex_attention`` that computes the kernel's
    function where SDPA cannot (a softcap): the softcap as its score_mod
    (on the scaled scores, as the kernel applies it), ``keep(h, q, kv)`` as
    its block mask. Compiled, and the block mask built, before it is
    timed."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    flex = torch.compile(flex_attention, dynamic=False)
    H, Tq, Tkv = qh.shape[1], qh.shape[2], k.shape[-2]

    def capped(score, b, h, q_idx, kv_idx):
        return softcap * torch.tanh(score / softcap)

    def mask_mod(b, h, q_idx, kv_idx):
        return keep(h, q_idx, kv_idx)
    block_mask = create_block_mask(mask_mod, 1, H, Tq, Tkv, device=dev)
    return lambda: flex(qh, k[None], v[None], score_mod=capped,  # noqa
                        block_mask=block_mask, enable_gqa=G > 1)


def check_flash_varlen(dev, g, cfg, serve, causal=False, small=True,
                       window=0, lens=(256, 250, 240, 230)):
    """Row 1: small float32 shapes with every flag (dh 64, and dh 256 on one
    KV head), then the main path's full Refresh stream in bfloat16 at the
    arch's heads, with its attention softcap and, with ``window``, a local
    layer's sliding window (ragged segments of 230-256 tokens, so a window
    of 64 cuts them; a frontend arch's ``lens`` are ``[F ; text]``
    segments of up to S + F rows). The SDPA
    yardstick takes GQA heads by ``enable_gqa``; where a softcap applies,
    which SDPA has not, ``flex_attention`` is the library call, held to the
    plain version first."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_varlen as FV
    # small float32, GQA, every mask flag, ragged tile edges, at dh 64 and
    # at gemma-2b's dh 256 on one KV head
    for K, G, dh in ((2, 2, 64), (1, 8, 256)) if small else ():
        seg, pos, valid = stream([70, 9, 133, 1], 43, dev)
        T = seg.shape[0]
        q = torch.randn((K, T * G, dh), generator=g, device=dev)
        k = torch.randn((K, T, dh), generator=g, device=dev)
        v = torch.randn((K, T, dh), generator=g, device=dev)
        rows = valid.repeat_interleave(G)
        for kw, loc in ((dict(), False), (dict(softcap=20.0), False),
                        (dict(causal=True), False), (dict(window=5), True)):
            out = FV.flash_varlen_call(q, k, v, pos, seg, valid, loc, **kw)
            ref = FV.varlen_attention_plain(q, k, v, pos, seg,
                                            pos.expand(K, T), seg,
                                            valid.expand(K, T), loc, **kw)
            err = (out[:, rows] - ref[:, rows]).abs().max().item()
            log(f"  flash_varlen f32 G={G} dh={dh} {kw or 'plain'} "
                f"local={loc}: max_abs_err={err:.3g} (tol 1e-4)")
            assert err < 1e-4, err
    # the main path's full Refresh stream: 4 refresh slots x max_seq_len
    # filling the max_num_batched_tokens bucket, bf16, the arch's heads
    T = serve.max_num_batched_tokens
    seg, pos, valid = stream(lens, T - sum(lens), dev)
    K, dh, bf = cfg.n_kv_heads, cfg.resolved_head_dim, torch.bfloat16
    G, softcap, local = cfg.n_heads // K, cfg.attn_softcap, bool(window)
    q = torch.randn((K, T * G, dh), generator=g, device=dev, dtype=bf)
    k = torch.randn((K, T, dh), generator=g, device=dev, dtype=bf)
    v = torch.randn((K, T, dh), generator=g, device=dev, dtype=bf)
    kvp, kvv = pos.expand(K, T), valid.expand(K, T)
    kw = dict(softcap=softcap, causal=causal, window=window)
    call = lambda: FV.flash_varlen_call(q, k, v, pos, seg, valid,  # noqa
                                        local, **kw)
    plain = lambda: FV.varlen_attention_plain(  # noqa: E731
        q, k, v, pos, seg, kvp, seg, kvv, local, **kw)
    out, ref = call(), plain()
    rows = valid.repeat_interleave(G)
    err = (out[:, rows] - ref[:, rows]).abs().max().item()
    log(f"  flash_varlen bf16 {cfg.name} T={T} lens={list(lens)} K={K} G={G} "
        f"dh={dh} causal={causal} softcap={softcap} window={window}: "
        f"max_abs_err={err:.3g} (tol 2e-2)")
    assert err < 2e-2, err
    mask = (seg[:, None] == seg[None, :]) & valid[None, :]
    if causal:
        mask = mask & (pos[:, None] >= pos[None, :])
    if window:
        mask = mask & ((pos[:, None] - pos[None, :]).abs() <= window)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ops = 4.0 * int(mask.sum()) * cfg.n_heads * dh
    b, by = bound(ops, nbytes(q, k, v, seg, pos, valid) + K * T * G * dh * 4,
                  bf)
    dev_ms = time_ms(call, queued=True)
    qh = gqa_heads(q, G)[None]

    def library():
        return sdpa(qh, k[None], v[None], attn_mask=mask, enable_gqa=G > 1)
    if softcap:
        def keep(h, i, j):
            ok = (seg[i] == seg[j]) & valid[j]
            if causal:
                ok = ok & (pos[i] >= pos[j])
            if window:
                ok = ok & ((pos[i] - pos[j]).abs() <= window)
            return ok
        library = flex_library(dev, qh, k, v, keep, softcap, G)
        hrows = valid.expand(cfg.n_heads, T)
        lib_err = (library()[0].float()[hrows]
                   - gqa_heads(ref, G)[hrows]).abs().max().item()
        log(f"  flash_varlen {cfg.name} library flex_attention: "
            f"max_abs_err={lib_err:.3g} (tol 2e-2)")
        assert lib_err < 2e-2, lib_err
    lib = dict(library_ms=time_ms(library),
               library_device_ms=time_ms(library, queued=True))
    return dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_varlen.cu",
        replaces="src/repro/kernels/flash_varlen.py:97",
        max_abs_err=err, ms=time_ms(call), plain_ms=time_ms(plain, iters=5),
        bound_ms=b, bound_by=by, **lib,
        splits=FV.kv_splits(T * G, K, T, build.sm_count(dev), dh=dh),
        device_ms=dev_ms, tflop_s=ops / dev_ms / 1e9, host_us=host_us(call))


def check_flash_varlen_cross(dev, g, cfg, serve, retain, causal=False,
                             small=True, window=0):
    """Row 2: small float32 shapes with every flag (dh 64 and 256), then the
    main path's largest Reuse stream in bfloat16 at the arch's heads, with
    its softcap and, with ``window``, a local layer's window (retained keys at
    positions 0-299 against a block at 200-207: a window of 64 cuts); the
    chooser's split count and a sweep of others. SDPA, or
    ``flex_attention`` where a softcap applies, as for row 1."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_varlen as FV
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def case(R, Sb, Cr, K, G, dh, dtype):
        Tq, Tkv = R * Sb, R * (Cr + Sb)
        q = torch.randn((K, Tq * G, dh), generator=g, device=dev).to(dtype)
        k = torch.randn((K, Tkv, dh), generator=g, device=dev).to(dtype)
        v = torch.randn((K, Tkv, dh), generator=g, device=dev).to(dtype)
        ar = torch.arange(R, dtype=torch.int32, device=dev)
        q_seg, kv_seg = ar.repeat_interleave(Sb), ar.repeat_interleave(Cr + Sb)
        q_pos = (torch.arange(Sb, dtype=torch.int32, device=dev).repeat(R)
                 + 200)
        kv_pos = torch.randint(0, 300, (K, Tkv), generator=g, device=dev,
                               dtype=torch.int32)
        kv_valid = torch.rand((K, Tkv), generator=g, device=dev) < 0.6
        # each request's live block, at the block's positions, is valid
        kv_valid.view(K, R, Cr + Sb)[:, :, Cr:] = True
        kv_pos.view(K, R, Cr + Sb)[:, :, Cr:] = q_pos.view(R, Sb)
        return q, k, v, q_pos, kv_pos, q_seg, kv_seg, kv_valid

    for K, G, dh in ((2, 2, 64), (1, 8, 256)) if small else ():
        args = case(5, 8, 40, K, G, dh, torch.float32)
        q, k, v, q_pos, kv_pos, q_seg, kv_seg, kv_valid = args
        for kw in (dict(), dict(softcap=20.0), dict(causal=True),
                   dict(window=30)):
            loc = "window" in kw
            out = FV.flash_varlen_cross_call(*args, loc, **kw)
            ref = FV.varlen_attention_plain(q, k, v, q_pos, q_seg, kv_pos,
                                            kv_seg, kv_valid, loc, **kw)
            err = (out - ref).abs().max().item()
            log(f"  flash_varlen_cross f32 G={G} dh={dh} {kw or 'plain'}: "
                f"max_abs_err={err:.3g} (tol 1e-4)")
            assert err < 1e-4, err
    # the main path's largest Reuse stream: every slot decoding a block
    R, Sb = serve.max_slots, serve.block_size
    K, dh, bf = cfg.n_kv_heads, cfg.resolved_head_dim, torch.bfloat16
    G, softcap, local = cfg.n_heads // K, cfg.attn_softcap, bool(window)
    args = case(R, Sb, retain, K, G, dh, bf)
    q, k, v, q_pos, kv_pos, q_seg, kv_seg, kv_valid = args
    kw = dict(softcap=softcap, causal=causal, window=window)
    call = lambda: FV.flash_varlen_cross_call(*args, local,  # noqa: E731
                                              **kw)
    plain = lambda: FV.varlen_attention_plain(  # noqa: E731
        q, k, v, q_pos, q_seg, kv_pos, kv_seg, kv_valid, local, **kw)
    out, ref = call(), plain()
    err = (out - ref).abs().max().item()
    log(f"  flash_varlen_cross bf16 {cfg.name} R={R} Tq={R * Sb} "
        f"Tkv={k.shape[1]} K={K} G={G} dh={dh} causal={causal} softcap="
        f"{softcap} window={window}: max_abs_err={err:.3g} (tol 2e-2)")
    assert err < 2e-2, err
    mask = (q_seg[:, None] == kv_seg[None, :])[None] & kv_valid[:, None, :]
    if causal:
        mask = mask & (q_pos[None, :, None] >= kv_pos[:, None, :])
    if window:
        mask = mask & ((q_pos[None, :, None] - kv_pos[:, None, :]).abs()
                       <= window)
    if causal or window:
        # the mask removes pairs: count the ones this data keeps
        ops = 4.0 * int(mask.sum()) * G * dh
    else:
        ops = 4.0 * R * Sb * (retain + Sb) * cfg.n_heads * dh
    moved = nbytes(*args) + q.numel() * 4
    b, by = bound(ops, moved, bf)
    splits = FV.kv_splits(q.shape[1], K, k.shape[1], build.sm_count(dev),
                          dh=dh)
    # the kernel at other split counts than the chooser's, for PERF.md
    sweep = [[s, time_ms(lambda s=s: FV._launch(
        FV.CROSS, q, k, v, q_pos, q_seg, kv_pos, kv_seg, kv_valid,
        k.shape[1], local, softcap, causal, window, splits=s), queued=True)]
        for s in sorted({1, 2, 3, 4, splits, 2 * splits})]
    dev_ms = time_ms(call, queued=True)
    qh, mh = gqa_heads(q, G)[None], mask.repeat_interleave(G, 0)[None]

    def library():
        return sdpa(qh, k[None], v[None], attn_mask=mh, enable_gqa=G > 1)
    if softcap:
        def keep(h, i, j):
            kh = h // G
            ok = (q_seg[i] == kv_seg[j]) & kv_valid[kh, j]
            if causal:
                ok = ok & (q_pos[i] >= kv_pos[kh, j])
            if window:
                ok = ok & ((q_pos[i] - kv_pos[kh, j]).abs() <= window)
            return ok
        library = flex_library(dev, qh, k, v, keep, softcap, G)
        lib_err = (library()[0].float()
                   - gqa_heads(ref, G)).abs().max().item()
        log(f"  flash_varlen_cross {cfg.name} library flex_attention: "
            f"max_abs_err={lib_err:.3g} (tol 2e-2)")
        assert lib_err < 2e-2, lib_err
    lib = dict(library_ms=time_ms(library),
               library_device_ms=time_ms(library, queued=True))
    return dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_varlen.cu",
        replaces="src/repro/kernels/flash_varlen.py:220",
        max_abs_err=err, ms=time_ms(call), plain_ms=time_ms(plain, iters=5),
        bound_ms=b, bound_by=by, **lib, device_ms=dev_ms,
        splits=splits, tb_s=moved / dev_ms / 1e9,
        host_us=host_us(call),
        ms_by_splits=sweep)


def check_head_score(dev, g, cfg, serve, small=True,
                     lens=(256, 250, 240, 230)):
    """Row 3 against its plain version: float32 (GQA Rq = 16, dh = 64, a
    one-token request, a PAD_SEG tail, requests that own nothing), then in
    bfloat16 at the main path's Refresh stream (R = 4 slots filling the
    max_num_batched_tokens bucket), its keys contiguous and, through
    ``ops.head_score_varlen``, as the [K, T, dh] view of the layer's
    [T, K, dh] keys (the kernel reads them in place); with ``small`` also
    at the paper's geometry (R = 12 slots, T = 4096). -inf where the plain
    version has it; else 1e-3 (float32) and 1e-2 (bfloat16: |scores| ~ 30,
    float32 sums of exact products in another order)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import select_pack as SP
    bf = torch.bfloat16

    def case(lens, pad, R, K, Rq, dh, dtype):
        seg, _, _ = stream(lens, pad, dev)
        q = torch.randn((R, K, Rq, dh), generator=g, device=dev).to(dtype)
        k = torch.randn((K, seg.shape[0], dh), generator=g,
                        device=dev).to(dtype)
        return q, k, seg

    def err_of(out, ref):
        assert torch.equal(torch.isinf(out), torch.isinf(ref))
        fin = torch.isfinite(ref)
        return (out[fin] - ref[fin]).abs().max().item()

    def measure(lens, T):
        R, K, dh = len(lens), cfg.n_kv_heads, cfg.resolved_head_dim
        G, Sb = cfg.n_heads // K, serve.block_size
        Rq = Sb * G
        q, k, seg = case(lens, T - sum(lens), R, K, Rq, dh, bf)
        err = err_of(SP.head_score_varlen_call(q, k, seg),
                     SP.head_score_varlen_plain(q, k, seg))
        log(f"  head_score_varlen bf16 {cfg.name} R={R} T={T} lens={lens} "
            f"dh={dh}: max_abs_err={err:.3g} (tol 1e-2)")
        assert err < 1e-2, err
        # the Refresh layer's call: block queries [R, Sb, H, dh] and the
        # [T, K, dh] keys, read in place as their [K, T, dh] view
        q_block = torch.randn((R, Sb, cfg.n_heads, dh), generator=g,
                              device=dev).to(bf)
        k_flat = k.permute(1, 0, 2).contiguous()
        qr = (q_block.reshape(R, Sb, K, G, dh).permute(0, 2, 1, 3, 4)
              .reshape(R, K, Rq, dh))
        via_ops = lambda: ops.head_score_varlen(q_block, k_flat, seg)  # noqa
        err_ops = err_of(via_ops(), SP.head_score_varlen_plain(
            qr, k_flat.permute(1, 0, 2), seg))
        log(f"  head_score_varlen bf16 {cfg.name} R={R} T={T} through "
            f"ops.head_score_varlen, keys as the [K, T, dh] view of "
            f"[T, K, dh]: max_abs_err={err_ops:.3g} (tol 1e-2)")
        assert err_ops < 1e-2, err_ops
        own = seg[None, :] == torch.arange(R, device=dev,
                                           dtype=torch.int32)[:, None]

        def library(q, k, seg):
            z = torch.matmul(q, k.transpose(1, 2)[None])    # [R, K, Rq, T]
            return z.amax(dim=2).masked_fill(~own[:, None, :], float("-inf"))

        # what the function needs: the owned keys, q, seg, the scores
        moved = nbytes(q, seg) + K * sum(lens) * dh * 2 + R * K * T * 4
        b, by = bound(2.0 * sum(lens) * Rq * K * dh, moved, bf)
        sets = [(q, k, seg)] + [case(lens, T - sum(lens), R, K, Rq, dh, bf)
                                for _ in range(cold_sets(moved) - 1)]
        call = lambda: SP.head_score_varlen_call(q, k, seg)  # noqa: E731
        cold = cold_ms(SP.head_score_varlen_call, sets)
        return dict(
            route="cuda", source="src/repro_torch/kernels/csrc/head_score.cu",
            replaces="src/repro/kernels/select_pack.py:82",
            max_abs_err=max(err, err_ops), ms=time_ms(call),
            plain_ms=time_ms(lambda: SP.head_score_varlen_plain(q, k, seg),
                             iters=5),
            bound_ms=b, bound_by=by, library_ms=time_ms(
                lambda: library(q, k, seg)),
            device_ms=time_ms(call, queued=True), cold_device_ms=cold,
            library_device_ms=time_ms(lambda: library(q, k, seg),
                                      queued=True),
            library_cold_device_ms=cold_ms(library, sets),
            tb_s=moved / cold / 1e9, host_us=host_us(call),
            ops_device_ms=time_ms(via_ops, queued=True),
            ops_host_us=host_us(via_ops))

    if small:
        args = case([70, 9, 133, 1, 64], 43, 8, 3, 16, 64, torch.float32)
        err = err_of(SP.head_score_varlen_call(*args),
                     SP.head_score_varlen_plain(*args))
        log(f"  head_score_varlen f32: max_abs_err={err:.3g} (tol 1e-3)")
        assert err < 1e-3, err
    row = measure(list(lens), serve.max_num_batched_tokens)
    if small:
        # the paper's geometry: 12 slots in the bucket of
        # max_num_batched_tokens = 4000
        row["R=12 T=4096"] = measure([333] * 12, 4096)
    return row


def check_logit_argmax(dev, g, cfg, serve, tied, heads):
    """Row 4: float32 in both layouts with a softcap; then in bfloat16 one
    max_num_logits chunk and the serving buckets T = 8 and 40 against the
    main path's [D, V] head (``cfg``), the same buckets against each of
    ``heads``' own head, in its layout and with its final softcap
    (gemma2-27b's tied [V, D] head: V = 256,000, D = 4608, softcap 30;
    qwen2.5-14b's untied [D, V] head: D = 5120, V = 152,064; gemma-2b's
    tied one: D = 2048), and one chunk against ``tied``'s tied head (V not
    a multiple of the 128-wide vocabulary tile)."""
    from repro_torch.kernels import logit_argmax as LA

    def compare(h, w, valid, layout, softcap, tol):
        idx, m, s = LA.fused_logit_argmax_call(h, w, valid, softcap=softcap,
                                               w_layout=layout)
        ri, rm, rs = LA.fused_logit_argmax_plain(h, w, softcap=softcap,
                                                 w_layout=layout)
        # ids must match wherever the plain version's top-2 gap exceeds tol
        wf = w.float() if layout == "dv" else w.float().t()
        top2 = torch.cat([(h.float() @ wf[:, c: c + 16384]).topk(
            2, dim=1).values for c in range(0, wf.shape[1], 16384)], 1)
        if softcap:
            top2 = softcap * torch.tanh(top2 / softcap)
        top2 = top2.topk(2, dim=1).values
        clear = valid & ((top2[:, 0] - top2[:, 1]) > tol)
        assert torch.equal(idx[clear], ri[clear]), "argmax ids differ"
        err_m = (m[valid] - rm[valid]).abs().max().item()
        err_s = ((s[valid] - rs[valid]).abs() / rs[valid]).max().item()
        assert err_m < tol and err_s < tol, (err_m, err_s)
        return max(err_m, err_s), int(clear.sum())

    for layout in ("dv", "vd"):
        h = torch.randn((150, 96), generator=g, device=dev)
        w = torch.randn((96, 5003), generator=g, device=dev) * 0.2
        if layout == "vd":
            w = w.t().contiguous()
        valid = torch.ones(150, dtype=torch.bool, device=dev)
        valid[140:] = False
        err, n = compare(h, w, valid, layout, 15.0, 1e-3)
        log(f"  fused_logit_argmax f32 {layout} softcap: max_err={err:.3g} "
            f"(tol 1e-3), {n} ids compared")
    bf = torch.bfloat16

    def buckets(c, layout, softcap):
        # one max_num_logits chunk, then the serving buckets T = 8 and 40,
        # against c's head in the layout
        D, V = c.d_model, c.vocab_size
        w = torch.empty((D, V) if layout == "dv" else (V, D), device=dev,
                        dtype=bf).normal_(0, 0.02, generator=g)
        wm = w if layout == "dv" else w.t()
        rows = {}
        for T in sorted({serve.max_num_logits, 8, 40}, reverse=True):
            h = torch.randn((T, D), generator=g, device=dev, dtype=bf)
            valid = torch.ones(T, dtype=torch.bool, device=dev)
            err, n = compare(h, w, valid, layout, softcap, 2e-3)
            log(f"  fused_logit_argmax bf16 {layout} {c.name} T={T} D={D} "
                f"V={V} softcap={softcap}: max_err={err:.3g} (tol 2e-3), "
                f"{n}/{T} ids compared")

            def library(h=h):
                z = (h @ wm).float()
                if softcap:
                    z = softcap * torch.tanh(z / softcap)
                return z.argmax(dim=1), torch.logsumexp(z, dim=1)

            b, by = bound(2.0 * T * D * V, nbytes(h, w, valid) + T * 12, bf)

            def call(h=h, valid=valid):
                return LA.fused_logit_argmax_call(h, w, valid,
                                                  softcap=softcap,
                                                  w_layout=layout)
            ms = time_ms(call)
            rows[T] = dict(
                max_abs_err=err, ms=ms,
                plain_ms=time_ms(lambda h=h: LA.fused_logit_argmax_plain(
                    h, w, softcap=softcap, w_layout=layout), iters=3),
                bound_ms=b, bound_by=by, library_ms=time_ms(library),
                device_ms=time_ms(call, queued=True),
                library_device_ms=time_ms(library, queued=True),
                w_tb_s=nbytes(w) / ms / 1e9, ids_compared=n)
        del w, wm
        return rows

    rows = buckets(cfg, "dv", 0.0)
    head_rows = {}
    for c in heads:
        layout = "vd" if c.tie_embeddings else "dv"
        for t, r in sorted(buckets(c, layout, c.final_softcap).items(),
                           reverse=True):
            head_rows[f"{c.name} {layout} T={t}"] = r
    # the tied [V, D] head of the attention-free arch, V not a multiple of
    # the 128-wide vocabulary tile
    T = serve.max_num_logits
    Dt, Vt = tied.d_model, tied.vocab_size
    ht = torch.randn((T, Dt), generator=g, device=dev, dtype=bf)
    wt = torch.empty((Vt, Dt), device=dev, dtype=bf).normal_(0, 0.02,
                                                             generator=g)
    valid = torch.ones(T, dtype=torch.bool, device=dev)
    err_t, n = compare(ht, wt, valid, "vd", 0.0, 2e-3)
    log(f"  fused_logit_argmax bf16 vd {tied.name} T={T} D={Dt} V={Vt}: "
        f"max_err={err_t:.3g} (tol 2e-3), {n}/{T} ids compared")
    main = rows.pop(serve.max_num_logits)
    return dict(
        route="cuda", source="src/repro_torch/kernels/csrc/logit_argmax.cu",
        replaces="src/repro/kernels/logit_argmax.py:80",
        **main, **{f"T={t}": r for t, r in sorted(rows.items())},
        **head_rows)


def check_ssm_segment_scan(dev, g, zamba, mamba, serve):
    """float32 on both sides: the kernel's chunked form on the tensor cores
    (3xTF32, chunks of 64 tokens) against the plain version's chunked form
    at other chunkings; tolerance 1e-4 relative to the largest output (the
    two sum the same terms in other orders)."""
    from repro_torch.kernels import ssm_scan as SS

    def case(lens, pad, H, P, N, block_starts, resets=(), caps=()):
        seg, pos, _ = stream(lens, pad, dev)
        T = seg.shape[0]
        xdt = torch.randn((T, H, P), generator=g, device=dev)
        # dt·A of a Mamba2 layer at init: A = -1, dt = softplus(.) > 0
        dA = -0.01 - torch.rand((T, H), generator=g, device=dev)
        Bm = torch.randn((T, N), generator=g, device=dev)
        Cm = torch.randn((T, N), generator=g, device=dev)
        cu = [sum(lens[:j]) for j in range(len(lens))]
        cap = [c + b - 1 if b > 0 else -1 for c, b in zip(cu, block_starts)]
        reset = (pos == 0).float()
        reset[list(resets)] = 1.0
        return (xdt, dA, Bm, Cm, reset,
                torch.tensor(cap + list(caps), dtype=torch.int32, device=dev))

    def compare(args, chunk):
        got = SS.ssm_segment_scan_call(*args, chunk=chunk)
        want = SS.ssm_segment_scan_plain(*args, chunk=chunk)
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        scale = max(1.0, max(b.abs().max().item() for b in want))
        assert err < 1e-4 * scale, (err, scale)
        T = args[0].shape[0]
        zero = (args[5] < 0) | (args[5] >= T)
        assert not got[1][zero].any(), "a capture outside the stream is not 0"
        return err, scale

    # small: resets inside chunks and on their edges, captures at -1, at
    # chunk edges and inside chunks, at every chunking of the plain version
    # (T = 96 leaves the kernel a ragged second chunk)
    args = case([40, 9, 33, 1], 13, 3, 8, 16, [24, 0, 8, 0])
    for chunk in (8, 16, 32, 96):
        err, scale = compare(args, chunk)
        log(f"  ssm_segment_scan f32 T=96 chunk={chunk}: max_abs_err="
            f"{err:.3g} (tol 1e-4 x {scale:.3g})")
    # a ragged T = 200 at N = 128: resets on the first and the last row of
    # the kernel's second chunk, captures at -1, on the chunk edges 63/64,
    # inside a chunk, at T - 1 and past T
    args = case([150, 50], 0, 4, 64, 128, [100, 20], resets=(64, 127),
                caps=(-1, 63, 64, 199, 205))
    err, scale = compare(args, 8)
    log(f"  ssm_segment_scan f32 T=200 N=128 resets at 64, 127: "
        f"max_abs_err={err:.3g} (tol 1e-4 x {scale:.3g})")
    out = {}
    lens = [256, 250, 240, 230]
    T = serve.max_num_batched_tokens
    for cfg in (zamba, mamba):
        H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        args = case(lens, T - sum(lens), H, P, N, [200, 96, 232, 8])
        err, scale = compare(args, 64)
        log(f"  ssm_segment_scan f32 {cfg.name} T={T} H={H} P={P} N={N} R=4: "
            f"max_abs_err={err:.3g} (tol 1e-4 x {scale:.3g})")
        R = args[5].shape[0]
        b, by = bound(4.0 * T * H * P * N,
                      nbytes(*args) + 4 * (T * H * P + (R + 1) * H * P * N),
                      torch.float32)
        call = lambda args=args: SS.ssm_segment_scan_call(*args)  # noqa
        out[cfg.name] = dict(
            route="cuda", source="src/repro_torch/kernels/csrc/ssm_scan.cu",
            replaces="src/repro/kernels/ssm_scan.py:128", max_abs_err=err,
            ms=time_ms(call),
            plain_ms=time_ms(lambda: SS.ssm_segment_scan_plain(*args),
                             iters=3),
            bound_ms=b, bound_by=by, library_ms=None,
            device_ms=time_ms(call, queued=True), host_us=host_us(call))
    main_row = out.pop(zamba.name)
    return dict(main_row, **out)


def check_packed_flash_attention(dev, g, cfg, retains, small=True,
                                 causal=False):
    """Row 6 at small float32 shapes with every flag (GQA rows reading mask
    row r // G, a one-row mask, softcap, a fully masked head, ragged KV
    tiles) on the first tile; at small bfloat16 shapes on the Hopper tile
    (R = 8, 16, 64 rows, Sm = 1 or Sb, softcap, head dims 64, 112 and 256,
    T = 40, 200 and 1000, a fully masked head); then at llada-8b's padded
    Reuse in bfloat16: B = 16 (the pow2 bucket of 12 slots), K = 32, Sb =
    8, the retained T of each baseline and the engine's one-row mask (with
    ``small=False`` only this, at ``cfg``'s heads: gemma-2b's K = 1, R = 64
    rows, dh = 256). With ``causal`` the mask is the hybrid's shared block's
    (zamba2-7b: K = 32, G = 1, dh = 112): one row per block query (Sm =
    Sb), a cached key kept where its position is at or before the
    query's, batch row 0's block at position 0 (every row fully masked).
    Tolerances: m to 1e-4; s and o relative to the row sums, 1e-4
    (float32) and 2e-2 (bfloat16: P rounded before P·V)."""
    from repro_torch.kernels import flash_attention as FA
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def case(B, K, R, T, Sm, dh, dtype, p_keep):
        q = torch.randn((B, K, R, dh), generator=g, device=dev).to(dtype)
        k = torch.randn((B, K, T, dh), generator=g, device=dev).to(dtype)
        v = torch.randn((B, K, T, dh), generator=g, device=dev).to(dtype)
        mask = torch.rand((B, K, Sm, T), generator=g, device=dev) < p_keep
        return q, k, v, mask

    def err_of(args, softcap, tol):
        o, m, s = FA.packed_flash_attention_call(*args, softcap=softcap)
        ro, rm, rs = FA.packed_attention_plain(*args, softcap=softcap)
        err = max((m - rm).abs().max().item(),
                  ((s - rs).abs() / rs).max().item(),
                  ((o - ro).abs() / rs[..., None]).max().item())
        assert err < tol, err
        return err, (m, s)

    for dtype, tol, shapes in (
            (torch.float32, 1e-4, ((2, 8, 200, 64), (1, 1, 200, 64),
                                   (4, 8, 200, 64), (8, 1, 200, 256))),
            (torch.bfloat16, 2e-2, ((1, 8, 40, 64), (2, 1, 1000, 112),
                                    (8, 8, 1000, 64), (8, 1, 40, 112),
                                    (8, 1, 200, 256)))
    ) if small else ():
        for G, Sm, T, dh in shapes:
            args = case(3, 2, 8 * G, T, Sm, dh, dtype, 0.6)
            args[3][1, 0] = False
            for softcap in (0.0, 30.0):
                err, (m, s) = err_of(args, softcap, tol)
                assert (m[1, 0] == -1e30).all() and (s[1, 0] == T).all()
                log(f"  packed_flash_attention {str(dtype)[6:]} R={8 * G} "
                    f"Sm={Sm} T={T} dh={dh} softcap={softcap}, a fully "
                    f"masked head: max_err={err:.3g} (tol {tol} rel.)")
    out = {}
    K, dh, bf = cfg.n_kv_heads, cfg.resolved_head_dim, torch.bfloat16
    B, Sb = 16, 8
    R = Sb * cfg.n_heads // K
    by_T = {}
    for name, T in retains:
        by_T.setdefault(T, []).append(name)
    for T, names in by_T.items():
        name = ", ".join(names)
        args = case(B, K, R, T, Sb if causal else 1, dh, bf, 0.97)
        q, k, v, mask = args
        if causal:
            # retained positions of a 256-token sequence outside the
            # active block (Refresh excludes it); block starts on block
            # edges, row 0's at 0
            start = 8 * torch.randint(1, 31, (B,), generator=g, device=dev)
            start[0] = 0
            cpos = torch.rand((B, K, 256 - Sb), generator=g,
                              device=dev).argsort(-1)[..., :T]
            cpos += Sb * (cpos >= start[:, None, None])
            qpos = start[:, None] + torch.arange(Sb, device=dev)
            mask &= qpos[:, None, :, None] >= cpos[:, :, None, :]
            assert not mask[0].any()
        err, (m, s) = err_of(args, 0.0, 2e-2)
        if causal:
            assert (m[0] == -1e30).all() and (s[0] == T).all()
        log(f"  packed_flash_attention bf16 {cfg.name} B={B} K={K} R={R} "
            f"T={T} dh={dh} causal={causal} ({name}): max_err={err:.3g} "
            f"(tol 2e-2 rel.)")
        full = mask.repeat_interleave(R // mask.shape[2], dim=2)
        pairs = int(full.sum())
        b, by = bound(4.0 * pairs * dh,
                      nbytes(q, k, v, mask) + B * K * R * (dh + 2) * 4, bf)
        call = lambda args=args: FA.packed_flash_attention_call(*args)  # noqa

        def library(q=q, k=k, v=v, full=full):
            return sdpa(q, k, v, attn_mask=full)
        out[f"T={T}"] = dict(
            route="cuda",
            source="src/repro_torch/kernels/csrc/packed_flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:70",
            max_abs_err=err,
            ms=time_ms(call),
            plain_ms=time_ms(lambda: FA.packed_attention_plain(*args),
                             iters=5),
            bound_ms=b, bound_by=by,
            library_ms=time_ms(library),
            device_ms=time_ms(call, queued=True),
            library_device_ms=time_ms(library, queued=True),
            host_us=host_us(call))
    main_row = out.pop(f"T={next(iter(by_T))}")
    return dict(main_row, **out)


def check_flash_refresh(dev, g, cfg, small=True, causal=False):
    """Row 7 at small float32 shapes with every flag (GQA, causal, window
    on and off a local layer, softcap, kv_valid holes, a batch row with no
    valid key, a ragged last tile; dh 64, and dh 256 on one KV head), then
    at the padded prefill of ``cfg`` in bfloat16: B = 2, S = 2048, its
    heads (llada-8b: K = 32, dh = 128; gemma-2b: K = 1, G = 8, dh = 256;
    with ``causal`` zamba2-7b's shared block: K = 32, G = 1, dh = 112);
    ``small=False`` skips the float32 shapes. SDPA takes GQA heads by
    ``enable_gqa``. Tolerances 1e-4 (float32) and 2e-2 (bfloat16)."""
    from repro_torch.kernels import flash_refresh as FR
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def case(B, K, S, G, dh, dtype):
        q = torch.randn((B, K, S * G, dh), generator=g, device=dev).to(dtype)
        k = torch.randn((B, K, S, dh), generator=g, device=dev).to(dtype)
        v = torch.randn((B, K, S, dh), generator=g, device=dev).to(dtype)
        pos = torch.arange(S, dtype=torch.int32, device=dev).repeat(B, 1)
        return q, k, v, pos

    for K, G, dh in ((2, 2, 64), (1, 8, 256)) if small else ():
        q, k, v, pos = case(3, K, 150, G, dh, torch.float32)
        valid = torch.rand((3, 150), generator=g, device=dev) < 0.8
        valid[2] = False
        for kw, loc in ((dict(), False), (dict(softcap=20.0), False),
                        (dict(causal=True), False), (dict(window=5), True),
                        (dict(window=5), False)):
            out = FR.flash_refresh_call(q, k, v, pos, pos, valid, loc, **kw)
            ref = FR.refresh_attention_plain(q, k, v, pos, pos, valid, loc,
                                             **kw)
            err = (out - ref).abs().max().item()
            log(f"  flash_refresh f32 G={G} dh={dh} S=150 {kw or 'plain'} "
                f"local={loc}: max_abs_err={err:.3g} (tol 1e-4)")
            assert err < 1e-4, err
    B, S, K, dh = 2, 2048, cfg.n_kv_heads, cfg.resolved_head_dim
    G, bf = cfg.n_heads // K, torch.bfloat16
    # a ragged kv_valid tail, holes, and a request with no valid key
    # (averages V over all S keys), at the prefill's S and heads
    q, k, v, pos = case(3, K, S, G, dh, bf)
    valid = torch.ones((3, S), dtype=torch.bool, device=dev)
    valid[0, S - 37:] = False
    valid[1] = torch.rand(S, generator=g, device=dev) < 0.7
    valid[2] = False
    err = (FR.flash_refresh_call(q, k, v, pos, pos, valid, causal=causal)
           - FR.refresh_attention_plain(q, k, v, pos, pos, valid, False,
                                        causal=causal)).abs().max().item()
    log(f"  flash_refresh bf16 {cfg.name} B=3 S={S} K={K} dh={dh} causal="
        f"{causal}, ragged tail, holes, no valid key: max_abs_err="
        f"{err:.3g} (tol 2e-2)")
    assert err < 2e-2, err
    q, k, v, pos = case(B, K, S, G, dh, bf)
    valid = torch.ones((B, S), dtype=torch.bool, device=dev)
    call = lambda: FR.flash_refresh_call(q, k, v, pos, pos,  # noqa: E731
                                         valid, causal=causal)
    plain = lambda: FR.refresh_attention_plain(  # noqa: E731
        q, k, v, pos, pos, valid, False, causal=causal)
    err = (call() - plain()).abs().max().item()
    log(f"  flash_refresh bf16 {cfg.name} B={B} S={S} K={K} dh={dh} "
        f"causal={causal}: max_abs_err={err:.3g} (tol 2e-2)")
    assert err < 2e-2, err
    mask = valid[:, None, None, :].expand(B, 1, S, S)
    if causal:
        mask = mask & torch.ones((S, S), dtype=torch.bool, device=dev).tril()
    # the pairs the mask keeps, each head's
    ops = 4.0 * int(mask.sum()) * cfg.n_heads * dh
    b, by = bound(ops, nbytes(q, k, v, pos, pos, valid) + q.numel() * 4, bf)
    ms = time_ms(call, iters=10)
    qh = gqa_heads(q, G)
    return dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_refresh.cu",
        replaces="src/repro/kernels/flash_refresh.py:89", max_abs_err=err,
        ms=ms, plain_ms=time_ms(plain, iters=3), bound_ms=b, bound_by=by,
        library_ms=time_ms(lambda: sdpa(qh, k, v, attn_mask=mask,
                                        enable_gqa=G > 1), iters=10),
        tflop_s=ops / ms / 1e9)


def check_head_score_padded(dev, g, cfg, serve, small=True):
    """Row 8 against its plain version: float32 GQA (Rq = 40, dh = 16, a
    ragged key tile), then llada-8b's padded Refresh in bfloat16: B = 4
    refresh slots, S = max_seq_len = 256, Rq = Sb = 8, dh = 128, its keys
    contiguous and, through ``ops.head_score``, as the [B, K, S, dh] view
    of [B, S, K, dh] keys. Tolerances: 1e-4 and 1e-3 relative to the
    largest score (float32 sums of exact products in another order).
    ``small=False`` skips the float32 shape."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import select_pack as SP

    def case(B, K, Rq, S, dh, dtype):
        q = torch.randn((B, K, Rq, dh), generator=g, device=dev).to(dtype)
        k = torch.randn((B, K, S, dh), generator=g, device=dev).to(dtype)
        return q, k

    def compare(out, ref, tol):
        scale = max(1.0, ref.abs().max().item())
        err = (out - ref).abs().max().item()
        assert err < tol * scale, (err, scale)
        return err, scale

    if small:
        q, k = case(3, 3, 40, 100, 16, torch.float32)
        err, scale = compare(SP.head_score_call(q, k),
                             SP.head_score_plain(q, k), 1e-4)
        log(f"  head_score f32 B=3 Rq=40 S=100 dh=16: max_abs_err={err:.3g} "
            f"(tol 1e-4 x {scale:.3g})")
    B, S, K, dh = 4, serve.max_seq_len, cfg.n_kv_heads, cfg.resolved_head_dim
    Sb, G, bf = serve.block_size, cfg.n_heads // K, torch.bfloat16
    Rq = Sb * G
    q, k = case(B, K, Rq, S, dh, bf)
    err, scale = compare(SP.head_score_call(q, k), SP.head_score_plain(q, k),
                         1e-3)
    log(f"  head_score bf16 {cfg.name} B={B} S={S} Rq={Rq} dh={dh}: "
        f"max_abs_err={err:.3g} (tol 1e-3 x {scale:.3g})")
    q_block = torch.randn((B, Sb, cfg.n_heads, dh), generator=g,
                          device=dev).to(bf)
    k_full = k.permute(0, 2, 1, 3).contiguous()          # [B, S, K, dh]
    qr = (q_block.reshape(B, Sb, K, G, dh).permute(0, 2, 1, 3, 4)
          .reshape(B, K, Rq, dh))
    via_ops = lambda: ops.head_score(q_block, k_full)  # noqa: E731
    err_ops, scale = compare(via_ops(), SP.head_score_plain(qr, k), 1e-3)
    log(f"  head_score bf16 {cfg.name} B={B} S={S} through ops.head_score, "
        f"keys as the [B, K, S, dh] view of [B, S, K, dh]: max_abs_err="
        f"{err_ops:.3g} (tol 1e-3 x {scale:.3g})")
    moved = nbytes(q, k) + B * K * S * 4
    b, by = bound(2.0 * B * K * Rq * S * dh, moved, bf)
    sets = [(q, k)] + [case(B, K, Rq, S, dh, bf)
                       for _ in range(cold_sets(moved) - 1)]
    call = lambda: SP.head_score_call(q, k)  # noqa: E731

    def library(q, k):
        return torch.matmul(q, k.transpose(2, 3)).amax(dim=2)
    cold = cold_ms(SP.head_score_call, sets)
    return dict(
        route="cuda", source="src/repro_torch/kernels/csrc/head_score.cu",
        replaces="src/repro/kernels/select_pack.py:56",
        max_abs_err=max(err, err_ops), ms=time_ms(call),
        plain_ms=time_ms(lambda: SP.head_score_plain(q, k), iters=5),
        bound_ms=b, bound_by=by, library_ms=time_ms(lambda: library(q, k)),
        device_ms=time_ms(call, queued=True), cold_device_ms=cold,
        library_device_ms=time_ms(lambda: library(q, k), queued=True),
        library_cold_device_ms=cold_ms(library, sets),
        tb_s=moved / cold / 1e9, host_us=host_us(call),
        ops_device_ms=time_ms(via_ops, queued=True),
        ops_host_us=host_us(via_ops),
        note="no path reaches it in the reference: its padded scoring "
             "(models/sparse_select.head_scores) is plain jnp")


# ---------------------------------------------------------------------------
# phase 4: a small end-to-end check against the CPU
# ---------------------------------------------------------------------------

def check_reduced_iteration(dev, arch, system="dllm-serve", **overrides):
    """Three engine iterations of the reduced arch (float32; ``overrides``
    to ``reduced``) under a system's profile with the kernels, on the card
    and on the CPU from the same weights and requests: committed ids exact,
    the pool's retained positions exact, retained keys, recurrent states
    and conv histories within 1e-4."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ServeConfig
    from repro_torch.core.baselines import system_profiles
    from repro_torch.core.engine import Engine
    from repro_torch.models.hybrid import HybridCache
    from repro_torch.params import copy_to, init_params

    cfg = reduced(get_config(arch), **overrides)
    serve = dataclasses.replace(system_profiles(ServeConfig(
        max_num_batched_tokens=512, max_num_logits=64, block_size=8,
        steps_per_block=8, max_seq_len=128, max_slots=6, pipeline=False))
        [system], use_flash_kernel=True, logit_mode="fused")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    engines = []
    for d in ("cpu", dev):
        p = params if d == "cpu" else copy_to(params, d)
        e = Engine(cfg, serve, params=p, clock="modeled", device=d)
        rng = np.random.default_rng(0)
        reqs = [e.submit(rng.integers(0, cfg.vocab_size - 1, n), gen_len=24,
                         rid=i) for i, n in enumerate((30, 17, 52, 41))]
        for _ in range(3):                  # one Refresh, two Reuse steps
            e.step(e.vtime)
        engines.append((e, reqs))
    (ec, rc), (eg, rg) = engines
    for a, b in zip(rc, rg):
        assert np.array_equal(a.tokens, b.tokens), f"request {a.rid}"
    pc, pg = ec.pool.cache, eg.pool.cache
    hybrid = isinstance(pc, HybridCache)
    kc, kg = (pc.kv, pg.kv) if hybrid else (pc, pg)
    assert torch.equal(kc.pos[:, :4], kg.pos[:, :4].cpu())
    ok = kc.valid[:, :4]
    assert torch.equal(ok, kg.valid[:, :4].cpu())
    err = (kc.k[:, :4][ok] - kg.k[:, :4].cpu()[ok]).abs().max().item()
    if hybrid:
        for a, b in ((pc.ssm_state, pg.ssm_state), (pc.conv, pg.conv)):
            err = max(err, (a[:, :4] - b[:, :4].cpu()).abs().max().item())
    assert err < 1e-4, err
    log(f"  reduced {arch} {overrides or ''} {system}, 3 iterations: ids "
        f"equal, retained positions equal, cache max_abs_err={err:.3g} "
        f"(tol 1e-4)")


# ---------------------------------------------------------------------------
# phase 5: serve the full models through the kernels
# ---------------------------------------------------------------------------

BASELINE_KERNELS = ("packed_flash_attention", "fused_logit_argmax")
DENSE_KERNELS = ("flash_varlen", "flash_varlen_cross", "head_score_varlen",
                 "fused_logit_argmax")
PATH_KERNELS = {
    ("llada-8b", "dllm-serve"): DENSE_KERNELS,
    ("qwen2.5-14b", "dllm-serve"): DENSE_KERNELS,
    ("gemma2-27b", "dllm-serve"): DENSE_KERNELS,
    ("gemma-2b", "dllm-serve"): DENSE_KERNELS,
    ("gemma-2b", "sparse-dllm"): BASELINE_KERNELS,
    ("zamba2-7b", "dllm-serve"): ("ssm_segment_scan", "flash_varlen",
                                  "flash_varlen_cross", "head_score_varlen",
                                  "fused_logit_argmax"),
    ("mamba2-130m", "dllm-serve"): ("ssm_segment_scan", "fused_logit_argmax"),
    ("llada-8b", "fast-dllm"): BASELINE_KERNELS,
    ("llada-8b", "dllm-cache"): BASELINE_KERNELS,
    ("llada-8b", "sparse-dllm"): BASELINE_KERNELS,
    # the scan families' padded path: the reference's jnp ssd_scan (torch
    # ops here), the shared block's cache half through row 6
    ("zamba2-7b", "fast-dllm"): BASELINE_KERNELS,
    ("zamba2-7b", "sparse-dllm"): BASELINE_KERNELS,
    ("mamba2-130m", "dllm-cache"): ("fused_logit_argmax",),
    ("phi3.5-moe-42b-a6.6b", "dllm-serve"): DENSE_KERNELS,
    ("qwen3-moe-235b-a22b", "dllm-serve"): DENSE_KERNELS,
    # the modality frontends: [F ; text] Refresh segments, text Reuse
    ("musicgen-medium", "dllm-serve"): DENSE_KERNELS,
    ("musicgen-medium", "fast-dllm"): BASELINE_KERNELS,
    ("internvl2-76b", "dllm-serve"): DENSE_KERNELS,
}
# depth cuts of the archs whose weights do not fit the card: phi3.5-moe's
# 32 layers are ~83.7 GB of bfloat16 weights (24: ~62.9 GB), qwen3-moe's
# 94 ~470 GB (8: ~42.3 GB), internvl2-76b's 80 ~141 GB (24: ~45.3 GB)
LAYERS = {"phi3.5-moe-42b-a6.6b": 24, "qwen3-moe-235b-a22b": 8,
          "internvl2-76b": 24}


def served_config(arch):
    """The arch's config, cut to ``LAYERS[arch]`` layers where it has a
    cut."""
    import dataclasses
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if arch in LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=LAYERS[arch])
    return cfg


def serve_plan(arch, system, serve_kw, hbm_gb, own_logits=False):
    """The plan run_serve sizes a kernels serve with (its own helper on the
    same ServeConfig and the same depth), and that ServeConfig with its
    slots sized; ``own_logits`` keeps the profile's logit mode (monolithic
    or chunked) in place of the fused kernel."""
    import dataclasses
    from repro_torch.configs.base import ServeConfig
    from repro_torch.core.baselines import system_profiles
    from repro_torch.launch.serve import profile_slots

    base = ServeConfig(max_refresh_per_iter=4, **serve_kw)
    serve = dataclasses.replace(system_profiles(base)[system],
                                use_flash_kernel=True)
    if not own_logits:
        serve = dataclasses.replace(serve, logit_mode="fused")
    return profile_slots(served_config(arch), serve, serve_kw["max_slots"],
                         hbm_gb)


def serve_full(arch, system, n_req, serve_kw, card, hbm_gb):
    """run_serve of the full arch under a system, its slots sized by the
    offline profiler at the card's memory, with the launch counts zeroed
    just before and read just after; returns the counts."""
    from repro_torch.kernels import build
    from repro_torch.launch.serve import run_serve

    plan, _ = serve_plan(arch, system, serve_kw, hbm_gb)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.reset_counters()
    res = run_serve(arch, system, "livebench", 50.0, n_req,
                    use_reduced=False, kernels=True, clock="wall",
                    size_by_profiler=True, hbm_gb=hbm_gb, device="cuda",
                    n_layers=LAYERS.get(arch), **serve_kw)
    counts = {n: (c.launches, c.plain_calls)
              for n, c in build.COUNTERS.items()}
    assert res["plan_slots_logical"] == plan.max_slots, (res, plan)
    assert res["max_slots"] == plan.phys_slots, (res, plan)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    keep = ("n_finished", "n_submitted", "committed_tokens", "iterations",
            "refresh_steps", "reuse_steps", "wall_clock_s", "wall_tok_s",
            "p50_latency", "p99_latency", "host_plan_s", "host_fill_s",
            "sync_wait_s", "warmup_s", "refresh_tokens_real",
            "refresh_tokens_exec", "reuse_tokens_exec", "logit_tokens_exec",
            "refresh_waste", "reuse_waste", "padded_refresh_calls",
            "padded_reuse_calls", "max_slots", "plan_slots_logical",
            "plan_slots_phys", "plan_slot_bytes", "pipeline",
            "compile_counts", "compiles_post_warmup", "dispatched_ahead",
            "overlap_frac", "graph_pool_bytes")
    replays = res["graph_replays"]
    log(json.dumps(dict(phase="serve", arch=arch, system=system,
                        n_layers=served_config(arch).n_layers,
                        **{k: res[k] for k in keep}, hbm_gb=hbm_gb,
                        plan=plan.summary(),
                        plan_activation_bytes=plan.activation_bytes,
                        graph_replays=sum(replays.values()),
                        graph_entries_replayed=len(replays),
                        max_memory_allocated=peak, launches=counts)))
    tag = arch if system == "dllm-serve" else f"{arch}_{system}"
    with open(os.path.join(OUT_DIR, f"chip_smoke_serve_{tag}.json"),
              "w") as f:
        json.dump(dict(res, arch=arch, max_memory_allocated=peak,
                       launches=counts, card=card), f, indent=2)
    assert res["n_finished"] == n_req, (arch, system, res["n_finished"])
    # every stage call of the run replayed a graph captured in warmup
    assert res["pipeline"] and res["dispatched_ahead"] > 0, res
    assert res["compiles_post_warmup"] == 0, res["compile_counts"]
    assert sum(replays.values()) >= res["iterations"], replays
    for name in PATH_KERNELS[(arch, system)]:
        assert counts[name][0] > 0, f"{arch} {system}: {name} never launched"
    for name, (_, plain) in counts.items():
        assert plain == 0, f"{arch} {system}: {plain} plain-version calls " \
            f"of {name}"
    return {n: launches for n, (launches, _) in counts.items()}


GRAPH_COUNTERS = (
    "iterations", "refresh_steps", "reuse_steps", "committed_tokens",
    "deferred_steps", "peak_query_tokens", "refresh_tokens_real",
    "refresh_tokens_exec", "reuse_tokens_real", "reuse_tokens_exec",
    "logit_tokens_real", "logit_tokens_exec", "packed_refresh_calls",
    "padded_refresh_calls", "packed_reuse_calls", "padded_reuse_calls",
    "submitted", "finished", "dispatched_ahead")


def graphs_vs_eager(arch, system, n_req, serve_kw, hbm_gb, own_logits=False):
    """The full arch under a system (its slots sized as ``run_serve`` sizes
    them, the launcher's pipelined loop, the modeled clock, the livebench
    trace ``run_serve`` draws; with ``own_logits`` the profile's own logit
    mode, monolithic or chunked, as torch ops), served by two engines on
    the same weights:
    with the stage entries captured as CUDA graphs and with the same
    entries run eagerly. Ids, counters and the modeled clock must be
    identical, and so must each kernel's launches over the run (counted
    from after warmup: the graphs' warmup runs every bucket once); the
    graphed engine builds nothing after warmup. Logs warmup seconds, the
    captures, the graph pool's bytes and the peak the captures add beside
    the plan's activation reservation."""
    import numpy as np
    from repro_torch.core.engine import Engine
    from repro_torch.data.workloads import make_trace, trace_prompts
    from repro_torch.kernels import build
    from repro_torch.params import init_params

    plan, serve = serve_plan(arch, system, serve_kw, hbm_gb, own_logits)
    cfg = served_config(arch)
    gc.collect()
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    trace = make_trace("livebench", n_req, 50.0, seed=0, scale=0.15)
    prompts = trace_prompts(trace, cfg.vocab_size, seed=0)
    S, Sb = serve.max_seq_len, serve.block_size
    out = {}
    for graphs in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        eng = Engine(cfg, serve, params=params, clock="modeled",
                     device="cuda", graphs=graphs)
        warmup_s = eng.warmup()
        warm_peak = torch.cuda.max_memory_allocated() - base
        reqs = []
        for i, (t, p) in enumerate(zip(trace, prompts)):
            gl = max(Sb, min(t.gen_len, S - len(p) - Sb))
            reqs.append(eng.submit(p[: min(len(p), S - gl - Sb)],
                                   gen_len=gl, arrival=t.arrival, rid=i))
        build.reset_counters()
        st = eng.run()
        torch.cuda.synchronize()
        out[graphs] = dict(
            tokens=[r.tokens.copy() for r in reqs], vtime=eng.vtime,
            counters={k: getattr(st, k) for k in GRAPH_COUNTERS},
            launches={n: (c.launches, c.plain_calls)
                      for n, c in build.COUNTERS.items()},
            warmup_s=warmup_s, captures=st.compile_counts,
            post_warmup=st.compiles_post_warmup,
            replays=sum(st.graph_replays.values()),
            pool_bytes=eng.graphs.pool_bytes(), warmup_peak_bytes=warm_peak,
            run_peak_bytes=torch.cuda.max_memory_allocated() - base)
        del eng, reqs, st
    del params
    e, g = out[False], out[True]
    same_ids = all(np.array_equal(a, b) for a, b in zip(e["tokens"],
                                                       g["tokens"]))
    log(json.dumps(dict(
        phase="graphs", arch=arch, system=system, n_layers=cfg.n_layers,
        logit_mode=serve.logit_mode, n_requests=n_req,
        max_slots=serve.max_slots, ids_equal=same_ids,
        counters_equal=e["counters"] == g["counters"],
        vtime_equal=e["vtime"] == g["vtime"],
        launches_equal=e["launches"] == g["launches"],
        iterations=g["counters"]["iterations"],
        warmup_s_graphs=g["warmup_s"], warmup_s_eager=e["warmup_s"],
        captures=g["captures"], compiles_post_warmup=g["post_warmup"],
        graph_replays=g["replays"], graph_pool_bytes=g["pool_bytes"],
        warmup_peak_bytes_graphs=g["warmup_peak_bytes"],
        warmup_peak_bytes_eager=e["warmup_peak_bytes"],
        run_peak_bytes_graphs=g["run_peak_bytes"],
        run_peak_bytes_eager=e["run_peak_bytes"],
        plan_activation_bytes=plan.activation_bytes,
        plan_logit_bytes=plan.logit_bytes,
        launches={n: c for n, (c, _) in g["launches"].items() if c})))
    assert same_ids, f"{arch} {system} {serve.logit_mode}: graphed ids " \
        f"differ from eager"
    assert e["counters"] == g["counters"], (e["counters"], g["counters"])
    assert e["vtime"] == g["vtime"], (e["vtime"], g["vtime"])
    assert e["launches"] == g["launches"], (e["launches"], g["launches"])
    assert all(p == 0 for _, p in g["launches"].values()), g["launches"]
    assert g["post_warmup"] == 0 and g["replays"] > 0, g["captures"]
    assert sum(g["captures"].values()) > 0 and e["replays"] == 0
    torch.cuda.empty_cache()


def footprint(dev, hbm_gb):
    """The C1 footprint: each llada-8b system's plan (its profile's own
    logit mode) at the reference's 24 GB and at the card's memory, at the
    plan geometry; then the logit stage's measured peak in each C1 mode at
    128 and 4000 rows beside the profiler's bill for it."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ServeConfig
    from repro_torch.core import budgeting as BG
    from repro_torch.core.baselines import system_profiles
    from repro_torch.launch.serve import PLAN_GEOMETRY

    cfg = get_config("llada-8b")
    profiles = system_profiles(ServeConfig(
        block_size=8, steps_per_block=8, max_slots=12,
        max_refresh_per_iter=4, pipeline=False, **PLAN_GEOMETRY))
    for system, serve in profiles.items():
        for gb in (24, hbm_gb):
            plan = BG.plan_memory(cfg, serve, gb << 30)
            log(json.dumps(dict(phase="footprint", arch=cfg.name,
                                system=system, logit_mode=serve.logit_mode,
                                hbm_gb=gb, slots=plan.max_slots,
                                slot_bytes=plan.slot_bytes,
                                logit_bytes=plan.logit_bytes,
                                plan=plan.summary())))
    serve = profiles["dllm-serve"]
    for n in (128, 4000):
        torch.cuda.empty_cache()
        peak = BG.measure_logit_peak(cfg, serve, n, device=dev)
        billed = {m: BG.logit_activation_bytes(
            cfg, dataclasses.replace(serve, logit_mode=m), n) for m in peak}
        log(json.dumps(dict(phase="footprint", arch=cfg.name, rows=n,
                            rows_billed=BG.logit_exec_tokens(serve, n),
                            max_num_logits=serve.max_num_logits,
                            measured_peak_bytes=peak,
                            logit_activation_bytes=billed)))
        assert all(v > 0 for v in peak.values()), peak
    torch.cuda.empty_cache()


def prefill_full(dev, serve, arch="llada-8b", Sb=None):
    """One padded prefill of the full arch (random bfloat16 weights):
    serve_refresh of B = 2 sequences of S = 2048 with use_flash_refresh (the flash_refresh kernel in every
    attention layer: each layer of a dense arch, each invocation of the
    hybrid's shared causal block), then decode_tokens of the active blocks
    (``Sb`` rows each, the serve's block by default) in the fused mode.
    Counted alone. The fused decode's ids must equal the argmax of the
    same hidden rows' float32 logits where their top two are 2e-3 apart
    (the logit kernel's tolerance above).

    Held against the same call without the kernel (the q-chunked plain
    attention), two ways. At one layer of the arch's full width in
    float32 (the hybrid: one group, its Mamba2 layers and the shared
    block; its own random weights) both compute every score in float32:
    the final-normed block hidden must agree within 1e-3 (sums in other
    orders, TF32 off). Through the bfloat16 layers the kernel keeps its
    scores in float32 where the plain attention, like the reference's jnp
    path, rounds them to bfloat16, so the two drift apart layer by layer:
    the drift is reported and held under 1.0 and 0.15 on average
    (magnitude ~1)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import backbone as BB
    from repro_torch.models import hybrid as HY
    from repro_torch.models import lm_head as LM
    from repro_torch.models import transformer as T

    torch.cuda.empty_cache()
    cfg = get_config(arch)
    hybrid = cfg.family == "hybrid"
    attn_layers = HY.group_shape(cfg)[0] if hybrid else cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(1)
    params = BB.init_params(cfg, gen, dev)
    B, S, Sb = 2, 2048, Sb or serve.block_size
    tokens = torch.randint(0, cfg.vocab_size - 1, (B, S), generator=gen,
                           device=dev, dtype=torch.int32)
    valid = torch.ones((B, S), dtype=torch.bool, device=dev)
    valid[1, 1500:] = False
    # block starts on block edges (the scan captures at chunk edges)
    bstart = torch.tensor([1024, 1480 // Sb * Sb], dtype=torch.int32,
                          device=dev)
    ctx = T.ServeContext(block_size=Sb, retain=S // 2, kernel_size=3,
                         selection=serve.selection, q_chunk=1024,
                         use_flash_kernel=True, use_flash_refresh=True,
                         max_seq_len=S)
    plain = dataclasses.replace(ctx, use_flash_refresh=False)
    torch.cuda.synchronize()
    build.reset_counters()
    t0 = time.perf_counter()
    out = BB.serve_refresh(params, cfg, tokens, bstart, ctx,
                           token_valid=valid)
    ids, _ = LM.decode_tokens(params["embed"], cfg,
                              out.block_hidden.reshape(B * Sb, -1),
                              max_num_logits=serve.max_num_logits,
                              mode="fused")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = {n: (c.launches, c.plain_calls)
              for n, c in build.COUNTERS.items()}
    assert counts["flash_refresh"][0] == attn_layers, counts
    assert counts["fused_logit_argmax"][0] > 0, counts
    for name, (_, n_plain) in counts.items():
        assert n_plain == 0, f"prefill: {n_plain} plain-version calls of " \
            f"{name}"
    z = LM.logits_monolithic(params["embed"], cfg,
                             out.block_hidden.reshape(B * Sb, -1))
    top2 = z.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2e-3
    same = torch.equal(ids[clear], z.argmax(dim=1).to(ids.dtype)[clear])

    ref = BB.serve_refresh(params, cfg, tokens, bstart, plain,
                           token_valid=valid).block_hidden.float()
    d = (out.block_hidden.float() - ref).abs()
    full = (d.max().item(), d.mean().item())
    del params, out, ref
    torch.cuda.empty_cache()
    c32 = dataclasses.replace(
        cfg, n_layers=cfg.shared_attn_interval if hybrid else 1,
        dtype="float32")
    p32 = BB.init_params(c32, gen, dev)
    a, b = (BB.serve_refresh(p32, c32, tokens, bstart, c, token_valid=valid)
            .block_hidden for c in (ctx, plain))
    one = (a - b).abs().max().item()
    del p32, a, b
    log(json.dumps(dict(
        phase="prefill", arch=cfg.name, n_layers=cfg.n_layers, B=B, S=S,
        block=Sb, seconds=secs,
        f32_one_layer_max_abs_err=one, bf16_max_abs_err=full[0],
        bf16_mean_abs_err=full[1],
        ids_compared=int(clear.sum()), ids_equal=same,
        launches={n: c for n, (c, _) in counts.items() if c})))
    assert one < 1e-3, one
    assert full[0] < 1.0 and full[1] < 0.15, full
    assert same, "the fused decode's ids differ from the logits' argmax"
    return {n: c for n, (c, _) in counts.items()}


def main(argv) -> int:
    kernels_only = "--kernels-only" in argv
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ServeConfig
    from repro_torch.core.baselines import system_profiles
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(OUT_DIR, exist_ok=True)
    dev = torch.device("cuda")
    t_all = time.perf_counter()

    # 1. environment
    t0 = time.perf_counter()
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    nvcc_v = subprocess.run([nvcc, "--version"], capture_output=True,
                            text=True).stdout.strip().splitlines()[-1]
    card = nvidia_smi("name,power.limit")
    log(json.dumps(dict(phase="environment", python=sys.version.split()[0],
                        torch=torch.__version__, cuda=torch.version.cuda,
                        nvcc=nvcc_v, device=torch.cuda.get_device_name(0),
                        device_count=torch.cuda.device_count(),
                        nvidia_smi=card)))
    log(f"phase environment: {time.perf_counter() - t0:.3f} s")

    # 2. build
    t0 = time.perf_counter()
    build.library()
    if build.build_log:         # empty when an earlier run built the library
        with open(os.path.join(OUT_DIR, "kernel_build.log"), "w") as f:
            f.write(build.build_log)
    log(f"phase build: {time.perf_counter() - t0:.3f} s "
        f"(nvcc {build.build_seconds:.3f} s; ptxas report in "
        f"build/chip_smoke/kernel_build.log)")

    # 3. each kernel against its plain version
    t0 = time.perf_counter()
    llada, zamba = get_config("llada-8b"), get_config("zamba2-7b")
    mamba = get_config("mamba2-130m")
    qwen14, qwen72 = get_config("qwen2.5-14b"), get_config("qwen2-72b")
    gemma27, gemma2b = get_config("gemma2-27b"), get_config("gemma-2b")
    phi, qwen3 = (get_config("phi3.5-moe-42b-a6.6b"),
                  get_config("qwen3-moe-235b-a22b"))
    musicgen, internvl = (get_config("musicgen-medium"),
                          get_config("internvl2-76b"))
    serve_kw = dict(max_seq_len=256, block_size=8, max_slots=12,
                    max_num_batched_tokens=1024, max_num_logits=128)
    serve = ServeConfig(**serve_kw)
    retain = min(serve.retained_len, serve.max_seq_len - serve.block_size)
    # the baselines' padded Reuse cache lengths (retention 1.0 and 0.5)
    base_retain = [(s, min(p.retained_len, p.max_seq_len - p.block_size))
                   for s, p in system_profiles(serve).items()
                   if p.scheduler == "request"]
    g = torch.Generator(device=dev).manual_seed(0)
    results = {
        "flash_varlen": check_flash_varlen(dev, g, llada, serve),
        "flash_varlen_cross": check_flash_varlen_cross(dev, g, llada, serve,
                                                       retain),
        "head_score_varlen": check_head_score(dev, g, llada, serve),
        "fused_logit_argmax": check_logit_argmax(
            dev, g, llada, serve, mamba,
            (gemma27, qwen14, gemma2b, phi, qwen3, musicgen, internvl)),
        "ssm_segment_scan": check_ssm_segment_scan(dev, g, zamba, mamba,
                                                   serve),
        "packed_flash_attention": check_packed_flash_attention(
            dev, g, llada, base_retain),
        "flash_refresh": check_flash_refresh(dev, g, llada),
        "head_score": check_head_score_padded(dev, g, llada, serve),
    }
    # the shared block of zamba2-7b: causal, head_dim 112
    results["flash_varlen"]["zamba2-7b"] = check_flash_varlen(
        dev, g, zamba, serve, causal=True, small=False)
    results["flash_varlen_cross"]["zamba2-7b"] = check_flash_varlen_cross(
        dev, g, zamba, serve, retain, causal=True, small=False)
    results["head_score_varlen"]["zamba2-7b"] = check_head_score(
        dev, g, zamba, serve, small=False)
    # the dense archs: gemma-2b's head_dim 256 on one KV head (G = 8),
    # gemma2-27b's G = 2 with its softcap 50 and a window of 64 that cuts
    # (its own 4096 never cuts at max_seq_len 256), qwen2.5-14b's G = 5
    # (128-row tiles cut tokens' query groups), qwen2-72b's H = 64, K = 8
    # (its weights do not fit the card; its heads do)
    for c, window in ((gemma2b, 0), (gemma27, 64), (qwen14, 0)):
        tag = f"{c.name} window={window}" if window else c.name
        results["flash_varlen"][tag] = check_flash_varlen(
            dev, g, c, serve, small=False, window=window)
        results["flash_varlen_cross"][tag] = check_flash_varlen_cross(
            dev, g, c, serve, retain, small=False, window=window)
        results["head_score_varlen"][c.name] = check_head_score(
            dev, g, c, serve, small=False)
    results["flash_varlen"][qwen72.name] = check_flash_varlen(
        dev, g, qwen72, serve, small=False)
    results["packed_flash_attention"]["gemma-2b T=128"] = \
        check_packed_flash_attention(
            dev, g, gemma2b, [("sparse-dllm", dict(base_retain)[
                "sparse-dllm"])], small=False)
    results["flash_refresh"]["gemma-2b"] = check_flash_refresh(
        dev, g, gemma2b, small=False)
    results["head_score"]["gemma-2b"] = check_head_score_padded(
        dev, g, gemma2b, serve, small=False)
    # the MoE archs' attention: phi3.5-moe's K = 8, G = 4 and qwen3-moe's
    # 64 heads on K = 4 (G = 16); their heads are rows 4's above
    for c in (phi, qwen3):
        results["flash_varlen"][c.name] = check_flash_varlen(
            dev, g, c, serve, small=False)
        results["flash_varlen_cross"][c.name] = check_flash_varlen_cross(
            dev, g, c, serve, retain, small=False)
        results["head_score_varlen"][c.name] = check_head_score(
            dev, g, c, serve, small=False)
    # the modality frontends: Refresh segments of F = 256 prefix rows and
    # up to S = 256 text tokens (two fill the 1,024-token bucket); musicgen-
    # medium's MHA at dh 64 (H = K = 24), internvl2-76b's 64 heads on K = 8;
    # their heads are row 4's above
    fe_lens = (512, 496)
    for c in (musicgen, internvl):
        tag = f"{c.name} [F ; text]"
        results["flash_varlen"][tag] = check_flash_varlen(
            dev, g, c, serve, small=False, lens=fe_lens)
        results["flash_varlen_cross"][c.name] = check_flash_varlen_cross(
            dev, g, c, serve, retain, small=False)
        results["head_score_varlen"][tag] = check_head_score(
            dev, g, c, serve, small=False, lens=fe_lens)
    # musicgen-medium's padded Reuse (fast-dllm): row 6 at K = 24, G = 1,
    # dh 64 over the dense retention's 248 cached rows
    results["packed_flash_attention"]["musicgen-medium T=248"] = \
        check_packed_flash_attention(
            dev, g, musicgen, [("fast-dllm", dict(base_retain)["fast-dllm"])],
            small=False)
    # zamba2-7b's shared block on the padded path: row 6 at the baselines'
    # Reuse with its causal mask rows, row 7 at its causal prefill
    z6 = check_packed_flash_attention(dev, g, zamba, base_retain,
                                      small=False, causal=True)
    pfa = results["packed_flash_attention"]
    pfa["zamba2-7b causal T=128"] = z6.pop("T=128")
    pfa["zamba2-7b causal T=248"] = z6
    results["flash_refresh"]["zamba2-7b causal"] = check_flash_refresh(
        dev, g, zamba, small=False, causal=True)
    torch.cuda.synchronize()
    for name, r in results.items():
        for shape, x in [("", r)] + [(f" {k}", v) for k, v in r.items()
                                      if isinstance(v, dict)]:
            lib = ("none" if x["library_ms"] is None
                   else f"{x['library_ms']:.4f}")
            rate = "".join(f" {k}={x[k]:.4f}" for k in (
                "device_ms", "cold_device_ms", "library_device_ms",
                "library_cold_device_ms", "tflop_s", "w_tb_s", "tb_s",
                "host_us", "ops_device_ms", "ops_host_us") if k in x)
            rate += "".join(f" {k}={x[k]}" for k in ("splits", "ms_by_splits")
                            if k in x)
            log(f"  {name}{shape}: kernel_ms={x['ms']:.4f} "
                f"plain_ms={x['plain_ms']:.4f} library_ms={lib} "
                f"bound_ms={x['bound_ms']:.4f} ({x['bound_by']}){rate}")
    log(f"phase kernels: {time.perf_counter() - t0:.3f} s")
    if kernels_only:
        # the kernel phase alone, for timing another tree's kernels with
        # this script's method: no serve, so no launch counts, no result
        print(json.dumps({"kernels": [dict(name=n, **r)
                                      for n, r in results.items()]}))
        print(card)
        return 0

    # 4. small end-to-end checks
    t0 = time.perf_counter()
    for arch, system, over in (("llada-8b", "dllm-serve", {}),
                               ("zamba2-7b", "dllm-serve", {}),
                               ("zamba2-7b", "sparse-dllm", {}),
                               # G = 4 as in the real arch; at 4 heads
                               # over 1 the first Refresh's layer-0
                               # scores hold two values equal within
                               # float32 rounding on the retention
                               # boundary, which the kernel's sums order
                               # the other way: a valid result, but no
                               # exact comparison
                               ("phi3.5-moe-42b-a6.6b", "dllm-serve",
                                dict(n_heads=8, n_kv_heads=2)),
                               ("llada-8b", "sparse-dllm", {}),
                               ("gemma2-27b", "dllm-serve",
                                dict(n_kv_heads=2)),
                               ("gemma-2b", "dllm-serve", dict(head_dim=256)),
                               ("gemma-2b", "sparse-dllm",
                                dict(head_dim=256)),
                               ("musicgen-medium", "dllm-serve", {}),
                               # G = 8 as in the real arch; at 4 heads on 4
                               # the first Refresh's scores hold two values
                               # 5.6e-7 apart (relative) on the retention
                               # boundary, which the card orders the other
                               # way; at 8 on 1 the closest pair is 2e-2
                               # apart
                               ("internvl2-76b", "dllm-serve",
                                dict(n_heads=8, n_kv_heads=1))):
        check_reduced_iteration(dev, arch, system, **over)
    log(f"phase reduced-check: {time.perf_counter() - t0:.3f} s")

    # 5. the C1 footprint, then serve the full models through the kernels,
    # each path counted alone, their slots sized at the card's memory
    del g
    hbm_gb = torch.cuda.get_device_properties(0).total_memory >> 30
    t0 = time.perf_counter()
    footprint(dev, hbm_gb)
    log(f"phase footprint: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    for arch, system, own in (("llada-8b", "dllm-serve", False),
                              ("llada-8b", "sparse-dllm", False),
                              ("zamba2-7b", "dllm-serve", False),
                              ("zamba2-7b", "sparse-dllm", False),
                              ("phi3.5-moe-42b-a6.6b", "dllm-serve", False),
                              ("gemma2-27b", "dllm-serve", False),
                              ("gemma-2b", "dllm-serve", False),
                              ("musicgen-medium", "dllm-serve", False),
                              # the profiles' own logit modes: monolithic
                              # (fast-dllm) and chunked (dllm-serve)
                              ("llada-8b", "fast-dllm", True),
                              ("llada-8b", "dllm-serve", True)):
        graphs_vs_eager(arch, system, 8, serve_kw, hbm_gb, own_logits=own)
    log(f"phase graphs: {time.perf_counter() - t0:.3f} s")
    launches = {name: {} for name in results}
    for arch, system, n_req in (("llada-8b", "dllm-serve", 8),
                                ("zamba2-7b", "dllm-serve", 8),
                                ("mamba2-130m", "dllm-serve", 4),
                                ("llada-8b", "fast-dllm", 8),
                                ("llada-8b", "dllm-cache", 8),
                                ("llada-8b", "sparse-dllm", 8),
                                ("qwen2.5-14b", "dllm-serve", 8),
                                ("gemma2-27b", "dllm-serve", 8),
                                ("gemma-2b", "dllm-serve", 8),
                                ("gemma-2b", "sparse-dllm", 8),
                                ("zamba2-7b", "fast-dllm", 8),
                                ("zamba2-7b", "sparse-dllm", 8),
                                ("mamba2-130m", "dllm-cache", 4),
                                ("phi3.5-moe-42b-a6.6b", "dllm-serve", 8),
                                ("qwen3-moe-235b-a22b", "dllm-serve", 8),
                                ("musicgen-medium", "dllm-serve", 8),
                                ("musicgen-medium", "fast-dllm", 8),
                                ("internvl2-76b", "dllm-serve", 8)):
        t0 = time.perf_counter()
        counts = serve_full(arch, system, n_req, serve_kw, card, hbm_gb)
        for name in PATH_KERNELS[(arch, system)]:
            launches[name][f"{arch} {system}"] = counts[name]
        log(f"phase serve {arch} {system}: {time.perf_counter() - t0:.3f} s")
    # zamba2-7b's prefill at block 64, so its scan runs the config's own
    # chunk of 64 (the serving chunk is gcd(ssm_chunk, block))
    for arch, kw in (("llada-8b", {}), ("gemma-2b", {}),
                     ("zamba2-7b", dict(Sb=64))):
        t0 = time.perf_counter()
        counts = prefill_full(dev, serve, arch, **kw)
        launches["flash_refresh"][f"{arch} padded prefill"] = \
            counts["flash_refresh"]
        log(f"phase prefill {arch}: {time.perf_counter() - t0:.3f} s")
    launches["head_score"] = {}
    for name, r in results.items():
        r["launches"] = sum(launches[name].values())
        r["launches_by_path"] = launches[name]

    keys = ("route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [dict(name=n, **{k: r[k] for k in keys},
                    **{k: v for k, v in r.items() if k not in keys})
               for n, r in results.items()]
    log(f"total: {time.perf_counter() - t_all:.3f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
