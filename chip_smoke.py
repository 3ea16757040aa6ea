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
     graphs: llada-8b and zamba2-7b under dllm-serve and sparse-dllm,
     phi3.5-moe, gemma2-27b, the full gemma-2b and musicgen-medium under
     dllm-serve, and llada-8b at the profiles' own logit modes
     (monolithic under fast-dllm, chunked under dllm-serve: torch ops, no
     kernel), at full width and cut in depth (``GRAPH_LAYERS``: 8 of
     llada-8b's 32 and phi3.5-moe's 32 layers, 12 of zamba2-7b's 81,
     gemma2-27b's 46 and musicgen-medium's 48), on the
     modeled clock, by an engine
     whose stage entries are captured CUDA graphs and by one running the
     same entries eagerly, on the same weights: ids, counters, modeled
     clock and launches identical, nothing built after warmup (warmup
     seconds, captures, the graph pool's bytes and the plan's activation
     reservation logged);
     multipliers: the full llada-8b under dllm-serve with a seeded fault
     plan (four slots, starvation preemption), with prefix sharing on the
     shared-prefix prompts (all arriving at once) and with int8 slots,
     each graphed = eager as above, then each served by run_serve on the
     wall clock (shared_hits, phys_slots_peak; the faults' retries and
     deferrals, at four slots for eight requests; wall_tok_s; the plan's
     physical slots with and without
     int8 at 24 GB and at the card's memory), and two serves at
     run_serve's default 24 GB with the slot cap raised to 64, bf16 and
     int8 slots, whose device bills (the engine's slot pool, the graph
     pool and the staging beside the engine's weights and the plan's
     reservation),
     re-sizes and allocator peaks are logged; each peak must stay under
     24 GiB;
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
     mesh: each of rows 1-7 on each half of the model axis at full width
     (llada-8b's 32 heads and 126,464-column head, zamba2-7b's 112 and
     mamba2-130m's 24 state heads; the argmax halves merged) against the
     unsharded launch; row 7 on each half of the query rows (llada-8b's
     and gemma-2b's prefill, B 2, S 2048: the flash Refresh's fallback
     where the heads do not divide the model axis) and row 6 on each half
     of the retained length (llada-8b B 16, K 32, T 248 and gemma-2b K 1,
     dh 256), merged by ``(o, m, s)``, against the unsharded launch; a
     batch-1 ``serve_reuse`` at (2, 1) on two ranks co-located on cuda:0
     (llada-8b at full width cut to 8 layers, bfloat16, the kernels, each
     rank holding half of 16,384 retained rows) against the one-device
     call, each rank's allocator peak and collective ms logged beside the
     one-device peak; one MoE layer a rank at full width, bfloat16
     (phi3.5-moe and qwen3-moe, T = 128 and 1,024, two ranks co-located
     at (1, 2) and (2, 1): ``gather`` against the one-device layer,
     ``ep`` against the one-device ``gather`` of the same rows, each
     rank's expert bytes the plan's, its peak, call ms and collective ms
     logged); ``launch.shard_check`` on two ranks co-located on
     cuda:0 over gloo (eager, the kernels, float32, TF32 off): llada-8b at
     full width cut to 8 of 32 layers at meshes (1, 2) and (2, 1) and on
     the padded path at (1, 2), the whole mamba2-130m at (1, 2) and on the
     pod mesh (2, 1, 1), and phi3.5-moe cut to 2 of 32 layers at (1, 2)
     and (2, 1), each
     against the one-device serve at the same depth and dtype by the
     tool's own law (ids, counters and the mesh's size exactly, the pool
     by ``shard_check.pool_close``, each rank's parameter bytes the
     plan's), every kernel of the path launched in
     the one-device serve and on each rank, the ranks' collective share
     logged, and beside llada-8b's (1, 2) the one-device serve against
     itself with its row-parallel sums reordered (the size of float32
     reordering alone); then llada-8b (8 layers, bfloat16) graphed on a
     (1, 1) mesh = no mesh graphed;
  6. train: masked-diffusion training, which runs torch ops under
     autograd and no hand kernel (as the reference's runs no Pallas
     kernel): the reduced llada-8b, gemma2-27b, phi3.5-moe, zamba2-7b and
     musicgen-medium (its frontend through make_train_step), float32, a
     loss with its gradients and three steps on the card against the
     same on the CPU; the chunked loss's allocator peak at llada-8b's head
     over 4,096 rows, at chunk 2,048 under the single chunk's; then
     ``Trainer`` for 5 steps of 8 x 2,048 tokens at the published widths,
     bfloat16: llada-8b at 8 of its 32 layers (a checkpoint at step 3 and
     a second Trainer resuming there) and the whole mamba2-130m, with
     every loss and grad_norm finite, every random weight moved, and all
     eight kernels' counters at 0 over each run; step time, tokens a
     second, the peak beside 16 bytes a parameter and the share of 989
     TFLOP/s are logged;
  7. tooling: the lint over src/repro_torch finds nothing; the retrace
     sentinel (analysis.retrace.check_engine) passes the graphs phase's
     graphed llada-8b dllm-serve (no build after warmup); the meta dry
     run's records of llada-8b decode_32k and qwen2-72b prefill_32k at
     16x16 and qwen3-moe decode_32k at 2x16x16; rank 0's qwen2-72b serve
     shard at 16x16, drawn on the card leaf by leaf, asks the allocator
     for exactly the dry run's parameter bytes (requested bytes; its
     blocks each rounded up to 512 B, or a cached block whole); a
     llada-8b padded Reuse at full width (4 layers, B = 4, 1,024 retained
     rows, the plain calls) peaks on the card within 10% of the meta
     tracker's temp bytes, both for those calls and for ``serve_reuse``,
     the figure the dry run records;
  8. the kernels line, the card line, and the result line.

Without a CUDA device, or without the rest of the repository beside it, the
script exits non-zero before printing any result.

    python3 chip_smoke.py --kernels-only

runs phases 1-3 alone and prints the kernels line without launch counts and
without the result line: copied into another checkout, it times that
tree's kernels by this script's method. That checkout needs
``repro_torch.roofline``, which holds the card's peaks that the bounds
read.
"""
from __future__ import annotations

import gc
import itertools
import json
import math
import os
import shutil
import statistics
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

# the card's datasheet peaks live in one place, the port's roofline
from repro_torch.roofline.analysis import (HBM_BW, PEAK_FLOPS,  # noqa: E402
                                           PEAK_FLOPS_F32)

PEAK_BYTES_S = HBM_BW
PEAK_OPS_S = {torch.bfloat16: PEAK_FLOPS, torch.float32: PEAK_FLOPS_F32}
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

def kernel_counts():
    """(launches, plain-version calls) of every kernel wrapper."""
    from repro_torch.kernels import build
    return {n: (c.launches, c.plain_calls)
            for n, c in build.COUNTERS.items()}


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
# the graphs phase's depth: graphed = eager is a property of the stage
# entries, which every layer repeats, so its serves run a few layers of
# each arch at full width (the serve phase keeps the depths above)
# the retrace sentinel's report of each graphs-phase serve at its profile's
# kernels, (arch, system) -> RetraceReport; the tooling phase reads it
RETRACE = {}
GRAPH_LAYERS = {"llada-8b": 8, "zamba2-7b": 12, "phi3.5-moe-42b-a6.6b": 8,
                "gemma2-27b": 12, "musicgen-medium": 12}


def served_config(arch, n_layers=None):
    """The arch's config, cut to ``n_layers``, else to ``LAYERS[arch]``
    layers where it has a cut."""
    import dataclasses
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    n_layers = n_layers or LAYERS.get(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return cfg


def serve_plan(arch, system, serve_kw, hbm_gb, own_logits=False,
               n_layers=None):
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
    return profile_slots(served_config(arch, n_layers), serve,
                         serve_kw["max_slots"], hbm_gb)


def serve_full(arch, system, n_req, serve_kw, card, hbm_gb,
               workload="livebench", rps=50.0, tag=None, **run_kw):
    """run_serve of the full arch under a system on ``workload``, its slots
    sized by the offline profiler at ``hbm_gb`` (``run_kw``: sharing, int8
    slots, a fault seed, the slot cap, starvation preemption), with the
    launch counts zeroed just before and read just after; returns the
    JSON, the counts and the allocator's peak over the call."""
    from repro_torch.kernels import build
    from repro_torch.launch.serve import run_serve

    kw = dict(serve_kw, **run_kw)
    plan, _ = serve_plan(arch, system, {k: v for k, v in kw.items()
                                        if k != "fault_seed"}, hbm_gb)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.reset_counters()
    res = run_serve(arch, system, workload, rps, n_req,
                    use_reduced=False, kernels=True, clock="wall",
                    size_by_profiler=True, hbm_gb=hbm_gb, device="cuda",
                    n_layers=LAYERS.get(arch), **kw)
    counts = kernel_counts()
    bill = res["device_bill"]
    assert res["plan_slots_logical"] == plan.max_slots, (res, plan)
    # a serve the device bill re-sized runs fewer slots than planned
    assert (bill["resized_from"] or res["max_slots"]) == plan.phys_slots, \
        (res, plan)
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
            "overlap_frac", "graph_pool_bytes", "prefix_sharing",
            "kv_quant", "share_factor", "shared_hits", "shared_cow_promotes",
            "phys_slots_peak", "dispatch_retries", "alloc_fault_iters",
            "n_preemptions", "device_bill")
    replays = res["graph_replays"]
    tag = tag or (arch if system == "dllm-serve" else f"{arch}_{system}")
    log(json.dumps(dict(phase="serve", arch=arch, system=system, tag=tag,
                        workload=workload, rps=rps,
                        n_layers=served_config(arch).n_layers,
                        **{k: res[k] for k in keep}, hbm_gb=hbm_gb,
                        plan=plan.summary(),
                        plan_activation_bytes=plan.activation_bytes,
                        graph_replays=sum(replays.values()),
                        graph_entries_replayed=len(replays),
                        max_memory_allocated=peak, launches=counts)))
    with open(os.path.join(OUT_DIR, f"chip_smoke_serve_{tag}.json"),
              "w") as f:
        json.dump(dict(res, arch=arch, max_memory_allocated=peak,
                       launches=counts, card=card), f, indent=2)
    assert res["n_finished"] == n_req, (arch, system, res["n_finished"])
    # every stage call of the run replayed a graph captured in warmup
    assert res["pipeline"] and res["dispatched_ahead"] > 0, res
    assert res["compiles_post_warmup"] == 0, res["compile_counts"]
    assert sum(replays.values()) >= res["iterations"], replays
    assert bill["fits"], bill
    for name in PATH_KERNELS[(arch, system)]:
        assert counts[name][0] > 0, f"{tag}: {name} never launched"
    for name, (_, plain) in counts.items():
        assert plain == 0, f"{tag}: {plain} plain-version calls of {name}"
    return res, {n: launches for n, (launches, _) in counts.items()}, peak


GRAPH_COUNTERS = (
    "iterations", "refresh_steps", "reuse_steps", "committed_tokens",
    "deferred_steps", "peak_query_tokens", "refresh_tokens_real",
    "refresh_tokens_exec", "reuse_tokens_real", "reuse_tokens_exec",
    "logit_tokens_real", "logit_tokens_exec", "packed_refresh_calls",
    "padded_refresh_calls", "packed_reuse_calls", "padded_reuse_calls",
    "submitted", "finished", "dispatched_ahead", "preemptions",
    "recomputed_tokens", "dispatch_retries", "alloc_fault_iters",
    "slow_fault_s", "shared_hits", "shared_cow_promotes", "phys_slots_peak")


def shared_requests(vocab, n_req):
    """The shared-prefix trace's prompts, every one arriving at once:
    co-resident twins are what the share ledger deduplicates."""
    from repro_torch.data.workloads import (PrefixSpec, make_trace,
                                            trace_prompts)

    trace = make_trace("shared-prefix", n_req, 8.0, seed=3,
                       prefix=PrefixSpec(n_prefixes=3, prefix_len=24))
    return [(p, 16, 0.0) for p in trace_prompts(trace, vocab, seed=3)]


def graphs_vs_eager(arch, system, n_req, serve_kw, hbm_gb, own_logits=False,
                    feature=None, serve_over=None, fault_seed=None,
                    shared=False, n_layers=None):
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
    the plan's activation reservation. ``serve_over`` replaces ServeConfig
    fields after sizing (prefix sharing, int8 slots, starvation
    preemption), ``fault_seed`` serves each engine under its own
    ``FaultPlan.seeded(fault_seed, horizon=60)``, and ``shared`` serves
    the shared-prefix prompts all at once in place of livebench's;
    ``n_layers`` cuts the arch's depth."""
    import dataclasses
    import numpy as np
    from repro_torch.analysis.retrace import check_engine
    from repro_torch.core.engine import Engine
    from repro_torch.core.faults import FaultPlan
    from repro_torch.data.workloads import make_trace, trace_prompts
    from repro_torch.kernels import build
    from repro_torch.params import init_params

    t0 = time.perf_counter()
    plan, serve = serve_plan(arch, system, serve_kw, hbm_gb, own_logits,
                             n_layers)
    serve = dataclasses.replace(serve, **(serve_over or {}))
    cfg = served_config(arch, n_layers)
    gc.collect()
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    S, Sb = serve.max_seq_len, serve.block_size
    if shared:
        requests = shared_requests(cfg.vocab_size, n_req)
    else:
        trace = make_trace("livebench", n_req, 50.0, seed=0, scale=0.15)
        requests = []
        for t, p in zip(trace, trace_prompts(trace, cfg.vocab_size, seed=0)):
            gl = max(Sb, min(t.gen_len, S - len(p) - Sb))
            requests.append((p[: min(len(p), S - gl - Sb)], gl, t.arrival))
    out = {}
    for graphs in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        faults = (None if fault_seed is None
                  else FaultPlan.seeded(fault_seed, horizon=60))
        eng = Engine(cfg, serve, params=params, clock="modeled",
                     device="cuda", graphs=graphs, faults=faults)
        warmup_s = eng.warmup()
        warm_peak = torch.cuda.max_memory_allocated() - base
        reqs = [eng.submit(p, gen_len=g, arrival=t, rid=i)
                for i, (p, g, t) in enumerate(requests)]
        build.reset_counters()
        st = eng.run()
        torch.cuda.synchronize()
        if graphs and feature is None and not own_logits:
            # the retrace sentinel's audit of this graphed serve
            RETRACE[(arch, system)] = check_engine(eng)
        out[graphs] = dict(
            tokens=[r.tokens.copy() for r in reqs], vtime=eng.vtime,
            counters={k: getattr(st, k) for k in GRAPH_COUNTERS},
            launches=kernel_counts(),
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
        feature=feature, counters=g["counters"],
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
        launches={n: c for n, (c, _) in g["launches"].items() if c},
        seconds=time.perf_counter() - t0)))
    assert same_ids, f"{arch} {system} {serve.logit_mode}: graphed ids " \
        f"differ from eager"
    assert e["counters"] == g["counters"], (e["counters"], g["counters"])
    assert e["vtime"] == g["vtime"], (e["vtime"], g["vtime"])
    assert e["launches"] == g["launches"], (e["launches"], g["launches"])
    assert all(p == 0 for _, p in g["launches"].values()), g["launches"]
    assert g["post_warmup"] == 0 and g["replays"] > 0, g["captures"]
    assert sum(g["captures"].values()) > 0 and e["replays"] == 0
    torch.cuda.empty_cache()
    return g["counters"]


def multipliers(serve_kw, card, hbm_gb, launches):
    """Fault injection, prefix sharing and int8 slots on the full llada-8b
    under dllm-serve with the kernels and graphs: each graphed = eager on
    the modeled clock, then served on the wall clock at the card's memory
    (their launches counted per path); then the device bill of a serve at
    run_serve's default 24 GB with the slot cap raised to 64, with bf16
    and with int8 slots, each of which must stay under 24 GiB on the
    allocator."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ServeConfig
    from repro_torch.core.baselines import system_profiles
    from repro_torch.launch.serve import profile_slots

    features = (
        ("faults", dict(fault_seed=1,
                        serve_over=dict(max_slots=4,
                                        preempt_starvation_s=0.05))),
        ("sharing", dict(shared=True,
                         serve_over=dict(prefix_sharing=True,
                                         preempt_starvation_s=0.05))),
        ("int8", dict(serve_over=dict(kv_quant="int8"))))
    for feature, kw in features:
        c = graphs_vs_eager("llada-8b", "dllm-serve", 8, serve_kw, hbm_gb,
                            feature=feature, **kw)
        assert {"faults": c["dispatch_retries"] > 0,
                "sharing": c["shared_hits"] > 0,
                "int8": c["finished"] == 8}[feature], (feature, c)

    def count(tag, got):
        for name in PATH_KERNELS[("llada-8b", "dllm-serve")]:
            launches[name][f"llada-8b dllm-serve {tag}"] = got[name]

    # every request arrives before the first plan, so twins are admitted
    # together and their Refreshes share content keys
    res, got, _ = serve_full("llada-8b", "dllm-serve", 8, serve_kw, card,
                             hbm_gb, "shared-prefix", 1e9,
                             "llada-8b_sharing", prefix_sharing=True)
    assert res["shared_hits"] > 0 and res["share_factor"] > 1.0, res
    count("sharing", got)
    res, got, _ = serve_full("llada-8b", "dllm-serve", 8, serve_kw, card,
                             hbm_gb, tag="llada-8b_int8", kv_quant="int8")
    count("int8", got)
    base = dataclasses.replace(
        system_profiles(ServeConfig(max_refresh_per_iter=4,
                                    **serve_kw))["dllm-serve"],
        use_flash_kernel=True, logit_mode="fused")
    # the plan's physical slots, capped at 64, with and without int8
    slots = {f"{q}@{gb}GB": profile_slots(
        get_config("llada-8b"), dataclasses.replace(base, kv_quant=q), 64,
        gb)[0].phys_slots for q in ("none", "int8") for gb in (24, hbm_gb)}
    log(json.dumps(dict(phase="multipliers", serve="int8 plan slots",
                        slots=slots)))
    assert slots["int8@24GB"] > slots["none@24GB"], slots
    # four slots for eight requests: the run outlasts the plan's first
    # dispatch fault (iteration 50) and requests wait while it runs
    res, got, _ = serve_full("llada-8b", "dllm-serve", 8, serve_kw, card,
                             hbm_gb, tag="llada-8b_faults", fault_seed=1,
                             max_slots=4, preempt_starvation_s=0.05)
    assert res["dispatch_retries"] > 0, res
    count("faults", got)
    # the device bill at run_serve's default budget, the slot cap lifted:
    # bf16 slots, then int8 slots, which the plan sizes at four times as
    # many; each bill beside the allocator's peak over the serve
    for quant in ("none", "int8"):
        tag = "llada-8b_24GB" + ("_int8" if quant == "int8" else "")
        res, got, peak = serve_full("llada-8b", "dllm-serve", 8, serve_kw,
                                    card, 24, tag=tag, max_slots=64,
                                    kv_quant=quant)
        count(f"uncapped at 24 GB, kv {quant}", got)
        bill = res["device_bill"]
        log(json.dumps(dict(phase="multipliers", serve=tag,
                            plan_slots=res["plan_slots_phys"],
                            slots=res["max_slots"],
                            resized_from=bill["resized_from"],
                            bill_total_bytes=bill["total_bytes"],
                            budget_bytes=bill["budget_bytes"],
                            graph_pool_bytes=bill["graph_pool_bytes"],
                            kv_pool_bytes=bill["kv_pool_bytes"],
                            plan_kv_pool_bytes=bill["plan_kv_pool_bytes"],
                            max_memory_allocated=peak,
                            peak_minus_bill=peak - bill["total_bytes"])))
        assert peak < 24 << 30, (peak, bill)


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
    counts = kernel_counts()
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


# ---------------------------------------------------------------------------
# phase 6: masked-diffusion training (torch ops under autograd, no kernel)
# ---------------------------------------------------------------------------

TRAIN_LAYERS = {"llada-8b": 8}    # of 32: its moments do not fit at full depth
TRAIN_RTOL = 1e-5                 # tests/test_torch_train.py's tolerances


# ---------------------------------------------------------------------------
# the mesh phase: per-shard kernels, co-located shard checks, (1, 1) graphed
# ---------------------------------------------------------------------------

def shard_cmp(name, tag, full, parts, tol, dim, dev_calls):
    """Each model shard's output against its slice of the unsharded one
    (``dim`` the head axis): the max abs error over the shards, exact when
    0; ``dev_calls`` the (unsharded, shard) calls to time, if any."""
    n = len(parts)
    err = max((p.float() - f.float()).abs().max().item() for p, f in
              zip(parts, full.float().chunk(n, dim=dim)))
    row = dict(max_abs_err=err, exact=err == 0.0, tol=tol)
    timed = ""
    if dev_calls is not None:
        full_call, shard_calls = dev_calls
        row.update(unsharded_ms=time_ms(full_call, queued=True),
                   shard_ms=[time_ms(c, queued=True) for c in shard_calls])
        timed = (f" unsharded_device_ms={row['unsharded_ms']:.4f} "
                 f"shard_device_ms={[round(t, 4) for t in row['shard_ms']]}")
    log(f"  mesh shards {name} {tag}: max_abs_err={err:.3g} (tol {tol:.3g}; "
        f"{'exact' if err == 0 else 'not exact'}){timed}")
    assert err <= tol, (name, tag, err)
    return row


def mesh_kernels(dev, g, llada, zamba, mamba, serve, results):
    """Rows 1-7 on each half of the model axis at full width, one process:
    the inputs sliced as ``Rules`` shards them (llada-8b's 32 query and KV
    heads, zamba2-7b's 112 and mamba2-130m's 24 state heads, llada-8b's
    126,464-column head), each half launched alone and held to the
    unsharded launch. Rows 1-3, 6 and 7 in bfloat16 (1e-2; exact where a
    head's arithmetic does not depend on the head count), row 5 in float32
    (1e-4 of the largest output), row 4's ids and maxima exact after the
    merge and its sums to 1e-5 relative. Then row 7 on each half of the
    query rows (:func:`mesh_query_rows`) and row 6 on each half of the
    retained length (:func:`mesh_retained_halves`)."""
    from repro_torch.kernels import logit_argmax as LA
    from repro_torch.kernels import ops
    bf, m = torch.bfloat16, 2
    H, K, dh = llada.n_heads, llada.n_kv_heads, llada.resolved_head_dim
    hq, hk = H // m, K // m
    # row 1: the Refresh stream of four segments in the token bucket
    T = serve.max_num_batched_tokens
    seg, pos, valid = stream([256, 250, 240, 230], T - 976, dev)
    q = torch.randn((T, H, dh), generator=g, device=dev).to(bf)
    k = torch.randn((T, K, dh), generator=g, device=dev).to(bf)
    v = torch.randn((T, K, dh), generator=g, device=dev).to(bf)

    def fv(q, k, v):
        return ops.flash_varlen_attention(q, k, v, seg_ids=seg, positions=pos,
                                          kv_valid=valid)
    shards = [(q[:, r * hq:(r + 1) * hq].contiguous(),
               k[:, r * hk:(r + 1) * hk].contiguous(),
               v[:, r * hk:(r + 1) * hk].contiguous()) for r in range(m)]
    out = {"flash_varlen": shard_cmp(
        "flash_varlen", "llada-8b H=32/2", fv(q, k, v),
        [fv(*a) for a in shards], 1e-2, 1,
        (lambda: fv(q, k, v), [lambda a=a: fv(*a) for a in shards]))}
    # row 3: the same stream's keys scored by each request's block queries
    Sb = serve.block_size
    cu = torch.tensor([0, 256, 506, 746], device=dev)
    rows = (cu[:, None] + 100 + torch.arange(Sb, device=dev)).long()
    qb = q[rows]                                     # [R, Sb, H, dh]

    def hs(qb, k):
        return ops.head_score_varlen(qb, k, seg)
    hshards = [(qb[:, :, r * hq:(r + 1) * hq], k[:, r * hk:(r + 1) * hk])
               for r in range(m)]
    full = hs(qb, k)
    parts = [hs(*a) for a in hshards]
    fin = torch.isfinite(full)
    full, parts = (full.masked_fill(~fin, 0),
                   [p.masked_fill(~f, 0) for p, f in
                    zip(parts, fin.chunk(m, dim=1))])
    out["head_score_varlen"] = shard_cmp(
        "head_score_varlen", "llada-8b K=32/2", full, parts, 1e-2, 1,
        (lambda: hs(qb, k), [lambda a=a: hs(*a) for a in hshards]))
    # row 2: every slot's Reuse block against [retained ; live] keys
    R, Cr = serve.max_slots, min(serve.retained_len,
                                 serve.max_seq_len - Sb)
    Tq, Tkv = R * Sb, R * (Cr + Sb)
    qr = torch.randn((Tq, H, dh), generator=g, device=dev).to(bf)
    kr = torch.randn((K, Tkv, dh), generator=g, device=dev).to(bf)
    vr = torch.randn((K, Tkv, dh), generator=g, device=dev).to(bf)
    ar = torch.arange(R, dtype=torch.int32, device=dev)
    q_seg, kv_seg = ar.repeat_interleave(Sb), ar.repeat_interleave(Cr + Sb)
    q_pos = torch.arange(Sb, dtype=torch.int32, device=dev).repeat(R) + 200
    kv_pos = torch.randint(0, 300, (K, Tkv), generator=g, device=dev,
                           dtype=torch.int32)
    kv_valid = torch.rand((K, Tkv), generator=g, device=dev) < 0.6
    kv_valid.view(K, R, Cr + Sb)[:, :, Cr:] = True

    def fx(q, k, v, kp, kv):
        return ops.flash_varlen_cross_attention(
            q, k, v, q_seg=q_seg, q_pos=q_pos, kv_seg=kv_seg, kv_pos=kp,
            kv_valid=kv)
    xshards = [(qr[:, r * hq:(r + 1) * hq].contiguous(),
                kr[r * hk:(r + 1) * hk], vr[r * hk:(r + 1) * hk],
                kv_pos[r * hk:(r + 1) * hk], kv_valid[r * hk:(r + 1) * hk])
               for r in range(m)]
    args = (qr, kr, vr, kv_pos, kv_valid)
    out["flash_varlen_cross"] = shard_cmp(
        "flash_varlen_cross", "llada-8b H=32/2", fx(*args),
        [fx(*a) for a in xshards], 1e-2, 1,
        (lambda: fx(*args), [lambda a=a: fx(*a) for a in xshards]))
    # row 6: the padded Reuse's cache half, each slot's block against its
    # retained keys (a valid key in every row)
    q6 = torch.randn((R, Sb, H, dh), generator=g, device=dev).to(bf)
    k6 = torch.randn((R, K, Cr, dh), generator=g, device=dev).to(bf)
    v6 = torch.randn((R, K, Cr, dh), generator=g, device=dev).to(bf)
    ok6 = torch.rand((R, K, 1, Cr), generator=g, device=dev) < 0.6
    ok6[..., 0] = True

    def pf(q, k, v, ok):
        return ops.packed_flash_attention(q, k, v, ok)
    pshards = [(q6[:, :, r * hq:(r + 1) * hq].contiguous(),
                k6[:, r * hk:(r + 1) * hk], v6[:, r * hk:(r + 1) * hk],
                ok6[:, r * hk:(r + 1) * hk]) for r in range(m)]
    args6 = (q6, k6, v6, ok6)
    out["packed_flash_attention"] = shard_cmp(
        "packed_flash_attention", "llada-8b H=32/2", pf(*args6),
        [pf(*a) for a in pshards], 1e-2, 2,
        (lambda: pf(*args6), [lambda a=a: pf(*a) for a in pshards]))
    # row 7: the padded full-sequence attention, two sequences of 2048
    # (the second padded from 1900)
    S7 = 2048
    q7 = torch.randn((2, S7, H, dh), generator=g, device=dev).to(bf)
    k7 = torch.randn((2, S7, K, dh), generator=g, device=dev).to(bf)
    v7 = torch.randn((2, S7, K, dh), generator=g, device=dev).to(bf)
    p7 = torch.arange(S7, dtype=torch.int32, device=dev).expand(2, S7)
    ok7 = p7 < torch.tensor([[S7], [1900]], device=dev)

    def fr(q, k, v):
        return ops.flash_refresh_attention(
            q, k, v, q_pos=p7, kv_pos=p7, kv_valid=ok7,
            mask_mode="bidirectional", window=0, is_local=False, softcap=0.0)
    rshards = [(q7[:, :, r * hq:(r + 1) * hq], k7[:, :, r * hk:(r + 1) * hk],
                v7[:, :, r * hk:(r + 1) * hk]) for r in range(m)]
    out["flash_refresh"] = shard_cmp(
        "flash_refresh", "llada-8b H=32/2", fr(q7, k7, v7),
        [fr(*a) for a in rshards], 1e-2, 2,
        (lambda: fr(q7, k7, v7), [lambda a=a: fr(*a) for a in rshards]))
    del q6, k6, v6
    out.update(mesh_query_rows(dev, g, llada, q7, k7, v7, p7, ok7))
    del q7, k7, v7
    out.update(mesh_retained_halves(dev, g, llada))
    # row 5: the SSD scan over each half of the state heads, float32
    lens = [256, 250, 240, 230]
    seg5, pos5, _ = stream(lens, T - sum(lens), dev)
    cap = torch.tensor([199, 256 + 95, 506 + 231, 746 + 7],
                       dtype=torch.int32, device=dev)
    for c in (zamba, mamba):
        Hs, P, N = c.ssm_heads, c.ssm_head_dim, c.ssm_state
        xh = torch.randn((T, Hs, P), generator=g, device=dev)
        dt = 0.01 + torch.rand((T, Hs), generator=g, device=dev)
        A = -torch.ones(Hs, device=dev)
        Bm = torch.randn((T, N), generator=g, device=dev)
        Cm = torch.randn((T, N), generator=g, device=dev)
        reset = pos5 == 0

        h2 = Hs // m
        sargs = [(xh[:, r * h2:(r + 1) * h2].contiguous(),
                  dt[:, r * h2:(r + 1) * h2].contiguous(),
                  A[r * h2:(r + 1) * h2].contiguous()) for r in range(m)]
        yf, sf = ops.ssm_segment_scan(xh, dt, A, Bm, Cm, reset, cap)
        got = [ops.ssm_segment_scan(*a, Bm, Cm, reset, cap) for a in sargs]
        scale = max(1.0, yf.abs().max().item(), sf.abs().max().item())
        tag = f"{c.name} Hs={Hs}/2"
        row = shard_cmp(
            "ssm_segment_scan", tag + " y", yf, [y for y, _ in got],
            1e-4 * scale, 1,
            (lambda: ops.ssm_segment_scan(xh, dt, A, Bm, Cm, reset, cap),
             [lambda a=a: ops.ssm_segment_scan(*a, Bm, Cm, reset, cap)
              for a in sargs]))
        st = shard_cmp("ssm_segment_scan", tag + " states", sf,
                       [s for _, s in got], 1e-4 * scale, 1, None)
        row["max_abs_err"] = max(row["max_abs_err"], st["max_abs_err"])
        row["exact"] = row["exact"] and st["exact"]
        out[f"ssm_segment_scan {c.name}"] = row
    # row 4: each half of llada-8b's [D, V] head, then the merge
    D, V = llada.d_model, llada.vocab_size
    Tl = serve.max_num_logits
    h = torch.randn((Tl, D), generator=g, device=dev).to(bf)
    w = torch.empty((D, V), device=dev, dtype=bf).normal_(0, 0.02,
                                                          generator=g)
    ok = torch.ones(Tl, dtype=torch.bool, device=dev)
    halves = [w[:, r * (V // m):(r + 1) * (V // m)].contiguous()
              for r in range(m)]
    idx, mx, s = LA.fused_logit_argmax_call(h, w, ok)
    parts = [LA.fused_logit_argmax_call(h, wh, ok) for wh in halves]
    gid, gm, gs = ops.merge_vocab_shards(
        torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts]),
        torch.stack([p[2] for p in parts]), V // m)
    assert torch.equal(gid, idx), "merged argmax ids differ"
    assert torch.equal(gm, mx), "merged maxima differ"
    err_s = ((gs - s).abs() / s).max().item()
    assert err_s <= 1e-5, err_s
    t_full = time_ms(lambda: LA.fused_logit_argmax_call(h, w, ok),
                     queued=True)
    t_half = [time_ms(lambda wh=wh: LA.fused_logit_argmax_call(h, wh, ok),
                      queued=True) for wh in halves]
    out["fused_logit_argmax"] = dict(
        ids_equal=True, max_equal=True, max_abs_err=err_s, tol=1e-5,
        exact=err_s == 0.0, unsharded_ms=t_full, shard_ms=t_half)
    log(f"  mesh shards fused_logit_argmax llada-8b V=126464/2 T={Tl}: ids "
        f"and maxima equal after the merge, sums max_rel_err={err_s:.3g} "
        f"(tol 1e-5) unsharded_device_ms={t_full:.4f} shard_device_ms="
        f"{[round(t, 4) for t in t_half]}")
    for name, row in out.items():
        results[name.split(" ")[0]].setdefault("mesh_shards", {})[
            name.split(" ", 1)[1] if " " in name else "llada-8b"] = row


def mesh_query_rows(dev, g, llada, q7, k7, v7, p7, ok7) -> dict:
    """Row 7 on each half of the query rows, the flash Refresh's fallback
    where the heads do not divide the model axis (``ops.
    flash_refresh_attention``'s row branch): each half of the 2,048 rows
    against the whole K/V of two sequences (the second padded from 1,900),
    concatenated and held to the unsharded launch, at llada-8b's 32 heads
    and gemma-2b's 8 over one KV head at dh 256, bfloat16 (1e-2; each
    row's arithmetic is its own)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    gemma = get_config("gemma-2b")
    B, S = p7.shape
    n = S // 2
    q = torch.randn((B, S, gemma.n_heads, gemma.resolved_head_dim),
                    generator=g, device=dev).to(torch.bfloat16)
    kv = [torch.randn((B, S, gemma.n_kv_heads, gemma.resolved_head_dim),
                      generator=g, device=dev).to(torch.bfloat16)
          for _ in range(2)]
    out = {}
    for tag, (qq, kk, vv) in (
            (f"llada-8b H=32 S={S} rows/2", (q7, k7, v7)),
            (f"gemma-2b H=8 K=1 dh=256 S={S} rows/2", (q, *kv))):
        def rows(lo, m, qq=qq, kk=kk, vv=vv):
            return ops.flash_refresh_attention(
                qq[:, lo:lo + m], kk, vv, q_pos=p7[:, lo:lo + m], kv_pos=p7,
                kv_valid=ok7, mask_mode="bidirectional", window=0,
                is_local=False, softcap=0.0)
        halves = [lambda r=r: rows(r * n, n) for r in range(2)]
        out[f"flash_refresh {tag}"] = shard_cmp(
            "flash_refresh", tag, rows(0, S), [h() for h in halves], 1e-2, 1,
            (lambda: rows(0, S), halves))
    return out


def mesh_retained_halves(dev, g, llada, T: int = 248) -> dict:
    """Row 6 on each half of the retained length, the Reuse on a cut
    retained length (``transformer._merge_stats``): each half's
    unnormalised ``(o, m, s)`` launched alone and merged across the
    halves by ``M = max m``, ``Σ o·exp(m − M) / Σ s·exp(m − M)``, held to
    the unsharded launch normalised the same way, at llada-8b's 16
    requests of 32 KV heads (8 block rows) and gemma-2b's one KV head at
    dh 256 (64 rows), ``T`` retained keys, bfloat16 (1e-2: each half
    rounds its probabilities to bfloat16 against its own max). One KV
    head's second half has no valid key (``m = -1e30`` merges as 0)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    gemma = get_config("gemma-2b")
    B, Sb, n = 16, 8, T // 2
    out = {}
    for cfg in (llada, gemma):
        K, dh = cfg.n_kv_heads, cfg.resolved_head_dim
        rows = Sb * (cfg.n_heads // K)
        q = torch.randn((B, K, rows, dh), generator=g,
                        device=dev).to(torch.bfloat16)
        k, v = (torch.randn((B, K, T, dh), generator=g,
                            device=dev).to(torch.bfloat16) for _ in range(2))
        ok = torch.rand((B, K, 1, T), generator=g, device=dev) < 0.6
        ok[..., 0] = True
        ok[:, 0, :, n:] = False

        def stats(lo, m):
            return ops.packed_flash_attention_stats(
                q, k[:, :, lo:lo + m], v[:, :, lo:lo + m],
                ok[..., lo:lo + m])

        def merged(parts):
            mx = torch.stack([p[1] for p in parts]).amax(dim=0)
            a = [torch.exp(p[1] - mx) for p in parts]
            o = sum(p[0] * w[..., None] for p, w in zip(parts, a))
            s = sum(p[2] * w for p, w in zip(parts, a))
            return o / s.clamp_min(1e-30)[..., None]
        whole = stats(0, T)
        halves = [lambda r=r: stats(r * n, n) for r in range(2)]
        tag = (f"{cfg.name} B={B} K={K} rows={rows} dh={dh} T={T} "
               f"retained/2")
        out[f"packed_flash_attention {tag}"] = shard_cmp(
            "packed_flash_attention", tag, merged([whole]),
            [merged([h() for h in halves])], 1e-2, 0,
            (lambda: stats(0, T), halves))
    return out


REUSE_LAYERS = 8          # of llada-8b's 32: the co-located Reuse's depth
REUSE_RETAIN = 16384      # decode_32k's retained length at r = 0.5
REUSE_TOL = 2.0 ** -5     # of the largest magnitude, bfloat16 layers


def layer0_attention(run):
    """``run()``, and layer 0's attention output from it: the first
    ``transformer._attn_out`` result, the sublayer's whole contribution to
    the residual stream (the embedding it is added to is the same on every
    rank, and dwarfs it at random weights)."""
    from repro_torch.models import transformer as T
    seen, attn_out = [], T._attn_out

    def record(*a, **kw):
        y = attn_out(*a, **kw)
        if not seen:
            seen.append(y.float().cpu())
        return y
    T._attn_out = record
    try:
        run()
    finally:
        T._attn_out = attn_out
    return seen[0]


def reuse_inputs(cfg, dev, R: int, Sb: int):
    """llada-8b's weights and a batch-1 Reuse's inputs, drawn from one
    seed on the card: the same on every co-located rank. The cache holds
    ``R`` retained rows a KV head at positions ``0..R-1``, a tenth of them
    invalid; the block's ``Sb`` tokens sit after it."""
    from repro_torch.models.sparse_select import PackedKV
    from repro_torch.params import init_params
    gen = torch.Generator(device=dev).manual_seed(27)
    params = init_params(cfg, gen, dev)
    kshape = (cfg.n_layers, 1, cfg.n_kv_heads, R, cfg.resolved_head_dim)
    cache = PackedKV(
        *(torch.randn(kshape, generator=gen, device=dev).to(torch.bfloat16)
          for _ in range(2)),
        torch.arange(R, dtype=torch.int32, device=dev).expand(
            kshape[:-1]).contiguous(),
        torch.rand(kshape[:-1], generator=gen, device=dev) < 0.9)
    btok = torch.randint(0, cfg.vocab_size - 1, (1, Sb), generator=gen,
                         device=dev, dtype=torch.int32)
    bpos = (R + torch.arange(Sb, dtype=torch.int32, device=dev))[None]
    return params, cache, btok, bpos


def reuse_call(mesh, cfg, R: int, Sb: int) -> dict:
    """``backbone.serve_reuse`` (the kernel path: row 6 on the cache half)
    of one llada-8b block at batch 1, on this process's rank of ``mesh``
    (None: one device): the cache cut to the rank's shard by ``Rules``
    (batch 1 cuts the retained length over the data axes) and merged
    across it. Its output, layer 0's attention output, the second call's
    wall ms and collective ms, the allocator's peak above the inputs over
    that call, and the launches of both calls; on a rank, also layer 0's
    attention output of an unmerged control (``kv_split=()``: the rank's
    shard attended alone), launched after the counts are read."""
    import dataclasses
    from repro_torch.kernels import build
    from repro_torch.launch.sharding import (Rules, local_slice,
                                             retained_axes)
    from repro_torch.models import backbone as BB
    from repro_torch.models import transformer as T
    from repro_torch.models.sparse_select import PackedKV
    dev = mesh.device if mesh is not None else torch.device("cuda")
    params, cache, btok, bpos = reuse_inputs(cfg, dev, R, Sb)
    split = ()
    if mesh is not None:
        spec = Rules(cfg, mesh, train=False).cache(1, R)
        cache = PackedKV(*(local_slice(t, sp, mesh)
                           for t, sp in zip(cache, spec)))
        split = retained_axes(spec)
    ctx = T.ServeContext(block_size=Sb, retain=R, use_flash_kernel=True,
                         kv_split=split)
    build.reset_counters()
    attn0 = layer0_attention(                                  # warm
        lambda: BB.serve_reuse(params, cfg, btok, bpos, cache, ctx))
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    c0 = mesh.collective_s if mesh is not None else 0.0
    t0 = time.perf_counter()
    h = BB.serve_reuse(params, cfg, btok, bpos, cache, ctx)
    torch.cuda.synchronize(dev)
    ms = 1e3 * (time.perf_counter() - t0)
    launches = kernel_counts()
    unmerged = layer0_attention(lambda: BB.serve_reuse(
        params, cfg, btok, bpos, cache,
        dataclasses.replace(ctx, kv_split=()))) if split else None
    return dict(
        h=h.float().cpu(), attn0=attn0, attn0_unmerged=unmerged, ms=ms,
        collective_ms=(1e3 * (mesh.collective_s - c0)
                       if mesh is not None else 0.0),
        peak_above_inputs_bytes=torch.cuda.max_memory_allocated(dev) - base,
        cache_bytes=sum(t.numel() * t.element_size() for t in cache),
        retained=cache.k.shape[3], kv_split=list(split), launches=launches)


def mesh_reuse(card, launches):
    """A batch-1 ``serve_reuse`` at (2, 1) on two ranks co-located on
    cuda:0 over gloo: llada-8b at full width cut to ``REUSE_LAYERS``
    layers, bfloat16, the kernels on, each rank holding half of the
    ``REUSE_RETAIN`` retained rows (the reference's sequence-parallel
    decode) and merging its cache half's ``(o, m, s)`` across the data
    axis, held to the one-device call (within ``REUSE_TOL`` of the largest
    magnitude: each rank's row 6 rounds its probabilities against its own
    max). The residual stream carries the embedding, so the merge is also
    held where it is the whole signal: layer 0's attention output within
    ``REUSE_TOL`` of its own largest magnitude, and an unmerged control
    (each rank's shard alone) must miss that tolerance, or the check
    could not see a missing merge. Row 6 launched on every rank and in
    the one-device call, no plain version; each rank's allocator peak and
    collective ms beside the one-device call's."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as M
    cfg = dataclasses.replace(get_config("llada-8b"), n_layers=REUSE_LAYERS)
    R, Sb = REUSE_RETAIN, 32
    gc.collect()
    torch.cuda.empty_cache()
    one = reuse_call(None, cfg, R, Sb)
    gc.collect()
    torch.cuda.empty_cache()
    ranks = M.spawn(reuse_call, (2, 1), "cuda", cfg, R, Sb, colocate=True)
    mag = one["h"].abs().max().item()
    errs = [(r["h"] - one["h"]).abs().max().item() for r in ranks]
    a_mag = one["attn0"].abs().max().item()
    a_errs = [(r["attn0"] - one["attn0"]).abs().max().item() for r in ranks]
    c_errs = [(r["attn0_unmerged"] - one["attn0"]).abs().max().item()
              for r in ranks]
    rec = dict(phase="mesh reuse", arch="llada-8b", n_layers=cfg.n_layers,
               dtype=cfg.dtype, mesh=[2, 1], batch=1, retain=R, block=Sb,
               max_abs_err=errs, max_abs=mag, tol=REUSE_TOL * mag,
               attn0_max_abs_err=a_errs, attn0_max_abs=a_mag,
               attn0_tol=REUSE_TOL * a_mag,
               attn0_unmerged_max_abs_err=c_errs,
               one_device_ms=one["ms"], rank_ms=[r["ms"] for r in ranks],
               rank_collective_ms=[r["collective_ms"] for r in ranks],
               one_device_peak_above_inputs_bytes=one[
                   "peak_above_inputs_bytes"],
               rank_peak_above_inputs_bytes=[
                   r["peak_above_inputs_bytes"] for r in ranks],
               one_device_cache_bytes=one["cache_bytes"],
               rank_cache_bytes=[r["cache_bytes"] for r in ranks],
               rank_retained=[r["retained"] for r in ranks],
               rank_kv_split=[r["kv_split"] for r in ranks],
               finite=bool(torch.isfinite(one["h"]).all()),
               launches=[one["launches"]["packed_flash_attention"]]
               + [r["launches"]["packed_flash_attention"] for r in ranks],
               nvidia_smi=card)
    log(json.dumps(rec))
    assert rec["finite"] and max(errs) <= rec["tol"], rec
    assert max(a_errs) <= rec["attn0_tol"] < min(c_errs), rec
    assert rec["rank_retained"] == [R // 2] * 2, rec
    for run in [one] + ranks:
        assert run["launches"]["packed_flash_attention"][0] > 0, run
        assert all(c[1] == 0 for c in run["launches"].values()), run
    launches["packed_flash_attention"]["llada-8b mesh 2x1 reuse"] = sum(
        run["launches"]["packed_flash_attention"][0]
        for run in [one] + ranks)


def reorder_witness(dev, cfg, seed: int = 0, n: int = 5) -> dict:
    """What reordering float32 sums alone does to the shard check's pool
    at this width and depth: the one-device serve of ``shard_check``'s
    trace (its serve config with the kernels, its weights from ``seed``)
    against the same serve with every row-parallel contraction turned by
    half (the query and KV heads, ``wo``'s heads and the MLP's ``d_ff``
    units rolled: the same function in exact arithmetic, other float32
    sums; the pool's KV heads rolled back before comparing). The mesh's
    pool difference is read beside it."""
    from repro_torch.core.engine import Engine
    from repro_torch.core.kv_pool import tree_leaves
    from repro_torch.launch import shard_check as SC
    from repro_torch.launch.mesh import SimMesh
    from repro_torch.launch.sharding import Rules, spec_axes, spec_leaves
    from repro_torch.params import init_params
    import numpy as np
    serve = SC.serve_config(True, True, False)
    prompts = SC.trace_prompts(cfg, n, seed)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dev)
    roll = {"wq": 2, "wk": 2, "wv": 2, "bq": 1, "bk": 1, "bv": 1, "wo": 1,
            "w_gate": 2, "w_up": 2, "w_down": 1}
    retain = min(serve.retained_len, serve.max_seq_len - serve.block_size)
    spec = Rules(cfg, SimMesh((1, 2)), train=False).cache(
        serve.max_slots + 1, retain, data_parallel=False,
        slot_data_parallel=True)
    heads = ["model" in spec_axes(sp[2]) for sp in spec_leaves(spec)]
    out = []
    for turned in (False, True):
        if turned:
            for name, t in params["stack"].items():
                if name in roll:
                    d = roll[name]
                    t.copy_(torch.roll(t, t.shape[d] // 2, dims=d))
        eng = Engine(cfg, serve, params=params, seed=seed, device=dev,
                     graphs=False)
        reqs = [eng.submit(p, gen_len=16, arrival=0.0, rid=i)
                for i, p in enumerate(prompts)]
        eng.run()
        pool = [t.float() for t in tree_leaves(eng.pool.full_cache())]
        if turned:
            pool = [torch.roll(t, -t.shape[2] // 2, dims=2) if h else t
                    for t, h in zip(pool, heads)]
        out.append(([r.output_tokens() for r in reqs], pool))
        del eng, reqs
    (ids_a, pool_a), (ids_b, pool_b) = out
    err, mag = 0.0, 0.0
    for a, b in zip(pool_a, pool_b):
        e = (a - b).abs().max().item()
        if e > err:
            err, mag = e, a.abs().max().item()
    close = all(SC.pool_close(a.cpu().numpy(), b.cpu().numpy())
                for a, b in zip(pool_a, pool_b))
    del params, pool_a, pool_b
    torch.cuda.empty_cache()
    return dict(ids_equal=all(np.array_equal(np.asarray(a), np.asarray(b))
                              for a, b in zip(ids_a, ids_b)),
                pool_max_err=err, pool_max_abs=mag, pool_close=close)


MOE_T = (128, 1024)          # rows of an MoE layer call on the mesh
MOE_TOL = 2.0 ** -5          # of the largest magnitude, bfloat16 layers


def moe_leaves(cfg, dev, seed: int = 25):
    """One MoE layer of ``cfg`` in bfloat16, leaf by leaf in a fixed order
    from ``seed``: the same tensors in every process that draws them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
    for name, shape in (("router", (D, E)), ("w_gate", (E, D, F)),
                        ("w_up", (E, D, F)), ("w_down", (E, F, D))):
        yield name, torch.empty(shape, device=dev,
                                dtype=torch.bfloat16).normal_(0, 0.02,
                                                              generator=g)


def moe_rows(cfg, T, dev):
    g = torch.Generator(device=dev).manual_seed(T)
    return torch.randn((T, cfg.d_model), generator=g, device=dev).to(
        torch.bfloat16)


def moe_expert_bill(cfg, mesh_shape) -> int:
    """The plan's bytes of one layer's expert stacks and router a device
    (``budgeting``'s per-leaf law over the serving ``Rules``)."""
    from repro_torch.core.budgeting import _sharded_bytes
    from repro_torch.launch.mesh import SimMesh
    from repro_torch.launch.sharding import Rules
    sim = SimMesh(mesh_shape)
    rules = Rules(cfg, sim, train=False)
    E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
    shapes = {"router": (1, D, E), "w_gate": (1, E, D, F),
              "w_up": (1, E, D, F), "w_down": (1, E, F, D)}
    return sum(_sharded_bytes(sim, s, rules.leaf_spec(f"stack/{n}", s), 2)
               for n, s in shapes.items())


def moe_one_device(dev, archs):
    """The one-device references of the mesh's MoE layers: for each arch
    and T, ``moe_ffn`` (gather) on the whole layer (its output, its slot-
    to-token map and its device ms), and ``gather`` over each data shard's
    rows alone for data axes of 2 (what ``ep`` computes there, in float32
    before its bfloat16 combine)."""
    from repro_torch.models import moe as TM
    refs = {}
    for cfg in archs:
        p = dict(moe_leaves(cfg, dev))
        for T in MOE_T:
            x = moe_rows(cfg, T, dev)
            seen, dispatch = [], TM._dispatch_indices

            def record(*a):
                out = dispatch(*a)
                seen.append(out[2].cpu())
                return out
            TM._dispatch_indices = record
            try:
                out, _ = TM.moe_ffn(p, x, cfg)
            finally:
                TM._dispatch_indices = dispatch
            halves = torch.cat([TM.moe_ffn(p, h, cfg)[0]
                                for h in x.chunk(2)])
            ms = time_ms(lambda: TM.moe_ffn(p, x, cfg), iters=10)
            refs[(cfg.name, T)] = dict(out=out.cpu(), inv=seen[0],
                                       halves=halves.cpu(), ms=ms)
        del p
        torch.cuda.empty_cache()
    return refs


def moe_layer_rank(mesh, archs, refs):
    """One co-located rank's MoE layers: each arch's layer drawn leaf by
    leaf and cut to this rank's shards (``Rules``: ``w_gate`` / ``w_up``
    by expert over ``model`` and ``d_model`` over ``data``, ``w_down`` by
    ``F`` over ``model``), then ``gather`` and ``ep`` at each T against
    the one-device references; the call's wall ms, its collective ms and
    this rank's allocator peak over each strategy's calls."""
    import dataclasses
    from repro_torch.launch.mesh import axis_size, data_axes
    from repro_torch.launch.sharding import Rules, local_slice
    from repro_torch.models import moe as TM
    dev = mesh.device
    dp = axis_size(mesh, data_axes(mesh))
    out = []
    for cfg in archs:
        rules = Rules(cfg, mesh, train=False)
        p = {}
        for name, w in moe_leaves(cfg, dev):
            shape = (1,) + tuple(w.shape)
            p[name] = local_slice(w, rules.leaf_spec(f"stack/{name}", shape)
                                  [1:], mesh)
            del w
        torch.cuda.empty_cache()
        held = dict(arch=cfg.name, held_bytes=sum(
            t.numel() * t.element_size() for t in p.values()))
        for impl in ("gather", "ep"):
            c = dataclasses.replace(cfg, moe_impl=impl)
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            for T in MOE_T:
                x = moe_rows(cfg, T, dev)
                ref = refs[(cfg.name, T)]
                seen, dispatch = [], TM._dispatch_indices

                def record(*a):
                    r = dispatch(*a)
                    seen.append(r[2].cpu())
                    return r
                torch.cuda.synchronize(dev)
                c0, t0 = mesh.collective_s, time.perf_counter()
                TM._dispatch_indices = record
                try:
                    y, _ = TM.moe_ffn(p, x, c)
                finally:
                    TM._dispatch_indices = dispatch
                torch.cuda.synchronize(dev)
                walls = [time.perf_counter() - t0]
                colls = [mesh.collective_s - c0]
                want = (ref["halves"] if impl == "ep" and dp == 2
                        else ref["out"])
                err = (y.float().cpu() - want.float()).abs().max().item()
                mag = want.float().abs().max().item()
                # ep regathers its stacks each call (seconds through
                # gloo's host staging): its checked call is the timed one;
                # gather's first call warms, three more are timed
                if impl == "gather":
                    walls, colls = [], []
                    for _ in range(3):
                        torch.cuda.synchronize(dev)
                        c0, t0 = mesh.collective_s, time.perf_counter()
                        TM.moe_ffn(p, x, c)
                        torch.cuda.synchronize(dev)
                        walls.append(time.perf_counter() - t0)
                        colls.append(mesh.collective_s - c0)
                out.append(dict(
                    arch=cfg.name, impl=impl, T=T, max_abs_err=err,
                    max_abs=mag, tol=MOE_TOL * mag,
                    dispatch_equal=(impl == "ep" or all(
                        torch.equal(s, ref["inv"]) for s in seen)),
                    ms=1e3 * statistics.median(walls),
                    collective_ms=1e3 * statistics.median(colls),
                    one_device_ms=ref["ms"]))
            held[f"peak_bytes_{impl}"] = torch.cuda.max_memory_allocated(dev)
        out.append(held)
        del p
        torch.cuda.empty_cache()
    return out


def mesh_moe_layers(card):
    """The MoE layer per shard at full width, bfloat16 (phi3.5-moe: 16
    experts top-2, D 4,096, F 6,400; qwen3-moe: 128 top-8, F 1,536), at T
    = 128 and 1,024, on two ranks co-located on cuda:0 at (1, 2) and
    (2, 1): ``gather`` on every rank against the one-device ``moe_ffn``
    (the slot-to-token map exact, the output within 2^-5 of its largest
    magnitude: bfloat16 partial sums in other orders), ``ep`` against the
    one-device ``gather`` of the same rows (each data shard's alone when
    the rows split), each rank's expert bytes equal to the plan's and its
    allocator peak over each strategy logged beside them."""
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as M
    archs = [get_config("phi3.5-moe-42b-a6.6b"),
             get_config("qwen3-moe-235b-a22b")]
    refs = moe_one_device(torch.device("cuda"), archs)
    rows = []
    for shape in ((1, 2), (2, 1)):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = M.spawn(moe_layer_rank, shape, "cuda", archs, refs,
                        colocate=True)
        for r, recs in enumerate(ranks):
            for rec in recs:
                rec.update(mesh=list(shape), rank=r)
                if "held_bytes" in rec:
                    cfg = next(c for c in archs if c.name == rec["arch"])
                    rec["plan_bytes"] = moe_expert_bill(cfg, shape)
                    assert rec["held_bytes"] == rec["plan_bytes"], rec
                else:
                    assert rec["dispatch_equal"], rec
                    assert rec["max_abs_err"] <= rec["tol"], rec
                log(json.dumps(dict(phase="mesh moe layer", card=card,
                                    **rec)))
                rows.append(rec)
        log(f"  mesh moe layers {shape}: {time.perf_counter() - t0:.3f} s")
    return rows


def mesh_phase(dev, serve, card, launches, results):
    """Mesh serving on the one card: (1) the per-shard kernels, and a
    batch-1 Reuse at (2, 1) on each rank's half of the retained length
    (:func:`mesh_reuse`); (2) the MoE layers per shard
    (:func:`mesh_moe_layers`); (3) the shard-check
    tool on two ranks co-located on cuda:0 over gloo (eager, the kernel
    paths, float32, TF32 off): llada-8b at full width cut to 8 of its 32
    layers at meshes (1, 2) and (2, 1) and on the padded path at (1, 2),
    the whole mamba2-130m at (1, 2) and on the pod mesh (2, 1, 1), and
    phi3.5-moe at full width cut to 2 of its 32 layers at (1, 2) and
    (2, 1), each against the one-device serve at the same depth and dtype
    (the tool's own law: ids, counters and the mesh's size exactly, the
    pool by ``pool_close``, each rank's parameter bytes the plan's),
    every kernel of the path launched in the one-device serve and on each
    rank; beside llada-8b's (1, 2) the one-device reordering witness; (4)
    llada-8b (8 layers, bfloat16) graphed on a (1, 1) mesh against no mesh
    graphed: ids, counters and launches identical. Each part's seconds are
    logged."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import shard_check as SC
    llada, zamba = get_config("llada-8b"), get_config("zamba2-7b")
    mamba = get_config("mamba2-130m")
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(24)
    mesh_kernels(dev, g, llada, zamba, mamba, serve, results)
    del g
    log(f"  mesh part kernels: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    mesh_reuse(card, launches)
    log(f"  mesh part batch-1 reuse: {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    mesh_moe_layers(card)
    log(f"  mesh part moe layers: {time.perf_counter() - t0:.3f} s")
    llada8 = dataclasses.replace(llada, n_layers=8, dtype="float32")
    mamba32 = dataclasses.replace(mamba, dtype="float32")
    phi2 = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b"),
                               n_layers=2, dtype="float32")
    scan = ("ssm_segment_scan", "fused_logit_argmax")
    for arch, cfg, mesh, varlen, kernels in (
            ("llada-8b", llada8, (1, 2), True, DENSE_KERNELS),
            ("llada-8b", llada8, (2, 1), True, DENSE_KERNELS),
            ("llada-8b", llada8, (1, 2), False, BASELINE_KERNELS),
            ("mamba2-130m", mamba32, (1, 2), True, scan),
            ("phi3.5-moe-42b-a6.6b", phi2, (1, 2), True, DENSE_KERNELS),
            ("phi3.5-moe-42b-a6.6b", phi2, (2, 1), True, DENSE_KERNELS),
            ("mamba2-130m", mamba32, (2, 1, 1), True, scan)):
        t0 = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        rec = SC.check(arch, mesh, varlen=varlen, kernels=True,
                       device="cuda", colocate=True, cfg=cfg)
        path = "" if varlen else "_padded"
        dims = "x".join(map(str, mesh))
        tag = f"{arch} mesh {dims}{path.replace('_', ' ')}"
        with open(os.path.join(OUT_DIR, f"shard_check_{arch}_{dims}"
                               f"{path}.json"), "w") as f:
            json.dump(rec, f, indent=2)
        share = [c / max(s, 1e-9) for c, s in zip(rec["rank_collective_s"],
                                                   rec["rank_serve_s"])]
        log(json.dumps(dict(
            phase="mesh shard_check", arch=arch, n_layers=cfg.n_layers,
            dtype=cfg.dtype, mesh=mesh, varlen=varlen, ok=rec["ok"],
            diffs=rec["diffs"], pool_max_err=rec["pool_max_err"],
            pool_max_abs=rec["pool_max_abs"],
            mesh_devices=rec["mesh_devices"], stats=rec["stats"],
            one_device_s=rec["one_device_s"], mesh_s=rec["mesh_s"],
            rank_serve_s=rec["rank_serve_s"],
            rank_collective_s=rec["rank_collective_s"],
            rank_collectives=rec["rank_collectives"],
            collective_share=share,
            plan_weight_bytes=rec["plan_weight_bytes"],
            rank_param_bytes=rec["rank_param_bytes"],
            rank_peak_bytes=rec["rank_peak_bytes"], card=card,
            seconds=time.perf_counter() - t0)))
        assert rec["ok"], (tag, rec["diffs"])
        runs = [rec["one_device_launches"]] + rec["rank_launches"]
        for name in kernels:
            assert all(r[name][0] > 0 for r in runs), (tag, name, runs)
            launches[name][tag] = sum(r[name][0] for r in runs)
        assert all(c[1] == 0 for r in runs for c in r.values()), runs
        if arch == "llada-8b" and mesh == (1, 2) and varlen:
            t0 = time.perf_counter()
            wit = reorder_witness(dev, cfg)
            log(json.dumps(dict(
                phase="mesh reorder witness", arch=arch,
                n_layers=cfg.n_layers, dtype=cfg.dtype, **wit,
                mesh_pool_max_err=rec["pool_max_err"],
                mesh_pool_max_abs=rec["pool_max_abs"], card=card,
                seconds=time.perf_counter() - t0)))
    t0 = time.perf_counter()
    mesh_1x1_graphed(dev, serve)
    log(f"  mesh part 1x1 graphed: {time.perf_counter() - t0:.3f} s")


def mesh_1x1_graphed(dev, serve):
    """llada-8b at 8 layers (bfloat16) under dllm-serve with the kernels,
    graphed, on the modeled clock: a (1, 1) mesh against no mesh on the
    same weights, ids, counters, vtime and launches (warmup and run)
    identical."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.baselines import system_profiles
    from repro_torch.core.engine import Engine
    from repro_torch.kernels import build
    from repro_torch.params import init_params
    cfg = dataclasses.replace(get_config("llada-8b"), n_layers=8)
    sv = dataclasses.replace(system_profiles(serve)["dllm-serve"],
                             use_flash_kernel=True, logit_mode="fused",
                             max_refresh_per_iter=4)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size - 1, int(rng.integers(16, 96)))
               for _ in range(8)]
    out = []
    for mesh in (None, (1, 1)):
        build.reset_counters()
        eng = Engine(cfg, dataclasses.replace(sv, mesh_shape=mesh),
                     params=params, clock="modeled", device=dev, graphs=True)
        eng.warmup()
        reqs = [eng.submit(p, gen_len=32, arrival=0.0, rid=i)
                for i, p in enumerate(prompts)]
        st = eng.run()
        torch.cuda.synchronize()
        out.append(dict(tokens=[r.tokens.copy() for r in reqs],
                        counters={k: getattr(st, k) for k in GRAPH_COUNTERS},
                        vtime=eng.vtime, launches=kernel_counts(),
                        replays=sum(st.graph_replays.values()),
                        mesh_devices=eng.mesh_devices))
        del eng, reqs
    a, b = out
    same = all(np.array_equal(x, y) for x, y in zip(a["tokens"],
                                                    b["tokens"]))
    log(json.dumps(dict(phase="mesh 1x1 graphed", ids_equal=same,
                        counters_equal=a["counters"] == b["counters"],
                        vtime_equal=a["vtime"] == b["vtime"],
                        launches_equal=a["launches"] == b["launches"],
                        replays=b["replays"], mesh_devices=b["mesh_devices"],
                        launches={n: c for n, (c, _) in b["launches"].items()
                                  if c})))
    assert same and a["counters"] == b["counters"] and a["vtime"] == b["vtime"]
    assert a["launches"] == b["launches"] and b["replays"] > 0
    assert b["mesh_devices"] == 1
    del params
    torch.cuda.empty_cache()


def assert_no_kernel(counts, tag):
    """The training path runs no hand kernel (the reference's runs no
    Pallas kernel): no wrapper launched, none ran its plain version."""
    assert all(c == (0, 0) for c in counts.values()), (tag, counts)
    assert len(counts) == 8, sorted(counts)


def train_reduced(dev, arch, **overrides):
    """The reduced arch (float32, TF32 off) trained on the card and on the
    CPU from the same weights (the port's ``init_params``, seed 0) and the
    same corruption (a CPU generator drives both runs' draws): one loss
    with its gradients, then three ``make_train_step`` steps (musicgen-
    medium with its frontend). Held as the CPU tests hold the port to the
    reference: the loss, the steps' loss, grad_norm and lr within 1e-5
    relative, every gradient and moment leaf within 1e-5 of its largest
    magnitude; the parameters within 0.1·lr (Adam makes the float32 noise
    of a gradient near zero an update of order lr: reduced zamba2-7b's
    reach 0.029·lr on the card against 0.0012-0.0092 for the others)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import frontend_batch, synthetic_batch
    from repro_torch.kernels import build
    from repro_torch.params import copy_to, init_params, named_leaves, \
        trainable
    from repro_torch.train import loss as TL
    from repro_torch.train import optimizer as TO
    from repro_torch.train.train_loop import make_train_step

    cfg = reduced(get_config(arch), **overrides)
    tc = TrainConfig(microbatches=2, loss_chunk=16, warmup_steps=2)

    def batch(step, d):
        fe = frontend_batch(cfg, 4, step, seed=2)
        return (torch.from_numpy(synthetic_batch(cfg, 4, 16, step, seed=2))
                .to(d), None if fe is None else torch.from_numpy(fe).to(d))

    runs = []
    build.reset_counters()
    for d in (dev, "cpu"):
        params = trainable(copy_to(init_params(
            cfg, torch.Generator().manual_seed(0), "cpu"), d))
        leaves = named_leaves(params)
        gen = torch.Generator().manual_seed(1)
        tokens, fe = batch(0, d)
        loss, _ = TL.loss_fn(params, cfg, tc, tokens, gen, fe)
        grads = torch.autograd.grad(loss, [t for _, t in leaves],
                                    allow_unused=True, materialize_grads=True)
        run = dict(loss=loss.item(), grads={n: g.cpu() for (n, _), g in
                                            zip(leaves, grads)}, steps=[])
        opt = TO.init_opt_state(params)
        step = make_train_step(cfg, tc, 20)
        for s in range(3):
            tokens, fe = batch(s, d)
            params, opt, m = step(params, opt, tokens, gen, fe)
            run["steps"].append({k: v.item() for k, v in m.items()})
        run.update(params={n: t.detach().cpu() for n, t in leaves},
                   m={n: t.cpu() for n, t in opt["m"].items()},
                   v={n: t.cpu() for n, t in opt["v"].items()})
        runs.append(run)
    counts = kernel_counts()
    card, cpu = runs

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()

    errs = dict(loss=abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"]),
                steps=max(abs(a[k] - b[k]) / abs(b[k]) for a, b in
                          zip(card["steps"], cpu["steps"]) for k in a),
                grads=max(rel(card["grads"][n], g)
                          for n, g in cpu["grads"].items()),
                m=max(rel(card["m"][n], t) for n, t in cpu["m"].items()),
                v=max(rel(card["v"][n], t) for n, t in cpu["v"].items()),
                params_over_lr=max(
                    (card["params"][n] - t).abs().max().item()
                    for n, t in cpu["params"].items()) / tc.learning_rate)
    log(json.dumps(dict(phase="train-reduced", arch=arch, overrides=overrides,
                        loss=card["loss"], steps=card["steps"], errs=errs)))
    for k in ("loss", "steps", "grads", "m", "v"):
        assert errs[k] <= TRAIN_RTOL, (arch, k, errs[k])
    assert errs["params_over_lr"] <= 0.1, (arch, errs)
    assert_no_kernel(counts, f"reduced {arch}")


def loss_peak(dev, chunk, rows=4096):
    """Allocator peak over diffusion_loss forward and backward of ``rows``
    tokens at llada-8b's head (D 4096, V 126,464, untied, bfloat16), above
    what was allocated before it: the head and its gradient buffer are not
    counted."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm_head as LM

    cfg = get_config("llada-8b")
    g = torch.Generator(device=dev).manual_seed(0)
    w = (torch.randn((cfg.d_model, cfg.vocab_size), generator=g, device=dev,
                     dtype=torch.bfloat16) * 0.02).requires_grad_()
    h = torch.randn((1, rows, cfg.d_model), generator=g, device=dev,
                    dtype=torch.bfloat16).requires_grad_()
    labels = torch.randint(0, cfg.vocab_size - 1, (1, rows), generator=g,
                           device=dev)
    weights = (torch.rand((1, rows), generator=g, device=dev) < 0.5).float()
    w.grad = torch.zeros_like(w)
    h.grad = torch.zeros_like(h)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    LM.diffusion_loss({"lm_head": w}, cfg, h, labels, weights,
                      chunk=chunk).backward()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - before


def train_full(dev, arch, card, resume=False, lr=None):
    """``Trainer`` on the arch at its published widths (``TRAIN_LAYERS``
    cuts llada-8b's depth), random bfloat16 weights from seed 0, for 5
    steps of a global batch of 8 sequences of 2,048 tokens in 4
    microbatches (loss chunk 2,048, warmup 2, remat on; ``lr`` in place of
    the default learning rate). Every step's loss
    and grad_norm finite, every parameter moved, no kernel launched. With
    ``resume`` it checkpoints at step 3, and a second ``Trainer`` on the
    same directory resumes there (start_step 3, one restart) and takes one
    step. Logs each step's loss and grad_norm, the median step time of
    steps 2-5, tokens a second, the allocator's peak beside 16 bytes a
    parameter (bf16 weights and gradients, float32 accumulator, m and v),
    and the model FLOPs a step (6·N·tokens plus attention's 12·L·S²·d·B,
    recompute not counted; N leaves out an untied input embedding, a
    lookup that does no matmul) over the median as a share of 989
    TFLOP/s."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels import build
    from repro_torch.train.train_loop import Trainer

    cfg = get_config(arch)
    if arch in TRAIN_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS[arch])
    G, S, n_steps = 8, 2048, 5
    tc = TrainConfig(microbatches=4, loss_chunk=2048, warmup_steps=2)
    if lr is not None:
        tc = dataclasses.replace(tc, learning_rate=lr)
    ckpt_dir = os.path.join(OUT_DIR, f"train_ckpt_{arch}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    os.makedirs(ckpt_dir)
    data = lambda s: synthetic_batch(cfg, G, S, s, seed=0)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.reset_counters()
    tr = Trainer(cfg, tc, ckpt_dir, G, S, seed=0,
                 ckpt_every=3 if resume else 1000, device=dev)
    n_params = sum(t.numel() for t in tr.params.parameters())
    n_matmul = n_params - (0 if cfg.tie_embeddings
                           else tr.params["embed"]["table"].numel())
    # a leaf's float64 sum moves when any of its elements does
    fingerprint = lambda t: torch.sum(t.detach(), dtype=torch.float64)
    before = {n: (fingerprint(t), t.detach().flatten()[:4096].float().std())
              for n, t in tr.params.named_parameters()}
    t0 = time.perf_counter()
    logs = tr.run(n_steps, data)
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counts = kernel_counts()
    still = [n for n, t in tr.params.named_parameters()
             if torch.equal(fingerprint(t), before[n][0])]
    step_s = statistics.median(m["dt"] for m in logs[1:])
    tokens = G * S
    attn = (12 * cfg.n_layers * S * S * cfg.d_model * G
            if cfg.family != "ssm" else 0)
    flops = 6 * n_matmul * tokens + attn
    rec = dict(phase="train", arch=arch, n_layers=cfg.n_layers,
               dtype=cfg.dtype, global_batch=G, seq_len=S,
               microbatches=tc.microbatches, loss_chunk=tc.loss_chunk,
               learning_rate=tc.learning_rate, n_params=n_params,
               n_matmul_params=n_matmul, steps=[{k: m[k] for k in (
                   "step", "loss", "grad_norm", "lr", "dt")} for m in logs],
               seconds=secs, median_step_s_2_5=step_s,
               tokens_per_s=tokens / step_s, max_memory_allocated=peak,
               reckoned_resident_bytes=16 * n_params,
               model_flops_per_step=flops,
               share_of_989_tflops=flops / step_s / PEAK_OPS_S[torch.bfloat16],
               checkpoints=tr.events.checkpoints, unmoved=still,
               disk_free_bytes=shutil.disk_usage(ckpt_dir).free, card=card)
    assert all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
               for m in logs), logs
    # every randomly drawn leaf moved; a constant start may sit where a
    # step is under half its bf16 spacing (the Mamba2 D_skip starts at
    # 1.0, spacing 2^-7): logged, not held
    assert not [n for n in still if before[n][1] > 0], \
        f"{arch}: weights that never moved: {still}"
    assert_no_kernel(counts, arch)
    if resume:
        assert tr.events.checkpoints == 1, tr.events
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        tr2 = Trainer(cfg, tc, ckpt_dir, G, S, seed=0, ckpt_every=1000,
                      device=dev)
        rec.update(resumed_start_step=tr2.start_step,
                   restarts=tr2.events.restarts,
                   restore_s=time.perf_counter() - t0)
        assert tr2.start_step == 3 and tr2.events.restarts == 1, rec
        more = tr2.run(1, data)
        assert math.isfinite(more[0]["loss"]), more
        assert_no_kernel(kernel_counts(), f"{arch} resumed")
        rec["resumed_step"] = more[0]
        del tr2
    else:
        del tr
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(json.dumps(rec))
    return rec


def train_phase(dev, card):
    """Phase 6: the reduced card-vs-CPU steps, the C1 loss peaks, then
    llada-8b (8 of 32 layers, with a resume) and mamba2-130m at their
    published widths."""
    for arch, over in (("llada-8b", {}), ("gemma2-27b", {}),
                       ("phi3.5-moe-42b-a6.6b", {}), ("zamba2-7b", {}),
                       ("musicgen-medium", {})):
        train_reduced(dev, arch, **over)
    peaks = {c: loss_peak(dev, c) for c in (2048, 4096)}
    log(json.dumps(dict(phase="train-loss-peak", arch="llada-8b", rows=4096,
                        peak_bytes_by_chunk=peaks, card=card)))
    assert peaks[2048] < peaks[4096], peaks
    for arch, resume, lr in (("llada-8b", True, None),
                             ("llada-8b", False, 3e-5),
                             ("mamba2-130m", False, None)):
        rec = train_full(dev, arch, card, resume=resume, lr=lr)
        if lr is not None:   # a tenth of the default rate descends
            assert rec["steps"][-1]["loss"] < rec["steps"][0]["loss"], rec
        log(f"  train {arch} x{rec['n_layers']} layers, lr "
            f"{rec['learning_rate']:g}: losses "
            f"{[round(m['loss'], 4) for m in rec['steps']]}, median step "
            f"{rec['median_step_s_2_5']:.4f} s, "
            f"{rec['tokens_per_s']:.1f} tok/s, peak "
            f"{rec['max_memory_allocated']} B (reckoned resident "
            f"{rec['reckoned_resident_bytes']} B), "
            f"{rec['share_of_989_tflops']:.4f} of 989 TFLOP/s ({card})")


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
        graphs_vs_eager(arch, system, 8, serve_kw, hbm_gb, own_logits=own,
                        n_layers=GRAPH_LAYERS.get(arch))
    log(f"phase graphs: {time.perf_counter() - t0:.3f} s")
    launches = {name: {} for name in results}
    t0 = time.perf_counter()
    multipliers(serve_kw, card, hbm_gb, launches)
    log(f"phase multipliers: {time.perf_counter() - t0:.3f} s")
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
        _, counts, _ = serve_full(arch, system, n_req, serve_kw, card,
                                  hbm_gb)
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
    # mesh serving on the one card: per-shard kernels, two co-located
    # ranks over gloo, a (1, 1) mesh graphed
    t0 = time.perf_counter()
    mesh_phase(dev, serve, card, launches, results)
    log(f"phase mesh: {time.perf_counter() - t0:.3f} s")
    # 6. masked-diffusion training: torch ops under autograd, no kernel
    t0 = time.perf_counter()
    train_phase(dev, card)
    log(f"phase train: {time.perf_counter() - t0:.3f} s")
    # 7. the tooling: the lint, the retrace sentinel, the meta dry run and
    # its bytes held against the card's allocator
    t0 = time.perf_counter()
    tooling_phase(dev, card)
    log(f"phase tooling: {time.perf_counter() - t0:.3f} s")
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


def plain_reuse(params, cfg, btok, bpos, cache, ctx):
    """``backbone.serve_reuse``'s plain path, call for call: the embedding,
    each layer's ``reuse_attention_layer`` (kernel off) and MLP, the final
    norm. ``serve_reuse`` itself refuses the plain path on the card
    (``_check_kernel_path``); on meta tensors it runs the same calls, but
    holds the embedding and the stack's output a little longer."""
    from repro_torch.models import backbone as BB
    from repro_torch.models import layers as L
    from repro_torch.models import lm_head as LM
    from repro_torch.models import transformer as T
    xb = LM.embed_tokens(params["embed"], btok, cfg.vocab_size)
    cos, sin = L.rope_tables(bpos, cfg.resolved_head_dim, cfg.rope_theta)
    flags = L.layer_flags(cfg)
    for i in range(cfg.n_layers):
        p = T.layer_params(params["stack"], i)
        xb = T.reuse_attention_layer(
            p, xb, cfg, cos, sin, bpos, flags[i], cache.k[i], cache.v[i],
            cache.pos[i], cache.valid[i], BB.mask_mode(cfg),
            use_kernel=False, concat=ctx.reuse_concat)
        y, _ = T._mlp(p, L.rms_norm(xb, p["mlp_norm"], cfg.rms_eps), cfg)
        xb = xb + y
    return BB._final(params, cfg, xb)


def tooling_phase(dev, card):
    """The port's tooling, checked on the card: the lint over
    ``src/repro_torch`` finds nothing; the retrace sentinel passes the
    graphed llada-8b dllm-serve of the graphs phase; three dry-run cells
    on the meta device (llada-8b decode_32k and qwen2-72b prefill_32k at
    16x16, qwen3-moe decode_32k at 2x16x16) give their records; rank 0's
    qwen2-72b serve shard at 16x16, drawn on the card, asks the
    allocator for exactly the dry run's parameter bytes (its blocks: each
    leaf rounded up to 512 B, a cached block with at most 1 MiB over
    handed out whole); and a llada-8b padded Reuse at full width
    (4 layers, B = 4, 1,024 retained rows, kernels off: serve_reuse's
    plain calls, :func:`plain_reuse`) peaks on the card within 10% of
    the meta tracker's temp bytes for the same calls, and within 10% of
    its temp bytes for ``serve_reuse`` itself, the figure the dry run
    records."""
    import dataclasses
    from repro_torch.analysis.lint import run_lint
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as M
    from repro_torch.launch.sharding import Rules
    from repro_torch.models import backbone as BB
    from repro_torch.models import transformer as T
    from repro_torch.models.sparse_select import PackedKV
    from repro_torch.params import init_params, shard_cut

    t0 = time.perf_counter()
    lint = run_lint()
    log(json.dumps(dict(phase="tooling", check="lint",
                        files=lint.files_scanned,
                        findings=[str(f) for f in lint.findings],
                        suppressed=len(lint.suppressed),
                        seconds=time.perf_counter() - t0)))
    assert lint.ok, lint.findings

    retrace = RETRACE[("llada-8b", "dllm-serve")]
    log(json.dumps(dict(phase="tooling", check="retrace",
                        arch="llada-8b", system="dllm-serve",
                        **retrace.to_dict())))
    assert retrace.ok, retrace.violations

    recs = {}
    for arch, shape, multi_pod in (("llada-8b", "decode_32k", False),
                                   ("qwen2-72b", "prefill_32k", False),
                                   ("qwen3-moe-235b-a22b", "decode_32k",
                                    True)):
        rec = D.run_cell(arch, shape, multi_pod=multi_pod, verbose=False)
        recs[arch] = rec
        log(json.dumps(dict(phase="tooling", check="dryrun", record=rec)))
        assert rec["ok"] and rec["counted_flops_per_device"] > 0

    # the bytes check: rank 0's qwen2-72b serve shard, each leaf drawn
    # whole on the card and cut as it lands (params.init_params)
    t0 = time.perf_counter()
    cfg = get_config("qwen2-72b")
    mesh = M.MetaMesh((16, 16))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    requested = "requested_bytes.all.current"
    base = torch.cuda.memory_allocated()
    base_req = torch.cuda.memory_stats()[requested]
    torch.cuda.reset_peak_memory_stats()
    shard = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                        cut=shard_cut(Rules(cfg, mesh, train=False), mesh))
    torch.cuda.synchronize()
    grew = torch.cuda.memory_allocated() - base
    grew_req = torch.cuda.memory_stats()[requested] - base_req
    sizes = [t.numel() * t.element_size() for t in shard.parameters()]
    rounded = sum(-(-n // 512) * 512 for n in sizes)
    want = recs["qwen2-72b"]["arg_breakdown"]["params"]
    log(json.dumps(dict(phase="tooling", check="bytes", arch="qwen2-72b",
                        mesh="16x16", dryrun_param_bytes=want,
                        allocator_requested_growth_bytes=grew_req,
                        allocator_growth_bytes=grew,
                        leaves_rounded_to_512=rounded, leaves=len(sizes),
                        draw_peak_bytes=torch.cuda.max_memory_allocated()
                        - base, nvidia_smi=card,
                        seconds=time.perf_counter() - t0)))
    # the bytes the leaves asked the allocator for are the dry run's; the
    # blocks it handed out are each rounded to 512 B, and a cached block
    # whose remainder would be at most 1 MiB (its small-block size) is
    # handed out whole, not split
    assert sum(sizes) == want == grew_req, (want, grew_req)
    assert rounded <= grew <= rounded + len(sizes) * (1 << 20), \
        (grew, rounded)
    del shard
    gc.collect()
    torch.cuda.empty_cache()

    # the temp check: one llada-8b padded Reuse at full width, 4 layers
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("llada-8b"), n_layers=4)
    B, R, Sb = 4, 1024, 32
    K, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    ctx = T.ServeContext(block_size=Sb, retain=R)

    def inputs(device, gen):
        def rnd(shape):
            return torch.randn(shape, generator=gen, device=device) \
                .to(torch.bfloat16)
        kshape = (cfg.n_layers, B, K, R, dh)
        cache = PackedKV(
            rnd(kshape), rnd(kshape),
            torch.arange(R, dtype=torch.int32, device=device)
            .expand(kshape[:-1]).contiguous(),
            torch.ones(kshape[:-1], dtype=torch.bool, device=device))
        btok = torch.randint(0, cfg.vocab_size - 1, (B, Sb), generator=gen,
                             device=device, dtype=torch.int32)
        bpos = (R + torch.arange(Sb, dtype=torch.int32, device=device)) \
            .expand(B, Sb).contiguous()
        return btok, bpos, cache

    meta = torch.device("meta")
    mparams = init_params(cfg, None, meta)
    mb = [torch.empty((B, Sb), dtype=torch.int32, device=meta)
          for _ in range(2)]
    kshape = (cfg.n_layers, B, K, R, dh)
    mcache = PackedKV(*(torch.empty(s, dtype=d, device=meta) for s, d in (
        (kshape, torch.bfloat16), (kshape, torch.bfloat16),
        (kshape[:-1], torch.int32), (kshape[:-1], torch.bool))))
    temps = {}
    for name, fn in (("serve_reuse", BB.serve_reuse),
                     ("plain_reuse", plain_reuse)):
        mem = D.MetaMemory()
        mem.hold([*mparams.parameters(), *mb, *mcache])
        with mem:
            out = fn(mparams, cfg, mb[0], mb[1], mcache, ctx)
        del out
        temps[name] = mem.peak
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dev)
    btok, bpos, cache = inputs(dev, gen)
    plain_reuse(params, cfg, btok, bpos, cache, ctx)   # workspaces, once
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    h = plain_reuse(params, cfg, btok, bpos, cache, ctx)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    gap = peak / temps["plain_reuse"] - 1.0
    gap_serve = peak / temps["serve_reuse"] - 1.0
    log(json.dumps(dict(phase="tooling", check="temp", arch="llada-8b",
                        n_layers=cfg.n_layers, batch=B, retain=R,
                        block=Sb, meta_temp_bytes=temps["plain_reuse"],
                        meta_temp_bytes_serve_reuse=temps["serve_reuse"],
                        cuda_peak_above_inputs_bytes=peak,
                        relative_gap=gap,
                        relative_gap_serve_reuse=gap_serve, finite=bool(
                            torch.isfinite(h.float()).all()),
                        nvidia_smi=card,
                        seconds=time.perf_counter() - t0)))
    assert torch.isfinite(h.float()).all()
    # both within 10%: the copy's calls, and serve_reuse's own, which is
    # what the dry run records
    assert abs(gap) <= 0.10, (peak, temps)
    assert abs(gap_serve) <= 0.10, (peak, temps)
    del params, cache, h
    gc.collect()
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
