"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. environment: torch / CUDA / nvcc versions and the card, as nvidia-smi
     reports its name and power limit;
  2. build: the four kernels from src/repro_torch/kernels/csrc with nvcc
     for sm_90a (one nvcc per source, all started together);
  3. each kernel against its plain PyTorch version on the card, at a small
     float32 shape with every mask flag, and at the main path's full-width
     bfloat16 shapes (llada-8b; Refresh streams up to the token bucket of
     max_num_batched_tokens, one max_num_logits chunk for the logit stage),
     with the kernel's time, the plain version's, one PyTorch library
     call's (a yardstick the port never calls) and the least time the card
     could take (bound_ms);
  4. a small end-to-end check: one iteration of the reduced model on the
     card against the same iteration on the CPU (the plain versions);
  5. serve: run_serve of the full llada-8b (random weights from a seed,
     bfloat16) through the dllm-serve profile with the kernels, on the wall
     clock; every request must finish, every kernel must have launched, and
     no plain version may have run;
  6. the kernels line, the card line, and the result line.

Without a CUDA device, or without the rest of the repository beside it, the
script exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

PEAK_BYTES_S = 3.35e12            # H100 SXM HBM3
PEAK_OPS_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")   # long logs


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


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

def check_flash_varlen(dev, g, cfg, serve, results):
    from repro_torch.kernels import flash_varlen as FV
    # small float32, GQA G=2, every mask flag, ragged tile edges
    seg, pos, valid = stream([70, 9, 133, 1], 43, dev)
    T, K, G, dh = seg.shape[0], 2, 2, 64
    q = torch.randn((K, T * G, dh), generator=g, device=dev)
    k = torch.randn((K, T, dh), generator=g, device=dev)
    v = torch.randn((K, T, dh), generator=g, device=dev)
    rows = valid.repeat_interleave(G)
    for kw, loc in ((dict(), False), (dict(softcap=20.0), False),
                    (dict(causal=True), False), (dict(window=5), True)):
        out = FV.flash_varlen_call(q, k, v, pos, seg, valid, loc, **kw)
        ref = FV.varlen_attention_plain(q, k, v, pos, seg, pos.expand(K, T),
                                        seg, valid.expand(K, T), loc, **kw)
        err = (out[:, rows] - ref[:, rows]).abs().max().item()
        log(f"  flash_varlen f32 {kw or 'plain'} local={loc}: "
            f"max_abs_err={err:.3g} (tol 1e-4)")
        assert err < 1e-4, err
    # the main path's full Refresh stream: 4 refresh slots x max_seq_len
    # filling the max_num_batched_tokens bucket, bf16, llada-8b heads
    lens = [256, 250, 240, 230]
    T = serve.max_num_batched_tokens
    seg, pos, valid = stream(lens, T - sum(lens), dev)
    K, dh, bf = cfg.n_kv_heads, cfg.resolved_head_dim, torch.bfloat16
    G = cfg.n_heads // K
    q = torch.randn((K, T * G, dh), generator=g, device=dev, dtype=bf)
    k = torch.randn((K, T, dh), generator=g, device=dev, dtype=bf)
    v = torch.randn((K, T, dh), generator=g, device=dev, dtype=bf)
    kvp, kvv = pos.expand(K, T), valid.expand(K, T)
    out = FV.flash_varlen_call(q, k, v, pos, seg, valid)
    ref = FV.varlen_attention_plain(q, k, v, pos, seg, kvp, seg, kvv, False)
    rows = valid.repeat_interleave(G)
    err = (out[:, rows] - ref[:, rows]).abs().max().item()
    log(f"  flash_varlen bf16 T={T} K={K} dh={dh}: max_abs_err={err:.3g} "
        f"(tol 2e-2)")
    assert err < 2e-2, err
    assert G == 1, "the SDPA yardstick below takes one query head per KV head"
    mask = (seg[:, None] == seg[None, :]) & valid[None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ops = 4.0 * sum(n * n for n in lens) * cfg.n_heads * dh
    b, by = bound(ops, nbytes(q, k, v, seg, pos, valid) + K * T * G * dh * 4,
                  bf)
    results["flash_varlen"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_varlen.cu",
        replaces="src/repro/kernels/flash_varlen.py:97",
        max_abs_err=err,
        ms=time_ms(lambda: FV.flash_varlen_call(q, k, v, pos, seg, valid)),
        plain_ms=time_ms(lambda: FV.varlen_attention_plain(
            q, k, v, pos, seg, kvp, seg, kvv, False), iters=5),
        bound_ms=b, bound_by=by,
        library_ms=time_ms(lambda: sdpa(q[None], k[None], v[None],
                                        attn_mask=mask)))


def check_flash_varlen_cross(dev, g, cfg, serve, retain, results):
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

    args = case(5, 8, 40, 2, 2, 64, torch.float32)
    for kw in (dict(), dict(softcap=20.0), dict(causal=True),
               dict(window=30)):
        loc = "window" in kw
        out = FV.flash_varlen_cross_call(*args, loc, **kw)
        q, k, v, q_pos, kv_pos, q_seg, kv_seg, kv_valid = args
        ref = FV.varlen_attention_plain(q, k, v, q_pos, q_seg, kv_pos,
                                        kv_seg, kv_valid, loc, **kw)
        err = (out - ref).abs().max().item()
        log(f"  flash_varlen_cross f32 {kw or 'plain'}: max_abs_err="
            f"{err:.3g} (tol 1e-4)")
        assert err < 1e-4, err
    # the main path's largest Reuse stream: every slot decoding a block
    R, Sb = serve.max_slots, serve.block_size
    K, dh, bf = cfg.n_kv_heads, cfg.resolved_head_dim, torch.bfloat16
    G = cfg.n_heads // K
    args = case(R, Sb, retain, K, G, dh, bf)
    q, k, v, q_pos, kv_pos, q_seg, kv_seg, kv_valid = args
    out = FV.flash_varlen_cross_call(*args)
    ref = FV.varlen_attention_plain(q, k, v, q_pos, q_seg, kv_pos, kv_seg,
                                    kv_valid, False)
    err = (out - ref).abs().max().item()
    log(f"  flash_varlen_cross bf16 R={R} Tq={R * Sb} Tkv={k.shape[1]}: "
        f"max_abs_err={err:.3g} (tol 2e-2)")
    assert err < 2e-2, err
    mask = ((q_seg[:, None] == kv_seg[None, :])[None]
            & kv_valid[:, None, :])[None]                 # [1, K, Tq, Tkv]
    ops = 4.0 * R * Sb * (retain + Sb) * cfg.n_heads * dh
    b, by = bound(ops, nbytes(*args) + q.numel() * 4, bf)
    results["flash_varlen_cross"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_varlen.cu",
        replaces="src/repro/kernels/flash_varlen.py:220",
        max_abs_err=err,
        ms=time_ms(lambda: FV.flash_varlen_cross_call(*args)),
        plain_ms=time_ms(lambda: FV.varlen_attention_plain(
            q, k, v, q_pos, q_seg, kv_pos, kv_seg, kv_valid, False), iters=5),
        bound_ms=b, bound_by=by,
        library_ms=time_ms(lambda: sdpa(q[None], k[None], v[None],
                                        attn_mask=mask)))


def check_head_score(dev, g, cfg, serve, results):
    from repro_torch.kernels import select_pack as SP

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

    args = case([70, 9, 133, 1, 64], 43, 8, 3, 16, 64, torch.float32)
    err = err_of(SP.head_score_varlen_call(*args),
                 SP.head_score_varlen_plain(*args))
    log(f"  head_score_varlen f32: max_abs_err={err:.3g} (tol 1e-3)")
    assert err < 1e-3, err
    lens = [256, 250, 240, 230]
    T = serve.max_num_batched_tokens
    K, dh, Sb = cfg.n_kv_heads, cfg.resolved_head_dim, serve.block_size
    Rq = Sb * cfg.n_heads // K
    args = case(lens, T - sum(lens), len(lens), K, Rq, dh, torch.bfloat16)
    q, k, seg = args
    err = err_of(SP.head_score_varlen_call(*args),
                 SP.head_score_varlen_plain(*args))
    log(f"  head_score_varlen bf16 R={len(lens)} T={T}: max_abs_err="
        f"{err:.3g} (tol 1e-2: |scores| ~ 30, float32 sums)")
    assert err < 1e-2, err
    R = len(lens)
    own = seg[None, :] == torch.arange(R, device=dev, dtype=torch.int32)[:, None]

    def library():
        z = torch.matmul(q, k.transpose(1, 2)[None])       # [R, K, Rq, T]
        return z.amax(dim=2).masked_fill(~own[:, None, :], float("-inf"))

    ops = 2.0 * sum(lens) * Sb * cfg.n_heads * dh
    b, by = bound(ops, nbytes(q, k, seg) + R * K * T * 4, torch.bfloat16)
    results["head_score_varlen"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/head_score.cu",
        replaces="src/repro/kernels/select_pack.py:82",
        max_abs_err=err,
        ms=time_ms(lambda: SP.head_score_varlen_call(*args)),
        plain_ms=time_ms(lambda: SP.head_score_varlen_plain(*args), iters=5),
        bound_ms=b, bound_by=by, library_ms=time_ms(library))


def check_logit_argmax(dev, g, cfg, serve, results):
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
    # one max_num_logits chunk of the main path against the llada-8b head
    T, D, V = serve.max_num_logits, cfg.d_model, cfg.vocab_size
    bf = torch.bfloat16
    h = torch.randn((T, D), generator=g, device=dev, dtype=bf)
    w = torch.empty((D, V), device=dev, dtype=bf).normal_(0, 0.02,
                                                          generator=g)
    valid = torch.ones(T, dtype=torch.bool, device=dev)
    err, n = compare(h, w, valid, "dv", 0.0, 2e-3)
    log(f"  fused_logit_argmax bf16 T={T} D={D} V={V}: max_err={err:.3g} "
        f"(tol 2e-3), {n}/{T} ids compared")

    def library():
        z = (h @ w).float()
        return z.argmax(dim=1), torch.logsumexp(z, dim=1)

    b, by = bound(2.0 * T * D * V, nbytes(h, w, valid) + T * 12, bf)
    results["fused_logit_argmax"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/logit_argmax.cu",
        replaces="src/repro/kernels/logit_argmax.py:80",
        max_abs_err=err,
        ms=time_ms(lambda: LA.fused_logit_argmax_call(h, w, valid)),
        plain_ms=time_ms(lambda: LA.fused_logit_argmax_plain(h, w), iters=3),
        bound_ms=b, bound_by=by, library_ms=time_ms(library))


# ---------------------------------------------------------------------------
# phase 4: a small end-to-end check against the CPU
# ---------------------------------------------------------------------------

def check_reduced_iteration(dev):
    """One engine iteration of the reduced model (float32) on the card and on
    the CPU from the same weights and requests: committed ids exact, the
    pool's retained positions exact, hidden-derived keys within 1e-4."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ServeConfig
    from repro_torch.core.baselines import system_profiles
    from repro_torch.core.engine import Engine
    from repro_torch.params import init_params

    cfg = reduced(get_config("llada-8b"))
    serve = dataclasses.replace(system_profiles(ServeConfig(
        max_num_batched_tokens=512, max_num_logits=64, block_size=8,
        steps_per_block=8, max_seq_len=128, max_slots=6, pipeline=False))
        ["dllm-serve"], use_flash_kernel=True, logit_mode="fused")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    engines = []
    for d in ("cpu", dev):
        p = params if d == "cpu" else type(params)({
            "embed": type(params)({n: t.to(d) for n, t in
                                   params["embed"].items()}),
            "final_norm": params["final_norm"].to(d),
            "stack": type(params)({n: t.to(d) for n, t in
                                   params["stack"].items()})})
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
    assert torch.equal(pc.pos[:, :4], pg.pos[:, :4].cpu())
    ok = pc.valid[:, :4]
    assert torch.equal(ok, pg.valid[:, :4].cpu())
    err = (pc.k[:, :4][ok] - pg.k[:, :4].cpu()[ok]).abs().max().item()
    assert err < 1e-4, err
    log(f"  reduced llada-8b, 3 iterations: ids equal, retained positions "
        f"equal, key max_abs_err={err:.3g} (tol 1e-4)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on an NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ServeConfig
    from repro_torch.kernels import build
    from repro_torch.launch.serve import run_serve

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
    with open(os.path.join(OUT_DIR, "kernel_build.log"), "w") as f:
        f.write(build.build_log)
    log(f"phase build: {time.perf_counter() - t0:.3f} s "
        f"(nvcc {build.build_seconds:.3f} s; ptxas report in "
        f"build/chip_smoke/kernel_build.log)")

    # 3. each kernel against its plain version
    t0 = time.perf_counter()
    cfg = get_config("llada-8b")
    serve_kw = dict(max_seq_len=256, block_size=8, max_slots=12,
                    max_num_batched_tokens=1024, max_num_logits=128)
    serve = ServeConfig(**serve_kw)
    retain = min(serve.retained_len, serve.max_seq_len - serve.block_size)
    g = torch.Generator(device=dev).manual_seed(0)
    results = {}
    check_flash_varlen(dev, g, cfg, serve, results)
    check_flash_varlen_cross(dev, g, cfg, serve, retain, results)
    check_head_score(dev, g, cfg, serve, results)
    check_logit_argmax(dev, g, cfg, serve, results)
    torch.cuda.synchronize()
    for name, r in results.items():
        log(f"  {name}: kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
            f"({r['bound_by']})")
    log(f"phase kernels: {time.perf_counter() - t0:.3f} s")

    # 4. small end-to-end check
    t0 = time.perf_counter()
    check_reduced_iteration(dev)
    log(f"phase reduced-check: {time.perf_counter() - t0:.3f} s")

    # 5. serve the full model through the kernels
    t0 = time.perf_counter()
    del g
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n_req = 8
    build.reset_counters()
    res = run_serve("llada-8b", "dllm-serve", "livebench", 50.0, n_req,
                    use_reduced=False, kernels=True, clock="wall",
                    size_by_profiler=False, device="cuda", **serve_kw)
    counts = {n: (c.launches, c.plain_calls)
              for n, c in build.COUNTERS.items()}
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    keep = ("n_finished", "n_submitted", "committed_tokens", "iterations",
            "refresh_steps", "reuse_steps", "wall_clock_s", "wall_tok_s",
            "p50_latency", "p99_latency", "host_plan_s", "host_fill_s",
            "sync_wait_s", "warmup_s", "refresh_tokens_real",
            "refresh_tokens_exec", "reuse_tokens_exec", "logit_tokens_exec")
    log(json.dumps(dict(phase="serve", **{k: res[k] for k in keep},
                        max_memory_allocated=peak, launches=counts)))
    with open(os.path.join(OUT_DIR, "chip_smoke_serve.json"), "w") as f:
        json.dump(dict(res, max_memory_allocated=peak, launches=counts,
                       card=card), f, indent=2)
    assert res["n_finished"] == n_req, res["n_finished"]
    for name in results:
        launches, plain = counts[name]
        assert launches > 0, f"{name} never launched on the main path"
        assert plain == 0, f"{name}: {plain} plain-version calls in serve"
        results[name]["launches"] = launches
    log(f"phase serve: {time.perf_counter() - t0:.3f} s")

    kernels = [dict(name=n, **{k: r[k] for k in (
        "route", "source", "replaces", "launches", "max_abs_err", "ms",
        "plain_ms", "bound_ms", "bound_by", "library_ms")})
        for n, r in results.items()]
    log(f"total: {time.perf_counter() - t_all:.3f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
