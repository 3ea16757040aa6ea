"""The port's scan family (mamba2-130m) against ``repro`` on the same weights
(``repro.models.backbone.init_params``, bridged through numpy) and the same
inputs, made with numpy. The JAX side runs its Pallas scan kernel in
interpret mode (or its jnp fallback ``varlen_ssd_scan``); the port runs on
the CPU, i.e. on its scan kernel's plain version.

Tolerances, all float32 (TF32 off; the CPU has none):
* the scan alone: 2e-4 absolute on outputs of magnitude ~10 — the chunked
  and the associative-scan forms sum the same terms in other orders;
* one Mamba2 block and the serving stages: 1e-4 on hidden states of
  magnitude ~1, 1e-5 on the captured states and conv histories (the
  reduced model's states are ~1e-2);
* the engine and ``run_serve``: exact ids, counters and modeled clock.
"""
import torch_testing  # noqa: F401  (the thread cap, before anything builds)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.configs.base import ServeConfig as JServe
from repro.core.baselines import system_profiles as jprofiles
from repro.core.engine import Engine as JEngine
from repro.kernels import ops as JO
from repro.kernels.ssm_scan import ssm_segment_scan_call as jscan_call
from repro.launch.serve import run_serve as jrun_serve
from repro.models import backbone as JBB
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch.configs import get_config, reduced as treduced
from repro_torch.configs.base import ServeConfig as TServe
from repro_torch.core.baselines import system_profiles as tprofiles
from repro_torch.core.engine import Engine as TEngine
from repro_torch.core.request import State
from repro_torch.kernels import build
from repro_torch.kernels import ops as TO
from repro_torch.kernels import ssm_scan as TSS
from repro_torch.kernels.flash_varlen import PAD_SEG
from repro_torch.launch.serve import run_serve as trun_serve
from repro_torch.models import backbone as TBB
from repro_torch.models import hybrid as HY
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.models.sparse_select import PackedKV
from repro_torch.params import from_jax

ARCH = "mamba2-130m"
SB, S_MAX, RETAIN = 8, 64, 32
LENS = [40, 25, 33]
HOST_TIMES = {"host_plan_s", "host_fill_s", "sync_wait_s",
              "overlapped_host_s"}
JAX_ONLY = {"compile_counts", "compiles_warmup"}


def scan_inputs(T=64, H=3, P=8, N=16, seed=0):
    """A packed stream with resets inside chunks and on chunk edges, and
    captures at -1, at chunk edges and inside chunks."""
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((T, H, P)).astype(np.float32)
    dt = rng.uniform(0.05, 1.0, (T, H)).astype(np.float32)
    A = -rng.uniform(0.2, 1.5, H).astype(np.float32)
    Bm = rng.standard_normal((T, N)).astype(np.float32)
    Cm = rng.standard_normal((T, N)).astype(np.float32)
    reset = np.zeros(T, bool)
    reset[[0, 5, 16, 17, 40, T - 1]] = True
    cap = np.array([-1, 15, 16, 3, T - 1, 31, 7, 8], np.int32)
    return xh, dt, A, Bm, Cm, reset, cap


@pytest.mark.parametrize("chunk", [8, 16, 32, 64])
def test_scan_plain_matches_reference(chunk):
    """The plain version against the Pallas kernel (interpret) at the same
    chunk and against the associative-scan fallback; the -1 capture is an
    exact zero."""
    xh, dt, A, Bm, Cm, reset, cap = scan_inputs()
    jy, jc = JO.ssm_segment_scan(*map(jnp.asarray, (xh, dt, A, Bm, Cm, reset,
                                                    cap)), chunk=chunk)
    vy, vc = JS.varlen_ssd_scan(*map(jnp.asarray, (xh, dt, A, Bm, Cm, reset,
                                                   cap)))
    ty, tc = TO.ssm_segment_scan(*map(torch.from_numpy, (xh, dt, A, Bm, Cm,
                                                         reset, cap)),
                                 chunk=chunk)
    for want_y, want_c in ((jy, jc), (vy, vc)):
        np.testing.assert_allclose(ty.numpy(), np.asarray(want_y), atol=2e-4)
        np.testing.assert_allclose(tc.numpy(), np.asarray(want_c), atol=2e-4)
    assert not tc[0].any()


@pytest.mark.parametrize("chunk", [16, 64])
def test_scan_call_final_state_matches_pallas(chunk):
    """The kernel contract itself: xdt/dA/reset-as-float in, the final
    state out, against ``ssm_segment_scan_call`` in interpret mode."""
    xh, dt, A, Bm, Cm, reset, cap = scan_inputs(seed=1)
    xdt = xh * dt[..., None]
    dA = dt * A[None]
    args = (xdt, dA, Bm, Cm, reset.astype(np.float32), cap)
    want = jscan_call(*map(jnp.asarray, args), chunk=chunk, interpret=True)
    before = TSS.SCAN.plain_calls
    got = TSS.ssm_segment_scan_call(*map(torch.from_numpy, args), chunk=chunk)
    assert TSS.SCAN.plain_calls == before + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4)


def _cfgs():
    return reduced(ARCHS[ARCH]), treduced(get_config(ARCH))


def _params(jcfg, tcfg, seed=0):
    jp = JBB.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _stream(V, seed=0, tp=128, rp=4):
    """Engine-shaped packed Refresh inputs: a bucket with a PAD_SEG tail and
    one padding request (cu at the tail, length 0)."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros(tp, np.int32)
    pos = np.zeros(tp, np.int32)
    seg = np.full(tp, PAD_SEG, np.int32)
    valid = np.zeros(tp, bool)
    cu = np.full(rp, tp - 1, np.int32)
    lens = np.zeros(rp, np.int32)
    bstart = np.zeros(rp, np.int32)
    off = 0
    for j, n in enumerate(LENS):
        tokens[off: off + n] = rng.integers(0, V - 1, n)
        pos[off: off + n] = np.arange(n)
        seg[off: off + n] = j
        valid[off: off + n] = True
        cu[j], lens[j] = off, n
        bstart[j] = [0, 8, 24][j]           # at 0, one block in, deeper
        off += n
    return tokens, pos, seg, valid, cu, lens, bstart


def _ctx(mod, kernel=True):
    return mod.ServeContext(block_size=SB, retain=RETAIN, kernel_size=3,
                            selection="head", use_flash_kernel=kernel,
                            max_seq_len=S_MAX)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_mamba_block_packed_matches_reference(use_kernel):
    """One block, its captured state (chunk-floor contract) and its conv
    history (zero before the segment start), against the JAX block, both
    with the scan kernel (the port's plain version of it on the CPU) or
    both with the fallback scan beside it."""
    jcfg, tcfg = _cfgs()
    assert jcfg.ssm_chunk == SB == tcfg.ssm_chunk
    jp, tp = _params(jcfg, tcfg)
    _, pos, seg, _, cu, _, bstart = _stream(jcfg.vocab_size)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, pos.shape[0], jcfg.d_model)).astype(
        np.float32)
    jl = jax.tree.map(lambda a: a[1], jp["stack"])
    want = JS.mamba_block_packed(jl, jnp.asarray(x), jcfg, jnp.asarray(seg),
                                 jnp.asarray(pos), jnp.asarray(cu),
                                 jnp.asarray(bstart), use_kernel=use_kernel)
    got = TS.mamba_block_packed(TT.layer_params(tp["stack"], 1),
                                torch.from_numpy(x), tcfg,
                                *map(torch.from_numpy, (seg, pos, cu, bstart)),
                                use_kernel=use_kernel)
    for g, w, tol in zip(got, want, (1e-4, 1e-5, 1e-5)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol)
    assert not got[1][0].any() and not got[2][0].any()   # block at 0
    assert got[1][2].abs().max() > 0                       # a real capture


def test_mamba_decode_block_matches_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    rng = np.random.default_rng(3)
    R, H, P, N = 3, jcfg.ssm_heads, jcfg.ssm_head_dim, jcfg.ssm_state
    ch = JS.conv_channels(jcfg)
    xb = rng.standard_normal((R, SB, jcfg.d_model)).astype(np.float32)
    state = (0.1 * rng.standard_normal((R, H, P, N))).astype(np.float32)
    hist = rng.standard_normal((R, jcfg.ssm_conv_kernel - 1, ch)).astype(
        np.float32)
    jl = jax.tree.map(lambda a: a[0], jp["stack"])
    want = JS.mamba_decode_block(jl, jnp.asarray(xb), jcfg,
                                 jnp.asarray(state), jnp.asarray(hist))
    got = TS.mamba_decode_block(TT.layer_params(tp["stack"], 0),
                                torch.from_numpy(xb), tcfg,
                                torch.from_numpy(state),
                                torch.from_numpy(hist))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def refresh_both(arch, seed=0, kernel=True):
    """serve_refresh_packed of both packages on one stream (reduced arch),
    with the kernel flag or without it (the plain fallbacks)."""
    jcfg, tcfg = reduced(ARCHS[arch]), treduced(get_config(arch))
    jp, tp = _params(jcfg, tcfg, seed)
    args = _stream(jcfg.vocab_size)
    ref = jax.jit(lambda p, *a: JBB.serve_refresh_packed(
        p, jcfg, *a, _ctx(JT, kernel)))(jp, *map(jnp.asarray, args))
    out = TBB.serve_refresh_packed(tp, tcfg, *map(torch.from_numpy, args),
                                   _ctx(TT, kernel))
    return jcfg, tcfg, jp, tp, ref, out


def to_port(cache):
    """A reference cache tree as the port's named tuples of tensors."""
    if hasattr(cache, "_fields"):
        cls = {"SSMCache": TS.SSMCache, "HybridCache": HY.HybridCache,
               "PackedKV": PackedKV}[type(cache).__name__]
        return cls(*[to_port(f) for f in cache])
    return torch.from_numpy(np.array(cache))


def reuse_both(jcfg, tcfg, jp, tp, ref, kernel=True):
    """serve_reuse_packed of both packages, the port fed the reference's
    cache so the stage is compared alone."""
    R = len(LENS)
    rng = np.random.default_rng(5)
    btok = rng.integers(0, jcfg.vocab_size - 1, R * SB).astype(np.int32)
    bpos = np.concatenate([np.arange(b, b + SB) for b in (0, 8, 24)]
                          ).astype(np.int32)
    jcache = jax.tree.map(lambda x: x[:, :R], ref.cache)
    want = jax.jit(lambda p, a, b, c: JBB.serve_reuse_packed(
        p, jcfg, a, b, c, _ctx(JT, kernel)))(jp, jnp.asarray(btok),
                                             jnp.asarray(bpos), jcache)
    tcache = to_port(jcache)
    got = TBB.serve_reuse_packed(tp, tcfg, torch.from_numpy(btok),
                                 torch.from_numpy(bpos), tcache,
                                 _ctx(TT, kernel))
    return got, want


@pytest.mark.parametrize("kernel", [True, False])
def test_serve_refresh_and_reuse_packed_match_reference(kernel):
    """Both packed stages, with the kernel flag and without it (the
    fallback scan beside the kernel)."""
    jcfg, tcfg, jp, tp, ref, out = refresh_both(ARCH, kernel=kernel)
    n = len(LENS)
    assert isinstance(out.cache, TS.SSMCache)
    np.testing.assert_allclose(out.block_hidden.numpy()[:n],
                               np.asarray(ref.block_hidden)[:n], atol=1e-4)
    for got, want in zip(out.cache, ref.cache):
        np.testing.assert_allclose(got.numpy()[:, :n],
                                   np.asarray(want)[:, :n], atol=1e-5)
    h, h_ref = reuse_both(jcfg, tcfg, jp, tp, ref, kernel)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=1e-4)


def test_init_params_shapes_and_law_match_reference():
    jcfg, tcfg = _cfgs()
    shapes = jax.tree.map(lambda x: tuple(x.shape),
                          JBB.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = TBB.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    got = {n: tuple(p.shape) for n, p in tp.named_parameters()}
    want = {"final_norm": shapes["final_norm"],
            **{f"embed.{k}": v for k, v in shapes["embed"].items()},
            **{f"stack.{k}": v for k, v in shapes["stack"].items()}}
    assert got == want and "embed.lm_head" not in got       # tied head
    st = tp["stack"]
    for name in ("norm", "gate_norm", "dt_bias", "conv_b", "A_log"):
        assert float(st[name].abs().max()) == 0.0, name
    assert float(st["D_skip"].min()) == float(st["D_skip"].max()) == 1.0
    assert 0.15 < float(st["conv_w"].std()) < 0.25
    assert 0.015 < float(st["w_xbc"].std()) < 0.025


SERVE = dict(max_num_batched_tokens=64, max_num_logits=32, block_size=8,
             steps_per_block=8, max_seq_len=96, max_slots=4,
             max_refresh_per_iter=2, pipeline=False)


def _serve(cls, profiles):
    s = profiles(cls(**SERVE))["dllm-serve"]
    return dataclasses.replace(s, use_flash_kernel=True, logit_mode="fused")


def engines_match(arch, n_req=4):
    """Both engines serve the same requests on the same weights (modeled
    clock): exact ids, request times, every EngineStats counter and vtime.
    Returns the port's stats."""
    jcfg, tcfg = reduced(ARCHS[arch]), treduced(get_config(arch))
    jp = JBB.init_params(jcfg, jax.random.PRNGKey(3))
    je = JEngine(jcfg, _serve(JServe, jprofiles), params=jp, clock="modeled")
    te = TEngine(tcfg, _serve(TServe, tprofiles),
                 params=from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu"),
                 clock="modeled", device="cpu")
    rng = np.random.default_rng(11)
    jreqs, treqs = [], []
    for i in range(n_req):
        p = rng.integers(0, jcfg.vocab_size - 1, int(rng.integers(8, 24)))
        g, t = int(rng.integers(9, 30)), float(i) * 0.004
        jreqs.append(je.submit(p, gen_len=g, arrival=t, rid=i))
        treqs.append(te.submit(p, gen_len=g, arrival=t, rid=i))
    build.reset_counters()
    js, ts = je.run(), te.run()
    assert all(r.state == State.FINISHED for r in treqs)
    assert ts.reuse_steps > 0
    for a, b in zip(jreqs, treqs):
        assert np.array_equal(a.tokens, b.tokens), a.rid
        assert (a.t_admitted, a.t_first_commit, a.t_finished) == \
            (b.t_admitted, b.t_first_commit, b.t_finished)
    assert je.vtime == te.vtime
    for f in dataclasses.fields(js):
        if f.name in HOST_TIMES | JAX_ONLY:
            continue
        want, got = getattr(js, f.name), getattr(ts, f.name)
        if f.name == "iter_log":
            drop = {"plan_s", "fill_s", "sync_s"}
            want = [{k: v for k, v in r.items() if k not in drop}
                    for r in want]
            got = [{k: v for k, v in r.items() if k not in drop}
                   for r in got]
        assert want == got, f.name
    return ts


def test_engine_matches_reference_exactly():
    engines_match(ARCH)
    assert build.COUNTERS["ssm_segment_scan"].plain_calls > 0


def run_serve_matches(arch):
    kw = dict(use_reduced=True, seed=1, kernels=True, clock="modeled",
              size_by_profiler=False, pipeline=False, max_seq_len=128,
              max_num_batched_tokens=384, max_slots=6)
    want = jrun_serve(arch, "dllm-serve", "burst", 4.0, 3, **kw)
    got = trun_serve(arch, "dllm-serve", "burst", 4.0, 3, device="cpu", **kw)
    # the port's own keys: replays per captured stage entry, the captured
    # graphs' pool
    assert set(got) == set(want) | {"graph_replays", "graph_pool_bytes"}
    assert got["n_finished"] == 3 and got["padded_refresh_calls"] == 0
    skip = HOST_TIMES | JAX_ONLY | {"warmup_s", "wall_clock_s", "wall_tok_s",
                                    "overlap_frac", "compiles_post_warmup"}
    for k in sorted(set(want) - skip):
        assert got[k] == want[k], k


def test_run_serve_json_matches_reference():
    run_serve_matches(ARCH)


@pytest.mark.parametrize("arch", [ARCH, "zamba2-7b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_kernel_flag_off_raises_on_cuda(arch, monkeypatch):
    """The plain fallbacks run on the CPU only: without the kernel flag a
    CUDA device is refused (``_check_kernel_path`` and the engine, before
    any weight is drawn), the CPU is not. The CPU parity of the fallbacks
    is ``test_torch_scan_engine.py``'s dllm-serve case and
    ``test_serve_refresh_and_reuse_packed_match_reference[False]``."""
    tcfg = treduced(get_config(arch))
    ctx = _ctx(TT, kernel=False)
    with pytest.raises(ValueError, match="use_flash_kernel=True"):
        TT._check_kernel_path(ctx, torch.device("cuda"))
    TT._check_kernel_path(ctx, torch.device("cpu"))
    TT._check_kernel_path(_ctx(TT), torch.device("cuda"))
    from repro_torch.core import engine as tengine
    monkeypatch.setattr(tengine.devices, "resolve",
                        lambda d: torch.device("cuda"))
    bad = dataclasses.replace(_serve(TServe, tprofiles),
                              use_flash_kernel=False)
    with pytest.raises(ValueError, match="use_flash_kernel=False"):
        TEngine(tcfg, bad)
