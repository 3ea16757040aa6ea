"""The modality frontends (internvl2-76b: vlm; musicgen-medium: audio) in
the port, against ``repro`` on the same weights
(``repro.models.backbone.init_params``, bridged through numpy) and inputs,
after the reference's ``tests/test_frontend_packing.py``.

A frontend arch's request carries ``frontend_len`` precomputed embedding
rows; ``frontend.proj`` projects them onto the first rows of its
sequence. The padded Refresh embeds ``[B, F + S]``; the packed Refresh
gives each request a ``[F ; text]`` segment; Reuse and the logit stage are
text only.

* ``embed_inputs`` and ``embed_inputs_packed`` against the JAX functions,
  with a bucket-exact stream whose padding request must not overwrite the
  real tail;
* in the port, packed = padded for Refresh (block hidden and captured
  caches) and Reuse, and each padded stage against the reference's;
* the scheduler's layouts: prefix rows in Refresh segments only, never in
  the Reuse or logit streams;
* the engines: exact ids, EngineStats and ``vtime`` under dllm-serve on
  both archs and under sparse-dllm (padded) on musicgen-medium; the warmup
  builds every bucket a served trace requests, the prefix included.

Tolerance: float32 on both sides (TF32 off), sums in other orders: 1e-6
for an embedding row, 1e-4 for the 3-layer reduced model's hidden states
and caches; ids, retained positions and counters exact.
"""
import dataclasses

import torch_testing  # noqa: F401  (the thread cap, before anything builds)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.configs.base import ServeConfig as JServe
from repro.core.baselines import system_profiles as jprofiles
from repro.core.request import Request as JRequest
from repro.core.scheduler import PhaseMultiplexedScheduler as JPhase
from repro.kernels.flash_varlen import PAD_SEG
from repro.models import backbone as JBB
from repro.models import transformer as JT
from repro_torch.configs import get_config, reduced as treduced
from repro_torch.configs.base import ServeConfig as TServe
from repro_torch.core import diffusion
from repro_torch.core.baselines import system_profiles as tprofiles
from repro_torch.core.engine import Engine as TEngine, stage_keys
from repro_torch.core.request import Request as TRequest
from repro_torch.core.scheduler import PhaseMultiplexedScheduler as TPhase
from repro_torch.data.workloads import make_trace, trace_prompts
from repro_torch.models import backbone as TBB
from repro_torch.models import lm_head as TLM
from repro_torch.models import transformer as TT
from repro_torch.params import from_jax
from test_torch_engine import BASE, SERVE, _serve_both

ARCHS_FE = ("internvl2-76b", "musicgen-medium")
ATOL = 1e-4
S, SB = 96, 8


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _t(a):
    return torch.from_numpy(np.array(a))


def _setup(arch):
    jcfg, tcfg = reduced(ARCHS[arch]), treduced(get_config(arch))
    jp = JBB.init_params(jcfg, jax.random.PRNGKey(19))
    return jcfg, tcfg, jp, from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                    "cpu")


def _batch(cfg, lens, seed=0):
    """One ragged frontend batch as a padded ``[B, S]`` batch (validity
    over ``[B, F + S]``) and as a packed stream of ``[F ; text]`` segments
    in a 64-token bucket."""
    rng = np.random.default_rng(seed)
    F, B = cfg.frontend_len, len(lens)
    toks = np.zeros((B, S), np.int32)
    valid = np.zeros((B, F + S), bool)
    fe = rng.standard_normal((B, F, cfg.frontend_dim)).astype(np.float32)
    for j, n in enumerate(lens):
        toks[j, :n] = rng.integers(0, cfg.vocab_size - 1, n)
        valid[j, : F + n] = True
    tp = -(-sum(F + n for n in lens) // 64) * 64
    flat = np.zeros(tp, np.int32)
    pos = np.zeros(tp, np.int32)
    seg = np.full(tp, PAD_SEG, np.int32)
    val = np.zeros(tp, bool)
    cu = np.full(B, max(0, tp - 1), np.int32)
    sl = np.zeros(B, np.int32)
    off = 0
    for j, n in enumerate(lens):
        ln = F + n
        flat[off + F: off + ln] = toks[j, :n]
        pos[off: off + ln] = np.arange(ln)
        seg[off: off + ln] = j
        val[off: off + ln] = True
        cu[j], sl[j] = off, ln
        off += ln
    return toks, valid, fe, (flat, pos, seg, val, cu, sl)


def _ctx(mod, **kw):
    return mod.ServeContext(block_size=SB, retain=24, q_chunk=32,
                            max_seq_len=S, **kw)


# ---------------------------------------------------------------------------
# parameters and the embedding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS_FE)
def test_params_tree_and_full_shapes_match_reference(arch):
    """The reduced tree bridges name for name (``frontend.proj`` included);
    the full config's leaves are the reference's, shape for shape."""
    jcfg, tcfg, jp, tp = _setup(arch)
    assert tuple(tp["frontend"]["proj"].shape) == (tcfg.frontend_dim,
                                                   tcfg.d_model)
    want = jax.eval_shape(lambda: JBB.init_params(ARCHS[arch],
                                                  jax.random.PRNGKey(0)))
    from repro_torch.params import shapes
    got = shapes(get_config(arch))

    def flat(tree, path=""):
        if isinstance(tree, dict):
            return {k: v for n, t in tree.items()
                    for k, v in flat(t, f"{path}.{n}").items()}
        return {path: tuple(tree.shape) if hasattr(tree, "shape") else tree}
    assert flat(got) == flat(want)
    g = TBB.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert g["frontend"]["proj"].std().item() == pytest.approx(0.02, rel=0.2)


@pytest.mark.parametrize("arch", ARCHS_FE)
def test_embed_inputs_matches_reference(arch):
    jcfg, tcfg, jp, tp = _setup(arch)
    toks, _, fe, _ = _batch(jcfg, [40, 17])
    want = JBB.embed_inputs(jp, jcfg, jnp.asarray(toks), jnp.asarray(fe))
    got = TBB.embed_inputs(tp, tcfg, _t(toks), _t(fe))
    assert got.shape == (2, jcfg.frontend_len + S, jcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    with pytest.raises(ValueError, match="frontend"):
        TBB.embed_inputs(tp, tcfg, _t(toks))


def test_embed_inputs_packed_never_clobbers_the_real_tail():
    """A bucket-exact stream (the real request fills the bucket) whose
    padding request points at the real last row, the engine's convention:
    only the real request's prefix rows change, as in the reference."""
    jcfg, tcfg, jp, tp = _setup("internvl2-76b")
    F = jcfg.frontend_len
    rng = np.random.default_rng(2)
    n = 32
    flat = rng.integers(0, jcfg.vocab_size - 1, n).astype(np.int32)
    cu = np.array([0, n - 1], np.int32)
    sl = np.array([n, 0], np.int32)
    fe = rng.standard_normal((2, F, jcfg.frontend_dim)).astype(np.float32)
    want = JBB.embed_inputs_packed(jp, jcfg, jnp.asarray(flat),
                                   jnp.asarray(cu), jnp.asarray(sl),
                                   jnp.asarray(fe))
    got = TBB.embed_inputs_packed(tp, tcfg, _t(flat), _t(cu), _t(sl), _t(fe))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    tok = TLM.embed_tokens(tp["embed"], _t(flat))
    assert torch.equal(got[F:], tok[F:])
    proj = _t(fe[0]) @ tp["frontend"]["proj"]
    torch.testing.assert_close(got[:F], proj, atol=1e-6, rtol=0)


def test_embed_inputs_packed_drops_rows_past_the_stream():
    """The warmup's dummy segments (every request at row 0) in a bucket
    shorter than the prefix: the reference drops the rows past the stream
    (``mode="drop"``), and so does the port."""
    F = 80
    jcfg = reduced(ARCHS["internvl2-76b"], frontend_len=F)
    tcfg = treduced(get_config("internvl2-76b"), frontend_len=F)
    jp = JBB.init_params(jcfg, jax.random.PRNGKey(19))
    tp = from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.default_rng(4)
    n = 64
    flat = np.zeros(n, np.int32)
    cu = np.zeros(2, np.int32)
    sl = np.full(2, n, np.int32)
    fe = np.zeros((2, F, jcfg.frontend_dim), np.float32)
    fe[0] = rng.standard_normal((F, jcfg.frontend_dim))
    fe[1] = fe[0]
    want = JBB.embed_inputs_packed(jp, jcfg, jnp.asarray(flat),
                                   jnp.asarray(cu), jnp.asarray(sl),
                                   jnp.asarray(fe))
    got = TBB.embed_inputs_packed(tp, tcfg, _t(flat), _t(cu), _t(sl), _t(fe))
    assert got.shape == (n, jcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# ---------------------------------------------------------------------------
# the stages: packed = padded in the port, padded = the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", ARCHS_FE)
def test_packed_refresh_matches_padded(arch, use_kernel):
    """Block hidden rows and the captured caches: the port's packed Refresh
    over ``[F ; text]`` segments against its padded ``[B, F + S]`` batch,
    and that against the reference's padded Refresh (``use_kernel``: the
    packed path's kernels, their plain versions here)."""
    jcfg, tcfg, jp, tp = _setup(arch)
    F = jcfg.frontend_len
    lens = [90, 33, 52]
    bstart = F + np.array([((n - SB) // SB) * SB for n in lens], np.int32)
    toks, valid, fe, pk = _batch(jcfg, lens, seed=5)
    ref = JBB.serve_refresh(jp, jcfg, jnp.asarray(toks), jnp.asarray(bstart),
                            _ctx(JT), frontend=jnp.asarray(fe),
                            token_valid=jnp.asarray(valid))
    pad = TBB.serve_refresh(tp, tcfg, _t(toks), _t(bstart), _ctx(TT),
                            token_valid=_t(valid), frontend=_t(fe))
    np.testing.assert_allclose(pad.block_hidden.numpy(),
                               np.asarray(ref.block_hidden), atol=ATOL)
    for a, b in ((pad.cache.pos, ref.cache.pos),
                 (pad.cache.valid, ref.cache.valid)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    ok = pad.cache.valid
    np.testing.assert_allclose(pad.cache.k[ok].numpy(),
                               np.asarray(ref.cache.k)[ok.numpy()],
                               atol=ATOL)
    flat, pos, seg, val, cu, sl = pk
    out = TBB.serve_refresh_packed(
        tp, tcfg, _t(flat), _t(pos), _t(seg), _t(val), _t(cu), _t(sl),
        _t(bstart), _ctx(TT, use_flash_kernel=use_kernel), frontend=_t(fe))
    torch.testing.assert_close(out.block_hidden, pad.block_hidden,
                               atol=ATOL, rtol=0)
    # the prefix rows are retainable on both paths, and the same are kept
    assert torch.equal(out.cache.pos, pad.cache.pos)
    assert torch.equal(out.cache.valid, pad.cache.valid)
    assert bool((pad.cache.pos[pad.cache.valid] < F).any())
    torch.testing.assert_close(out.cache.k[ok], pad.cache.k[ok], atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", ARCHS_FE)
def test_packed_reuse_matches_padded(arch, use_kernel):
    """The text-only block stream at positions ``F + block_start`` against
    caches that retain prefix rows: packed = padded in the port, padded =
    the reference's."""
    jcfg, tcfg, jp, tp = _setup(arch)
    F = jcfg.frontend_len
    lens = [70, 24, 95]
    bs_text = np.array([((n - SB) // SB) * SB for n in lens], np.int32)
    toks, valid, fe, _ = _batch(jcfg, lens, seed=1)
    ref = JBB.serve_refresh(jp, jcfg, jnp.asarray(toks),
                            jnp.asarray(F + bs_text), _ctx(JT),
                            frontend=jnp.asarray(fe),
                            token_valid=jnp.asarray(valid))
    btok = np.stack([toks[j, b: b + SB] for j, b in enumerate(bs_text)])
    bpos = (F + bs_text[:, None] + np.arange(SB)).astype(np.int32)
    want = JBB.serve_reuse(jp, jcfg, jnp.asarray(btok), jnp.asarray(bpos),
                           ref.cache, _ctx(JT))
    from repro_torch.models.sparse_select import PackedKV
    cache = PackedKV(*[_t(np.asarray(a)) for a in ref.cache])
    pad = TBB.serve_reuse(tp, tcfg, _t(btok), _t(bpos), cache, _ctx(TT))
    np.testing.assert_allclose(pad.numpy(), np.asarray(want), atol=ATOL)
    pk = TBB.serve_reuse_packed(tp, tcfg, _t(btok.reshape(-1)),
                                _t(bpos.reshape(-1)), cache,
                                _ctx(TT, use_flash_kernel=use_kernel))
    torch.testing.assert_close(pk.reshape(pad.shape), pad, atol=2e-4,
                               rtol=0)


# ---------------------------------------------------------------------------
# layouts: the prefix lives in the Refresh segments only
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n,budget,cap", [
    (0, 1, 128, 1), (1, 4, 200, 2), (2, 8, 512, 4), (3, 6, 300, 3)])
def test_prefix_never_leaks_into_reuse_or_logit(seed, n, budget, cap):
    """Every Refresh segment is ``F + total_len`` rows, every Reuse segment
    one block, the logit stream one text block a request, the query
    currency counts the prefix in Refresh only; and the port's plans and
    layouts are the reference's, plan for plan."""
    F, fdim = 4, 8
    serves = [cls(max_num_batched_tokens=budget, max_num_logits=64,
                  block_size=8, steps_per_block=8, max_seq_len=128,
                  max_slots=8, max_refresh_per_iter=2, varlen_pack=True,
                  token_bucket=64) for cls in (JServe, TServe)]
    scheds = [JPhase(serves[0]), TPhase(serves[1])]
    rng = np.random.default_rng(seed)
    for i in range(n):
        plen = int(rng.integers(4, 48))
        if plen + 16 + 8 > 128 or F + plen + 16 > budget:
            plen = 8
        fe = rng.standard_normal((F, fdim)).astype(np.float32)
        for sch, cls, sv in zip(scheds, (JRequest, TRequest), serves):
            sch.submit(cls(rid=i, prompt=np.zeros(plen, np.int32),
                           gen_len=16, arrival=0.0, cfg=sv, mask_id=255,
                           frontend=fe))
    for _ in range(6):
        plans = [sch.plan(now=1e9) for sch in scheds]
        jl, tl = (p.packed_layout(cap) for p in plans)
        plan = plans[1]
        assert [r.rid for r in plan.refresh] == \
            [r.rid for r in plans[0].refresh]
        assert [r.rid for r in plan.reuse] == [r.rid for r in plans[0].reuse]
        for a, b in zip(jl.refresh_chunks, tl.refresh_chunks):
            assert np.array_equal(a.cu_seqlens, b.cu_seqlens)
        for seg in tl.refresh_chunks:
            assert seg.token_counts == [F + r.total_len for r in seg.requests]
        if tl.reuse:
            assert list(np.diff(tl.reuse.cu_seqlens)) == [8] * len(plan.reuse)
        assert tl.logit_tokens == jl.logit_tokens == \
            (len(plan.refresh) + len(plan.reuse)) * 8
        assert plan.query_tokens <= budget
        assert all(r.query_tokens == F + r.total_len for r in plan.refresh)
        assert all(r.query_tokens == 8 for r in plan.reuse)
        for p, sch in zip(plans, scheds):
            for r in p.refresh + p.reuse:
                left = 8 - r.step_in_block
                r.advance_control(diffusion.commit_count(r.masked_left, left),
                                  0.0)
                if r.state.value == "finished":
                    sch.finish(r)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def _kernels(serve):
    return dataclasses.replace(serve, use_flash_kernel=True,
                               logit_mode="fused")


@pytest.mark.parametrize("arch,system", [("internvl2-76b", "dllm-serve"),
                                         ("musicgen-medium", "dllm-serve"),
                                         ("musicgen-medium", "sparse-dllm")])
def test_engine_matches_reference_exactly(arch, system):
    """Both engines draw each request's frontend payload from their own
    rng at the same seed, in submit order; ids, request times, every
    counter and ``vtime`` are equal. dllm-serve serves every stage packed
    (no padded dispatch), sparse-dllm the padded ``[b, F + S]`` path."""
    base = SERVE if system == "dllm-serve" else BASE
    ts = _serve_both(_kernels(jprofiles(JServe(**base))[system]),
                     _kernels(tprofiles(TServe(**base))[system]),
                     check_deferred=False, arch=arch)
    packed = system == "dllm-serve"
    assert (ts.packed_refresh_calls > 0) == packed
    assert (ts.padded_refresh_calls > 0) != packed
    assert (ts.padded_reuse_calls > 0) != packed


def test_warmup_covers_every_bucket_with_the_prefix():
    """The run_serve geometry cut to S = 128 (reduced internvl2-76b with a
    prefix of F = 80 rows, longer than the 64-token bucket, as the real
    archs' 256 rows are longer than the 128-token bucket): warmup builds
    every entry of ``stage_keys`` and runs each stage's smallest (a dummy
    segment shorter than the prefix), whose packed Refresh buckets
    reach ``rp * (S + F)``; serving a trace then builds nothing and uses
    only listed keys."""
    cfg = treduced(get_config("internvl2-76b"), frontend_len=80)
    F = cfg.frontend_len
    serve = _kernels(tprofiles(TServe(
        max_seq_len=128, block_size=8, steps_per_block=8, max_slots=6,
        max_num_batched_tokens=512, max_num_logits=64,
        max_refresh_per_iter=4, token_bucket=64))["dllm-serve"])
    keys = stage_keys(serve, cfg)
    assert keys["refresh_packed"][-1] == (512, 4)
    # one request's segment is up to S + F = 208 rows: the 256-row bucket
    assert max(t for t, r in keys["refresh_packed"] if r == 1) == \
        -(-(128 + F) // 64) * 64 == 256
    eng = TEngine(cfg, serve, clock="modeled", device="cpu")
    eng.warmup()
    listed = {(n, k) for n, ks in keys.items() for k in ks}
    assert set(eng.graphs.entries) == listed
    trace = make_trace("livebench", 8, 50.0, seed=0, scale=0.15)
    for i, (t, p) in enumerate(zip(trace, trace_prompts(trace, cfg.vocab_size,
                                                         seed=0))):
        gl = max(8, min(t.gen_len, 128 - len(p) - 8))
        eng.submit(p[: min(len(p), 128 - gl - 8)], gen_len=gl,
                   arrival=t.arrival, rid=i)
    stats = eng.run()
    assert stats.finished == 8
    assert stats.compiles_post_warmup == 0, stats.compile_counts
    used = {k for k, e in eng.graphs.entries.items() if e.calls}
    assert used <= listed and len(used) >= 4, sorted(used)
