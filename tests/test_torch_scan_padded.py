"""The scan families' padded path (mamba2-130m, zamba2-7b) against
``repro.models`` on the same weights (``repro.models.backbone.init_params``,
bridged through numpy) and the same numpy inputs: ``ssd_scan``,
``mamba_block`` with its serving capture, the ``varlen_ssd_scan`` fallback,
``hybrid.forward_full`` / ``forward_block`` and the backbone's padded
``serve_refresh`` / ``serve_reuse``. The JAX kernels run in interpret mode;
the port's kernel wrappers run their plain versions (the CPU).

Tolerances, float32 on both sides (TF32 off):
* the scans: 2e-4 absolute on outputs of magnitude ~10 and on states
  (the chunked and the associative forms, and JAX's einsums, sum the same
  terms in other orders);
* one Mamba2 block and the serving stages: 1e-4 on hidden states and
  retained keys/values (magnitude ~1), 1e-5 on captured states and conv
  histories (~1e-2); retained positions and their validity exact.
"""
import torch_testing  # noqa: F401  (the thread cap, before anything builds)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.models import backbone as JBB
from repro.models import hybrid as JHY
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch.configs import get_config, reduced as treduced
from repro_torch.models import backbone as TBB
from repro_torch.models import hybrid as THY
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.params import from_jax
from test_torch_ssm import scan_inputs, to_port

SB, S_MAX, RETAIN = 8, 48, 24
ATOL_SCAN = 2e-4


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


def _cfgs(arch):
    return reduced(ARCHS[arch]), treduced(get_config(arch))


def _params(jcfg, tcfg, seed=0):
    jp = JBB.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _ctx(mod, **kw):
    base = dict(block_size=SB, retain=RETAIN, kernel_size=3,
                selection="head", q_chunk=16, max_seq_len=S_MAX)
    return mod.ServeContext(**{**base, **kw})


def _ssd_inputs(B=2, S=32, H=3, P=4, N=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.05, 1.0, (B, S, H)).astype(np.float32)
    A = -rng.uniform(0.2, 1.5, H).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    init = (0.5 * rng.standard_normal((B, H, P, N))).astype(np.float32)
    return x, dt, A, Bm, Cm, init


def test_segsum_matches_reference():
    x = np.random.default_rng(0).standard_normal((2, 3, 7)).astype(
        np.float32)
    want = np.asarray(JS._segsum(jnp.asarray(x)))
    got = TS._segsum(_t(x)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-5, rtol=0)


@pytest.mark.parametrize("chunk", [4, 8, 32])
@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("chunk_states", [False, True])
def test_ssd_scan_matches_reference(chunk, with_init, chunk_states):
    """y and the final state, or the state entering every chunk, with and
    without an initial state, at chunks that split S = 32 into 8, 4 and
    1."""
    x, dt, A, Bm, Cm, init = _ssd_inputs()
    args = (x, dt, A, Bm, Cm)
    init = init if with_init else None
    wy, ws = JS.ssd_scan(*map(jnp.asarray, args), chunk,
                         None if init is None else jnp.asarray(init),
                         return_chunk_states=chunk_states)
    gy, gs = TS.ssd_scan(*map(_t, args), chunk,
                         None if init is None else _t(init),
                         return_chunk_states=chunk_states)
    assert gs.dtype == torch.float32 and gs.shape == ws.shape
    _close(gy, wy, ATOL_SCAN)
    _close(gs, ws, ATOL_SCAN)


def test_ssd_scan_chunkings_agree():
    """Every chunking of the port's scan is the same recurrence."""
    x, dt, A, Bm, Cm, init = _ssd_inputs(seed=1)
    args = [_t(a) for a in (x, dt, A, Bm, Cm)]
    y1, s1 = TS.ssd_scan(*args, 1, _t(init))
    for chunk in (2, 16, 32):
        y, s = TS.ssd_scan(*args, chunk, _t(init))
        torch.testing.assert_close(y, y1, atol=ATOL_SCAN, rtol=0)
        torch.testing.assert_close(s, s1, atol=ATOL_SCAN, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_varlen_ssd_scan_matches_reference(seed):
    """The log-depth fallback against the reference's associative scan:
    resets inside chunks and on their edges, captures at -1 (an exact 0),
    at chunk edges, inside chunks and at T - 1."""
    xh, dt, A, Bm, Cm, reset, cap = scan_inputs(seed=seed)
    args = (xh, dt, A, Bm, Cm, reset, cap)
    wy, wc = JS.varlen_ssd_scan(*map(jnp.asarray, args))
    gy, gc = TS.varlen_ssd_scan(*map(_t, args))
    _close(gy, wy, ATOL_SCAN)
    _close(gc, wc, ATOL_SCAN)
    assert not gc[0].any()


def _block_inputs(jcfg, B=3, S=48, seed=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("capture", [[0, 16, 40], [8, 20, 47]])
def test_mamba_block_capture_matches_reference(capture):
    """The serving capture: the state entering the chunk that holds
    ``capture_at`` (8 = a chunk edge; 20 and 47 inside chunks, so the chunk
    floor shows) and the ck-1 pre-conv rows before it, zero in front of
    the sequence (capture at 0)."""
    jcfg, tcfg = _cfgs("mamba2-130m")
    jp, tp = _params(jcfg, tcfg)
    x = _block_inputs(jcfg)
    cap = np.array(capture, np.int32)
    jl = jax.tree.map(lambda a: a[1], jp["stack"])
    want = JS.mamba_block(jl, jnp.asarray(x), jcfg, capture_at=jnp.asarray(cap))
    got = TS.mamba_block(TT.layer_params(tp["stack"], 1), _t(x), tcfg,
                         capture_at=_t(cap))
    for g, w, tol in zip(got, want, (1e-4, 1e-5, 1e-5)):
        _close(g, w, tol)
    if capture[0] == 0:
        assert not got[1][0].any() and not got[2][0].any()
    assert got[1][1].abs().max() > 0


def test_mamba_block_state_and_history_match_reference():
    """``conv_hist`` and ``init_state`` in, ``return_state`` out: the final
    state and the conv history after the last row; and the plain call."""
    jcfg, tcfg = _cfgs("mamba2-130m")
    jp, tp = _params(jcfg, tcfg)
    x = _block_inputs(jcfg, S=24)
    rng = np.random.default_rng(4)
    H, P, N = jcfg.ssm_heads, jcfg.ssm_head_dim, jcfg.ssm_state
    hist = rng.standard_normal((3, jcfg.ssm_conv_kernel - 1,
                                JS.conv_channels(jcfg))).astype(np.float32)
    st = (0.1 * rng.standard_normal((3, H, P, N))).astype(np.float32)
    jl = jax.tree.map(lambda a: a[0], jp["stack"])
    tl = TT.layer_params(tp["stack"], 0)
    want = JS.mamba_block(jl, jnp.asarray(x), jcfg, jnp.asarray(hist),
                          jnp.asarray(st), return_state=True)
    got = TS.mamba_block(tl, _t(x), tcfg, _t(hist), _t(st),
                         return_state=True)
    for g, w, tol in zip(got, want, (1e-4, 1e-5, 1e-5)):
        _close(g, w, tol)
    _close(TS.mamba_block(tl, _t(x), tcfg),
           JS.mamba_block(jl, jnp.asarray(x), jcfg), 1e-4)


def _batch(V, seed=0):
    """A padded Refresh batch: tokens/valid [3, S], block starts [3] on
    block edges (one at 0)."""
    rng = np.random.default_rng(seed)
    lens = [48, 30, 17]
    tokens = np.zeros((3, S_MAX), np.int32)
    valid = np.zeros((3, S_MAX), bool)
    for j, n in enumerate(lens):
        tokens[j, :n] = rng.integers(0, V - 1, n)
        valid[j, :n] = True
    return tokens, valid, np.array([32, 0, 8], np.int32)


def _same_kv(got, want):
    want = jax.tree.map(np.asarray, want)
    assert np.array_equal(got.pos.numpy(), want.pos)
    assert np.array_equal(got.valid.numpy(), want.valid)
    ok = want.valid
    assert ok.sum() > 0
    for g, w in ((got.k, want.k), (got.v, want.v)):
        np.testing.assert_allclose(g.numpy()[ok], w[ok], atol=1e-4, rtol=0)


@pytest.mark.parametrize("serve", [False, True])
def test_hybrid_forward_full_matches_reference(serve):
    """The padded hybrid Refresh: hidden states and, with a ServeContext,
    the HybridCache (each Mamba layer's state and conv history, the shared
    block's causal head-centric packed KV)."""
    jcfg, tcfg = _cfgs("zamba2-7b")
    jp, tp = _params(jcfg, tcfg)
    tokens, valid, bstart = _batch(jcfg.vocab_size)
    x = np.asarray(JBB.embed_inputs(jp, jcfg, jnp.asarray(tokens)))
    pos = np.broadcast_to(np.arange(S_MAX, dtype=np.int32), (3, S_MAX))
    kw = dict(token_valid=valid, block_start=bstart) if serve else {}
    want_h, want_c = JHY.forward_full(
        jp["stack"], jcfg, jnp.asarray(x), jnp.asarray(pos),
        serve=_ctx(JT) if serve else None,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    got_h, got_c = THY.forward_full(
        tp["stack"], tcfg, _t(x), _t(pos), serve=_ctx(TT) if serve else None,
        **{k: _t(v) for k, v in kw.items()})
    _close(got_h, want_h, 1e-4)
    if not serve:
        assert got_c is None
        return
    assert isinstance(got_c, THY.HybridCache)
    _close(got_c.ssm_state, want_c.ssm_state, 1e-5)
    _close(got_c.conv, want_c.conv, 1e-5)
    _same_kv(got_c.kv, want_c.kv)


@pytest.mark.parametrize("use_kernel,concat", [(False, False), (True, False),
                                               (False, True), (True, True)])
def test_hybrid_forward_block_matches_reference(use_kernel, concat):
    """The padded hybrid Reuse on the reference's captured cache: the
    shared block's causal split attention (the cache half through
    ``packed_flash_attention`` under ``use_kernel``; a request's block at
    0 sees no cached key) and the paper-naive single pass."""
    jcfg, tcfg = _cfgs("zamba2-7b")
    jp, tp = _params(jcfg, tcfg)
    tokens, valid, bstart = _batch(jcfg.vocab_size, seed=1)
    ref = JBB.serve_refresh(jp, jcfg, jnp.asarray(tokens),
                            jnp.asarray(bstart), _ctx(JT),
                            token_valid=jnp.asarray(valid))
    rng = np.random.default_rng(5)
    btok = rng.integers(0, jcfg.vocab_size - 1, (3, SB)).astype(np.int32)
    bpos = (bstart[:, None] + np.arange(SB)).astype(np.int32)
    kw = dict(use_flash_kernel=use_kernel, reuse_concat=concat)
    xb = np.asarray(JBB.LM.embed_tokens(jp["embed"], jnp.asarray(btok)))
    want = JHY.forward_block(jp["stack"], jcfg, jnp.asarray(xb),
                             jnp.asarray(bpos), ref.cache,
                             serve=_ctx(JT, **kw))
    got = THY.forward_block(tp["stack"], tcfg, _t(xb), _t(bpos),
                            to_port(ref.cache), serve=_ctx(TT, **kw))
    _close(got, want, 1e-4)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b"])
def test_serve_refresh_and_reuse_match_reference(arch):
    """The backbone's padded stages: block hidden rows and the serving
    cache of the Refresh, then the Reuse on the port's own cache."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, tcfg)
    tokens, valid, bstart = _batch(jcfg.vocab_size, seed=2)
    want = JBB.serve_refresh(jp, jcfg, jnp.asarray(tokens),
                             jnp.asarray(bstart), _ctx(JT),
                             token_valid=jnp.asarray(valid))
    got = TBB.serve_refresh(tp, tcfg, _t(tokens), _t(bstart), _ctx(TT),
                            token_valid=_t(valid))
    _close(got.block_hidden, want.block_hidden, 1e-4)
    wc = want.cache
    gc = got.cache
    if arch == "zamba2-7b":
        _same_kv(gc.kv, wc.kv)
        gc, wc = (gc.ssm_state, gc.conv), (wc.ssm_state, wc.conv)
    assert len(gc) == 2
    for g, w in zip(gc, wc):
        _close(g, w, 1e-5)
    rng = np.random.default_rng(6)
    btok = rng.integers(0, jcfg.vocab_size - 1, (3, SB)).astype(np.int32)
    bpos = (bstart[:, None] + np.arange(SB)).astype(np.int32)
    ctx = dict(use_flash_kernel=True)
    hw = JBB.serve_reuse(jp, jcfg, jnp.asarray(btok), jnp.asarray(bpos),
                         want.cache, _ctx(JT, **ctx))
    hg = TBB.serve_reuse(tp, tcfg, _t(btok), _t(bpos), got.cache,
                         _ctx(TT, **ctx))
    _close(hg, hw, 1e-4)


def test_serve_refresh_chunk_follows_the_block():
    """The serving chunk is gcd(ssm_chunk, block_size): a block of 4
    under the reduced chunk of 8 captures at chunk edges of 4."""
    jcfg, tcfg = _cfgs("mamba2-130m")
    jp, tp = _params(jcfg, tcfg)
    tokens, valid, _ = _batch(jcfg.vocab_size, seed=3)
    bstart = np.array([4, 12, 0], np.int32)
    want = JBB.serve_refresh(jp, jcfg, jnp.asarray(tokens),
                             jnp.asarray(bstart), _ctx(JT, block_size=4),
                             token_valid=jnp.asarray(valid))
    got = TBB.serve_refresh(tp, tcfg, _t(tokens), _t(bstart),
                            _ctx(TT, block_size=4), token_valid=_t(valid))
    assert TBB._serve_chunk_cfg(tcfg, 4).ssm_chunk == 4
    _close(got.block_hidden, want.block_hidden, 1e-4)
    for g, w in zip(got.cache, want.cache):
        _close(g, w, 1e-5)
