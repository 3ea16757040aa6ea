"""The port's padded serving path (the oracle, and the three baseline
systems) against ``repro.models`` on the same weights
(``repro.models.backbone.init_params``, bridged through numpy) and the same
numpy inputs: ``layers.attention``, the padded select/pack in its three
modes, ``forward_full`` / ``forward_block`` / ``reuse_attention_layer``, the
backbone's ``serve_refresh`` / ``serve_reuse``, ``decode_tokens`` in its
three modes, the packed path's plain fallbacks, and the padded-versus-
packed agreement inside the port. The JAX kernels run in interpret mode;
the port's kernel wrappers run their plain versions.

Tolerance: float32 on both sides (TF32 off), sums in other orders: 2e-5 for
one attention of outputs ~1, 1e-4 for the 3-layer reduced model's hidden
states and caches. Retained positions, their validity, and decoded ids are
exact.
"""
import torch_testing  # noqa: F401  (the thread cap, before anything builds)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.models import backbone as JBB
from repro.models import layers as JL
from repro.models import lm_head as JLM
from repro.models import sparse_select as JS
from repro.models import transformer as JT
from repro_torch.configs import get_config, reduced as treduced
from repro_torch.models import backbone as TBB
from repro_torch.models import layers as TL
from repro_torch.models import lm_head as TLM
from repro_torch.models import sparse_select as TS
from repro_torch.models import transformer as TT
from repro_torch.models.sparse_select import PackedKV
from repro_torch.params import from_jax

ATOL_ATTN = 2e-5
ATOL = 1e-4
SB, S, RETAIN = 8, 48, 24
LENS = [48, 30, 17]          # three requests of a padded [3, 48] batch


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(kv_heads=4, **kw):
    return (reduced(ARCHS["llada-8b"], n_kv_heads=kv_heads, **kw),
            treduced(get_config("llada-8b"), n_kv_heads=kv_heads, **kw))


def _params(jcfg, tcfg):
    jp = JBB.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _ctx(mod, **kw):
    base = dict(block_size=SB, retain=RETAIN, kernel_size=3,
                selection="head", q_chunk=16, max_seq_len=S)
    return mod.ServeContext(**{**base, **kw})


def _batch(V, seed=0):
    """A padded Refresh batch: tokens/valid [3, S], block starts [3]."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros((len(LENS), S), np.int32)
    valid = np.zeros((len(LENS), S), bool)
    for j, n in enumerate(LENS):
        tokens[j, :n] = rng.integers(0, V - 1, n)
        valid[j, :n] = True
    bstart = np.array([n - SB - 3 * j for j, n in enumerate(LENS)], np.int32)
    return tokens, valid, bstart


def _same_cache(got, want, n=None):
    """Retained positions and validity exact; valid keys/values close."""
    want = jax.tree.map(np.asarray, want)
    got = [t.numpy() for t in got]
    sl = (slice(None),) * (got[2].ndim - 3) + (slice(n),)
    assert np.array_equal(got[2][sl], want.pos[sl])
    assert np.array_equal(got[3][sl], want.valid[sl])
    ok = want.valid[sl]
    assert ok.sum() > 0
    for g, w in ((got[0], want.k), (got[1], want.v)):
        np.testing.assert_allclose(g[sl][ok], w[sl][ok], atol=ATOL)


# ---------------------------------------------------------------------------
# layers.attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,K", [(4, 4), (4, 2)])
@pytest.mark.parametrize("flags", [
    dict(), dict(kv_valid=True), dict(attn_softcap=20.0),
    dict(mask_mode="causal", kv_valid=True),
    dict(window=3, is_local=True), dict(window=3, is_local=False),
    dict(seg=True, kv_valid=True), dict(use_kernel=True, kv_valid=True),
    dict(use_kernel=True, mask_mode="causal", window=4, is_local=True),
])
@pytest.mark.parametrize("q_chunk", [1024, 8])
def test_attention_matches_reference(H, K, flags, q_chunk):
    """Every mask flag, whole and q-chunked (Sq = 21, ragged last chunk);
    ``use_kernel`` runs flash_refresh (Pallas interpret vs plain)."""
    rng = np.random.default_rng(0)
    B, Sq, dh = 2, 21, 16
    q = rng.standard_normal((B, Sq, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, Sq, K, dh)).astype(np.float32)
    v = rng.standard_normal((B, Sq, K, dh)).astype(np.float32)
    pos = np.tile(np.arange(Sq, dtype=np.int32), (B, 1))
    kw = {k_: v_ for k_, v_ in flags.items() if k_ not in ("kv_valid", "seg")}
    jkw, tkw = dict(kw), dict(kw)
    if flags.get("kv_valid"):
        valid = np.ones((B, Sq), bool)
        valid[0, 15:] = False
        valid[1, 3] = False
        jkw["kv_valid"], tkw["kv_valid"] = jnp.asarray(valid), _t(valid)
    if flags.get("seg"):
        seg = np.array([[0] * 9 + [1] * 12, [0] * 21], np.int32)
        jkw.update(q_seg=jnp.asarray(seg), kv_seg=jnp.asarray(seg))
        tkw.update(q_seg=_t(seg), kv_seg=_t(seg))
    ref = JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       q_pos=jnp.asarray(pos), kv_pos=jnp.asarray(pos),
                       q_chunk=q_chunk, **jkw)
    out = TL.attention(_t(q), _t(k), _t(v), q_pos=_t(pos), kv_pos=_t(pos),
                       q_chunk=q_chunk, **tkw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL_ATTN)


def test_attention_chunked_equals_whole():
    rng = np.random.default_rng(1)
    q = _t(rng.standard_normal((2, 37, 4, 16)).astype(np.float32))
    k = _t(rng.standard_normal((2, 37, 2, 16)).astype(np.float32))
    pos = torch.arange(37, dtype=torch.int32).expand(2, 37)
    kw = dict(q_pos=pos, kv_pos=pos, mask_mode="causal")
    whole = TL.attention(q, k, k, q_chunk=1024, **kw)
    for c in (5, 16, 36):
        torch.testing.assert_close(TL.attention(q, k, k, q_chunk=c, **kw),
                                   whole, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# sparse_select: the padded select/pack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["head", "uniform", "none"])
@pytest.mark.parametrize("H,K", [(4, 4), (4, 2)])
def test_select_and_pack_matches_reference(mode, H, K):
    """Exact indices and valid flags in all three modes, fewer candidates
    than ``retain`` in one row (excluded picks come back invalid)."""
    rng = np.random.default_rng(2)
    B, dh = 3, 16
    qb = rng.standard_normal((B, SB, H, dh)).astype(np.float32)
    kf = rng.standard_normal((B, S, K, dh)).astype(np.float32)
    vf = rng.standard_normal((B, S, K, dh)).astype(np.float32)
    valid = np.arange(S)[None] < np.array(LENS)[:, None]
    bs = np.array([[n - SB] for n in LENS])
    in_block = (np.arange(S)[None] >= bs) & (np.arange(S)[None] < bs + SB)
    exclude = in_block | ~valid
    kw = dict(retain=RETAIN, kernel_size=3, mode=mode)
    ref = JS.select_and_pack(jnp.asarray(qb), jnp.asarray(kf),
                             jnp.asarray(vf), exclude=jnp.asarray(exclude),
                             token_valid=jnp.asarray(valid), **kw)
    out = TS.select_and_pack(_t(qb), _t(kf), _t(vf), exclude=_t(exclude),
                             token_valid=_t(valid), **kw)
    assert np.array_equal(out.pos.numpy(), np.asarray(ref.pos))
    assert np.array_equal(out.valid.numpy(), np.asarray(ref.valid))
    assert not out.valid.numpy()[2].all()          # 17 - 8 < 24 candidates
    np.testing.assert_allclose(out.k.numpy(), np.asarray(ref.k), atol=0)
    np.testing.assert_allclose(out.v.numpy(), np.asarray(ref.v), atol=0)
    if mode != "none":
        sc = TS.head_scores(_t(qb), _t(kf), 3, s_chunk=16, valid=_t(valid))
        sr = JS.head_scores(jnp.asarray(qb), jnp.asarray(kf), 3,
                            valid=jnp.asarray(valid))
        assert np.array_equal(np.isinf(sc.numpy()), np.isinf(np.asarray(sr)))
        fin = np.isfinite(np.asarray(sr))
        np.testing.assert_allclose(sc.numpy()[fin], np.asarray(sr)[fin],
                                   atol=ATOL_ATTN)


# ---------------------------------------------------------------------------
# transformer: forward_full, forward_block, reuse_attention_layer
# ---------------------------------------------------------------------------

def _full_both(kv_heads, selection="head", flash_refresh=False):
    jcfg, tcfg = _cfgs(kv_heads)
    jp, tp = _params(jcfg, tcfg)
    tokens, valid, bstart = _batch(jcfg.vocab_size)
    pos = np.tile(np.arange(S, dtype=np.int32), (len(LENS), 1))
    kw = dict(selection=selection, use_flash_refresh=flash_refresh)
    x = JLM.embed_tokens(jp["embed"], jnp.asarray(tokens))
    ref = JT.forward_full(jp["stack"], jcfg, x, jnp.asarray(pos),
                          token_valid=jnp.asarray(valid),
                          serve=_ctx(JT, **kw),
                          block_start=jnp.asarray(bstart))
    out = TT.forward_full(tp["stack"], tcfg, _t(np.asarray(x)), _t(pos),
                          token_valid=_t(valid), serve=_ctx(TT, **kw),
                          block_start=_t(bstart))
    return ref, out, valid


@pytest.mark.parametrize("kv_heads,selection,flash_refresh", [
    (4, "head", False), (2, "uniform", False), (2, "none", False),
    (4, "head", True)])
def test_forward_full_matches_reference(kv_heads, selection, flash_refresh):
    ref, out, valid = _full_both(kv_heads, selection, flash_refresh)
    np.testing.assert_allclose(out[0].numpy()[valid],
                               np.asarray(ref[0])[valid], atol=ATOL)
    _same_cache(out[1], ref[1])


def _reuse_inputs(jcfg, seed=3):
    """A random retained cache [L, B, K, C, dh] with some invalid rows, and
    block tokens/positions [B, Sb]."""
    rng = np.random.default_rng(seed)
    L_, B, K, C, dh = (jcfg.n_layers, 3, jcfg.n_kv_heads, RETAIN,
                       jcfg.resolved_head_dim)
    cache = PackedKV(
        rng.standard_normal((L_, B, K, C, dh)).astype(np.float32),
        rng.standard_normal((L_, B, K, C, dh)).astype(np.float32),
        np.sort(rng.integers(0, 40, (L_, B, K, C)), -1).astype(np.int32),
        rng.random((L_, B, K, C)) < 0.8)
    cache.valid[:, 2, 0] = False            # one head of one row sees none
    btok = rng.integers(0, jcfg.vocab_size - 1, (B, SB)).astype(np.int32)
    bpos = (np.arange(SB)[None] + np.array([[40], [24], [8]])).astype(
        np.int32)
    return cache, btok, bpos


@pytest.mark.parametrize("kv_heads", [4, 2])
@pytest.mark.parametrize("concat,use_kernel", [
    (False, False), (False, True), (True, False), (True, True)])
def test_forward_block_matches_reference(kv_heads, concat, use_kernel):
    """Split (kernel branch: packed_flash_attention's stats) and concat."""
    jcfg, tcfg = _cfgs(kv_heads)
    jp, tp = _params(jcfg, tcfg)
    cache, btok, bpos = _reuse_inputs(jcfg)
    kw = dict(reuse_concat=concat, use_flash_kernel=use_kernel)
    xb = JLM.embed_tokens(jp["embed"], jnp.asarray(btok))
    ref = JT.forward_block(jp["stack"], jcfg, xb, jnp.asarray(bpos),
                           PackedKV(*map(jnp.asarray, cache)),
                           serve=_ctx(JT, **kw))
    out = TT.forward_block(tp["stack"], tcfg, _t(np.asarray(xb)), _t(bpos),
                           PackedKV(*map(_t, cache)), serve=_ctx(TT, **kw))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("concat,use_kernel", [
    (False, False), (False, True), (True, False), (True, True)])
@pytest.mark.parametrize("mask_mode,is_local", [
    ("bidirectional", True), ("causal", False), ("causal", True)])
def test_reuse_attention_layer_masks_match_reference(concat, use_kernel,
                                                     mask_mode, is_local):
    """One Reuse sublayer with every mask term: causal, a sliding window
    on a local layer, softcap, GQA."""
    jcfg, tcfg = _cfgs(2, sliding_window=12, attn_softcap=30.0)
    jp, tp = _params(jcfg, tcfg)
    cache, btok, bpos = _reuse_inputs(jcfg, seed=4)
    x = np.asarray(JLM.embed_tokens(jp["embed"], jnp.asarray(btok)))
    jcos, jsin = JL.rope_tables(jnp.asarray(bpos), jcfg.resolved_head_dim,
                                jcfg.rope_theta)
    tcos, tsin = TL.rope_tables(_t(bpos), tcfg.resolved_head_dim,
                                tcfg.rope_theta)
    jl = jax.tree.map(lambda a: a[0], jp["stack"])
    tl = TT.layer_params(tp["stack"], 0)
    c = [a[0] for a in cache]
    ref = JT.reuse_attention_layer(
        jl, jnp.asarray(x), jcfg, jcos, jsin, jnp.asarray(bpos),
        jnp.asarray(is_local), *map(jnp.asarray, c), mask_mode,
        use_kernel=use_kernel, concat=concat)
    out = TT.reuse_attention_layer(
        tl, _t(x), tcfg, tcos, tsin, _t(bpos), is_local, *map(_t, c),
        mask_mode, use_kernel=use_kernel, concat=concat)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


# ---------------------------------------------------------------------------
# backbone and lm_head: the padded stages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_heads,selection", [(4, "head"), (2, "uniform"),
                                                (4, "none")])
def test_serve_refresh_and_reuse_match_reference(kv_heads, selection):
    jcfg, tcfg = _cfgs(kv_heads)
    jp, tp = _params(jcfg, tcfg)
    tokens, valid, bstart = _batch(jcfg.vocab_size, seed=5)
    jctx = _ctx(JT, selection=selection, use_flash_kernel=True)
    tctx = _ctx(TT, selection=selection, use_flash_kernel=True)
    ref = JBB.serve_refresh(jp, jcfg, jnp.asarray(tokens),
                            jnp.asarray(bstart), jctx,
                            token_valid=jnp.asarray(valid))
    out = TBB.serve_refresh(tp, tcfg, _t(tokens), _t(bstart), tctx,
                            token_valid=_t(valid))
    np.testing.assert_allclose(out.block_hidden.numpy(),
                               np.asarray(ref.block_hidden), atol=ATOL)
    _same_cache(out.cache, ref.cache)
    rng = np.random.default_rng(6)
    btok = rng.integers(0, jcfg.vocab_size - 1, (3, SB)).astype(np.int32)
    bpos = (bstart[:, None] + np.arange(SB)).astype(np.int32)
    h_ref = JBB.serve_reuse(jp, jcfg, jnp.asarray(btok), jnp.asarray(bpos),
                            ref.cache, jctx)
    tcache = PackedKV(*[_t(np.array(a)) for a in ref.cache])
    h = TBB.serve_reuse(tp, tcfg, _t(btok), _t(bpos), tcache, tctx)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=ATOL)


@pytest.mark.parametrize("mode", ["monolithic", "chunked", "fused"])
@pytest.mark.parametrize("N", [16, 40])
def test_decode_tokens_matches_reference(mode, N):
    """All three modes, N below and above max_num_logits (the reference's
    precedence: one pass unless fused when N fits)."""
    jcfg, tcfg = _cfgs(4)
    jp, tp = _params(jcfg, tcfg)
    h = np.random.default_rng(7).standard_normal(
        (N, jcfg.d_model)).astype(np.float32)
    ids_r, conf_r = JLM.decode_tokens(jp["embed"], jcfg, jnp.asarray(h),
                                      max_num_logits=16, mode=mode,
                                      vocab_tile=64)
    ids, conf = TLM.decode_tokens(tp["embed"], tcfg, _t(h),
                                  max_num_logits=16, mode=mode)
    assert np.array_equal(ids.numpy(), np.asarray(ids_r))
    np.testing.assert_allclose(conf.numpy(), np.asarray(conf_r), rtol=1e-5,
                               atol=1e-7)
    z = TLM.logits_monolithic(tp["embed"], tcfg, _t(h))
    np.testing.assert_allclose(
        z.numpy(), np.asarray(JLM.logits_monolithic(jp["embed"], jcfg,
                                                    jnp.asarray(h))),
        atol=ATOL_ATTN)


def test_decode_tokens_packed_monolithic_matches_reference():
    jcfg, tcfg = _cfgs(4)
    jp, tp = _params(jcfg, tcfg)
    h = np.random.default_rng(8).standard_normal(
        (40, jcfg.d_model)).astype(np.float32)
    valid = np.arange(40) < 29
    ids_r, conf_r = JLM.decode_tokens_packed(
        jp["embed"], jcfg, jnp.asarray(h), jnp.asarray(valid),
        max_num_logits=16, mode="monolithic")
    ids, conf = TLM.decode_tokens_packed(tp["embed"], tcfg, _t(h), _t(valid),
                                         max_num_logits=16, mode="monolithic")
    assert np.array_equal(ids.numpy(), np.asarray(ids_r))
    np.testing.assert_allclose(conf.numpy(), np.asarray(conf_r), rtol=1e-5,
                               atol=1e-7)


def test_decode_tokens_packed_chunked_matches_reference():
    """The chunked mode over a stream whose last two chunks are all padding:
    the reference branches around them (``lax.cond``), the port computes
    and masks them on the device; the same ids and confidences, and the
    padding rows are (0, 0.0)."""
    jcfg, tcfg = _cfgs(4)
    jp, tp = _params(jcfg, tcfg)
    h = np.random.default_rng(9).standard_normal(
        (64, jcfg.d_model)).astype(np.float32)
    valid = np.arange(64) < 29
    ids_r, conf_r = JLM.decode_tokens_packed(
        jp["embed"], jcfg, jnp.asarray(h), jnp.asarray(valid),
        max_num_logits=16, mode="chunked")
    ids, conf = TLM.decode_tokens_packed(tp["embed"], tcfg, _t(h), _t(valid),
                                         max_num_logits=16, mode="chunked")
    assert np.array_equal(ids.numpy(), np.asarray(ids_r))
    np.testing.assert_allclose(conf.numpy(), np.asarray(conf_r), rtol=1e-5,
                               atol=1e-7)
    assert not ids[29:].any() and not conf[29:].any()
    assert bool((conf[:29] > 0).all())


# ---------------------------------------------------------------------------
# the packed path's plain fallbacks (use_flash_kernel=False)
# ---------------------------------------------------------------------------

def _stream(V, tp, seed=9):
    """A packed Refresh stream of LENS in a ``tp``-token bucket, plus one
    padding request."""
    rng = np.random.default_rng(seed)
    rp = 4
    tokens = np.zeros(tp, np.int32)
    pos = np.zeros(tp, np.int32)
    seg = np.full(tp, -1, np.int32)
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
        cu[j], lens[j], bstart[j] = off, n, n - SB - 3 * j
        off += n
    return tokens, pos, seg, valid, cu, lens, bstart


@pytest.mark.parametrize("tp,q_chunk", [(96, 16), (128, 16), (128, 96)])
def test_packed_refresh_fallback_matches_reference(tp, q_chunk):
    """``_attend_packed_stream``: its windowed chunks (T = 128, q_chunk
    16: a 112-token window) and its whole-stream segment path (the window
    covers T = 96; q_chunk 96 does not divide 128); the plain varlen
    scores."""
    jcfg, tcfg = _cfgs(2)
    jp, tp_ = _params(jcfg, tcfg)
    args = _stream(jcfg.vocab_size, tp)
    ref = JBB.serve_refresh_packed(jp, jcfg, *map(jnp.asarray, args),
                                   _ctx(JT, q_chunk=q_chunk))
    out = TBB.serve_refresh_packed(tp_, tcfg, *map(_t, args),
                                   _ctx(TT, q_chunk=q_chunk))
    n = len(LENS)
    np.testing.assert_allclose(out.block_hidden.numpy()[:n],
                               np.asarray(ref.block_hidden)[:n], atol=ATOL)
    _same_cache(out.cache, ref.cache, n)


@pytest.mark.parametrize("concat", [False, True])
def test_packed_reuse_fallback_matches_reference(concat):
    jcfg, tcfg = _cfgs(2)
    jp, tp = _params(jcfg, tcfg)
    cache, btok, bpos = _reuse_inputs(jcfg, seed=10)
    ctx = dict(reuse_concat=concat)
    ref = JBB.serve_reuse_packed(jp, jcfg, jnp.asarray(btok.reshape(-1)),
                                 jnp.asarray(bpos.reshape(-1)),
                                 PackedKV(*map(jnp.asarray, cache)),
                                 _ctx(JT, **ctx))
    out = TBB.serve_reuse_packed(tp, tcfg, _t(btok.reshape(-1)),
                                 _t(bpos.reshape(-1)),
                                 PackedKV(*map(_t, cache)), _ctx(TT, **ctx))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


# ---------------------------------------------------------------------------
# padded versus packed inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
def test_packed_refresh_matches_padded(use_kernel):
    """The port's packed Refresh reproduces its padded oracle on the same
    ragged requests: block hidden, retained positions and caches."""
    _, tcfg = _cfgs(2)
    tp = TBB.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tokens, valid, bstart = _batch(tcfg.vocab_size, seed=11)
    ctx = _ctx(TT, use_flash_kernel=use_kernel)
    pad = TBB.serve_refresh(tp, tcfg, _t(tokens), _t(bstart), ctx,
                            token_valid=_t(valid))
    flat, pos, seg, val, cu, lens, bs = _stream(tcfg.vocab_size, 128)
    off = 0
    for j, n in enumerate(LENS):
        flat[off: off + n] = tokens[j, :n]
        bs[j] = bstart[j]
        off += n
    pk = TBB.serve_refresh_packed(tp, tcfg, *map(_t, (flat, pos, seg, val,
                                                       cu, lens, bs)), ctx)
    n = len(LENS)
    torch.testing.assert_close(pk.block_hidden[:n], pad.block_hidden,
                               atol=ATOL, rtol=0)
    for a, b in ((pk.cache.pos, pad.cache.pos),
                 (pk.cache.valid, pad.cache.valid)):
        assert torch.equal(a[:, :n], b)
    ok = pad.cache.valid
    torch.testing.assert_close(pk.cache.k[:, :n][ok], pad.cache.k[ok],
                               atol=ATOL, rtol=0)


def test_unported_padded_branches_raise():
    """Every branch of the padded stages is ported (the modality frontends
    last: ``test_torch_frontend.py``); what they refuse names its cause. A
    frontend arch's parameters hold its projection, and its padded Refresh
    without the requests' frontend embeddings raises naming them."""
    cfg = dataclasses.replace(treduced(get_config("llada-8b")),
                              frontend_dim=32, frontend_len=4)
    ctx = _ctx(TT, use_flash_kernel=True)
    params = TBB.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert tuple(params["frontend"]["proj"].shape) == (32, cfg.d_model)
    with pytest.raises(ValueError, match="frontend"):
        TBB.serve_refresh(params, cfg, torch.zeros(1, S, dtype=torch.int32),
                          torch.zeros(1, dtype=torch.int32), ctx)
