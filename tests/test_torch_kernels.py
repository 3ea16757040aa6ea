"""The port's kernel wrappers, on CPU tensors (their plain PyTorch versions),
against the JAX package's kernel wrappers (Pallas in interpret mode) on the
same numpy inputs. The kernel-vs-plain cases on the card are in
``test_torch_kernels_cuda.py``.

Tolerances: both sides compute in float32 on the CPU and differ only in the
order of their sums (online vs whole-row softmax, tiled vs whole matmuls),
so outputs of magnitude ~1 agree to a few 1e-6; 2e-5 leaves headroom.
Argmax ids and -inf positions must match exactly.
"""
import torch_testing  # noqa: F401  (the thread cap, before anything builds)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import flash_refresh as FR
from repro_torch.kernels import flash_varlen as FV
from repro_torch.kernels import logit_argmax as LA
from repro_torch.kernels import select_pack as SP
from repro_torch.kernels import ops as tops
from repro_torch.kernels.flash_varlen import PAD_SEG

ATOL = 2e-5


def _stream(lens, pad):
    """Segment-ascending packed stream: seg/pos per token, PAD_SEG tail."""
    seg = np.concatenate([np.full(n, j, np.int32) for j, n in enumerate(lens)]
                         + [np.full(pad, PAD_SEG, np.int32)])
    pos = np.concatenate([np.arange(n, dtype=np.int32) for n in lens]
                         + [np.zeros(pad, np.int32)])
    return seg, pos, seg != PAD_SEG


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("H,K", [(4, 4), (4, 2)])
@pytest.mark.parametrize("flags", [
    dict(), dict(softcap=20.0), dict(causal=True),
    dict(window=4, is_local=True), dict(window=4, is_local=False),
])
def test_flash_varlen_plain_matches_jax(H, K, flags):
    rng = np.random.default_rng(0)
    seg, pos, valid = _stream([20, 7, 25], pad=12)
    T, dh = seg.shape[0], 16
    q = rng.standard_normal((T, H, dh)).astype(np.float32)
    k = rng.standard_normal((T, K, dh)).astype(np.float32)
    v = rng.standard_normal((T, K, dh)).astype(np.float32)
    kw = dict(softcap=flags.get("softcap", 0.0),
              causal=flags.get("causal", False),
              window=flags.get("window", 0),
              is_local=flags.get("is_local", False))
    ref = jops.flash_varlen_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), seg_ids=seg,
        positions=pos, kv_valid=valid, q_tile=16, kv_tile=16, **kw)
    out = tops.flash_varlen_attention(
        _t(q), _t(k), _t(v), seg_ids=_t(seg), positions=_t(pos),
        kv_valid=_t(valid), **kw)
    # padding rows attend to nothing and are junk on both sides
    np.testing.assert_allclose(out.numpy()[valid], np.asarray(ref)[valid],
                               atol=ATOL)


@pytest.mark.parametrize("H,K", [(4, 4), (4, 2)])
@pytest.mark.parametrize("flags", [
    dict(), dict(softcap=20.0), dict(causal=True),
    dict(window=3, is_local=True),
])
def test_flash_varlen_cross_plain_matches_jax(H, K, flags):
    rng = np.random.default_rng(1)
    R, Sb, Cr, dh = 3, 4, 10, 16
    Tq, Tkv = R * Sb, R * (Cr + Sb)
    q = rng.standard_normal((Tq, H, dh)).astype(np.float32)
    k = rng.standard_normal((K, Tkv, dh)).astype(np.float32)
    v = rng.standard_normal((K, Tkv, dh)).astype(np.float32)
    q_seg = np.repeat(np.arange(R, dtype=np.int32), Sb)
    kv_seg = np.repeat(np.arange(R, dtype=np.int32), Cr + Sb)
    q_pos = (np.tile(np.arange(Sb), R) + 20).astype(np.int32)
    kv_pos = rng.integers(0, 30, (K, Tkv)).astype(np.int32)
    kv_valid = rng.random((K, Tkv)) < 0.7
    # every request's live block (the last Sb keys of its span) is valid,
    # at the block's own positions, as the engine lays it out
    for r in range(R):
        blk = slice(r * (Cr + Sb) + Cr, (r + 1) * (Cr + Sb))
        kv_valid[:, blk] = True
        kv_pos[:, blk] = np.arange(Sb) + 20
    kw = dict(softcap=flags.get("softcap", 0.0),
              causal=flags.get("causal", False),
              window=flags.get("window", 0),
              is_local=flags.get("is_local", False))
    ref = jops.flash_varlen_cross_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_seg=q_seg,
        q_pos=q_pos, kv_seg=kv_seg, kv_pos=kv_pos, kv_valid=kv_valid,
        q_tile=4, kv_tile=14, **kw)
    out = tops.flash_varlen_cross_attention(
        _t(q), _t(k), _t(v), q_seg=_t(q_seg), q_pos=_t(q_pos),
        kv_seg=_t(kv_seg), kv_pos=_t(kv_pos), kv_valid=_t(kv_valid), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("RG,K,Tkv,name", [
    (96, 32, 1632, "llada-8b Reuse (R=12 Sb=8 Cr=128)"),
    (192, 32, 1632, "llada-8b Reuse at G=2"),
    (384, 32, 1632, "llada-8b Reuse at G=4"),
    (48, 32, 624, "six requests' Reuse"),
    (1024, 32, 1024, "llada-8b and zamba2-7b Refresh (T=1024)"),
    (8, 2, 1000, "two heads, one row tile"),
    (600, 2, 60, "one KV tile"),
])
def test_kv_splits_fill_the_card_from_the_shapes(RG, K, Tkv, name):
    """The split-KV grid: one split when the row tiles fill the 132 SMs
    (llada-8b's Refresh), else at least one CTA an SM, and never more
    splits than the stream has KV tiles."""
    splits = FV.kv_splits(RG, K, Tkv, dh=128)
    ctas = -(-RG // FV.BM) * K
    tiles = -(-Tkv // FV.BK)
    assert 1 <= splits <= tiles
    if ctas >= build.H100_SMS:
        assert splits == 1
    elif tiles * ctas >= build.H100_SMS:
        assert ctas * splits >= build.H100_SMS
    else:
        assert splits == tiles


@pytest.mark.parametrize("RG,K,Tkv,name", [
    (768, 1, 1632, "gemma-2b Reuse (R=12 Sb=8 Cr=128, G=8)"),
    (8192, 1, 1024, "gemma-2b Refresh (T=1024, G=8)"),
])
def test_kv_splits_count_the_column_ctas_at_dh_256(RG, K, Tkv, name):
    """At dh 256 a row tile is two CTAs (one for each half of V's
    columns): the chooser counts both, so it splits the keys half as far
    as the same rows at dh 128 would."""
    splits = FV.kv_splits(RG, K, Tkv, dh=256)
    ctas = -(-RG // FV.BM) * K * 2
    assert 1 <= splits <= -(-Tkv // FV.BK)
    assert ctas * splits >= build.H100_SMS
    assert ctas * (splits - 1) < build.H100_SMS
    if name.startswith("llada-8b Reuse"):
        assert ctas * splits >= 132
    if name.startswith("llada-8b and"):
        assert splits == 1


@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("splits", [1, 2, 3, 7, 20])
def test_split_merge_law_matches_plain(G, causal, splits):
    """The bfloat16 kernel's law (row-tile key windows from the segments,
    even shares of whole KV tiles, partials folded by (max, rescaled Σ))
    against the whole-row softmax, float32, on a stream whose segments
    start off the 64-key grid and straddle 128-row tiles; 20 splits leave
    shares empty."""
    rng = np.random.default_rng(3)
    seg, pos, valid = (_t(a) for a in _stream([70, 9, 133, 250, 1], pad=50))
    T, K, dh = seg.shape[0], 2, 16
    q = _t(rng.standard_normal((K, T * G, dh)).astype(np.float32))
    k = _t(rng.standard_normal((K, T, dh)).astype(np.float32))
    v = _t(rng.standard_normal((K, T, dh)).astype(np.float32))
    args = (q, k, v, pos, seg, pos.expand(K, T), seg, valid.expand(K, T),
            False)
    out = FV.split_merge_plain(*args, splits=splits, causal=causal)
    ref = FV.varlen_attention_plain(*args, causal=causal)
    rows = valid.repeat_interleave(G)
    np.testing.assert_allclose(out[:, rows].numpy(), ref[:, rows].numpy(),
                               atol=ATOL)


@pytest.mark.parametrize("splits", [1, 4])
def test_split_merge_law_empty_window_is_finite(splits):
    """A cross stream whose last 128-row tile is all PAD_SEG rows while no
    key carries PAD_SEG: every share of that tile is empty and its rows
    merge to 0, not NaN; the real rows match the whole-row softmax."""
    rng = np.random.default_rng(4)
    R, Sb, Cr, K, dh, pad = 4, 8, 30, 2, 16, 200
    Tq, Tkv = R * Sb + pad, R * (Cr + Sb)
    q = _t(rng.standard_normal((K, Tq, dh)).astype(np.float32))
    k = _t(rng.standard_normal((K, Tkv, dh)).astype(np.float32))
    v = _t(rng.standard_normal((K, Tkv, dh)).astype(np.float32))
    q_seg = _t(np.concatenate([np.repeat(np.arange(R), Sb),
                               np.full(pad, PAD_SEG)]).astype(np.int32))
    kv_seg = _t(np.repeat(np.arange(R), Cr + Sb).astype(np.int32))
    q_pos = _t(np.concatenate([np.tile(np.arange(Sb), R) + 40,
                               np.zeros(pad)]).astype(np.int32))
    kv_pos = _t(rng.integers(0, 48, (K, Tkv)).astype(np.int32))
    kv_valid = _t(rng.random((K, Tkv)) < 0.7)
    args = (q, k, v, q_pos, q_seg, kv_pos, kv_seg, kv_valid, False)
    out = FV.split_merge_plain(*args, splits=splits)
    ref = FV.varlen_attention_plain(*args)
    assert torch.isfinite(out).all()
    assert (out[:, FV.BM:] == 0).all()
    real = (q_seg != PAD_SEG).numpy()
    np.testing.assert_allclose(out[:, real].numpy(), ref[:, real].numpy(),
                               atol=ATOL)


@pytest.mark.parametrize("H,K", [(4, 4), (4, 2)])
def test_head_score_plain_matches_jax(H, K):
    rng = np.random.default_rng(2)
    seg, _, _ = _stream([20, 7, 25, 9], pad=11)
    T, R, Sb, dh = seg.shape[0], 5, 4, 16      # request 4 owns no tokens
    q = rng.standard_normal((R, Sb, H, dh)).astype(np.float32)
    k = rng.standard_normal((T, K, dh)).astype(np.float32)
    ref = np.asarray(jops.head_score_varlen(jnp.asarray(q), jnp.asarray(k),
                                            seg, s_tile=8))
    out = tops.head_score_varlen(_t(q), _t(k), _t(seg)).numpy()
    assert np.array_equal(np.isinf(out), np.isinf(ref))
    fin = np.isfinite(ref)
    assert fin.sum() == K * 61
    np.testing.assert_allclose(out[fin], ref[fin], atol=ATOL)


@pytest.mark.parametrize("layout", ["dv", "vd"])
@pytest.mark.parametrize("softcap", [0.0, 5.0])
def test_logit_argmax_plain_matches_jax(layout, softcap):
    rng = np.random.default_rng(3)
    T, D, V = 40, 32, 200
    h = rng.standard_normal((T, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) * 0.3).astype(np.float32)
    valid = np.ones(T, bool)
    valid[16:32] = False           # whole 8-row tiles of padding in JAX
    valid[37:] = False
    wl = w if layout == "dv" else np.ascontiguousarray(w.T)
    ids_r, conf_r = jops.fused_logit_argmax(
        jnp.asarray(h), jnp.asarray(wl), softcap=softcap, vocab_tile=8,
        t_tile=8, w_layout=layout, valid=jnp.asarray(valid))
    ids, conf = tops.fused_logit_argmax(_t(h), _t(wl), softcap=softcap,
                                        w_layout=layout, valid=_t(valid))
    assert np.array_equal(ids.numpy(), np.asarray(ids_r))
    assert (ids.numpy()[~valid] == 0).all() and (conf.numpy()[~valid] == 0).all()
    np.testing.assert_allclose(conf.numpy(), np.asarray(conf_r), rtol=1e-5,
                               atol=1e-7)


def test_logit_argmax_ties_pick_lowest_index():
    """Identical columns tie exactly; the lowest vocabulary index wins in
    both packages, across the reference's tiles and the port's chunks."""
    rng = np.random.default_rng(4)
    T, D, V = 8, 16, 40000
    h = np.abs(rng.standard_normal((T, D))).astype(np.float32)
    w = (rng.standard_normal((D, V)) * 0.01).astype(np.float32)
    for c in (7, 9000, 20000, 39000):
        w[:, c] = 1.0             # the maximum, four times over
    ids_r, _ = jops.fused_logit_argmax(jnp.asarray(h), jnp.asarray(w),
                                       vocab_tile=1000, t_tile=8)
    ids, _ = tops.fused_logit_argmax(_t(h), _t(w))
    assert (np.asarray(ids_r) == 7).all()
    assert (ids.numpy() == 7).all()


@pytest.mark.parametrize("V", [126464, 32000, 50280, 5003, 256000, 152064])
@pytest.mark.parametrize("n_ctas", [132, 114, 7, 1, 100000])
def test_vocab_split_covers_the_vocabulary_in_whole_tiles(V, n_ctas):
    """The logit kernel's persistent grid: the splits of the llada-8b,
    zamba2-7b, mamba2-130m, gemma (256,000) and qwen2 (152,064) heads and
    of a ragged test vocabulary cover
    [0, V) exactly, each a run of whole 128-column tiles (the last one
    ragged only at V), none empty, at most one per CTA."""
    split = LA.vocab_split(V, n_ctas)
    n = -(-V // split)
    assert split % LA.V_TILE == 0 and n <= max(1, n_ctas)
    starts = [i * split for i in range(n)]
    ends = [min(V, s + split) for s in starts]
    assert starts[0] == 0 and ends[-1] == V
    assert all(e == s for s, e in zip(starts[1:], ends[:-1]))
    assert all(e > s for s, e in zip(starts, ends))
    assert all((e - s) % LA.V_TILE == 0 for s, e in zip(starts[:-1],
                                                         ends[:-1]))
    assert LA.vocab_split(V) == LA.vocab_split(V, LA.H100_SMS)


def _gqa_rows(q, K):
    """[B, Sb, H, dh] -> the kernels' [B, K, Sb·G, dh] (row = sb·G + g)."""
    B, Sb, H, dh = q.shape
    return (q.reshape(B, Sb, K, H // K, dh).transpose(0, 2, 1, 3, 4)
            .reshape(B, K, Sb * (H // K), dh))


@pytest.mark.parametrize("G,Sm", [(1, 8), (2, 8), (2, 1)])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_packed_flash_attention_plain_matches_jax(G, Sm, softcap):
    """Row 6's plain version: the unnormalised (o, m, s) against the Pallas
    kernel in interpret mode (T = 40 in tiles of 8), the normalised output
    against ``repro.kernels.ref``; a fully masked row comes out with
    m = -1e30 and s = T in both, and a mask of one row (Sm = 1) serves
    every query row."""
    from repro.kernels.flash_attention import packed_flash_attention_call
    rng = np.random.default_rng(5)
    B, K, Sb, T, dh = 2, 2, 8, 40, 16
    R = Sb * G
    q = rng.standard_normal((B, K, R, dh)).astype(np.float32)
    k = rng.standard_normal((B, K, T, dh)).astype(np.float32)
    v = rng.standard_normal((B, K, T, dh)).astype(np.float32)
    mask = rng.random((B, K, Sm, T)) < 0.6
    mask[0, 1] = False                       # every row of one head masked
    o_r, m_r, s_r = packed_flash_attention_call(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        softcap=softcap, t_tile=8, interpret=True)
    o, m, s = FA.packed_flash_attention_call(_t(q), _t(k), _t(v), _t(mask),
                                             softcap=softcap)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_r), atol=ATOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_r), rtol=1e-5)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_r), rtol=1e-5,
                               atol=1e-4)
    assert (m.numpy()[0, 1] == -1e30).all() and (s.numpy()[0, 1] == T).all()
    if Sm == Sb:
        want = jref.packed_flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(mask), softcap=softcap)
        got = o / s[..., None]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("H,K", [(4, 4), (4, 2)])
def test_packed_flash_attention_op_matches_jax(H, K):
    """``ops.packed_flash_attention`` (the model-layer contract)."""
    rng = np.random.default_rng(6)
    B, Sb, T, dh = 2, 4, 24, 16
    q = rng.standard_normal((B, Sb, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, K, T, dh)).astype(np.float32)
    v = rng.standard_normal((B, K, T, dh)).astype(np.float32)
    mask = rng.random((B, K, Sb, T)) < 0.7
    ref = jops.packed_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(mask),
                                      t_tile=8)
    out = tops.packed_flash_attention(_t(q), _t(k), _t(v), _t(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("H,K", [(4, 4), (4, 2)])
@pytest.mark.parametrize("flags", [
    dict(), dict(softcap=20.0), dict(mask_mode="causal"),
    dict(window=3, is_local=True), dict(window=3, is_local=False),
])
def test_flash_refresh_plain_matches_jax(H, K, flags):
    """Row 7's plain version through ``ops.flash_refresh_attention`` against
    the Pallas kernel in interpret mode (S = 24 in 8-row tiles), with
    ``kv_valid`` holes and a row of a batch with no valid key."""
    rng = np.random.default_rng(7)
    B, Sq, dh = 3, 24, 16
    q = rng.standard_normal((B, Sq, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, Sq, K, dh)).astype(np.float32)
    v = rng.standard_normal((B, Sq, K, dh)).astype(np.float32)
    pos = np.tile(np.arange(Sq, dtype=np.int32), (B, 1))
    valid = rng.random((B, Sq)) < 0.7
    valid[2] = False
    kw = dict(mask_mode=flags.get("mask_mode", "bidirectional"),
              window=flags.get("window", 0),
              is_local=flags.get("is_local", False),
              softcap=flags.get("softcap", 0.0))
    ref = jops.flash_refresh_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_pos=jnp.asarray(pos), kv_pos=jnp.asarray(pos),
        kv_valid=jnp.asarray(valid), q_tile=8, kv_tile=8, **kw)
    out = tops.flash_refresh_attention(
        _t(q), _t(k), _t(v), q_pos=_t(pos), kv_pos=_t(pos),
        kv_valid=_t(valid), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    # the kernel layout of the plain version, against the row layout
    qr, kr, vr = _gqa_rows(q, K), k.transpose(0, 2, 1, 3), \
        v.transpose(0, 2, 1, 3)
    raw = FR.refresh_attention_plain(
        _t(qr), _t(kr), _t(vr), _t(pos), _t(pos), _t(valid),
        kw["is_local"], softcap=kw["softcap"],
        causal=kw["mask_mode"] == "causal", window=kw["window"])
    assert raw.shape == (B, K, Sq * (H // K), dh)


# gemma-2b's head_dim and one KV head, and gemma2-27b-like flags: softcap
# and a sliding window on a local layer
DH256 = dict(softcap=30.0, window=5, is_local=True)


@pytest.mark.parametrize("H,K", [(8, 1), (4, 2)])
def test_varlen_plain_matches_jax_at_head_dim_256(H, K):
    """Rows 1 and 2: the plain versions against the Pallas kernels in
    interpret mode at head_dim 256 with softcap and window."""
    rng = np.random.default_rng(9)
    seg, pos, valid = _stream([20, 7, 25], pad=12)
    T, dh = seg.shape[0], 256
    q = rng.standard_normal((T, H, dh)).astype(np.float32)
    k = rng.standard_normal((T, K, dh)).astype(np.float32)
    v = rng.standard_normal((T, K, dh)).astype(np.float32)
    ref = jops.flash_varlen_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), seg_ids=seg,
        positions=pos, kv_valid=valid, q_tile=16, kv_tile=16, **DH256)
    out = tops.flash_varlen_attention(
        _t(q), _t(k), _t(v), seg_ids=_t(seg), positions=_t(pos),
        kv_valid=_t(valid), **DH256)
    np.testing.assert_allclose(out.numpy()[valid], np.asarray(ref)[valid],
                               atol=ATOL)
    R, Sb, Cr = 3, 4, 10
    Tq, Tkv = R * Sb, R * (Cr + Sb)
    q = rng.standard_normal((Tq, H, dh)).astype(np.float32)
    k = rng.standard_normal((K, Tkv, dh)).astype(np.float32)
    v = rng.standard_normal((K, Tkv, dh)).astype(np.float32)
    q_seg = np.repeat(np.arange(R, dtype=np.int32), Sb)
    kv_seg = np.repeat(np.arange(R, dtype=np.int32), Cr + Sb)
    q_pos = (np.tile(np.arange(Sb), R) + 20).astype(np.int32)
    kv_pos = rng.integers(0, 30, (K, Tkv)).astype(np.int32)
    kv_valid = rng.random((K, Tkv)) < 0.7
    for r in range(R):
        blk = slice(r * (Cr + Sb) + Cr, (r + 1) * (Cr + Sb))
        kv_valid[:, blk] = True
        kv_pos[:, blk] = np.arange(Sb) + 20
    ref = jops.flash_varlen_cross_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_seg=q_seg,
        q_pos=q_pos, kv_seg=kv_seg, kv_pos=kv_pos, kv_valid=kv_valid,
        q_tile=4, kv_tile=14, **DH256)
    out = tops.flash_varlen_cross_attention(
        _t(q), _t(k), _t(v), q_seg=_t(q_seg), q_pos=_t(q_pos),
        kv_seg=_t(kv_seg), kv_pos=_t(kv_pos), kv_valid=_t(kv_valid),
        **DH256)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("G,Sm", [(8, 1), (2, 8)])
def test_packed_flash_attention_plain_matches_jax_at_head_dim_256(G, Sm):
    """Row 6 at head_dim 256 with softcap (its mask is the caller's: no
    window): the unnormalised (o, m, s) against the Pallas kernel."""
    from repro.kernels.flash_attention import packed_flash_attention_call
    rng = np.random.default_rng(10)
    B, K, Sb, T, dh = 2, 8 // G, 8, 40, 256
    R = Sb * G
    q = rng.standard_normal((B, K, R, dh)).astype(np.float32)
    k = rng.standard_normal((B, K, T, dh)).astype(np.float32)
    v = rng.standard_normal((B, K, T, dh)).astype(np.float32)
    mask = rng.random((B, K, Sm, T)) < 0.6
    o_r, m_r, s_r = packed_flash_attention_call(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        softcap=DH256["softcap"], t_tile=8, interpret=True)
    o, m, s = FA.packed_flash_attention_call(_t(q), _t(k), _t(v), _t(mask),
                                             softcap=DH256["softcap"])
    np.testing.assert_allclose(m.numpy(), np.asarray(m_r), atol=ATOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_r), rtol=1e-5)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_r), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("H,K", [(8, 1), (4, 2)])
def test_flash_refresh_plain_matches_jax_at_head_dim_256(H, K):
    """Row 7 at head_dim 256 with softcap and window, kv_valid holes and a
    batch row with no valid key, against the Pallas kernel."""
    rng = np.random.default_rng(11)
    B, Sq, dh = 3, 24, 256
    q = rng.standard_normal((B, Sq, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, Sq, K, dh)).astype(np.float32)
    v = rng.standard_normal((B, Sq, K, dh)).astype(np.float32)
    pos = np.tile(np.arange(Sq, dtype=np.int32), (B, 1))
    valid = rng.random((B, Sq)) < 0.7
    valid[2] = False
    kw = dict(mask_mode="bidirectional", **DH256)
    ref = jops.flash_refresh_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_pos=jnp.asarray(pos), kv_pos=jnp.asarray(pos),
        kv_valid=jnp.asarray(valid), q_tile=8, kv_tile=8, **kw)
    out = tops.flash_refresh_attention(
        _t(q), _t(k), _t(v), q_pos=_t(pos), kv_pos=_t(pos),
        kv_valid=_t(valid), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("H,K", [(4, 4), (4, 2)])
def test_head_score_padded_plain_matches_jax(H, K):
    """Row 8's plain version: raw scores against ``repro.kernels.ref`` and
    the JAX ``ops.head_score`` (Pallas interpret, 16-key tiles)."""
    rng = np.random.default_rng(8)
    B, Sb, S, dh = 3, 4, 48, 16
    q = rng.standard_normal((B, Sb, H, dh)).astype(np.float32)
    kf = rng.standard_normal((B, S, K, dh)).astype(np.float32)
    ref = jops.head_score(jnp.asarray(q), jnp.asarray(kf), s_tile=16)
    out = tops.head_score(_t(q), _t(kf))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    want = jref.head_score(jnp.asarray(_gqa_rows(q, K)),
                           jnp.asarray(kf.transpose(0, 2, 1, 3)))
    got = SP.head_score_plain(_t(_gqa_rows(q, K)),
                              _t(kf.transpose(0, 2, 1, 3)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_wrappers_count_plain_calls_on_cpu():
    build.reset_counters()
    tops.fused_logit_argmax(torch.zeros(4, 8), torch.zeros(8, 16))
    c = build.COUNTERS["fused_logit_argmax"]
    assert (c.plain_calls, c.launches) == (1, 0)
    z = torch.zeros(1, 1, 8, 16)
    tops.packed_flash_attention_stats(z, z, z,
                                      torch.ones(1, 1, 8, 8, dtype=bool))
    tops.head_score(torch.zeros(1, 8, 1, 16), torch.zeros(1, 16, 1, 16))
    i = torch.zeros(1, 8, dtype=torch.int32)
    tops.flash_refresh_attention(
        torch.zeros(1, 8, 1, 16), torch.zeros(1, 8, 1, 16),
        torch.zeros(1, 8, 1, 16), q_pos=i, kv_pos=i,
        kv_valid=torch.ones(1, 8, dtype=bool), mask_mode="bidirectional",
        window=0, is_local=False, softcap=0.0)
    for name in ("packed_flash_attention", "head_score", "flash_refresh"):
        c = build.COUNTERS[name]
        assert (c.plain_calls, c.launches) == (1, 0), name
