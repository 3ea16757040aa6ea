"""The port's kernel wrappers, on CPU tensors (their plain PyTorch versions),
against the JAX package's kernel wrappers (Pallas in interpret mode) on the
same numpy inputs. The kernel-vs-plain cases on the card are in
``test_torch_kernels_cuda.py``.

Tolerances: both sides compute in float32 on the CPU and differ only in the
order of their sums (online vs whole-row softmax, tiled vs whole matmuls),
so outputs of magnitude ~1 agree to a few 1e-6; 2e-5 leaves headroom.
Argmax ids and -inf positions must match exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import build
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


def test_wrappers_count_plain_calls_on_cpu():
    build.reset_counters()
    tops.fused_logit_argmax(torch.zeros(4, 8), torch.zeros(8, 16))
    c = build.COUNTERS["fused_logit_argmax"]
    assert (c.plain_calls, c.launches) == (1, 0)
