"""The head-score wrappers read the keys in place.

``ops.head_score_varlen`` and ``ops.head_score`` hand their kernel wrapper
the ``[K, T, dh]`` / ``[B, K, S, dh]`` view of the layer's keys, not a copy;
on the CPU the wrapper runs its plain version on that view, and the scores
still equal the JAX package's ``ops.head_score_varlen`` / ``ops.head_score``
(Pallas in interpret mode) on the same numpy inputs, at GQA and MHA. Both
sides compute in float32 and differ only in the order of their sums: 2e-5
on scores of magnitude ~5; -inf positions match exactly. The layout check
the kernel path applies before a launch is a plain function of the
tensor's strides, so it is held here on CPU views.
"""
import torch_testing  # noqa: F401  (the thread cap, before anything builds)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels import select_pack as SP
from repro_torch.kernels.flash_varlen import PAD_SEG

ATOL = 2e-5


def _spy(monkeypatch, name):
    """Record the (q, k) that ``ops`` hands ``SP.<name>``."""
    seen = {}
    real = getattr(SP, name)

    def spy(q, k, *rest):
        seen["q"], seen["k"] = q, k
        return real(q, k, *rest)
    monkeypatch.setattr(SP, name, spy)
    return seen


def _shares_storage(view, base):
    return (view.untyped_storage().data_ptr()
            == base.untyped_storage().data_ptr()
            and view.data_ptr() == base.data_ptr())


@pytest.mark.parametrize("H,K", [(4, 4), (8, 2)])
def test_varlen_scores_read_the_keys_in_place(monkeypatch, H, K):
    rng = np.random.default_rng(17)
    # a one-token request, an empty one (2), one that owns nothing (5)
    lens, pad = [20, 1, 0, 25, 9], 17
    seg = np.concatenate([np.full(n, j, np.int32) for j, n in enumerate(lens)]
                         + [np.full(pad, PAD_SEG, np.int32)])
    T, R, Sb, dh = seg.shape[0], 6, 4, 16
    q = rng.standard_normal((R, Sb, H, dh)).astype(np.float32)
    k = rng.standard_normal((T, K, dh)).astype(np.float32)
    seen = _spy(monkeypatch, "head_score_varlen_call")
    k_flat = torch.from_numpy(k)
    out = tops.head_score_varlen(torch.from_numpy(q), k_flat,
                                 torch.from_numpy(seg)).numpy()
    assert seen["k"].shape == (K, T, dh)
    assert _shares_storage(seen["k"], k_flat)
    assert seen["k"].stride() == (dh, K * dh, 1)
    ref = np.asarray(jops.head_score_varlen(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(seg), s_tile=8))
    assert np.array_equal(np.isinf(out), np.isinf(ref))
    fin = np.isfinite(ref)
    assert fin.sum() == K * sum(lens)
    np.testing.assert_allclose(out[fin], ref[fin], atol=ATOL)


@pytest.mark.parametrize("H,K", [(4, 4), (8, 2)])
def test_padded_scores_read_the_keys_in_place(monkeypatch, H, K):
    rng = np.random.default_rng(18)
    B, Sb, S, dh = 3, 4, 48, 16
    q = rng.standard_normal((B, Sb, H, dh)).astype(np.float32)
    kf = rng.standard_normal((B, S, K, dh)).astype(np.float32)
    seen = _spy(monkeypatch, "head_score_call")
    k_full = torch.from_numpy(kf)
    out = tops.head_score(torch.from_numpy(q), k_full).numpy()
    assert seen["k"].shape == (B, K, S, dh)
    assert _shares_storage(seen["k"], k_full)
    assert seen["k"].stride() == (S * K * dh, dh, K * dh, 1)
    ref = jops.head_score(jnp.asarray(q), jnp.asarray(kf), s_tile=16)
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL)


def _keys(T, K, dh, dtype, extra=0):
    """The [K, T, dh] view of [T, K, dh + extra] keys (dh columns)."""
    return torch.zeros((T, K, dh + extra), dtype=dtype)[..., :dh].permute(
        1, 0, 2)


@pytest.mark.parametrize("view,ok", [
    (lambda: _keys(10, 3, 64, torch.bfloat16), True),
    (lambda: _keys(10, 3, 4, torch.float32), True),
    # a token step of 3·65 bf16 = 390 bytes
    (lambda: _keys(10, 3, 64, torch.bfloat16, extra=1), False),
    # a base 2 bytes past a 16-byte boundary
    (lambda: torch.zeros(3 * 10 * 64 + 1, dtype=torch.bfloat16)[1:]
     .view(3, 10, 64), False),
    # rows of 24 bytes
    (lambda: torch.zeros((3, 10, 12), dtype=torch.bfloat16), False),
    # dh not unit-stride
    (lambda: torch.zeros((3, 64, 10), dtype=torch.bfloat16).transpose(1, 2),
     False),
], ids=["view_bf16", "view_f32", "token_step", "base", "row_bytes",
        "dh_stride"])
def test_layout_check_takes_16_byte_views_only(view, ok):
    k = view()
    if ok:
        SP.check_layout("head_score_varlen", "k", k)
    else:
        with pytest.raises(ValueError, match="head_score_varlen: k"):
            SP.check_layout("head_score_varlen", "k", k)
