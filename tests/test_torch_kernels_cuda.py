"""Each Hopper kernel against its plain PyTorch version on the card.

Needs a CUDA device, ``nvcc`` and the kernels built from
``src/repro_torch/kernels/csrc``; every test takes the ``cuda`` fixture,
which skips with a reason when ``torch.cuda.is_available()`` is False. This
file imports nothing of JAX, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

Tolerances: float32 inputs run in full float32 on both sides (TF32 off), so
only the order of sums differs: 1e-4 on outputs of magnitude ~1. bfloat16
inputs: the kernel rounds the attention probabilities to bfloat16 before
the P·V product, as the reference kernels do, and sums in another order:
2e-2 (the unnormalised output of ``packed_flash_attention``: 2e-2 relative
to its row sums). Argmax ids must match where the top two logits are
apart. The SSD
scan is float32 on both sides, the kernel's chunks of 64 on the tensor
cores (3xTF32) against the plain chunked form at other chunkings: 1e-4
relative to the largest output.
"""
import torch_testing  # noqa: F401  (the thread cap, before anything builds)

import hashlib
import re
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import flash_refresh as FR
from repro_torch.kernels import flash_varlen as FV
from repro_torch.kernels import logit_argmax as LA
from repro_torch.kernels import select_pack as SP
from repro_torch.kernels import ssm_scan as SS


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _stream(lens, pad, dev):
    seg = np.concatenate([np.full(n, j) for j, n in enumerate(lens)]
                         + [np.full(pad, FV.PAD_SEG)]).astype(np.int32)
    pos = np.concatenate([np.arange(n) for n in lens]
                         + [np.zeros(pad)]).astype(np.int32)
    valid = seg != FV.PAD_SEG
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return t(seg), t(pos), t(valid)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("G,dh", [(1, 16), (2, 64), (1, 128), (1, 112),
                                  (8, 256)])
@pytest.mark.parametrize("flags", [dict(), dict(softcap=20.0),
                                   dict(causal=True),
                                   dict(window=5, is_local=True)])
def test_flash_varlen_matches_plain(cuda, dtype, tol, G, dh, flags):
    g = torch.Generator(device=cuda).manual_seed(0)
    seg, pos, valid = _stream([70, 9, 133, 1], pad=43, dev=cuda)
    T, K = seg.shape[0], 2
    q = torch.randn((K, T * G, dh), generator=g, device=cuda).to(dtype)
    k = torch.randn((K, T, dh), generator=g, device=cuda).to(dtype)
    v = torch.randn((K, T, dh), generator=g, device=cuda).to(dtype)
    kw = dict(softcap=flags.get("softcap", 0.0),
              causal=flags.get("causal", False), window=flags.get("window", 0))
    loc = flags.get("is_local", False)
    out = FV.flash_varlen_call(q, k, v, pos, seg, valid, loc, **kw)
    ref = FV.varlen_attention_plain(q, k, v, pos, seg, pos.expand(K, T), seg,
                                    valid.expand(K, T), loc, **kw)
    rows = valid.repeat_interleave(G)
    torch.cuda.synchronize()
    assert (out[:, rows] - ref[:, rows]).abs().max().item() < tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("G", [1, 2])
def test_flash_varlen_cross_matches_plain(cuda, dtype, tol, G):
    g = torch.Generator(device=cuda).manual_seed(1)
    R, Sb, Cr, K, dh = 5, 8, 120, 4, 128
    Tq, Tkv = R * Sb, R * (Cr + Sb)
    q = torch.randn((K, Tq * G, dh), generator=g, device=cuda).to(dtype)
    k = torch.randn((K, Tkv, dh), generator=g, device=cuda).to(dtype)
    v = torch.randn((K, Tkv, dh), generator=g, device=cuda).to(dtype)
    ar = torch.arange(R, dtype=torch.int32, device=cuda)
    q_seg, kv_seg = ar.repeat_interleave(Sb), ar.repeat_interleave(Cr + Sb)
    q_pos = torch.arange(Sb, dtype=torch.int32, device=cuda).repeat(R) + 200
    kv_pos = torch.randint(0, 300, (K, Tkv), generator=g, device=cuda,
                           dtype=torch.int32)
    kv_valid = torch.rand((K, Tkv), generator=g, device=cuda) < 0.6
    # each request's live block, at the block's positions, is valid
    kv_valid.view(K, R, Cr + Sb)[:, :, Cr:] = True
    kv_pos.view(K, R, Cr + Sb)[:, :, Cr:] = q_pos.view(R, Sb)
    for kw in (dict(), dict(causal=True), dict(softcap=10.0)):
        out = FV.flash_varlen_cross_call(q, k, v, q_pos, kv_pos, q_seg,
                                         kv_seg, kv_valid, **kw)
        ref = FV.varlen_attention_plain(q, k, v, q_pos, q_seg, kv_pos,
                                        kv_seg, kv_valid, False, **kw)
        torch.cuda.synchronize()
        assert (out - ref).abs().max().item() < tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("dh", [112])
def test_flash_varlen_cross_causal_dh112_matches_plain(cuda, dtype, tol, dh):
    """zamba2-7b's shared block: MHA (G=1), head_dim 112, causal."""
    g = torch.Generator(device=cuda).manual_seed(5)
    R, Sb, Cr, K = 6, 8, 96, 4
    Tq, Tkv = R * Sb, R * (Cr + Sb)
    q = torch.randn((K, Tq, dh), generator=g, device=cuda).to(dtype)
    k = torch.randn((K, Tkv, dh), generator=g, device=cuda).to(dtype)
    v = torch.randn((K, Tkv, dh), generator=g, device=cuda).to(dtype)
    ar = torch.arange(R, dtype=torch.int32, device=cuda)
    q_seg, kv_seg = ar.repeat_interleave(Sb), ar.repeat_interleave(Cr + Sb)
    q_pos = torch.arange(Sb, dtype=torch.int32, device=cuda).repeat(R) + 100
    kv_pos = torch.randint(0, 200, (K, Tkv), generator=g, device=cuda,
                           dtype=torch.int32)
    kv_valid = torch.rand((K, Tkv), generator=g, device=cuda) < 0.7
    kv_valid.view(K, R, Cr + Sb)[:, :, Cr:] = True
    kv_pos.view(K, R, Cr + Sb)[:, :, Cr:] = q_pos.view(R, Sb)
    out = FV.flash_varlen_cross_call(q, k, v, q_pos, kv_pos, q_seg, kv_seg,
                                     kv_valid, causal=True)
    ref = FV.varlen_attention_plain(q, k, v, q_pos, q_seg, kv_pos, kv_seg,
                                    kv_valid, False, causal=True)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() < tol


def _cross_stream(dev, g, R, Sb, Cr, K, G, dh, pad_rows=0):
    """A packed Reuse stream: R requests of Sb query tokens against their
    Cr retained keys (random positions, 60% valid) and their live block
    (valid, at the block's positions), then pad_rows PAD_SEG query tokens;
    no key carries PAD_SEG. bfloat16."""
    Tq, Tkv = R * Sb + pad_rows, R * (Cr + Sb)
    bf = torch.bfloat16
    q = torch.randn((K, Tq * G, dh), generator=g, device=dev).to(bf)
    k = torch.randn((K, Tkv, dh), generator=g, device=dev).to(bf)
    v = torch.randn((K, Tkv, dh), generator=g, device=dev).to(bf)
    ar = torch.arange(R, dtype=torch.int32, device=dev)
    pad = torch.full((pad_rows,), FV.PAD_SEG, dtype=torch.int32, device=dev)
    q_seg = torch.cat([ar.repeat_interleave(Sb), pad])
    kv_seg = ar.repeat_interleave(Cr + Sb)
    blk = torch.arange(Sb, dtype=torch.int32, device=dev).repeat(R) + 200
    q_pos = torch.cat([blk, torch.zeros_like(pad)])
    kv_pos = torch.randint(0, 300, (K, Tkv), generator=g, device=dev,
                           dtype=torch.int32)
    kv_valid = torch.rand((K, Tkv), generator=g, device=dev) < 0.6
    kv_valid.view(K, R, Cr + Sb)[:, :, Cr:] = True
    kv_pos.view(K, R, Cr + Sb)[:, :, Cr:] = blk.view(R, Sb)
    return q, k, v, q_pos, kv_pos, q_seg, kv_seg, kv_valid


@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("dh", FV.HEAD_DIMS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("splits", [None, 1])
def test_flash_varlen_bf16_windows_match_plain(cuda, G, dh, causal, splits):
    """The bfloat16 Hopper tile on windows that start off the 64-key grid
    (segments at keys 70, 79, 212, 462) and segments that straddle the
    128-row tile boundaries, at the chooser's split count (> 1 here: two
    KV heads leave the card idle) and at one split."""
    g = torch.Generator(device=cuda).manual_seed(12)
    seg, pos, valid = _stream([70, 9, 133, 250, 1], pad=50, dev=cuda)
    T, K, bf = seg.shape[0], 2, torch.bfloat16
    assert FV.kv_splits(T * G, K, T, build.sm_count(cuda), dh=dh) > 1
    q = torch.randn((K, T * G, dh), generator=g, device=cuda).to(bf)
    k = torch.randn((K, T, dh), generator=g, device=cuda).to(bf)
    v = torch.randn((K, T, dh), generator=g, device=cuda).to(bf)
    out = FV._launch(FV.SELF, q, k, v, pos, seg, pos, seg, valid, 0, False,
                     0.0, causal, 0, splits=splits)
    ref = FV.varlen_attention_plain(q, k, v, pos, seg, pos.expand(K, T), seg,
                                    valid.expand(K, T), False, causal=causal)
    torch.cuda.synchronize()
    rows = valid.repeat_interleave(G)
    assert torch.isfinite(out).all()
    assert (out[:, rows] - ref[:, rows]).abs().max().item() < 2e-2


@pytest.mark.parametrize("splits", [None, 1, 3])
@pytest.mark.parametrize("G", [1, 2])
def test_flash_varlen_cross_bf16_empty_window_is_finite(cuda, splits, G):
    """A cross stream whose last row tile holds only PAD_SEG rows while no
    key carries PAD_SEG: that tile's key window is empty, and its rows
    (junk by contract) are finite; the real rows match the plain version."""
    g = torch.Generator(device=cuda).manual_seed(13)
    args = _cross_stream(cuda, g, R=5, Sb=8, Cr=40, K=2, G=G, dh=64,
                         pad_rows=220)
    q, k, v, q_pos, kv_pos, q_seg, kv_seg, kv_valid = args
    assert q.shape[1] > FV.BM and q_seg[FV.BM // G:].eq(FV.PAD_SEG).all()
    out = FV._launch(FV.CROSS, q, k, v, q_pos, q_seg, kv_pos, kv_seg,
                     kv_valid, k.shape[1], False, 0.0, False, 0,
                     splits=splits)
    ref = FV.varlen_attention_plain(q, k, v, q_pos, q_seg, kv_pos, kv_seg,
                                    kv_valid, False)
    torch.cuda.synchronize()
    real = (q_seg != FV.PAD_SEG).repeat_interleave(G)
    assert torch.isfinite(out).all()
    assert (out[:, real] - ref[:, real]).abs().max().item() < 2e-2


@pytest.mark.parametrize("splits", [2, 8, 30])
@pytest.mark.parametrize("G,dh", [(1, 128), (2, 112), (4, 32), (5, 128),
                                  (8, 256)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_varlen_cross_bf16_splits_match_plain(cuda, splits, G, dh,
                                                    causal):
    """Forced split counts over a 3-tile key stream: 8 and 30 splits leave
    shares empty (their partials are (0, -inf, 0) and fold to nothing)."""
    g = torch.Generator(device=cuda).manual_seed(14)
    args = _cross_stream(cuda, g, R=3, Sb=8, Cr=40, K=2, G=G, dh=dh)
    q, k, v, q_pos, kv_pos, q_seg, kv_seg, kv_valid = args
    out = FV._launch(FV.CROSS, q, k, v, q_pos, q_seg, kv_pos, kv_seg,
                     kv_valid, k.shape[1], False, 0.0, causal, 0,
                     splits=splits)
    ref = FV.varlen_attention_plain(q, k, v, q_pos, q_seg, kv_pos, kv_seg,
                                    kv_valid, False, causal=causal)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() < 2e-2


@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_varlen_cross_llada_reuse_shape_matches_plain(cuda, G, causal):
    """llada-8b's packed Reuse: 12 requests of an 8-token block against
    128 retained keys each, K = 32, dh = 128, at the chooser's splits."""
    g = torch.Generator(device=cuda).manual_seed(15)
    args = _cross_stream(cuda, g, R=12, Sb=8, Cr=128, K=32, G=G, dh=128)
    q, k, v, q_pos, kv_pos, q_seg, kv_seg, kv_valid = args
    splits = FV.kv_splits(q.shape[1], 32, k.shape[1], build.sm_count(cuda),
                          dh=128)
    assert -(-q.shape[1] // FV.BM) * 32 * splits >= build.sm_count(cuda)
    out = FV.flash_varlen_cross_call(*args, causal=causal)
    ref = FV.varlen_attention_plain(q, k, v, q_pos, q_seg, kv_pos, kv_seg,
                                    kv_valid, False, causal=causal)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() < 2e-2


@pytest.mark.parametrize("splits", [None, 1])
def test_gemma_2b_geometry_bf16_matches_plain(cuda, splits):
    """Rows 1-3 in bfloat16 at gemma-2b's heads: one KV head (K = 1) for
    eight query heads (G = 8), head_dim 256, so the grids are covered by
    row tiles (and V's two column halves) alone: the Refresh stream (T =
    1024 in four requests and a PAD_SEG tail), the Reuse stream (12
    requests of an 8-token block against 128 retained keys) and the C3
    scores of the Refresh stream's 8-token blocks."""
    g = torch.Generator(device=cuda).manual_seed(16)
    K, G, dh, bf = 1, 8, 256, torch.bfloat16
    seg, pos, valid = _stream([256, 250, 240, 230], pad=48, dev=cuda)
    T = seg.shape[0]
    q = torch.randn((K, T * G, dh), generator=g, device=cuda).to(bf)
    k = torch.randn((K, T, dh), generator=g, device=cuda).to(bf)
    v = torch.randn((K, T, dh), generator=g, device=cuda).to(bf)
    out = FV._launch(FV.SELF, q, k, v, pos, seg, pos, seg, valid, 0, False,
                     0.0, False, 0, splits=splits)
    ref = FV.varlen_attention_plain(q, k, v, pos, seg, pos.expand(K, T), seg,
                                    valid.expand(K, T), False)
    rows = valid.repeat_interleave(G)
    torch.cuda.synchronize()
    assert (out[:, rows] - ref[:, rows]).abs().max().item() < 2e-2
    args = _cross_stream(cuda, g, R=12, Sb=8, Cr=128, K=K, G=G, dh=dh)
    q, k, v, q_pos, kv_pos, q_seg, kv_seg, kv_valid = args
    out = FV._launch(FV.CROSS, q, k, v, q_pos, q_seg, kv_pos, kv_seg,
                     kv_valid, k.shape[1], False, 0.0, False, 0,
                     splits=splits)
    ref = FV.varlen_attention_plain(q, k, v, q_pos, q_seg, kv_pos, kv_seg,
                                    kv_valid, False)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() < 2e-2
    qs = torch.randn((4, K, 8 * G, dh), generator=g, device=cuda).to(bf)
    ks = torch.randn((K, T, dh), generator=g, device=cuda).to(bf)
    out = SP.head_score_varlen_call(qs, ks, seg)
    ref = SP.head_score_varlen_plain(qs, ks, seg)
    torch.cuda.synchronize()
    assert torch.equal(torch.isinf(out), torch.isinf(ref))
    fin = torch.isfinite(ref)
    scale = ref[fin].abs().max().item()
    assert (out[fin] - ref[fin]).abs().max().item() < 1e-3 * max(1.0, scale)


@pytest.mark.parametrize("splits", [None, 1])
def test_qwen25_14b_geometry_bf16_matches_plain(cuda, splits):
    """Rows 1-3 in bfloat16 at qwen2.5-14b's heads (K = 8, G = 5, head_dim
    128): 128 is no multiple of 5, so the 128-row tiles cut tokens' query
    groups in two (the Reuse stream's 480 rows at 128, 256 and 384): the
    Refresh stream, the Reuse stream (12 requests of an 8-token block
    against 128 retained keys) and the C3 scores (Rq = 40)."""
    g = torch.Generator(device=cuda).manual_seed(18)
    K, G, dh, bf = 8, 5, 128, torch.bfloat16
    seg, pos, valid = _stream([256, 250, 240, 230], pad=48, dev=cuda)
    T = seg.shape[0]
    q = torch.randn((K, T * G, dh), generator=g, device=cuda).to(bf)
    k = torch.randn((K, T, dh), generator=g, device=cuda).to(bf)
    v = torch.randn((K, T, dh), generator=g, device=cuda).to(bf)
    out = FV._launch(FV.SELF, q, k, v, pos, seg, pos, seg, valid, 0, False,
                     0.0, False, 0, splits=splits)
    ref = FV.varlen_attention_plain(q, k, v, pos, seg, pos.expand(K, T), seg,
                                    valid.expand(K, T), False)
    rows = valid.repeat_interleave(G)
    torch.cuda.synchronize()
    assert (out[:, rows] - ref[:, rows]).abs().max().item() < 2e-2
    args = _cross_stream(cuda, g, R=12, Sb=8, Cr=128, K=K, G=G, dh=dh)
    q, k, v, q_pos, kv_pos, q_seg, kv_seg, kv_valid = args
    assert q.shape[1] % FV.BM and q.shape[1] > FV.BM
    out = FV._launch(FV.CROSS, q, k, v, q_pos, q_seg, kv_pos, kv_seg,
                     kv_valid, k.shape[1], False, 0.0, False, 0,
                     splits=splits)
    ref = FV.varlen_attention_plain(q, k, v, q_pos, q_seg, kv_pos, kv_seg,
                                    kv_valid, False)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() < 2e-2
    qs = torch.randn((4, K, 8 * G, dh), generator=g, device=cuda).to(bf)
    ks = torch.randn((K, T, dh), generator=g, device=cuda).to(bf)
    out = SP.head_score_varlen_call(qs, ks, seg)
    ref = SP.head_score_varlen_plain(qs, ks, seg)
    torch.cuda.synchronize()
    assert torch.equal(torch.isinf(out), torch.isinf(ref))
    fin = torch.isfinite(ref)
    scale = ref[fin].abs().max().item()
    assert (out[fin] - ref[fin]).abs().max().item() < 1e-3 * max(1.0, scale)


@pytest.mark.parametrize("splits", [None, 1, 3])
def test_gemma2_27b_geometry_windowed_softcap_matches_plain(cuda, splits):
    """Rows 1 and 2 in bfloat16 at gemma2-27b's heads (K = 16, G = 2,
    head_dim 128) on a local layer: softcap 50 and a window of 64 that cuts
    the 256-token segments of the Refresh stream and the Reuse stream's
    retained keys (positions 0-299 against a block at 200-207)."""
    g = torch.Generator(device=cuda).manual_seed(17)
    K, G, dh, bf = 16, 2, 128, torch.bfloat16
    kw = dict(softcap=50.0, window=64)
    seg, pos, valid = _stream([256, 250, 240, 230], pad=48, dev=cuda)
    T = seg.shape[0]
    q = torch.randn((K, T * G, dh), generator=g, device=cuda).to(bf) * 4
    k = torch.randn((K, T, dh), generator=g, device=cuda).to(bf) * 4
    v = torch.randn((K, T, dh), generator=g, device=cuda).to(bf)
    out = FV._launch(FV.SELF, q, k, v, pos, seg, pos, seg, valid, 0, True,
                     50.0, False, 64, splits=splits)
    ref = FV.varlen_attention_plain(q, k, v, pos, seg, pos.expand(K, T), seg,
                                    valid.expand(K, T), True, **kw)
    rows = valid.repeat_interleave(G)
    torch.cuda.synchronize()
    assert (out[:, rows] - ref[:, rows]).abs().max().item() < 2e-2
    # the window cuts: the plain version without it differs
    wide = FV.varlen_attention_plain(q, k, v, pos, seg, pos.expand(K, T),
                                     seg, valid.expand(K, T), False,
                                     softcap=50.0)
    assert (wide[:, rows] - ref[:, rows]).abs().max().item() > 0.1
    args = _cross_stream(cuda, g, R=12, Sb=8, Cr=128, K=K, G=G, dh=dh)
    q, k, v, q_pos, kv_pos, q_seg, kv_seg, kv_valid = args
    out = FV._launch(FV.CROSS, q, k, v, q_pos, q_seg, kv_pos, kv_seg,
                     kv_valid, k.shape[1], True, 50.0, False, 64,
                     splits=splits)
    ref = FV.varlen_attention_plain(q, k, v, q_pos, q_seg, kv_pos, kv_seg,
                                    kv_valid, True, **kw)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() < 2e-2


def test_varlen_wrappers_refuse_what_the_tile_cannot_take(cuda):
    """The bfloat16 kernel loads by TMA: a base that is not 16-byte aligned
    raises with the kernel's name (no fallback); float32 takes no split."""
    seg, pos, valid = _stream([20], pad=0, dev=cuda)
    buf = torch.zeros(2 * 20 * 64 + 1, dtype=torch.bfloat16, device=cuda)
    odd = buf[1:].view(1, 40, 64)              # 2 bytes past an aligned base
    z = torch.zeros((1, 20, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="flash_varlen.*16-byte"):
        FV.flash_varlen_call(odd[:, :20], z, z, pos, seg, valid)
    zf = z.float()
    with pytest.raises(ValueError, match="flash_varlen"):
        FV._launch(FV.SELF, zf, zf, zf, pos, seg, pos, seg, valid, 0, False,
                   0.0, False, 0, splits=2)


REFRESH_FLAGS = {"plain": (dict(), False),
                 "causal_softcap": (dict(causal=True, softcap=20.0), False),
                 "window_local": (dict(window=5), True)}
# the head dims the full-window tile took (256 came later, with key windows)
REFRESH_DIMS = (16, 32, 64, 112, 128)


def refresh_digests(dev):
    """sha256 (16 hex digits) of flash_refresh's bfloat16 output at every
    head_dim of REFRESH_DIMS and three flag sets: G = 2, S = 150 (a ragged
    last KV tile), kv_valid holes; inputs from numpy, so any checkout's
    kernel can be held to the same bytes."""
    out = {}
    for dh in REFRESH_DIMS:
        for name, (kw, loc) in REFRESH_FLAGS.items():
            rng = np.random.default_rng(11)
            B, K, S, G = 2, 2, 150, 2

            def bf(*shape):
                x = rng.standard_normal(shape).astype(np.float32)
                return torch.from_numpy(x).to(torch.bfloat16).to(dev)
            q, k, v = bf(B, K, S * G, dh), bf(B, K, S, dh), bf(B, K, S, dh)
            pos = torch.arange(S, dtype=torch.int32).repeat(B, 1).to(dev)
            valid = torch.from_numpy(rng.random((B, S)) < 0.8).to(dev)
            o = FR.flash_refresh_call(q, k, v, pos, pos, valid, loc, **kw)
            out[f"{dh}/{name}"] = hashlib.sha256(
                o.cpu().numpy().tobytes()).hexdigest()[:16]
    return out


# refresh_digests of the tile before it took key windows (every CTA over
# all S keys), printed by this file run as a script with PYTHONPATH at that
# tree's src: NVIDIA H100 80GB HBM3, kernels built for sm_90a by the nvcc
# release below. Another compiler may schedule the tile's float operations
# otherwise; take the digests anew from the older tile with it.
REFRESH_NVCC = "12.9"
REFRESH_DIGESTS = {
    "16/plain": "7b5bfb5dfd0a50d7",
    "16/causal_softcap": "9320ab59d91029ec",
    "16/window_local": "0a82c33fa056d908",
    "32/plain": "f75109a04a38f20c",
    "32/causal_softcap": "d89fe4cbe319b618",
    "32/window_local": "9f4bc0827a84da86",
    "64/plain": "ee5e6310c12a6530",
    "64/causal_softcap": "41924e7866324ec4",
    "64/window_local": "1fe64a1c858a4bfc",
    "112/plain": "9bd926d94a32806f",
    "112/causal_softcap": "2530ccdaeb904e69",
    "112/window_local": "8e79e4fded7a5f28",
    "128/plain": "6a2399cd0fc37661",
    "128/causal_softcap": "7d40fdb6d6150a83",
    "128/window_local": "10ddfb66c101c892",
}


def test_flash_refresh_bf16_bit_identical_to_the_full_window_tile(cuda):
    """flash_refresh passes the window [0, S) to the windowed tile and
    must give the bytes the tile gave before it took windows."""
    out = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                         text=True).stdout
    release = re.search(r"release (\d+\.\d+)", out)
    if release is None or release.group(1) != REFRESH_NVCC:
        pytest.skip(f"the digests hold for nvcc {REFRESH_NVCC}: take them "
                    f"anew from the older tile with this toolkit")
    assert refresh_digests(cuda) == REFRESH_DIGESTS


# streams for row 3: ragged segments with an empty request (2), a PAD_SEG
# tail and requests that own nothing (6, 7), T = 320; a tile of 64
# one-token owners; T = 135 (not a multiple of the 64-key tile or of 4)
HEAD_SCORE_STREAMS = {"ragged": ([70, 9, 0, 133, 1, 64], 43, 8),
                      "one_token": ([1] * 150 + [3], 0, 151),
                      "odd_T": ([50, 77, 3], 5, 4)}


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-3)])
@pytest.mark.parametrize("Rq,dh,sign", [(8, 128, 1), (40, 16, 1),
                                        (8, 112, 1), (8, 72, 1),
                                        (8, 256, 1), (12, 128, -1),
                                        (40, 64, -1)])
@pytest.mark.parametrize("stream", list(HEAD_SCORE_STREAMS))
@pytest.mark.parametrize("keys", ["contiguous", "permuted"])
def test_head_score_matches_plain(cuda, dtype, tol, Rq, dh, sign, stream,
                                  keys):
    """Row 3. ``sign = -1``: every score negative (q = -|q|, k = |k|), so
    a padded query column that scored 0 would win the max. ``permuted``:
    the keys as the [K, T, dh] view of a [T, K, dh] tensor, read in
    place."""
    g = torch.Generator(device=cuda).manual_seed(2)
    lens, pad, R = HEAD_SCORE_STREAMS[stream]
    seg, _, _ = _stream(lens, pad=pad, dev=cuda)
    K, T = 3, seg.shape[0]
    q = torch.randn((R, K, Rq, dh), generator=g, device=cuda)
    k = torch.randn((K, T, dh), generator=g, device=cuda)
    if sign < 0:
        q, k = -q.abs(), k.abs()
    q, k = q.to(dtype), k.to(dtype)
    if keys == "permuted":
        k = k.permute(1, 0, 2).contiguous().permute(1, 0, 2)
        assert not k.is_contiguous()
    out = SP.head_score_varlen_call(q, k, seg)
    ref = SP.head_score_varlen_plain(q, k, seg)
    torch.cuda.synchronize()
    assert torch.equal(torch.isinf(out), torch.isinf(ref))
    fin = torch.isfinite(ref)
    assert fin.sum().item() == K * sum(lens)
    # products of bf16 values are exact in float32; only sum order differs
    scale = ref[fin].abs().max().item()
    assert (out[fin] - ref[fin]).abs().max().item() < tol * max(1.0, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["dv", "vd"])
@pytest.mark.parametrize("T,D,V,softcap", [(100, 64, 1000, 0.0),
                                           (257, 96, 5003, 15.0)])
def test_logit_argmax_matches_plain(cuda, dtype, layout, T, D, V, softcap):
    g = torch.Generator(device=cuda).manual_seed(3)
    h = torch.randn((T, D), generator=g, device=cuda).to(dtype)
    w = (torch.randn((D, V), generator=g, device=cuda) * 0.2).to(dtype)
    w[:, 17] = w[:, V - 3]                     # an exact tie in every row
    if layout == "vd":
        w = w.t().contiguous()
    valid = torch.ones(T, dtype=torch.bool, device=cuda)
    valid[128:256] = False                     # an all-padding T tile
    idx, m, s = LA.fused_logit_argmax_call(h, w, valid, softcap=softcap,
                                           w_layout=layout)
    ri, rm, rs = LA.fused_logit_argmax_plain(h, w, softcap=softcap,
                                             w_layout=layout)
    torch.cuda.synchronize()
    assert (idx[~valid] == 0).all() and torch.isinf(m[~valid]).all()
    z = (h.float() @ (w.float() if layout == "dv" else w.float().t()))
    if softcap:
        z = softcap * torch.tanh(z / softcap)
    top2 = z.topk(2, dim=1).values
    clear = valid & ((top2[:, 0] - top2[:, 1]) > 1e-3)
    assert torch.equal(idx[clear], ri[clear])
    tie = valid & (ri == 17)                   # the lowest tied index wins
    assert torch.equal(idx[tie], ri[tie])
    torch.testing.assert_close(m[valid], rm[valid], rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(s[valid], rs[valid], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout,D,V", [("dv", 96, 5003), ("vd", 96, 5003),
                                        ("dv", 64, 2040),
                                        ("vd", 768, 50280)])
@pytest.mark.parametrize("T", [1, 8, 40, 128])
def test_logit_argmax_serving_buckets_match_plain(cuda, dtype, layout, D, V,
                                                  T):
    """The serving buckets' T (one T tile of 8-128 columns) against a
    vocabulary ragged against the 128-wide tile: V = 5003 (rows not
    16-byte aligned in the [D, V] layout: the plain-load path), V = 2040
    (aligned, ragged), and mamba2-130m's tied [V, D] head (50,280 x 768).
    Column 17 ties column V - 3 in every row: the lowest index wins."""
    g = torch.Generator(device=cuda).manual_seed(9)
    h = torch.randn((T, D), generator=g, device=cuda).to(dtype)
    w = (torch.randn((D, V), generator=g, device=cuda)
         * (2.0 / D ** 0.5)).to(dtype)
    w[:, 17] = w[:, V - 3]
    if layout == "vd":
        w = w.t().contiguous()
    valid = torch.ones(T, dtype=torch.bool, device=cuda)
    if T > 1:
        valid[T // 2] = False                  # one padding row
    idx, m, s = LA.fused_logit_argmax_call(h, w, valid, w_layout=layout)
    ri, rm, rs = LA.fused_logit_argmax_plain(h, w, w_layout=layout)
    torch.cuda.synchronize()
    z = (h.float() @ (w.float() if layout == "dv" else w.float().t()))
    top2 = z.topk(2, dim=1).values
    clear = valid & ((top2[:, 0] - top2[:, 1]) > 1e-3)
    assert torch.equal(idx[clear], ri[clear])
    tie = valid & (ri == 17)
    assert torch.equal(idx[tie], ri[tie])
    torch.testing.assert_close(m[valid], rm[valid], rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(s[valid], rs[valid], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("T,H,P,N", [(96, 3, 8, 16), (320, 5, 64, 64),
                                     (256, 4, 64, 128), (64, 2, 16, 32)])
def test_ssm_segment_scan_matches_plain(cuda, T, H, P, N):
    """Resets inside chunks and on chunk edges; captures at -1, at a chunk
    edge, inside a chunk, at the last row and past the stream (zero)."""
    g = torch.Generator(device=cuda).manual_seed(4)
    xdt = torch.randn((T, H, P), generator=g, device=cuda)
    dA = -0.01 - torch.rand((T, H), generator=g, device=cuda)
    Bm = torch.randn((T, N), generator=g, device=cuda)
    Cm = torch.randn((T, N), generator=g, device=cuda)
    reset = torch.zeros(T, device=cuda)
    reset[[0, 5, 32, 33, T - 1]] = 1.0
    cap_rows = torch.tensor([-1, 4, 31, 32, T - 1, T + 5, 17],
                            dtype=torch.int32, device=cuda)
    got = SS.ssm_segment_scan_call(xdt, dA, Bm, Cm, reset, cap_rows)
    for chunk in (16, 32):
        want = SS.ssm_segment_scan_plain(xdt, dA, Bm, Cm, reset, cap_rows,
                                         chunk)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            scale = max(1.0, b.abs().max().item())
            assert (a - b).abs().max().item() < 1e-4 * scale
    assert not got[1][0].any() and not got[1][5].any()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("G,Sm,dh", [(1, 8, 128), (2, 8, 64), (4, 1, 16),
                                     (1, 8, 112), (8, 1, 256)])
@pytest.mark.parametrize("T", [40, 128, 248])
def test_packed_flash_attention_matches_plain(cuda, dtype, tol, G, Sm, dh,
                                              T):
    """Ragged last KV tile (T = 40, 248), GQA rows reading mask row
    r // G, a one-row mask (Sm = 1), softcap, and a head whose keys are all
    masked (m = -1e30, s = T, as the Pallas kernel gives it)."""
    g = torch.Generator(device=cuda).manual_seed(6)
    B, K, Sb = 3, 2, 8
    R = Sb * G
    q = torch.randn((B, K, R, dh), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, K, T, dh), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, K, T, dh), generator=g, device=cuda).to(dtype)
    mask = torch.rand((B, K, Sm, T), generator=g, device=cuda) < 0.6
    mask[1, 0] = False
    for softcap in (0.0, 30.0):
        o, m, s = FA.packed_flash_attention_call(q, k, v, mask,
                                                 softcap=softcap)
        ro, rm, rs = FA.packed_attention_plain(q, k, v, mask,
                                               softcap=softcap)
        torch.cuda.synchronize()
        assert (m[1, 0] == -1e30).all() and (s[1, 0] == T).all()
        assert (m - rm).abs().max().item() < 1e-4
        assert ((s - rs).abs() / rs).max().item() < tol
        assert ((o - ro).abs() / rs[..., None]).max().item() < tol


@pytest.mark.parametrize("T", [248, 128])
def test_packed_flash_attention_zamba2_causal_reuse_bf16(cuda, T):
    """Row 6 at zamba2-7b's padded Reuse under the baselines: B = 16 (the
    pow2 bucket of 12 slots), K = 32, G = 1 (R = Sb = 8 rows), dh = 112,
    bfloat16, the retained T of retention 1.0 (248) and 0.5 (128), and the
    shared block's causal mask rows (Sm = Sb): a query sees a cached key
    only at a position at or before its own. Row 0's block starts at 0
    (every row fully masked), row 1 is a padding row (no valid key), the
    others start deeper with keys on both sides of the block."""
    g = torch.Generator(device=cuda).manual_seed(11)
    B, K, Sb, dh, bf = 16, 32, 8, 112, torch.bfloat16
    q = torch.randn((B, K, Sb, dh), generator=g, device=cuda).to(bf)
    k = torch.randn((B, K, T, dh), generator=g, device=cuda).to(bf)
    v = torch.randn((B, K, T, dh), generator=g, device=cuda).to(bf)
    # retained positions of a 256-token sequence outside the active block
    # (Refresh excludes it), block starts on block edges
    start = 8 * torch.randint(1, 31, (B,), generator=g, device=cuda)
    start[0] = 0
    cpos = torch.rand((B, K, 256 - Sb), generator=g,
                      device=cuda).argsort(-1)[..., :T]
    cpos += Sb * (cpos >= start[:, None, None])
    valid = torch.rand((B, K, T), generator=g, device=cuda) < 0.9
    valid[1] = False
    qpos = start[:, None] + torch.arange(Sb, device=cuda)
    mask = valid[:, :, None, :] & (qpos[:, None, :, None]
                                   >= cpos[:, :, None, :])
    assert not mask[:2].any() and mask[2:].any()
    o, m, s = FA.packed_flash_attention_call(q, k, v, mask)
    ro, rm, rs = FA.packed_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert (m[:2] == -1e30).all() and (s[:2] == T).all()
    assert (m - rm).abs().max().item() < 1e-4
    assert ((s - rs).abs() / rs).max().item() < 2e-2
    assert ((o - ro).abs() / rs[..., None]).max().item() < 2e-2


@pytest.mark.parametrize("S", [150, 2048])
def test_flash_refresh_zamba2_causal_bf16(cuda, S):
    """Row 7 at zamba2-7b's padded prefill: bfloat16, causal, K = 32,
    G = 1, dh = 112; one request's valid keys end 37 before S (a ragged
    tail; at S = 150 also a ragged last KV tile), the other all valid."""
    g = torch.Generator(device=cuda).manual_seed(12)
    B, K, dh, bf = 2, 32, 112, torch.bfloat16
    q = torch.randn((B, K, S, dh), generator=g, device=cuda).to(bf)
    k = torch.randn((B, K, S, dh), generator=g, device=cuda).to(bf)
    v = torch.randn((B, K, S, dh), generator=g, device=cuda).to(bf)
    pos = torch.arange(S, dtype=torch.int32, device=cuda).repeat(B, 1)
    valid = torch.ones((B, S), dtype=torch.bool, device=cuda)
    valid[0, S - 37:] = False
    out = FR.flash_refresh_call(q, k, v, pos, pos, valid, causal=True)
    ref = FR.refresh_attention_plain(q, k, v, pos, pos, valid, False,
                                     causal=True)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() < 2e-2


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("G,dh", [(1, 128), (2, 64), (1, 112), (4, 16),
                                  (8, 256)])
@pytest.mark.parametrize("flags", [dict(), dict(softcap=20.0),
                                   dict(causal=True),
                                   dict(window=5, is_local=True),
                                   dict(window=5, is_local=False)])
def test_flash_refresh_matches_plain(cuda, dtype, tol, G, dh, flags):
    """S = 150 (a ragged last tile), kv_valid holes, a batch row with no
    valid key (averages V, as the reference does)."""
    g = torch.Generator(device=cuda).manual_seed(7)
    B, K, S = 3, 2, 150
    q = torch.randn((B, K, S * G, dh), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, K, S, dh), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, K, S, dh), generator=g, device=cuda).to(dtype)
    pos = torch.arange(S, dtype=torch.int32, device=cuda).repeat(B, 1)
    valid = torch.rand((B, S), generator=g, device=cuda) < 0.8
    valid[2] = False
    kw = dict(softcap=flags.get("softcap", 0.0),
              causal=flags.get("causal", False), window=flags.get("window", 0))
    loc = flags.get("is_local", False)
    out = FR.flash_refresh_call(q, k, v, pos, pos, valid, loc, **kw)
    ref = FR.refresh_attention_plain(q, k, v, pos, pos, valid, loc, **kw)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() < tol


@pytest.mark.parametrize("dh", FV.HEAD_DIMS)
@pytest.mark.parametrize("S", [150, 2048])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_refresh_bf16_ragged_tail_matches_plain(cuda, dh, S, causal):
    """The bfloat16 path (the Hopper tile) at every head_dim: a ragged last
    KV tile (S = 150), a request whose valid keys end 37 before S, one with
    holes, and one with no valid key (averages V over all S keys)."""
    g = torch.Generator(device=cuda).manual_seed(10)
    B, K, bf = 3, 2, torch.bfloat16
    q = torch.randn((B, K, S, dh), generator=g, device=cuda).to(bf)
    k = torch.randn((B, K, S, dh), generator=g, device=cuda).to(bf)
    v = torch.randn((B, K, S, dh), generator=g, device=cuda).to(bf)
    pos = torch.arange(S, dtype=torch.int32, device=cuda).repeat(B, 1)
    valid = torch.ones((B, S), dtype=torch.bool, device=cuda)
    valid[0, S - 37:] = False
    valid[1] = torch.rand(S, generator=g, device=cuda) < 0.7
    valid[2] = False
    out = FR.flash_refresh_call(q, k, v, pos, pos, valid, causal=causal)
    ref = FR.refresh_attention_plain(q, k, v, pos, pos, valid, False,
                                     causal=causal)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() < 2e-2


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-3)])
@pytest.mark.parametrize("B,Rq,S,dh,sign", [
    (4, 8, 256, 128, 1), (4, 40, 100, 16, 1), (4, 8, 77, 112, 1),
    (4, 8, 300, 72, 1), (2, 8, 130, 256, 1), (3, 12, 100, 128, -1),
    (3, 40, 33, 64, -1), (1, 8, 1, 128, 1)])
@pytest.mark.parametrize("keys", ["contiguous", "permuted"])
def test_head_score_padded_matches_plain(cuda, dtype, tol, B, Rq, S, dh,
                                         sign, keys):
    """Row 8, as row 3: all-negative scores with ``sign = -1``, ragged key
    tiles, B = S = 1, and the keys as the [B, K, S, dh] view of a
    [B, S, K, dh] tensor with ``permuted``."""
    g = torch.Generator(device=cuda).manual_seed(8)
    K = 3
    q = torch.randn((B, K, Rq, dh), generator=g, device=cuda)
    k = torch.randn((B, K, S, dh), generator=g, device=cuda)
    if sign < 0:
        q, k = -q.abs(), k.abs()
    q, k = q.to(dtype), k.to(dtype)
    if keys == "permuted":
        k = k.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    out = SP.head_score_call(q, k)
    ref = SP.head_score_plain(q, k)
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    assert (out - ref).abs().max().item() < tol * max(1.0, scale)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    """No fallback on the card: an unsupported head_dim, a CPU tensor in a
    CUDA call, a non-bool mask or a key view the 16-byte loads cannot read
    raises."""
    z = torch.zeros((1, 1, 8, 96), device=cuda)
    mask = torch.ones((1, 1, 8, 8), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        FA.packed_flash_attention_call(z, z[:, :, :8], z[:, :, :8], mask)
    z = torch.zeros((1, 1, 8, 64), device=cuda)
    with pytest.raises(ValueError):
        FA.packed_flash_attention_call(z, z.cpu(), z, mask)
    with pytest.raises(TypeError):
        FA.packed_flash_attention_call(z, z, z, mask.float())
    # head scores read keys in place: a token step of 3·65 bf16 (390
    # bytes) or a base 2 bytes past a boundary raises, with no copy made
    bf = torch.bfloat16
    seg = torch.zeros(10, dtype=torch.int32, device=cuda)
    q = torch.zeros((1, 3, 8, 64), dtype=bf, device=cuda)
    step = torch.zeros((10, 3, 65), dtype=bf, device=cuda)[..., :64]
    with pytest.raises(ValueError, match="head_score_varlen: k.*16-byte"):
        SP.head_score_varlen_call(q, step.permute(1, 0, 2), seg)
    with pytest.raises(ValueError, match="head_score: k.*16-byte"):
        SP.head_score_call(q, step.permute(1, 0, 2)[None])
    base = torch.zeros(3 * 10 * 64 + 1, dtype=bf, device=cuda)[1:]
    with pytest.raises(ValueError, match="head_score_varlen: k.*16-byte"):
        SP.head_score_varlen_call(q, base.view(3, 10, 64), seg)


@pytest.mark.parametrize("dh", FV.HEAD_DIMS)
@pytest.mark.parametrize("T", [40, 128, 248, 1000])
@pytest.mark.parametrize("mask_rows", ["one", "Sb"])
@pytest.mark.parametrize("G", [1, 2, 8])
def test_packed_flash_attention_bf16_tile_matches_plain(cuda, G, mask_rows,
                                                        T, dh):
    """The bfloat16 Hopper tile (query rows on the narrow side of mma.sync,
    a cp.async K/V ring a warp): R = 8, 16, 64 rows, a one-row or an Sb-row
    mask, ragged key tails, every head dim, softcap, and a fully masked
    head (m = -1e30, s = T)."""
    g = torch.Generator(device=cuda).manual_seed(7 * T + dh + G)
    B, K, Sb = 3, 2, 8
    R, Sm = Sb * G, 1 if mask_rows == "one" else Sb
    bf = torch.bfloat16
    q = torch.randn((B, K, R, dh), generator=g, device=cuda).to(bf)
    k = torch.randn((B, K, T, dh), generator=g, device=cuda).to(bf)
    v = torch.randn((B, K, T, dh), generator=g, device=cuda).to(bf)
    mask = torch.rand((B, K, Sm, T), generator=g, device=cuda) < 0.6
    mask[1, 0] = False
    for softcap in (0.0, 30.0):
        o, m, s = FA.packed_flash_attention_call(q, k, v, mask,
                                                 softcap=softcap)
        ro, rm, rs = FA.packed_attention_plain(q, k, v, mask, softcap=softcap)
        torch.cuda.synchronize()
        assert (m[1, 0] == -1e30).all() and (s[1, 0] == T).all()
        assert (m - rm).abs().max().item() < 1e-4
        assert ((s - rs).abs() / rs).max().item() < 2e-2
        assert ((o - ro).abs() / rs[..., None]).max().item() < 2e-2


@pytest.mark.parametrize("B,K", [(2, 3), (16, 40)])
def test_packed_flash_attention_bf16_below_and_above_one_wave(cuda, B, K):
    """llada-8b's padded Reuse rows (R = 8, dh = 128, T = 248, one mask
    row) with 6 groups, a few warps of one CTA, and with 640 groups, more
    than one CTA of four warps on each of 132 SMs."""
    g = torch.Generator(device=cuda).manual_seed(B * K)
    R, T, dh, bf = 8, 248, 128, torch.bfloat16
    q = torch.randn((B, K, R, dh), generator=g, device=cuda).to(bf)
    k = torch.randn((B, K, T, dh), generator=g, device=cuda).to(bf)
    v = torch.randn((B, K, T, dh), generator=g, device=cuda).to(bf)
    mask = torch.rand((B, K, 1, T), generator=g, device=cuda) < 0.97
    o, m, s = FA.packed_flash_attention_call(q, k, v, mask)
    ro, rm, rs = FA.packed_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert (m - rm).abs().max().item() < 1e-4
    assert ((s - rs).abs() / rs).max().item() < 2e-2
    assert ((o - ro).abs() / rs[..., None]).max().item() < 2e-2


@pytest.mark.parametrize("T,H,P,N,chunk", [(200, 4, 64, 128, 8),
                                           (333, 3, 8, 16, 9),
                                           (1024, 112, 64, 64, 32),
                                           (1024, 24, 64, 128, 16)])
def test_ssm_segment_scan_kernel_chunks_match_plain(cuda, T, H, P, N, chunk):
    """The kernel's chunks of 64 against the plain version at another
    chunking: T not a multiple of 64, a reset on the first (64) and on the
    last (127) row of a kernel chunk, captures at -1, on the chunk edge
    (63, 64), inside a chunk, at T - 1 and past T; N = 128; the zamba2-7b
    (H = 112, P = N = 64) and mamba2-130m (H = 24, P = 64, N = 128)
    widths."""
    g = torch.Generator(device=cuda).manual_seed(T + H)
    xdt = torch.randn((T, H, P), generator=g, device=cuda)
    dA = -0.01 - torch.rand((T, H), generator=g, device=cuda)
    Bm = torch.randn((T, N), generator=g, device=cuda)
    Cm = torch.randn((T, N), generator=g, device=cuda)
    reset = torch.zeros(T, device=cuda)
    reset[[0, 64, 127, 150, T - 1]] = 1.0
    cap_rows = torch.tensor([-1, 63, 64, 100, T - 1, T + 5], dtype=torch.int32,
                            device=cuda)
    got = SS.ssm_segment_scan_call(xdt, dA, Bm, Cm, reset, cap_rows)
    want = SS.ssm_segment_scan_plain(xdt, dA, Bm, Cm, reset, cap_rows, chunk)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        scale = max(1.0, b.abs().max().item())
        assert (a - b).abs().max().item() < 1e-4 * scale
    assert not got[1][0].any() and not got[1][5].any()


def test_launches_are_counted(cuda):
    build.reset_counters()
    h = torch.zeros((4, 16), device=cuda)
    LA.fused_logit_argmax_call(h, torch.zeros((16, 256), device=cuda),
                               torch.ones(4, dtype=torch.bool, device=cuda))
    c = build.COUNTERS["fused_logit_argmax"]
    assert (c.launches, c.plain_calls) == (1, 0)
    z = torch.zeros((1, 1, 8, 16), device=cuda)
    i = torch.zeros((1, 8), dtype=torch.int32, device=cuda)
    ones = torch.ones((1, 8), dtype=torch.bool, device=cuda)
    FA.packed_flash_attention_call(z, z, z, ones.view(1, 1, 1, 8))
    FR.flash_refresh_call(z, z, z, i, i, ones)
    SP.head_score_call(z, z)
    for name in ("packed_flash_attention", "flash_refresh", "head_score"):
        c = build.COUNTERS[name]
        assert (c.launches, c.plain_calls) == (1, 0), name


if __name__ == "__main__":
    # the digests of whichever package PYTHONPATH names, for REFRESH_DIGESTS
    import json
    print(json.dumps(refresh_digests(torch.device("cuda")), indent=1))
