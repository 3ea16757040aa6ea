"""The port's packed serving stages against ``repro.models`` on the same
weights (``repro.models.backbone.init_params``, bridged through numpy) and
the same packed streams, with the JAX kernels in interpret mode and the
port's kernel wrappers on their plain versions.

Tolerance: float32 on both sides; the order of sums differs in every matmul,
softmax and norm of the 3-layer reduced model, which moves hidden states of
magnitude ~1 by ~1e-6 per layer; 1e-4 leaves headroom. Retained positions,
their validity and decoded ids must match exactly.
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
from repro.models import lm_head as JLM
from repro.models import transformer as JT
from repro_torch.configs import get_config, reduced as treduced
from repro_torch.kernels.flash_varlen import PAD_SEG
from repro_torch.models import backbone as TBB
from repro_torch.models import lm_head as TLM
from repro_torch.models import transformer as TT
from repro_torch.params import from_jax

ATOL = 1e-4
SB, S_MAX, RETAIN = 8, 64, 32
LENS = [40, 25, 33]          # three requests in one packed Refresh stream


def _cfgs(kv_heads):
    j = reduced(ARCHS["llada-8b"], n_kv_heads=kv_heads)
    t = treduced(get_config("llada-8b"), n_kv_heads=kv_heads)
    return j, t


def _params(jcfg, tcfg):
    jp = JBB.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _ctx(mod):
    return mod.ServeContext(block_size=SB, retain=RETAIN, kernel_size=3,
                            selection="head", use_flash_kernel=True,
                            max_seq_len=S_MAX)


def _refresh_stream(V, seed=0):
    """Engine-shaped packed Refresh inputs: a 128-token bucket with a
    PAD_SEG tail and one padding request (cu at the tail, length 0)."""
    rng = np.random.default_rng(seed)
    tp, rp = 128, 4
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
        bstart[j] = n - 2 * SB + j          # somewhere inside the sequence
        off += n
    return tokens, pos, seg, valid, cu, lens, bstart


def _refresh_both(kv_heads):
    jcfg, tcfg = _cfgs(kv_heads)
    jp, tp = _params(jcfg, tcfg)
    args = _refresh_stream(jcfg.vocab_size)
    ref = jax.jit(lambda p, *a: JBB.serve_refresh_packed(
        p, jcfg, *a, _ctx(JT)))(jp, *map(jnp.asarray, args))
    out = TBB.serve_refresh_packed(
        tp, tcfg, *map(torch.from_numpy, args), _ctx(TT))
    return jcfg, tcfg, jp, tp, ref, out


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_serve_refresh_packed_matches_reference(kv_heads):
    *_, ref, out = _refresh_both(kv_heads)
    n = len(LENS)
    np.testing.assert_allclose(out.block_hidden.numpy()[:n],
                               np.asarray(ref.block_hidden)[:n], atol=ATOL)
    rc = jax.tree.map(np.asarray, ref.cache)
    tc = [t.numpy() for t in out.cache]
    assert np.array_equal(tc[2][:, :n], rc.pos[:, :n])
    assert np.array_equal(tc[3][:, :n], rc.valid[:, :n])
    ok = rc.valid[:, :n]
    assert ok.sum() > 0
    # invalid retained rows may point at padding rows, junk on both sides
    for got, want in ((tc[0], rc.k), (tc[1], rc.v)):
        np.testing.assert_allclose(got[:, :n][ok], want[:, :n][ok],
                                   atol=ATOL)


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_serve_reuse_packed_matches_reference(kv_heads):
    jcfg, tcfg, jp, tp, ref, out = _refresh_both(kv_heads)
    R = len(LENS)
    rng = np.random.default_rng(5)
    btok = rng.integers(0, jcfg.vocab_size - 1, R * SB).astype(np.int32)
    bpos = np.concatenate([np.arange(b, b + SB) for b in
                           (n - 2 * SB + j for j, n in enumerate(LENS))]
                          ).astype(np.int32)
    jcache = jax.tree.map(lambda x: x[:, :R], ref.cache)
    h_ref = jax.jit(lambda p, a, b, c: JBB.serve_reuse_packed(
        p, jcfg, a, b, c, _ctx(JT)))(jp, jnp.asarray(btok),
                                     jnp.asarray(bpos), jcache)
    # feed the port the reference's cache, so the stage is compared alone
    tcache = type(out.cache)(*[torch.from_numpy(np.array(x))
                               for x in jcache])
    h = TBB.serve_reuse_packed(tp, tcfg, torch.from_numpy(btok),
                               torch.from_numpy(bpos), tcache, _ctx(TT))
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=ATOL)


@pytest.mark.parametrize("n_valid", [40, 17])
def test_decode_tokens_packed_fused_matches_reference(n_valid):
    jcfg, tcfg = _cfgs(4)
    jp, tp = _params(jcfg, tcfg)
    rng = np.random.default_rng(6)
    h = rng.standard_normal((40, jcfg.d_model)).astype(np.float32)
    valid = np.arange(40) < n_valid
    ids_r, conf_r = JLM.decode_tokens_packed(
        jp["embed"], jcfg, jnp.asarray(h), jnp.asarray(valid),
        max_num_logits=16, mode="fused", vocab_tile=64)
    for mode in ("fused", "chunked"):
        ids, conf = TLM.decode_tokens_packed(
            tp["embed"], tcfg, torch.from_numpy(h), torch.from_numpy(valid),
            max_num_logits=16, mode=mode)
        assert np.array_equal(ids.numpy(), np.asarray(ids_r))
        np.testing.assert_allclose(conf.numpy(), np.asarray(conf_r),
                                   rtol=1e-5, atol=1e-7)


def test_init_params_shapes_match_reference():
    jcfg, tcfg = _cfgs(4)
    shapes = jax.tree.map(lambda x: tuple(x.shape),
                          JBB.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = TBB.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    got = {n: tuple(p.shape) for n, p in tp.named_parameters()}
    want = {"final_norm": shapes["final_norm"],
            **{f"embed.{k}": v for k, v in shapes["embed"].items()},
            **{f"stack.{k}": v for k, v in shapes["stack"].items()}}
    assert got == want
    assert float(tp["stack"]["attn_norm"].abs().max()) == 0.0
    assert 0.015 < float(tp["stack"]["wq"].std()) < 0.025


def test_unported_paths_raise():
    """The MoE layers' expert-parallel strategy needs a serving mesh: both
    Refresh paths refuse it without one, as the reference's asserts one
    (it serves on a mesh, see ``test_torch_moe_mesh.py``); an unknown
    logit mode is refused."""
    _, tcfg = _cfgs(4)
    moe = dataclasses.replace(tcfg, family="moe", n_experts=4,
                              experts_per_token=2, moe_impl="ep")
    tp = TBB.init_params(moe, torch.Generator().manual_seed(0), "cpu")
    ctx = dataclasses.replace(_ctx(TT), use_flash_kernel=False)
    x = torch.zeros(1, 8, tcfg.d_model)
    pos = torch.arange(8, dtype=torch.int32)[None]
    seg = torch.zeros(1, 8, dtype=torch.int32)
    one = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="serving mesh"):
        TT.forward_full_packed(tp["stack"], moe, x, pos, seg,
                               torch.ones(1, 8, dtype=torch.bool), one,
                               one + 8, one, ctx)
    with pytest.raises(ValueError, match="serving mesh"):
        TT.forward_full(tp["stack"], moe, x, pos)
    with pytest.raises(ValueError):
        TLM.decode_tokens_packed({}, tcfg, x[0], torch.ones(8, dtype=bool),
                                 max_num_logits=8, mode="sampled")
