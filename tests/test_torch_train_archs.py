"""The port's masked-diffusion loss and its gradients against
``jax.value_and_grad(repro.train.loss.loss_fn)`` for every arch of the
reference, on shared weights (``repro.models.backbone.init_params``,
bridged through numpy) and under the reference's own corruption
(``repro.train.loss.corrupt`` with the key ``loss_fn`` draws from), the
port with remat on and off against the reference at its default
(``remat=True``; remat changes what backward recomputes, not what it
computes, so one reference serves both); and the SSD scan's backward at
the serving chunk and over a whole sequence.

Tolerance: float32 on both sides, sums in another order (every matmul,
softmax, norm, the scan's einsums and the loss chunks); over the reduced
configs the loss agrees to ~1e-7 relative and each gradient leaf to
~1.5e-6 of its largest magnitude. The tests hold the loss to 1e-5
relative and every gradient leaf to 1e-5 of its largest magnitude.
"""
import torch_testing  # noqa: F401  (the thread cap, before anything builds)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models import backbone as JBB
from repro.models import ssm as JS
from repro.train import loss as JL
from repro_torch.configs import get_config, reduced as treduced
from repro_torch.configs.base import TrainConfig
from repro_torch.models import ssm as TS
from repro_torch.params import from_jax, named_leaves, trainable
from repro_torch.train import loss as TL

B, S, CHUNK = 2, 16, 8          # 32 rows in 4 stride chunks of the loss
LOSS_RTOL = GRAD_RTOL = 1e-5


def _leaf_errors(port_grads, ref_tree):
    """{leaf: max |port - ref| / max |ref|} in the port's leaf order."""
    ref = {".".join(k.key for k in path): np.asarray(v) for path, v in
           jax.tree_util.tree_flatten_with_path(ref_tree)[0]}
    assert set(ref) == {n for n, _ in port_grads}
    return {n: float(np.abs(g.detach().numpy() - ref[n]).max()
                     / max(np.abs(ref[n]).max(), 1e-30))
            for n, g in port_grads}


def _reference(arch):
    """(weights, tokens, frontend, corrupted, weights, loss, metrics,
    gradients) of ``jax.value_and_grad(loss_fn)`` on the reduced arch."""
    jcfg = reduced(ARCHS[arch])
    jtc = JTrainConfig(loss_chunk=CHUNK)
    jp = JBB.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size - 1, (B, S)).astype(np.int32)
    fe = (rng.standard_normal((B, jcfg.frontend_len, jcfg.frontend_dim))
          .astype(np.float32) if jcfg.frontend_dim else None)
    key = jax.random.PRNGKey(1)
    vg = jax.jit(jax.value_and_grad(JL.loss_fn, has_aux=True),
                 static_argnums=(1, 2))
    (jloss, jm), jgrads = vg(jp, jcfg, jtc, tokens, key, fe)
    corrupted, w = JL.corrupt(jnp.asarray(tokens), key, jcfg, jtc)
    return (jax.tree.map(np.asarray, jp), tokens, fe, np.array(corrupted),
            np.array(w), float(jloss), {k: float(v) for k, v in jm.items()},
            jgrads)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_gradients_match_the_reference(arch, remat):
    jp, tokens, fe, corrupted, weights, jloss, jm, jgrads = \
        torch_testing.cached(("train-ref", arch), lambda: _reference(arch))
    assert 0 < int((weights > 0).sum()) < B * S
    tcfg = treduced(get_config(arch))
    tc = TrainConfig(loss_chunk=CHUNK, remat=remat)

    params = trainable(from_jax(jp, tcfg, "cpu"))
    leaves = named_leaves(params)
    loss, m = TL.masked_loss(
        params, tcfg, tc, torch.from_numpy(tokens),
        torch.from_numpy(corrupted), torch.from_numpy(weights),
        None if fe is None else torch.from_numpy(fe))
    grads = torch.autograd.grad(loss, [t for _, t in leaves],
                                allow_unused=True, materialize_grads=True)
    assert abs(loss.item() - jloss) <= LOSS_RTOL * abs(jloss)
    assert abs(float(m["ce"].detach()) - jm["ce"]) <= LOSS_RTOL * jm["ce"]
    aux = float(m["aux"].detach()) if tcfg.is_moe else m["aux"]
    assert abs(aux - jm["aux"]) <= LOSS_RTOL * max(abs(jm["aux"]), 1.0)
    assert (jm["aux"] > 0) == tcfg.is_moe
    errs = _leaf_errors(list(zip([n for n, _ in leaves], grads)), jgrads)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL, (worst, errs[worst])


@pytest.mark.parametrize("chunk", [64, 128], ids=["chunk64", "whole"])
def test_ssd_scan_backward_is_finite_and_matches(chunk):
    """The scan's masked ``-inf`` (``_segsum``) and its ``isfinite`` guard
    under autograd: finite gradients at the serving chunk of 64 (two
    chunks) and over the whole 128-row sequence (one chunk), equal to the
    reference's ``jax.grad``."""
    rng = np.random.default_rng(3)
    Bb, L, H, P, N = 2, 128, 3, 4, 8
    x = rng.standard_normal((Bb, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bb, L, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((Bb, L, N)).astype(np.float32)
    Cm = rng.standard_normal((Bb, L, N)).astype(np.float32)
    r = rng.standard_normal((Bb, L, H, P)).astype(np.float32)

    def jf(x, dt, A, Bm, Cm):
        y, st = JS.ssd_scan(x, dt, A, Bm, Cm, chunk)
        return jnp.sum(y * r) + jnp.sum(st)

    jg = jax.jit(jax.grad(jf, argnums=(0, 1, 2, 3, 4)))(x, dt, A, Bm, Cm)
    ts = [torch.tensor(a, requires_grad=True) for a in (x, dt, A, Bm, Cm)]
    y, st = TS.ssd_scan(*ts, chunk)
    (y * torch.from_numpy(r)).sum().add(st.sum()).backward()
    for t, g in zip(ts, jg):
        assert torch.isfinite(t.grad).all()
        g = np.asarray(g)
        err = np.abs(t.grad.numpy() - g).max() / np.abs(g).max()
        assert err <= GRAD_RTOL, err
