"""The MoE layers (phi3.5-moe: 16 experts top-2; qwen3-moe: 128 experts
top-8) against ``repro.models.moe`` and the reference engine, on the same
weights (``repro.models.backbone.init_params``, bridged through numpy) and
the same numpy inputs, float32 with TF32 off; the port runs on the CPU.

* The router's top-k ids, the capacity slots, the keep mask and the
  slot-to-token map are exact; the gates, the layer's output and the aux
  loss agree to 1e-5 (sums of the same float32 products in other orders),
  including a call whose capacity drops assignments (``capacity_factor``
  0.5) and one whose router ties every expert (equal router columns: the
  lower index wins, as in ``jax.lax.top_k``).
* The engines: ids, request times, every EngineStats counter and the
  modeled clock exact, under dllm-serve (packed; the capacity taken on
  each stage's bucketed T) and sparse-dllm (padded), with one KV head so
  that G = 4 (phi3.5-moe's), and a capacity-drop case.
* Parameter shapes and ``weight_bytes_per_device`` equal the reference's
  at full size.
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
from repro.core import budgeting as JB
from repro.core.baselines import system_profiles as jprofiles
from repro.models import backbone as JBB
from repro.models import moe as JM
from repro_torch import params as TP
from repro_torch.configs import get_config, reduced as treduced
from repro_torch.configs.base import ServeConfig as TServe
from repro_torch.core import budgeting as TB
from repro_torch.core.baselines import system_profiles as tprofiles
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.params import from_jax
from test_torch_engine import BASE, SERVE, _serve_both

PHI, QWEN = "phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b"
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _cfgs(arch, **over):
    return reduced(ARCHS[arch], **over), treduced(get_config(arch), **over)


def _layer(jcfg, tcfg, seed=0, tie_router=False):
    """One MoE layer's weights of both packages; ``tie_router`` gives every
    expert the same router column."""
    jp = JBB.init_params(jcfg, jax.random.PRNGKey(seed))
    jl = {k: np.asarray(v[0]) for k, v in jp["stack"].items()
          if k in ("router", "w_gate", "w_up", "w_down")}
    if tie_router:
        jl["router"] = np.repeat(jl["router"][:, :1], jcfg.n_experts, 1)
    return ({k: jnp.asarray(v) for k, v in jl.items()},
            {k: torch.from_numpy(v) for k, v in jl.items()})


def _x(T, D, seed=1):
    return np.random.default_rng(seed).standard_normal((T, D)).astype(
        np.float32)


# (arch, reduce overrides): phi3.5-moe's default reduction (4 experts,
# top-2) and qwen3-moe's 8 experts top-4, also with drops and in gelu
LAYERS = [(PHI, {}), (QWEN, dict(n_experts=8, experts_per_token=4)),
          (PHI, dict(capacity_factor=0.5)),
          (QWEN, dict(n_experts=8, experts_per_token=4, capacity_factor=0.5)),
          (PHI, dict(activation="gelu"))]


def _ids(case):
    arch, over = case
    return arch.split("-")[0] + "".join(f"-{k}={v}" for k, v in over.items())


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("case", LAYERS[:2], ids=_ids)
def test_route_matches_reference(case, tie):
    jcfg, tcfg = _cfgs(case[0], **case[1])
    jl, tl = _layer(jcfg, tcfg, tie_router=tie)
    x = _x(40, jcfg.d_model)
    wg, wi, wa = JM._route(jl, jnp.asarray(x), jcfg)
    gg, gi, ga = TM._route(tl, torch.from_numpy(x), tcfg)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gg.numpy(), np.asarray(wg), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ga.item(), float(wa), atol=ATOL, rtol=0)
    if tie:
        k = tcfg.experts_per_token
        assert (gi == torch.arange(k)).all()           # lower index first


@pytest.mark.parametrize("T", [1, 8, 37, 128, 1000])
@pytest.mark.parametrize("case", LAYERS[:4], ids=_ids)
def test_capacity_matches_reference(case, T):
    jcfg, tcfg = _cfgs(case[0], **case[1])
    assert TM._capacity(T, tcfg) == JM._capacity(T, jcfg)
    full = get_config(case[0])
    assert TM._capacity(T, full) == JM._capacity(T, ARCHS[case[0]])


@pytest.mark.parametrize("C", [8, 16, 64])
def test_dispatch_indices_match_reference(C):
    """Slots first come first served in (token, k) order; past C the
    assignment drops into the discarded bin."""
    rng = np.random.default_rng(3)
    T, E, k = 48, 4, 2
    idx = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(
        np.int32)
    idx[:20] = [0, 1]                 # a hot pair overflows C = 8 and 16
    want = JM._dispatch_indices(jnp.asarray(idx), T, E, C)
    got = TM._dispatch_indices(torch.from_numpy(idx).long(), T, E, C)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert bool((~got[1]).any()) == (C < 20)


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("case", LAYERS, ids=_ids)
def test_moe_ffn_matches_reference(case, tie):
    jcfg, tcfg = _cfgs(case[0], **case[1])
    jl, tl = _layer(jcfg, tcfg, tie_router=tie)
    x = _x(48, jcfg.d_model).reshape(3, 16, jcfg.d_model)
    wy, wa = JM.moe_ffn(jl, jnp.asarray(x), jcfg)
    gy, ga = TM.moe_ffn(tl, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ga.item(), float(wa), atol=ATOL, rtol=0)
    C = TM._capacity(48, tcfg)
    _, idx, _ = TM._route(tl, torch.from_numpy(x).reshape(48, -1), tcfg)
    drops = bool((~TM._dispatch_indices(idx, 48, tcfg.n_experts, C)[1])
                 .any())
    assert drops == (tie or tcfg.capacity_factor < 1.0)


@pytest.mark.parametrize("arch", [PHI, QWEN])
def test_params_and_weight_bytes_match_reference(arch):
    """At full size, shapes only: the stack gains the router and the
    stacked experts, and the profiler bills them."""
    jcfg, tcfg = ARCHS[arch], get_config(arch)
    want = jax.eval_shape(lambda k: JBB.init_params(jcfg, k),
                          jax.random.PRNGKey(0))
    want = {".".join(str(p.key) for p in path): tuple(a.shape) for path, a
            in jax.tree_util.tree_flatten_with_path(want)[0]}

    def flat(tree, pre=""):
        out = {}
        for n, s in tree.items():
            out.update(flat(s, f"{pre}{n}.") if isinstance(s, dict)
                       else {pre + n: tuple(s)})
        return out
    assert flat(TP.shapes(tcfg)) == want
    assert TP.shapes(tcfg)["stack"]["w_down"] == (
        tcfg.n_layers, tcfg.n_experts, tcfg.d_ff, tcfg.d_model)
    assert TB.weight_bytes_per_device(tcfg) == \
        JB.weight_bytes_per_device(jcfg, None)


def test_reduced_params_bridge_and_init():
    jcfg, tcfg = _cfgs(QWEN, n_experts=8, experts_per_token=4)
    jp = JBB.init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    assert tp["stack"]["router"].shape == (jcfg.n_layers, jcfg.d_model, 8)
    ti = TP.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert {n: p.shape for n, p in ti.named_parameters()} == \
        {n: p.shape for n, p in tp.named_parameters()}
    assert 0.015 < float(ti["stack"]["w_up"].std()) < 0.025
    assert 0.015 < float(ti["stack"]["router"].std()) < 0.025


def test_moe_layer_in_forward_full_matches_reference():
    """The MoE MLP inside the padded Refresh's layer loop, and the mean of
    the layers' aux losses."""
    jcfg, tcfg = _cfgs(PHI, n_kv_heads=1)
    jp = JBB.init_params(jcfg, jax.random.PRNGKey(2))
    tp = from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    x = _x(2 * 24, jcfg.d_model).reshape(2, 24, -1)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24))
    from repro.models import transformer as JT
    wh, _, wa = JT.forward_full(jp["stack"], jcfg, jnp.asarray(x),
                                jnp.asarray(pos))
    gh, _, ga = TT.forward_full(tp["stack"], tcfg, torch.from_numpy(x),
                                torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(ga), float(wa), atol=ATOL, rtol=0)


def _kernels(serve):
    return dataclasses.replace(serve, use_flash_kernel=True,
                               logit_mode="fused")


# the engines: one KV head, so G = 4 over the reduced 4 query heads
# (phi3.5-moe's G; qwen3-moe's is 16, held on the card in chip_smoke's
# phase 3); qwen3-moe with its top-8 over 16 experts; a case
# whose capacity drops assignments. (At 8 experts top-4 the reduced qwen3
# run holds, in one block, two confidences equal within float32 rounding,
# whose commit order the rounding decides: no exact comparison there.)
ENGINES = [(PHI, dict(n_kv_heads=1)),
           (QWEN, dict(n_kv_heads=1, n_experts=16, experts_per_token=8)),
           (PHI, dict(n_kv_heads=1, capacity_factor=0.5))]


@pytest.mark.parametrize("case", ENGINES, ids=_ids)
def test_moe_dllm_serve_matches_reference_exactly(case):
    arch, over = case
    ts = _serve_both(_kernels(jprofiles(JServe(**SERVE))["dllm-serve"]),
                     _kernels(tprofiles(TServe(**SERVE))["dllm-serve"]),
                     arch=arch, **over)
    assert ts.packed_refresh_calls > 0 and ts.padded_refresh_calls == 0


@pytest.mark.parametrize("case", ENGINES[:2], ids=_ids)
def test_moe_sparse_dllm_matches_reference_exactly(case):
    arch, over = case
    ts = _serve_both(_kernels(jprofiles(JServe(**BASE))["sparse-dllm"]),
                     _kernels(tprofiles(TServe(**BASE))["sparse-dllm"]),
                     check_deferred=False, arch=arch, **over)
    assert ts.padded_refresh_calls > 0 and ts.padded_reuse_calls > 0
