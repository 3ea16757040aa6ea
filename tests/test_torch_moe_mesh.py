"""The MoE archs on a serving mesh, held to the one-device port and to
the reference, on the CPU (gloo ranks of ``launch.mesh.spawn``).

* ``gather`` at module level on ``(1, 2)``, ``(2, 1)`` and ``(2, 2)``
  (and with drops, and with 3 experts on a 2-way model axis, where the
  stacks stay whole on ``E`` and only ``w_down`` splits): every rank's
  dispatch (slots, keep mask, the token in each slot) is the one-device
  call's exactly, its output within 1e-5 of the output's largest
  magnitude (the ``d_model`` and ``F`` sums reordered), and the bytes of
  its expert stacks are what the reference's planner bills a device for
  those leaves.
* ``ep`` on ``(1, 2)`` and ``(2, 1)`` against the reference's ``_moe_ep``
  on a 2-device JAX CPU mesh (a subprocess, under
  ``repro.jax_compat.use_mesh``). Both round each partial to bfloat16 and
  the sum again, so an element that sits on a rounding boundary in
  float32 can land one bfloat16 spacing away from the reference's: the
  tolerance is that spacing's bound, 2^-7 of each element's magnitude
  (bfloat16 keeps 8 significant bits, so its spacing is 2^-8 to 2^-7 of
  a value). ``aux`` to 1e-6.
* Engine level through ``shard_check``: reduced phi3.5-moe and qwen3-moe
  (16 experts, top-8: at 8 top-4 two block confidences tie) on ``(1, 2)``
  and ``(2, 1)`` with the kernel paths, phi3.5-moe's padded sparse-dllm,
  ``(2, 1, 1)`` pod meshes of llada-8b (the CLI) and phi3.5-moe, and a
  ``(2, 2, 1)`` mesh whose slot pool shards over the pod and data axes
  together: ids and the counters exact, the pool by ``pool_close``, each
  rank's parameter bytes the reference's ``weight_bytes_per_device``.
  phi3.5-moe runs seed 1: its seed-0 trace holds a float32 near-tie
  (reordering only the experts' ``d_model`` sums in one process, no mesh,
  changes one request's ids), which no mesh can be held to exactly.
* The per-device planner of both MoE archs on the pod meshes, and each
  rank's cut of the expert stacks and of the slot axis over
  ``('pod', 'data')``.
"""
import torch_testing  # noqa: F401  (the thread cap, before anything builds)

import dataclasses
import itertools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.configs.base import ServeConfig as JServe
from repro.core import budgeting as JB
from repro.launch.mesh import SimMesh as JSimMesh
from repro.launch.sharding import Rules as JRules
from repro.models import moe as JM
from repro_torch.configs import get_config, reduced as treduced
from repro_torch.configs.base import ServeConfig as TServe
from repro_torch.core import budgeting as TB
from repro_torch.launch import mesh as M
from repro_torch.launch import shard_check as SC
from repro_torch.launch.serve import run_serve
from repro_torch.launch.sharding import Rules, local_slice
from repro_torch.models import moe as TM
from torch_testing import REPO, moe_rank, shard_check

PHI, QWEN = "phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b"
QWEN16 = dict(n_experts=16, experts_per_token=8)
EP_TOL = 2.0 ** -7      # one bfloat16 spacing, relative to the element


def _stack(jcfg, seed=0) -> dict:
    """The reference's expert stacks ``[nl, ...]`` as numpy arrays."""
    st = JM.init_moe_stack(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    return {k: np.asarray(v) for k, v in st.items()}


def _expert_bill(jcfg, mesh) -> int:
    """The reference planner's per-device bytes of the expert stacks."""
    shapes = {"stack": jax.eval_shape(
        lambda k: JM.init_moe_stack(jcfg, k, jnp.float32),
        jax.random.PRNGKey(0))}
    sim = JSimMesh(mesh)
    specs = JRules(jcfg, sim, train=False).params(shapes)
    return JB._sharded_tree_bytes(sim, shapes, specs)


@pytest.mark.parametrize("mesh,over", [
    ((1, 2), {}), ((2, 1), {}), ((2, 2), {}),
    ((2, 2), dict(capacity_factor=0.5)),       # assignments drop
    ((1, 2), dict(n_experts=3)),               # E does not divide m
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple)
    else "-".join(f"{k}={x}" for k, x in v.items()) or "base")
def test_gather_on_a_mesh_equals_one_device(mesh, over):
    jcfg, tcfg = reduced(ARCHS[PHI], **over), treduced(get_config(PHI),
                                                       **over)
    stack = _stack(jcfg)
    x = np.random.default_rng(1).standard_normal(
        (40, jcfg.d_model)).astype(np.float32)
    one = moe_rank(M.ServingMesh((1, 1), "cpu"), tcfg, stack, x)
    if over.get("capacity_factor"):
        assert not one["dispatch"][0][1].all()         # some drop
    ranks = M.spawn(moe_rank, mesh, "cpu", tcfg, stack, x)
    bill = _expert_bill(jcfg, mesh)
    scale = float(np.abs(one["out"]).max())
    for r, got in enumerate(ranks):
        for a, b in zip(one["dispatch"][0], got["dispatch"][0]):
            assert np.array_equal(a, b), r
        err = float(np.abs(got["out"] - one["out"]).max())
        assert err <= 1e-5 * scale, (r, err, scale)
        assert abs(got["aux"] - one["aux"]) <= 1e-6
        assert got["bytes"] == bill, (r, got["shapes"])
        assert got["collectives"] > 0
    if over.get("n_experts") == 3:
        # the stacks replicate on E, only w_down splits (by F)
        assert ranks[0]["shapes"]["w_gate"] == stack["w_gate"].shape
        assert ranks[0]["shapes"]["w_down"][2] == jcfg.d_ff // 2


_REF_EP = r"""
import dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import ARCHS, reduced
from repro.models import moe as JM
from repro.jax_compat import use_mesh
shape = tuple(int(v) for v in sys.argv[1].split(","))
cfg = dataclasses.replace(reduced(ARCHS[sys.argv[2]]), moe_impl="ep")
st = JM.init_moe_stack(cfg, jax.random.PRNGKey(0), jnp.float32)
x = jax.random.normal(jax.random.PRNGKey(1), (32, cfg.d_model), jnp.float32)
with use_mesh(jax.make_mesh(shape, ("data", "model"))):
    y, aux = JM._moe_ep({k: v[0] for k, v in st.items()}, x, cfg)
np.savez(sys.argv[3], y=np.asarray(y), aux=np.asarray(aux),
         x=np.asarray(x), **{k: np.asarray(v) for k, v in st.items()})
"""


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1)], ids=["1x2", "2x1"])
def test_ep_matches_the_reference(mesh, tmp_path):
    out = tmp_path / "ref.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    r = subprocess.run([sys.executable, "-c", _REF_EP,
                        ",".join(map(str, mesh)), PHI, str(out)],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    z = np.load(out)
    tcfg = dataclasses.replace(treduced(get_config(PHI)), moe_impl="ep")
    stack = {k: z[k] for k in ("router", "w_gate", "w_up", "w_down")}
    want = z["y"]
    for got in M.spawn(moe_rank, mesh, "cpu", tcfg, stack, z["x"]):
        err = np.abs(got["out"] - want)
        assert (err <= EP_TOL * np.abs(want)).all(), float(err.max())
        assert abs(got["aux"] - float(z["aux"])) <= 1e-6
    # ep against the port's own gather on the same rows: the same float32
    # function, its partials rounded to bfloat16 (within a spacing of the
    # largest magnitude)
    gcfg = treduced(get_config(PHI))
    g = moe_rank(M.ServingMesh((1, 1), "cpu"), gcfg, stack, z["x"])
    assert np.abs(got["out"] - g["out"]).max() <= \
        EP_TOL * np.abs(g["out"]).max()


# (arch, mesh, overrides of the reduced config, check keywords)
ENGINE = [
    (PHI, (1, 2), {}, dict(seed=1, kernels=True)),
    (PHI, (2, 1), {}, dict(seed=1, kernels=True)),
    (QWEN, (1, 2), QWEN16, dict(kernels=True)),
    (QWEN, (2, 1), QWEN16, dict(kernels=True)),
    # a padded baseline: row 6 on each rank's KV heads
    (PHI, (1, 2), {}, dict(seed=1, kernels=True, system="sparse-dllm")),
    (PHI, (2, 1, 1), {}, dict(seed=1)),
    # the pod and data axes together shard the slot pool
    (PHI, (2, 2, 1), {}, dict(seed=1, kernels=True)),
]


def _engine_id(case):
    arch, mesh, over, kw = case
    return "-".join([arch.split("-")[0], "x".join(map(str, mesh)),
                     kw.get("system", "dllm-serve")])


@pytest.mark.parametrize("case", ENGINE, ids=_engine_id)
def test_moe_mesh_serve_equals_one_device(case):
    arch, mesh, over, kw = case
    rec = SC.check(arch, mesh, device="cpu",
                   cfg=treduced(get_config(arch), **over), **kw)
    assert rec["ok"], rec["diffs"]
    assert rec["mesh_devices"] == int(np.prod(mesh))
    assert min(rec["rank_collectives"]) > 0
    want = JB.weight_bytes_per_device(reduced(ARCHS[arch], **over), mesh)
    assert rec["rank_param_bytes"] == [want] * len(rec["rank_param_bytes"])


def test_launcher_serves_moe_and_pod_meshes():
    """``run_serve`` spawns a rank a device of a 2-D or 3-D mesh and
    returns rank 0's JSON (the profiler off: at its 24 GB default the
    device bill refuses both MoE archs, with or without a mesh, since it
    bills the full configs' weights); a 3-D mesh larger than the visible
    GPUs raises before any rank starts."""
    for arch, mesh in ((QWEN, (1, 2)), (PHI, (2, 1, 1))):
        res = run_serve(arch, "dllm-serve", "burst", 2.0, 3, device="cpu",
                        mesh_shape=mesh, size_by_profiler=False,
                        kernels=True)
        assert res["mesh_shape"] == list(mesh)
        assert res["mesh_devices"] == 2 and res["n_finished"] == 3
    with pytest.raises(ValueError, match="visible GPU"):
        run_serve(PHI, "dllm-serve", "burst", 2.0, 2, mesh_shape=(2, 1, 1),
                  device="cuda")


def test_pod_mesh_through_the_cli(tmp_path):
    """``--mesh 2,1,1`` on the tool: llada-8b's slot pool over the pod
    axis, the weights whole on each rank."""
    rec = shard_check("llada-8b", ["--mesh", "2,1,1"], tmp_path)
    assert rec["mesh"] == [2, 1, 1]


PLAN_MESHES = ((1, 2), (2, 2), (16, 16), (2, 16, 16))
PLAN_SERVES = (dict(), dict(logit_mode="fused"),
               dict(prefix_sharing=True, max_slots=64))


@pytest.mark.parametrize("arch", [PHI, QWEN])
def test_moe_per_device_plan_equals_the_reference(arch):
    """weight_bytes_per_device and plan_memory (every field) of the full
    MoE archs on 2-D and pod meshes, exactly."""
    jcfg, tcfg = ARCHS[arch], get_config(arch)
    for mesh in PLAN_MESHES:
        assert TB.weight_bytes_per_device(tcfg, mesh) == \
            JB.weight_bytes_per_device(jcfg, mesh), mesh
        for kw, hbm in itertools.product(PLAN_SERVES, (24 << 30, 80 << 30)):
            want = JB.plan_memory(jcfg, JServe(mesh_shape=mesh, **kw), hbm)
            got = TB.plan_memory(tcfg, TServe(mesh_shape=mesh, **kw), hbm)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), \
                (mesh, kw)


def test_rank_cuts_on_the_expert_placement_and_the_pod_axis():
    """Each rank of a (2, 2, 2) mesh cuts ``w_gate`` by expert over
    ``model`` and by ``d_model`` over ``data`` (whole over ``pod``),
    ``w_down`` by its hidden ``F`` over ``model`` with every expert, and
    the slot pool's slot axis over ``('pod', 'data')`` major to minor."""
    cfg = treduced(get_config(PHI))
    nl, E, D, F = cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff
    wg = torch.arange(nl * E * D * F, dtype=torch.float32).reshape(
        nl, E, D, F)
    wd = wg.reshape(nl, E, F, D)
    slots = torch.arange(cfg.n_layers * 16 * 4).reshape(cfg.n_layers, 16, 4)
    shape = (2, 2, 2)
    for rank in range(8):
        mesh = M.ServingMesh(shape, "cpu", rank=rank)
        p, d, m = (mesh.index(a) for a in ("pod", "data", "model"))
        assert rank == (p * 2 + d) * 2 + m
        assert mesh.index(("pod", "data")) == p * 2 + d
        rules = Rules(cfg, mesh, train=False)
        got = local_slice(wg, rules.leaf_spec("stack/w_gate", wg.shape),
                          mesh)
        assert torch.equal(got, wg[:, m * E // 2:(m + 1) * E // 2,
                                   d * D // 2:(d + 1) * D // 2])
        got = local_slice(wd, rules.leaf_spec("stack/w_down", wd.shape),
                          mesh)
        assert torch.equal(got, wd[:, :, m * F // 2:(m + 1) * F // 2])
        spec = (None, rules.dp, None)
        got = local_slice(slots, spec, mesh)
        i = p * 2 + d
        assert torch.equal(got, slots[:, i * 4:(i + 1) * 4])


def test_ep_refusals():
    """``ep`` raises without a mesh (the reference asserts one), and where
    its rows do not divide the data axes (the reference's ``shard_map``
    refuses them)."""
    cfg = dataclasses.replace(treduced(get_config(PHI)), moe_impl="ep")
    stack = {k: torch.from_numpy(v[0]) for k, v in
             _stack(reduced(ARCHS[PHI])).items()}
    x = torch.zeros(6, cfg.d_model)
    with pytest.raises(ValueError, match="serving mesh"):
        TM.moe_ffn(stack, x, cfg)
    M.activate(M.ServingMesh((1, 1), "cpu"))
    try:
        y, _ = TM.moe_ffn(stack, x, cfg)          # a one-device mesh serves
        assert y.shape == x.shape
    finally:
        M.activate(None)
    mesh = M.ServingMesh((4, 1), "cpu")
    M.activate(mesh)
    try:
        with pytest.raises(ValueError, match="do not divide"):
            TM.moe_ffn(stack, x, cfg)
    finally:
        M.activate(None)
