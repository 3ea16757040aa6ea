"""``run_serve`` at the launcher's defaults (``use_reduced=True``, the
profiler on at ``hbm_gb=24``) serves every registered arch, as the
reference's does.

The profiler plans the full config, and an arch whose full weights exceed
24 GB gets the reference's floor of one slot; the device bill then holds
what the engine serves, the reduced weights, against the budget. Each
arch's call is compared with the reference's on the same call: every
request's committed token ids (both engines on the reference's weights
for seed 0, carried across with ``params.from_jax``), every counter of
the JSON and ``max_slots``. A full-width serve whose weights do not fit
is still refused, billed on meta tensors so nothing large is allocated.
"""
import torch_testing  # noqa: F401  (the thread cap, before anything builds)

import dataclasses

import numpy as np
import pytest
import torch

import jax
from repro.configs import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core.engine import Engine as JEngine
from repro.launch.serve import run_serve as jrun_serve
from repro.models import backbone as JBB
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import ServeConfig
from repro_torch.core import engine as tengine
from repro_torch.core.baselines import system_profiles
from repro_torch.core.budgeting import plan_memory
from repro_torch.launch.serve import PLAN_GEOMETRY, fit_to_budget
from repro_torch.launch.serve import run_serve as trun_serve
from repro_torch.params import from_jax, init_params, param_bytes

CALL = ("dllm-serve", "livebench", 50.0, 2)
HOST_CLOCK = {"host_plan_s", "host_fill_s", "sync_wait_s", "warmup_s",
              "wall_clock_s", "wall_tok_s", "overlapped_host_s",
              "overlap_frac"}
JAX_ONLY = {"compile_counts", "compiles_warmup", "compiles_post_warmup"}
PORT_ONLY = {"graph_replays", "graph_pool_bytes", "device_bill"}


def _capture(monkeypatch, cls, into):
    submit = cls.submit

    def wrapped(self, *a, **kw):
        r = submit(self, *a, **kw)
        into.append(r)
        return r
    monkeypatch.setattr(cls, "submit", wrapped)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_run_serve_defaults_serve_every_arch(monkeypatch, arch):
    jreqs, treqs = [], []
    _capture(monkeypatch, JEngine, jreqs)
    _capture(monkeypatch, tengine.Engine, treqs)
    want = jrun_serve(arch, *CALL)
    jtree = jax.tree.map(np.asarray, JBB.init_params(
        jreduced(jget_config(arch)), jax.random.PRNGKey(0)))
    monkeypatch.setattr(tengine, "init_params",
                        lambda cfg, gen, device, cut=None: from_jax(
                            jtree, cfg, device, cut=cut))
    got = trun_serve(arch, *CALL, device="cpu")
    assert set(got) == set(want) | PORT_ONLY
    for k in sorted(set(want) - HOST_CLOCK - JAX_ONLY):
        assert got[k] == want[k], k
    assert got["max_slots"] == want["max_slots"] >= 1
    assert got["n_finished"] == 2 and len(jreqs) == len(treqs) == 2
    for a, b in zip(jreqs, treqs):
        assert np.array_equal(a.tokens, b.tokens), (arch, b.rid)
    bill = got["device_bill"]
    assert bill["fits"] and bill["resized_from"] is None
    assert bill["weights_bytes"] < bill["plan_weights_bytes"]


class _MetaEngine:
    """What ``fit_to_budget`` reads of an engine, holding the full
    config's weights as meta tensors (no storage)."""

    def __init__(self, serve, cfg):
        self.serve = serve
        self.params = init_params(cfg, None, "meta")
        self.device = torch.device("cpu")
        slot = 1 << 20
        self.pool = type("P", (), dict(slot_bytes=lambda _: slot,
                                       rows=serve.max_slots + 1))()
        self.graphs = type("G", (), dict(
            capture=False, pool_bytes=lambda _: 0,
            staging_bytes=lambda _: 0))()


def test_full_width_serve_that_does_not_fit_is_refused():
    """qwen2-72b served whole at 24 GB: its ~145 GB of held weights are
    billed, no slot count pays for them, and the serve is refused; the
    same engine at 1,000 GB fits."""
    cfg = get_config("qwen2-72b")
    serve = system_profiles(ServeConfig(max_slots=12))["dllm-serve"]
    plan_serve = dataclasses.replace(serve, **PLAN_GEOMETRY)
    for gb, fits in ((24, False), (1000, True)):
        plan = plan_memory(cfg, plan_serve, gb << 30)
        served = dataclasses.replace(serve,
                                     max_slots=max(1, plan.max_slots))

        def build(sv, params):
            return _MetaEngine(sv, cfg), 0.0
        if fits:
            eng, bill, resized_from, _ = fit_to_budget(
                build, served, plan, cfg, gb << 30)
            assert bill.fits and resized_from is None
            assert bill.weights_bytes == param_bytes(eng.params) \
                == plan.weights_bytes
            continue
        with pytest.raises(ValueError, match="does not fit") as e:
            fit_to_budget(build, served, plan, cfg, gb << 30)
        assert f"weights {plan.weights_bytes} " in str(e.value)
