"""Mesh serving on the CPU, held to the one-device serve (the sharding
oracle of ``tests/test_mesh_serving.py``, on the port).

* In process: a ``(1, 1)`` or ``(1, 1, 1)`` mesh is bit-identical to no
  mesh (ids, counters, the pool byte for byte), with the plain paths and
  with the kernel flags (their CPU plain versions); every refusal of a
  mesh is raised before it could serve anything else.
* On two gloo ranks (``python -m repro_torch.launch.shard_check``, the
  reference suite's parametrisation, split with
  ``test_torch_mesh_check.py`` so that ``--dist loadfile`` runs the two
  halves on two workers): token ids and the ``EngineStats`` counters
  exactly, the slot pool allclose at 1e-5, ``mesh_devices`` 2.
"""
import torch_testing  # noqa: F401  (the thread cap, before anything builds)

import dataclasses

import numpy as np
import pytest
import torch
from torch.multiprocessing.spawn import ProcessRaisedException

from repro_torch.configs import get_config, reduced
from repro_torch.core import engine as tengine
from repro_torch.core.engine import Engine
from repro_torch.launch import mesh as M
from repro_torch.launch import shard_check as SC
from repro_torch.launch.serve import run_serve
from torch_testing import shard_check


@pytest.mark.parametrize("kernels", [False, True])
def test_1x1_mesh_bit_identical_to_no_mesh(kernels):
    cfg = reduced(get_config("llada-8b"))
    serve = SC.serve_config(kernels=kernels)
    prompts = SC.trace_prompts(cfg, 4, 0)
    recs = []
    for mesh in (None, (1, 1), (1, 1, 1)):
        s = dataclasses.replace(serve, mesh_shape=mesh)
        eng, reqs, stats = SC.serve_trace(cfg, s, prompts, 0, False, "cpu")
        recs.append(SC._record(eng, reqs, stats, pool=True))
    a = recs[0]
    for b in recs[1:]:
        assert b["mesh_devices"] == 1
        assert all(np.array_equal(x, y) for x, y in zip(a["tokens"],
                                                        b["tokens"]))
        assert a["stats"] == b["stats"]
        assert all(np.array_equal(x, y) for x, y in zip(a["pool"],
                                                        b["pool"]))


def test_mesh_engine_rejects_indivisible_kernel_dims():
    """The divisibility law is checked before any group: reduced llada's 4
    heads and 256-word vocabulary do not divide a 3-way model axis. The
    plain paths carry no such law and get as far as the mesh, which this
    process does not have."""
    cfg = reduced(get_config("llada-8b"))
    base = SC.serve_config()
    with pytest.raises(ValueError, match="Pallas.*divide"):
        Engine(cfg, dataclasses.replace(base, mesh_shape=(1, 3),
                                        use_flash_kernel=True,
                                        logit_mode="fused"), device="cpu")
    with pytest.raises(RuntimeError) as ei:
        Engine(cfg, dataclasses.replace(base, mesh_shape=(1, 3)),
               device="cpu")
    assert "Pallas" not in str(ei.value) and "spawn" in str(ei.value)


def test_mesh_refusals(monkeypatch):
    """Each refusal fails loudly, never serving on one device: int8 slots,
    a mesh larger than the visible GPUs (the launcher, before any rank
    starts), gloo ranks asked to capture graphs on the card, a rank that
    raises (its error reaches the spawner), and the expert-parallel MoE
    without a mesh (the reference's ``assert mesh is not None``)."""
    base = SC.serve_config()
    llada = reduced(get_config("llada-8b"))
    with pytest.raises(NotImplementedError, match="int8"):
        Engine(llada, dataclasses.replace(base, mesh_shape=(1, 2),
                                          kv_quant="int8"), device="cpu")
    with pytest.raises(ValueError, match="visible GPU"):
        run_serve("llada-8b", "dllm-serve", "burst", 2.0, 2,
                  mesh_shape=(1, 2), device="cuda")
    with pytest.raises(ValueError, match="visible GPU"):
        M.spawn(SC._mesh_rank, (2, 1), "cuda")
    monkeypatch.setattr(tengine.devices, "resolve",
                        lambda d: torch.device("cuda"))
    M.activate(M.ServingMesh((1, 2), "cuda", backend="gloo"))
    try:
        with pytest.raises(ValueError, match="CUDA graph"):
            Engine(llada, dataclasses.replace(base, mesh_shape=(1, 2),
                                              use_flash_kernel=True),
                   device="cuda", graphs=True)
    finally:
        M.activate(None)
    monkeypatch.undo()
    serve = dataclasses.replace(base, mesh_shape=(1, 2), kv_quant="int8")
    with pytest.raises(ProcessRaisedException, match="int8"):
        M.spawn(SC._mesh_rank, (1, 2), "cpu", llada, serve,
                SC.trace_prompts(llada, 1, 0), 0, False, None, None)
    ep = dataclasses.replace(reduced(get_config("phi3.5-moe-42b-a6.6b")),
                             moe_impl="ep")
    with pytest.raises(ValueError, match="serving mesh"):
        Engine(ep, base, device="cpu").warmup()


@pytest.mark.parametrize("arch,extra", [
    ("llada-8b", ["--warmup"]),      # attention stream, warmed entries
    ("mamba2-130m", []),             # segment-reset SSD scan
    ("llada-8b", ["--kernels"]),     # head-sharded kernels, vocab merge
    ("mamba2-130m", ["--kernels"]),  # the scan kernel over state heads
])
def test_shard_agreement_subprocess(arch, extra, tmp_path):
    shard_check(arch, extra, tmp_path)
