"""Mesh serving on two gloo ranks, the second half of the shard-check
grid (the first is in ``test_torch_mesh_serving.py``), and two holds the
reference suite could not make here:

* a ``(1, 2)`` serve on the modeled clock whose token ids and counters
  equal the REFERENCE's one-device serve on the same weights, and whose
  ``vtime`` equals a reference no-mesh engine whose ``_tp_work_split`` is
  set, on that instance, to the reference's own formula (the reference's
  mesh engine does not run under this jax);
* gemma-2b's one KV head on a 2-way model axis: the pool shards the
  retained length (the idle-TP fallback) and the serve equals one
  device's.
"""
import torch_testing  # noqa: F401  (the thread cap, before anything builds)

import jax
import numpy as np
import pytest

from repro.configs import ARCHS, reduced
from repro.core import budgeting as JB
from repro.core.engine import Engine as JEngine
from repro.models import backbone as JBB
from repro_torch.configs import get_config, reduced as treduced
from repro_torch.launch import mesh as M
from repro_torch.launch import shard_check as SC
from repro_torch.launch.sharding import Rules
from torch_testing import shard_check


@pytest.mark.parametrize("arch,extra", [
    # the data axis: the slot pool sharded over 'data' (a padded slot
    # axis), the streams replicated
    ("llada-8b", ["--kernels", "--mesh", "2,1"]),
    # prefix sharing over duplicated prompts: hits, promotes and the
    # promote-on-release choice are device-count invariant
    ("llada-8b", ["--sharing", "--n", "6"]),
    ("zamba2-7b", ["--kernels"]),    # hybrid: scan heads and shared block
    ("llada-8b", ["--padded"]),      # the padded path (the baselines')
    # the padded path's kernel wrappers (row 6 on each rank's KV heads)
    ("llada-8b", ["--padded", "--kernels"]),
    # a frontend arch: the frontend rows a segment prefix on every rank
    ("musicgen-medium", ["--kernels"]),
])
def test_shard_agreement_subprocess(arch, extra, tmp_path):
    shard_check(arch, extra, tmp_path)


def test_mesh_serve_equals_the_reference_one_device_serve():
    jcfg = reduced(ARCHS["llada-8b"])
    tcfg = treduced(get_config("llada-8b"))
    params = JBB.init_params(jcfg, jax.random.PRNGKey(3))
    serve = SC.serve_config()
    from repro.configs.base import ServeConfig as JServe
    jserve = JServe(**{f: getattr(serve, f) for f in (
        "max_num_batched_tokens", "max_num_logits", "block_size",
        "steps_per_block", "max_seq_len", "max_slots",
        "max_refresh_per_iter", "logit_mode", "varlen_pack",
        "token_bucket")})
    prompts = SC.trace_prompts(tcfg, 5, 0)
    je = JEngine(jcfg, jserve, params=params, clock="modeled")
    je._tp_work_split = (JB.weight_bytes_per_device(jcfg, None)
                         / JB.weight_bytes_per_device(jcfg, (1, 2)))
    jreqs = [je.submit(p, gen_len=16, arrival=0.0, rid=i)
             for i, p in enumerate(prompts)]
    js = je.run()
    rec = SC.check("llada-8b", (1, 2), device="cpu", cfg=tcfg,
                   clock="modeled",
                   params=jax.tree.map(np.asarray, params))
    assert rec["ok"], rec["diffs"]
    for r, got in zip(jreqs, rec["tokens"]):
        assert np.array_equal(r.output_tokens(), np.asarray(got)), r.rid
    for name in SC.COUNTERS:
        assert rec["stats"][name] == getattr(js, name), name
    assert rec["vtime"] == je.vtime


def test_mqa_retained_length_fallback_equals_one_device():
    cfg = treduced(get_config("gemma-2b"))
    assert cfg.n_kv_heads == 1 and cfg.n_heads % 2 == 0
    serve = SC.serve_config()
    retain = min(serve.retained_len, serve.max_seq_len - serve.block_size)
    spec = Rules(cfg, M.SimMesh((1, 2)), train=False).cache(
        serve.max_slots + 1, retain, data_parallel=False,
        slot_data_parallel=True)
    assert spec.k[2] is None and spec.k[3] == ("model",)
    rec = SC.check("gemma-2b", (1, 2), device="cpu", cfg=cfg)
    assert rec["ok"], rec["diffs"]
    assert rec["mesh_devices"] == 2
