"""Captured stage entries (CUDA graphs) against the same entries run
eagerly, on the card.

Needs a CUDA device and ``nvcc``; every test takes the ``cuda`` fixture,
which skips with a reason when ``torch.cuda.is_available()`` is False. This
file imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_graphs_cuda.py

A reduced float32 engine (TF32 off) serves the same requests on the same
weights with ``graphs=True`` and with ``graphs=False``: the committed ids,
every counter, the modeled clock and each kernel's launch count over the
run must be identical (the same kernels run on the same inputs; only their
launch path differs), and the graphed engine builds nothing after warmup.
"""
import torch_testing  # noqa: F401  (the thread cap, before anything builds)

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ServeConfig
from repro_torch.core.baselines import system_profiles
from repro_torch.core.engine import Engine
from repro_torch.core.graphs import Field, StageGraphs
from repro_torch.kernels import build
from repro_torch.params import init_params

COUNTERS = (
    "iterations", "refresh_steps", "reuse_steps", "committed_tokens",
    "deferred_steps", "peak_query_tokens", "refresh_tokens_real",
    "refresh_tokens_exec", "reuse_tokens_real", "reuse_tokens_exec",
    "logit_tokens_real", "logit_tokens_exec", "packed_refresh_calls",
    "padded_refresh_calls", "packed_reuse_calls", "padded_reuse_calls",
    "submitted", "finished", "dispatched_ahead", "streamed_events",
    "preemptions", "recomputed_tokens")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graphs are captured on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _serve(system, logit_mode="fused", **kw):
    base = ServeConfig(**dict(dict(
        max_num_batched_tokens=512, max_num_logits=64, block_size=8,
        steps_per_block=8, max_seq_len=128, max_slots=6,
        max_refresh_per_iter=2), **kw))
    return dataclasses.replace(system_profiles(base)[system],
                               use_flash_kernel=True, logit_mode=logit_mode)


def _run(cfg, serve, params, graphs, n=6):
    eng = Engine(cfg, serve, params=params, clock="modeled", device="cuda",
                 graphs=graphs, stream_cb=lambda ev: None)
    eng.warmup()
    build.reset_counters()
    rng = np.random.default_rng(0)
    reqs = [eng.submit(rng.integers(0, cfg.vocab_size - 1,
                                    int(rng.integers(8, 40))),
                       gen_len=int(rng.integers(9, 30)), arrival=0.004 * i,
                       rid=i) for i in range(n)]
    stats = eng.run()
    torch.cuda.synchronize()
    counts = {k: (c.launches, c.plain_calls)
              for k, c in build.COUNTERS.items()}
    return eng, reqs, stats, counts


def _compare(arch, serve):
    cfg = reduced(get_config(arch))
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    eg, rg, sg, cg = _run(cfg, serve, params, graphs=True)
    ee, re_, se, ce = _run(cfg, serve, params, graphs=False)
    for a, b in zip(rg, re_):
        assert np.array_equal(a.tokens, b.tokens), a.rid
    for k in COUNTERS:
        assert getattr(sg, k) == getattr(se, k), k
    assert eg.vtime == ee.vtime
    assert cg == ce
    assert sum(launches for launches, _ in cg.values()) > 0
    assert all(plain == 0 for _, plain in cg.values()), cg
    assert sg.compiles_warmup > 0 and sg.compiles_post_warmup == 0, \
        sg.compile_counts
    assert sum(sg.graph_replays.values()) > 0 and se.graph_replays == {}
    return sg


@pytest.mark.parametrize("arch", ["llada-8b", "mamba2-130m", "zamba2-7b"])
@pytest.mark.parametrize("pipeline", [True, False])
def test_graphs_equal_eager_packed(cuda, arch, pipeline):
    st = _compare(arch, _serve("dllm-serve", pipeline=pipeline))
    assert st.packed_refresh_calls > 0 and st.packed_reuse_calls > 0
    assert (st.dispatched_ahead > 0) == pipeline


@pytest.mark.parametrize("arch,system", [
    ("mamba2-130m", "dllm-cache"), ("zamba2-7b", "fast-dllm"),
    ("zamba2-7b", "sparse-dllm"), ("phi3.5-moe-42b-a6.6b", "dllm-serve"),
    ("qwen3-moe-235b-a22b", "dllm-serve"),
    ("phi3.5-moe-42b-a6.6b", "sparse-dllm")])
def test_graphs_equal_eager_scan_padded_and_moe(cuda, arch, system):
    """The scan families' padded stages (the float32 ``ssd_scan`` and its
    capture gathers, the hybrid's causal split Reuse) and the MoE
    dispatch (sort, cumsum, scatter into the slot map, gathers) inside
    captured graphs."""
    st = _compare(arch, _serve(system))
    padded = system != "dllm-serve"
    assert (st.padded_refresh_calls > 0) == padded
    assert (st.packed_refresh_calls > 0) != padded


@pytest.mark.parametrize("system,mode", [("fast-dllm", "monolithic"),
                                         ("dllm-serve", "chunked")])
def test_graphs_equal_eager_profile_logit_modes(cuda, system, mode):
    """The profiles' own logit modes, the reference's plain path as torch
    ops (a baseline's one ``[N, V]`` pass; dllm-serve's chunks, all-padding
    ones masked on the device), inside captured graphs."""
    st = _compare("llada-8b", _serve(system, logit_mode=mode))
    assert st.logit_tokens_exec >= st.logit_tokens_real > 0


def test_graphs_equal_eager_preemption(cuda):
    """Two slots for six requests with a starvation threshold: preempted
    residents roll back their block, and the pipelined loop drops their
    in-flight commits, the same with graphs as without."""
    st = _compare("llada-8b", _serve("dllm-serve", max_slots=2,
                                     preempt_starvation_s=0.02))
    assert st.preemptions > 0


@pytest.mark.parametrize("system", ["dllm-serve", "sparse-dllm"])
def test_graphs_equal_eager_frontend(cuda, system):
    """musicgen-medium's frontend: the packed Refresh's prefix scatter into
    the stream (padding requests into the cut row), the padded
    ``[b, F + S]`` batch, and the payloads' staging field."""
    st = _compare("musicgen-medium", _serve(system))
    assert st.refresh_tokens_real > 0


def test_graphs_equal_eager_padded_two_refresh_chunks(cuda):
    """The request-level baseline refreshes a whole admitted batch in
    chunks of ``refresh_slots``: one iteration replays the same ``refresh``
    entry more than once, so the staging and each chunk's hidden rows must
    survive the next chunk's replay."""
    serve = _serve("sparse-dllm")
    st = _compare("llada-8b", serve)
    assert st.padded_refresh_calls > 0
    assert max(r["n_refresh"] for r in st.iter_log) > serve.refresh_slots


def test_capture_failure_names_the_stage(cuda):
    """A host sync inside a stage fails its capture; the error names the
    stage, and nothing falls back to eager."""
    g = StageGraphs(cuda, graphs=True)
    e = g.get("bad", (3,), lambda: (
        [Field("a", (3,), torch.int32)],
        lambda x: x["a"] + int(x["a"].sum().item())))
    e.host()["a"][:] = 1
    with pytest.raises(RuntimeError, match=r"stage bad\[3\]"):
        e()
