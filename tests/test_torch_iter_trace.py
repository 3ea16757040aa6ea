"""The engine's ``iter_log`` rows as a trace of the serving loop, on the
CPU: every row carries the host's spans with their starts on
``torch.profiler``'s clock, the deferred steps and the idle laps; off the
card the device times read None (``tests/test_torch_graphs_cuda.py`` holds
them on the card).

A reduced llada-8b serves five requests due at once and one due long after
they finish (modeled clock), pipelined and synchronous, inside a
``record_function`` range under a CPU-only profiler.
"""
import torch_testing  # noqa: F401  (the thread cap, before anything builds)

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ServeConfig
from repro_torch.core.baselines import system_profiles
from repro_torch.core.engine import Engine

SERVE = dict(max_num_batched_tokens=64, max_num_logits=32, block_size=8,
             steps_per_block=8, max_seq_len=96, max_slots=4,
             max_refresh_per_iter=2)
LATE = 1000.0          # the last request's arrival, modeled seconds
SPANS = ("plan", "fill", "sync", "land")
DEVICE = ("refresh_dev_s", "reuse_dev_s", "logit_dev_s", "iter_dev_s",
          "gap_dev_s")
RANGE = "test.engine_run"


@pytest.fixture(scope="module", params=[True, False],
                ids=["pipelined", "synchronous"])
def served(request):
    serve = dataclasses.replace(
        system_profiles(ServeConfig(**SERVE,
                                    pipeline=request.param))["dllm-serve"],
        use_flash_kernel=True, logit_mode="fused")
    cfg = reduced(get_config("llada-8b"))
    eng = Engine(cfg, serve, clock="modeled", device="cpu")
    rng = np.random.default_rng(7)
    for i in range(5):
        eng.submit(rng.integers(0, cfg.vocab_size - 1,
                                int(rng.integers(8, 30))),
                   gen_len=20, arrival=0.004 * i)
    eng.submit(rng.integers(0, cfg.vocab_size - 1, 12), gen_len=9,
               arrival=LATE)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(RANGE):
            stats = eng.run()
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == RANGE]
    start = int(ev.start_ns())
    return stats, (start, start + int(ev.duration_ns()))


def test_every_row_has_the_new_keys_in_order(served):
    stats, _ = served
    assert stats.iter_log
    for r in stats.iter_log:
        for k in SPANS:
            assert isinstance(r[f"{k}_ns"], int), k
            assert r[f"{k}_s"] >= 0.0, k
        assert r["plan_ns"] <= r["fill_ns"] <= r["sync_ns"] <= r["land_ns"]
        assert all(r[k] is None for k in DEVICE), "device times off the card"


def test_stamps_fall_inside_a_profiler_range_around_run(served):
    stats, (lo, hi) = served
    for r in stats.iter_log:
        for k in SPANS:
            s = r[f"{k}_ns"]
            assert lo <= s and s + r[f"{k}_s"] * 1e9 <= hi, (k, s - lo,
                                                              hi - s)


def test_deferred_steps_add_up_to_the_counter(served):
    stats, _ = served
    assert stats.deferred_steps > 0
    assert sum(r["deferred"] for r in stats.iter_log) == stats.deferred_steps


def test_idle_laps_count_the_empty_laps_before_a_late_arrival(served):
    stats, _ = served
    laps = [r["idle_laps"] for r in stats.iter_log]
    first_late = next(i for i, r in enumerate(stats.iter_log)
                      if r["t"] >= LATE)
    # the modeled clock jumps to the arrival in one empty lap
    assert laps[first_late] == 1
    assert sum(laps) == 1
