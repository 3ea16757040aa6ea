"""The yardstick's arithmetic on synthetic runs: the window's tokens and
block latencies, the model FLOPs, the logit kernel's roofline, the idle
share and its breakdown."""
import numpy as np
import pytest

from sbench import flops, session, spec, trace, window
from sbench.serve import Event

MASK = 99
SB = 4


class Q:
    def __init__(self, rid, due, resident=False, gen_len=32):
        self.rid, self.due, self.resident, self.gen_len = \
            rid, due, resident, gen_len


def blk(done):
    return np.array([1] * SB if done else [1, MASK, 1, MASK])


EVENTS = [Event(0.5, 0, 0, blk(False)), Event(1.0, 0, 0, blk(True)),
          Event(1.5, 1, 3, blk(True)), Event(2.5, 0, 1, blk(True)),
          Event(3.5, 1, 4, blk(True)), Event(9.5, 2, 0, blk(True)),
          Event(10.2, 0, 2, blk(True))]
REQS = [Q(0, 0.2), Q(1, 0.0, resident=True), Q(2, 9.0), Q(3, 6.0),
        Q(4, 12.0)]


def test_tokens_are_the_positions_the_blocks_show_unmasked():
    cs = window.commits(EVENTS, REQS, SB, 2, MASK)
    assert [len(c.new) for c in cs] == [2, 2, 4, 4, 4, 4, 4]
    assert window.committed_tokens(EVENTS, cs, 10.0) == 20
    run = session.Run("c", {"serve": {"block_size": SB,
                                      "steps_per_block": 2}}, 10.0, 1.0,
                      EVENTS, REQS, [], 3, MASK, None)
    assert window.tok_s(run) == pytest.approx(2.0)
    # a last block of 2 generated positions: its pads are no commits
    cs = window.commits([Event(0.1, 5, 0, np.array([1, 2, 0, 0]))],
                        [Q(5, 0.0, gen_len=2)], SB, 2, MASK)
    assert cs[0].new == [0, 1] and cs[0].masked == [0, 1] and cs[0].due == 1


def test_the_schedule_counts_each_step_and_every_change():
    def ev(*blocks):
        return [Event(0.1 * i, 0, 0, np.array(b)) for i, b in
                enumerate(blocks)]
    q = [Q(0, 0.0, gen_len=SB)]
    sound = ev([MASK, 5, MASK, MASK], [MASK, 5, 6, MASK], [7, 5, 6, MASK],
               [7, 5, 6, 8])
    cs = window.commits(sound, q, SB, 4, MASK)
    assert [c.due for c in cs] == [1, 1, 1, 1]
    assert [c.step for c in cs] == [0, 1, 2, 3]
    assert window.schedule_misses(cs) == 0
    doubled = ev([MASK, 5, 6, MASK], [7, 5, 6, 8])
    assert window.schedule_misses(window.commits(doubled, q, SB, 4, MASK)) \
        == 2
    changed = ev([MASK, 5, MASK, MASK], [MASK, 9, 6, MASK],
                 [7, 9, 6, MASK], [7, 9, 6, 8])
    cs = window.commits(changed, q, SB, 4, MASK)
    assert [c.changed for c in cs] == [0, 1, 0, 0]
    assert window.schedule_misses(cs) == 1
    assert [window.commit_count(32, 32 - j) for j in (0, 31)] == [1, 32]
    assert window.commit_count(5, 2) == 3


DENSE = spec.reference("dense_diffusion")
MODEL = {"n_layers": 2, "d_model": 8, "d_ff": 16, "n_heads": 2,
         "n_kv_heads": 1, "head_dim": 4, "vocab_size": 10, "qkv_bias": True}
PEAK = {"bf16_flops": 1000.0, "hbm_bytes_s": 100.0}


def test_non_embedding_params_and_step_flops():
    attn = 8 * 2 * 4 + 2 * 8 * 1 * 4 + 2 * 4 * 8 + 2 * 4 + 2 * 4
    assert DENSE.token_params(MODEL) == 2 * (attn + 3 * 8 * 16 + 16) + 8
    row = dict(refresh_tokens_real=10, reuse_tokens_real=6,
               logit_tokens_real=3)
    assert flops.step_flops(MODEL, row, DENSE.token_params(MODEL)) == \
        2.0 * DENSE.token_params(MODEL) * 16 + 2.0 * 3 * 8 * 10
    assert flops.token_params({"reference": "dense_diffusion",
                               "model": MODEL}, spec.ROOT) == \
        DENSE.token_params(MODEL)


def _run(rows, tr=None, seconds=2.0):
    return session.Run("c", {"model": MODEL,
                             "serve": {"max_num_logits": 4}},
                       seconds, 1.0, [], [], rows, 3, MASK, PEAK, tr,
                       DENSE.token_params(MODEL))


ROWS = [dict(t=0.1, refresh_tokens_real=10, reuse_tokens_real=6,
             logit_tokens_real=6, logit_tokens_exec=8, n_refresh=1,
             n_reuse=2, plan_s=0.001, fill_s=0.003),
        dict(t=2.5, refresh_tokens_real=5, reuse_tokens_real=0,
             logit_tokens_real=2, logit_tokens_exec=4, n_refresh=1,
             n_reuse=0, plan_s=0.002, fill_s=0.002)]


def test_step_mfu_and_host_readers_take_the_window_rows():
    run = _run(ROWS)
    mfu = spec.metric_reader("step_mfu")(run)
    assert mfu == pytest.approx(100 * flops.step_flops(
        MODEL, ROWS[0], DENSE.token_params(MODEL)) / (2.0 * 1000.0))
    assert spec.metric_reader("steps_per_iter")(run) == 3
    assert spec.metric_reader("host_ms_per_iter")(run) == pytest.approx(4.0)
    assert spec.metric_reader("slots")(run) == 3
    assert spec.metric_reader("step_mfu")(_run(ROWS, seconds=2.0)) > 0


def _trace(device, host=(), window_ns=(0, 2_000_000_000)):
    return trace.TraceData(list(device), list(host), window_ns)


def test_logit_roofline_pairs_calls_with_the_engines_chunks():
    # chunks of max_num_logits 4: row 0 is 8 exec rows -> 4 + 2 real;
    # row 1 is 4 exec rows -> 2 real
    dev = [("logit_partial_kernel", 0, 100), ("logit_merge_kernel", 100, 110),
           ("logit_partial_kernel", 200, 300), ("logit_merge_kernel", 300, 310),
           ("logit_partial_kernel", 400, 450), ("logit_merge_kernel", 450, 460)]
    run = _run(ROWS, _trace(dev))
    bound = sum(flops.logit_bound_s(MODEL, n, PEAK) for n in (4, 2, 2))
    got = spec.metric_reader("logit_roofline")(run)
    assert got == pytest.approx(100 * bound / (280e-9))
    with pytest.raises(RuntimeError):
        spec.metric_reader("logit_roofline")(_run(ROWS, _trace(dev[:4])))
    assert spec.metric_reader("logit_roofline")(_run(ROWS, _trace([]))) \
        is None


def test_idle_share_unions_overlaps_and_clips_to_the_window():
    dev = [("a", -5, 10), ("b", 5, 20), ("c", 30, 40), ("d", 95, 130)]
    host = [("host.sync", 18, 32), ("host.dispatch", 40, 96)]
    tr = _trace(dev, host, (0, 100))
    assert trace.busy_intervals(tr) == [(0, 20), (30, 40), (95, 100)]
    assert trace.busy_s(tr) == pytest.approx(35e-9)
    run = _run([], tr, seconds=100e-9)
    assert spec.metric_reader("device_idle")(run) == pytest.approx(65.0)
    b = trace.breakdown(tr)
    assert dict(b["idle_gaps"]) == pytest.approx(
        {"host.sync": 10e-9, "host.dispatch": 55e-9})
    assert dict(b["device_ops"]) == pytest.approx(
        {"a": 10e-9, "b": 15e-9, "c": 10e-9, "d": 5e-9})
    assert b["device_ops"][0][0] == "b"
    assert spec.metric_reader("device_idle")(_run([], None)) is None
