"""The readers of the engine's stage and loop spans on synthetic
``iter_log`` rows: each figure from the window's rows, None off the card
(device times None) and None from an engine whose rows lack the keys."""
import pytest

from sbench import session, spec

DEVICE = ("refresh_us_per_tok", "reuse_us_per_tok", "logit_us_per_row",
          "gap_ms_per_iter")
HOST = ("land_ms_per_iter", "deferred_per_iter")


def _row(t, **kw):
    r = dict(t=t, n_refresh=1, n_reuse=2, refresh_tokens_real=100,
             reuse_tokens_real=64, logit_tokens_real=96, plan_s=0.001,
             fill_s=0.002, sync_s=0.003, land_s=0.0005, deferred=1,
             idle_laps=0, refresh_dev_s=0.002, reuse_dev_s=0.004,
             logit_dev_s=0.0003, iter_dev_s=0.007, gap_dev_s=0.001)
    r.update(kw)
    return r


# the last row was planned past the 2 s window; the second followed two
# empty laps (a quiet period: its gap is no wait on the host); the first
# has no predecessor
ROWS = [_row(0.1, gap_dev_s=None),
        _row(0.5, idle_laps=2, gap_dev_s=0.5, deferred=0,
             refresh_tokens_real=0, refresh_dev_s=0.0),
        _row(1.0, land_s=0.0015, deferred=2, gap_dev_s=0.003),
        _row(2.5, land_s=9.0, deferred=9, refresh_dev_s=9.0,
             gap_dev_s=9.0)]


def _run(rows, seconds=2.0):
    return session.Run("c", {}, seconds, 1.0, [], [], rows, 3, 99, None)


def read(name, rows):
    return spec.metric_reader(name)(_run(rows))


def test_each_reader_takes_the_window_rows():
    assert read("refresh_us_per_tok", ROWS) == pytest.approx(
        1e6 * 0.004 / 200)
    assert read("reuse_us_per_tok", ROWS) == pytest.approx(
        1e6 * 0.012 / 192)
    assert read("logit_us_per_row", ROWS) == pytest.approx(
        1e6 * 0.0009 / 288)
    # only the third row waited on the host alone
    assert read("gap_ms_per_iter", ROWS) == pytest.approx(3.0)
    assert read("land_ms_per_iter", ROWS) == pytest.approx(
        1e3 * (0.0005 + 0.0005 + 0.0015) / 3)
    assert read("deferred_per_iter", ROWS) == pytest.approx(1.0)


def test_a_sync_cut_by_the_window_leaves_its_landing_out():
    rows = ROWS[:2] + [_row(1.0, land_s=None)]
    assert read("land_ms_per_iter", rows) == pytest.approx(0.5)


@pytest.mark.parametrize("name", DEVICE)
def test_device_readers_read_nothing_off_the_card(name):
    keys = ("refresh_dev_s", "reuse_dev_s", "logit_dev_s", "iter_dev_s",
            "gap_dev_s")
    rows = [_row(t, **dict.fromkeys(keys)) for t in (0.1, 0.5)]
    assert read(name, rows) is None


@pytest.mark.parametrize("name", DEVICE + HOST)
def test_rows_without_the_keys_read_nothing(name):
    """An engine that predates the spans and counters: the reader returns
    None and does not raise."""
    bare = [dict(t=t, n_refresh=1, n_reuse=2, refresh_tokens_real=100,
                 reuse_tokens_real=64, logit_tokens_real=96, plan_s=0.001,
                 fill_s=0.002, sync_s=0.003) for t in (0.1, 0.5)]
    assert read(name, bare) is None
    assert read(name, []) is None
