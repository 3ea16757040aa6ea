"""Device microseconds a real Reuse token, over the iterations planned in
the window: the engine's CUDA-event time of its Reuse entries (``iter_log``
``reuse_dev_s``: the upload, the pool's gather and the block's pass) over
its real Reuse tokens. None where the rows carry no device time (off the
card, or an engine without the events)."""
from sbench import window


def read(run):
    rows = [r for r in window.window_rows(run.rows, run.seconds)
            if r.get("reuse_dev_s") is not None]
    tokens = sum(r["reuse_tokens_real"] for r in rows)
    if not tokens:
        return None
    return 1e6 * sum(r["reuse_dev_s"] for r in rows) / tokens
