"""Device microseconds a real logit row, over the iterations planned in
the window: the engine's CUDA-event time of its logit entries (``iter_log``
``logit_dev_s``: the upload and the budgeted logit stage) over its real
logit rows. None where the rows carry no device time (off the card, or an
engine without the events)."""
from sbench import window


def read(run):
    rows = [r for r in window.window_rows(run.rows, run.seconds)
            if r.get("logit_dev_s") is not None]
    n = sum(r["logit_tokens_real"] for r in rows)
    if not n:
        return None
    return 1e6 * sum(r["logit_dev_s"] for r in rows) / n
