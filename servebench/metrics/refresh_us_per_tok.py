"""Device microseconds a real Refresh token, over the iterations planned in
the window: the engine's CUDA-event time of its Refresh entries
(``iter_log`` ``refresh_dev_s``: the upload and the replay, the padded
path's chunks added) over its real Refresh tokens. None where the rows
carry no device time (off the card, or an engine without the events)."""
from sbench import window


def read(run):
    rows = [r for r in window.window_rows(run.rows, run.seconds)
            if r.get("refresh_dev_s") is not None]
    tokens = sum(r["refresh_tokens_real"] for r in rows)
    if not tokens:
        return None
    return 1e6 * sum(r["refresh_dev_s"] for r in rows) / tokens
