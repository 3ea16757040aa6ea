"""Mean Refresh plus Reuse steps an iteration, over the iterations planned
in the window (``iter_log`` ``n_refresh + n_reuse``)."""
from sbench import window


def read(run):
    rows = window.window_rows(run.rows, run.seconds)
    if not rows:
        return None
    return sum(r["n_refresh"] + r["n_reuse"] for r in rows) / len(rows)
