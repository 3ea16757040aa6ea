"""Mean host milliseconds an engine iteration spends planning and filling
and dispatching its stages (``iter_log`` ``plan_s + fill_s``), over the
iterations planned in the window (the engine's own spans)."""
from sbench import window


def read(run):
    rows = window.window_rows(run.rows, run.seconds)
    if not rows:
        return None
    return 1e3 * sum(r["plan_s"] + r["fill_s"] for r in rows) / len(rows)
