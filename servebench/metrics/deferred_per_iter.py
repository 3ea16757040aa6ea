"""Mean steps of running requests that an iteration's plan deferred to a
later iteration (a Refresh past the token budget or the cap of Refreshes
an iteration, a Reuse past the budget), over the iterations planned in
the window (``iter_log`` ``deferred``, the engine's counter). None where
the rows carry no such counter."""
from sbench import window


def read(run):
    rows = window.window_rows(run.rows, run.seconds)
    if not rows or any("deferred" not in r for r in rows):
        return None
    return sum(r["deferred"] for r in rows) / len(rows)
