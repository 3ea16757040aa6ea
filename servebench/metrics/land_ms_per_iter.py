"""Mean host milliseconds an iteration's sync spends after its wait, over
the iterations planned in the window: committing each request's ids into
its block and firing the stream callback (``iter_log`` ``land_s``, the
engine's own span). None where the rows carry no such span."""
from sbench import window


def read(run):
    lands = [r["land_s"] for r in window.window_rows(run.rows, run.seconds)
             if r.get("land_s") is not None]
    if not lands:
        return None
    return 1e3 * sum(lands) / len(lands)
