"""Mean device milliseconds between an iteration's last device operation
(its outputs' copy to the host) and the next iteration's first stage, over
the iterations planned in the window that followed their predecessor with
no empty lap (``iter_log`` ``gap_dev_s`` where ``idle_laps`` is 0): the
device waiting on the host's landing and fill, not on work to arrive. None
where the rows carry no device time (off the card, or an engine without
the events)."""
from sbench import window


def read(run):
    gaps = [r["gap_dev_s"] for r in window.window_rows(run.rows, run.seconds)
            if r.get("gap_dev_s") is not None and r.get("idle_laps") == 0]
    if not gaps:
        return None
    return 1e3 * sum(gaps) / len(gaps)
