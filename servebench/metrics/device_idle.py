"""Share of the window, in %, in which no kernel, copy or set ran on the
card: one less the union of the traced device intervals over the window."""
from sbench import trace


def read(run):
    if run.trace is None or run.trace.window is None:
        return None
    return 100.0 * (1.0 - trace.busy_s(run.trace) / run.seconds)
