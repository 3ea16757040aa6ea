"""90th percentile, over fresh requests due in the window, of the time
from due to the first block on the host (the window's end for one still
without it): the phase scheduler's admission (host clock)."""
from sbench import window


def read(run):
    return window.percentile(
        window.first_block_latencies(run.events, run.reqs, run.mask_id,
                                     run.seconds), 90)
