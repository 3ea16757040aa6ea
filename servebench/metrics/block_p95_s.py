"""95th percentile of block latency over the window: each completed block
from the request's previous block (or its due time); a fresh request due
in the window with no block counts at the window's end less its due time;
an in-flight resident's first block is left out (host clock)."""
from sbench import window


def read(run):
    return window.percentile(
        window.block_latencies(run.events, run.reqs, run.mask_id,
                               run.seconds), 95)
