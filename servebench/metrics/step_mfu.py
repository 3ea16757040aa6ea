"""Model FLOPs of the window's real tokens over the window times the
card's bf16 peak, in %: 2 x the parameters a Refresh or Reuse token
multiplies (the reference's count, carried by the run) plus 2·D·V a logit
row (attention left out: a lower bound)."""
from sbench import flops, window


def read(run):
    if run.peak is None or run.token_params is None:
        return None
    rows = window.window_rows(run.rows, run.seconds)
    model = run.config["model"]
    work = sum(flops.step_flops(model, r, run.token_params) for r in rows)
    return 100.0 * work / (run.seconds * run.peak["bf16_flops"])
