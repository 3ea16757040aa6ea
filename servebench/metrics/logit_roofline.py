"""The fused logit kernel's share of its roofline, in %: over every call of
the traced run, the sum of each call's bound (max of its bytes over the
card's bandwidth and 2·rows·D·V over its bf16 peak, the head read once,
rows the call's real logit rows) over the sum of its device time
(``logit_partial_kernel`` + ``logit_merge_kernel``). The calls are the
engine's ``max_num_logits`` chunks of each iteration, held to the
profiler's count of calls."""
from sbench import flops

PARTIAL, MERGE = "logit_partial_kernel", "logit_merge_kernel"


def chunks(run):
    """Real rows of every fused call, in launch order."""
    chunk = run.config["serve"]["max_num_logits"]
    out = []
    for r in run.rows:
        n_exec, n_real = r["logit_tokens_exec"], r["logit_tokens_real"]
        for c0 in range(0, n_exec, min(chunk, n_exec)):
            out.append(max(0, min(chunk, n_real - c0)))
    return out


def read(run):
    if run.trace is None or run.peak is None:
        return None
    parts = run.trace.calls(PARTIAL)
    merges = run.trace.calls(MERGE)
    rows = chunks(run)
    if not parts:
        return None
    if not (len(parts) == len(merges) == len(rows)):
        raise RuntimeError(
            f"logit_roofline: {len(parts)} partial and {len(merges)} merge "
            f"kernels traced against {len(rows)} calls in iter_log")
    model = run.config["model"]
    bound = sum(flops.logit_bound_s(model, n, run.peak) for n in rows)
    busy = sum((e - s) + (me - ms) for (_, s, e), (_, ms, me)
               in zip(parts, merges)) / 1e9
    return 100.0 * bound / busy
