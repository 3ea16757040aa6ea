"""Helpers of the benchmark's CPU tests: a tiny cell in a scratch
checkout, served by the real harness on the CPU."""
from __future__ import annotations

import json
import os
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

TINY_MODEL = {"family": "dense", "n_layers": 2, "d_model": 128,
              "n_heads": 4, "n_kv_heads": 2, "head_dim": 32, "d_ff": 256,
              "vocab_size": 2048, "qkv_bias": True, "activation": "silu",
              "rope_theta": 10000.0, "rms_eps": 1e-05,
              "tie_embeddings": False, "dtype": "bfloat16"}

# blocks of 16 tokens in 16 steps, a Refresh every 8; prompts up to 96, so
# that C3 keeps 64 of up to 112 positions outside the block
TINY_SERVE = {"system": "dllm-serve", "max_seq_len": 128,
              "max_num_batched_tokens": 320, "max_num_logits": 64,
              "block_size": 16, "steps_per_block": 16, "refresh_interval": 8,
              "max_refresh_per_iter": 4, "retention_ratio": 0.5,
              "kernel_size": 3, "token_bucket": 16, "max_slots": 6}

TINY_MIX = {"generator": "livebench", "mix_seed": 7, "scale": 0.125,
            "arrivals": "backlog", "fresh": 8, "residents": 4}


def tiny_config(dtype: str = "bfloat16", limit: float = 0.012,
                order: float = 0.0008) -> dict:
    """The tiny configuration. Its bf16 limits sit between the readings
    they were set from (CPU, seeds 11-22 of :func:`make_root`'s cell):
    ``logit_gap`` the program's widest 0.00496 at most, the float8
    control's 0.0163 at least; ``order_regret`` the program's 0.000385 at
    most, a program committing its least confident positions 0.00124 at
    least (seeds 13-16; the control reads 0.000645-0.00128 and fails on
    ``logit_gap``)."""
    return {"name": "tiny", "source": "test", "reference": "dense_diffusion",
            "model": dict(TINY_MODEL, dtype=dtype),
            "assumed": {"card_memory_gib": 79},
            "serve": dict(TINY_SERVE),
            "checks": {"logit_gap": limit, "order_regret": order,
                       "judged_tokens": 32,
                       "sample_tokens": 96, "sample_requests": 4}}


def make_root(tmp: Path, config: dict = None, mix: dict = None,
              extra_metrics: dict = None, per_layer: list = None,
              references: dict = None) -> Path:
    """A scratch checkout: ``BENCHMARK.json`` with one cell ``tiny.cell``,
    its configuration and mix files, the repo's metric readers and
    references (linked), and any ``extra_metrics`` and ``references``
    (name -> source)."""
    sb = tmp / "servebench"
    (sb / "configs").mkdir(parents=True, exist_ok=True)
    (sb / "traffic").mkdir(exist_ok=True)
    (sb / "metrics").mkdir(exist_ok=True)
    for f in (HERE / "metrics").glob("*.py"):
        dst = sb / "metrics" / f.name
        if not dst.exists():
            os.symlink(f, dst)
    (sb / "references").mkdir(exist_ok=True)
    for f in (HERE / "references").glob("*.py"):
        dst = sb / "references" / f.name
        if not dst.exists():
            os.symlink(f, dst)
    for name, src in (extra_metrics or {}).items():
        (sb / "metrics" / f"{name}.py").write_text(src)
    for name, src in (references or {}).items():
        (sb / "references" / f"{name}.py").write_text(src)
    (sb / "configs" / "tiny.json").write_text(
        json.dumps(config or tiny_config()))
    (sb / "traffic" / "tiny.json").write_text(json.dumps(mix or TINY_MIX))
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "test",
                         "file": "servebench/configs/tiny.json",
                         "reduced": [], "why": "a CPU test"}]
    bench["workloads"] = [{"name": "tiny.cell", "config": "tiny",
                           "traffic": "tiny", "chips": 1, "why": "a test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    bench["per_layer"] += per_layer or []
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def run_tiny(root: Path, seed: int = 2 ** 31 + 5, seconds: float = 30.0,
             trace: bool = False) -> dict:
    """One run of ``tiny.cell`` on the CPU through the harness (the card
    check skipped): the result line's object."""
    import torch

    from sbench import execute, spec
    cell = spec.load_cell("tiny.cell", root)
    return execute.execute(cell, seed, seconds, trace, torch.device("cpu"),
                           time.perf_counter(), log=lambda *a: None)


def serve_tiny(root: Path, seed: int = 2 ** 31 + 5,
               seconds: float = 30.0):
    """One window of ``tiny.cell`` served on the CPU through the harness's
    session, the program's state freed and no check run: its ``Run``."""
    import torch

    from sbench import session, spec
    cell = spec.load_cell("tiny.cell", root)
    sess = session.Session(cell, seed, torch.device("cpu"))
    w = sess.window(seed, seconds)
    sess.close()
    return w.run
