"""Fault-tolerant training loop of ``repro.train.train_loop``: gradient
accumulation, remat, checkpoint/restart, straggler detection, optional
gradient compression.

``make_train_step`` builds the step:

  grads = (1/M) Σ_microbatch ∇ loss    (autograd, a microbatch at a time)
  params, opt = AdamW(params, grads)   (in place)

Fault-tolerance contract (as the reference's, ``tests/test_train.py``):
  * checkpoint every ``ckpt_every`` steps (async, step-atomic),
  * ``Trainer`` resumes from the latest checkpoint if one exists — a
    crashed node restarting mid-run loses at most ``ckpt_every`` steps,
  * a step slower than ``straggler_factor`` × the running median is
    recorded as a straggler.

The reference's ``Trainer.run`` passes no frontend, so it trains no
vlm/audio arch; neither does this one. ``make_train_step`` takes one.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data.pipeline import to_device
from repro_torch.device import resolve
from repro_torch.params import init_params, named_leaves, trainable
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import loss as loss_lib
from repro_torch.train.optimizer import (adamw_update, compress_grads,
                                         init_opt_state)


def microbatch_grads(params, leaves, cfg: ModelConfig, tc: TrainConfig,
                     tokens, generator, frontend=None):
    """One microbatch's loss and its gradients with respect to ``leaves``
    (every one, zeros where unused), compressed by
    ``tc.grad_compression``."""
    loss, _ = loss_lib.loss_fn(params, cfg, tc, tokens, generator, frontend)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss, compress_grads(grads, tc.grad_compression)


def make_train_step(cfg: ModelConfig, tc: TrainConfig,
                    total_steps: int = 10_000) -> Callable:
    """Returns step(params, opt, tokens [G, S], generator, frontend=None)
    -> (params, opt, metrics {loss, grad_norm, lr}: device scalars).

    ``G = microbatches × per-step batch``; one microbatch's activations
    live at a time. Each microbatch's gradients are compressed, then
    accumulated as ``grad / M`` in float32 (bf16 under ``bf16``
    compression); the sum is compressed again before AdamW. ``frontend``
    [G, F, frontend_dim] splits with the tokens."""

    def step(params, opt, tokens, generator, frontend=None):
        M = tc.microbatches
        if tokens.shape[0] % M:
            raise ValueError(f"global batch {tokens.shape[0]} is not a "
                             f"multiple of {M} microbatches")
        leaves = [t for _, t in named_leaves(params)]
        acc_dtype = (torch.bfloat16 if tc.grad_compression == "bf16"
                     else torch.float32)
        acc = [torch.zeros(p.shape, dtype=acc_dtype, device=p.device)
               for p in leaves]
        total = torch.zeros((), dtype=torch.float32, device=tokens.device)
        fes = frontend.chunk(M) if frontend is not None else [None] * M
        for tok, fe in zip(tokens.chunk(M), fes):
            loss, grads = microbatch_grads(params, leaves, cfg, tc, tok,
                                           generator, fe)
            with torch.no_grad():
                for a, g in zip(acc, grads):
                    a.add_(g.to(a.dtype) / M)
                total += loss.detach() / M
            del grads, loss
        acc = compress_grads(acc, tc.grad_compression)
        params, opt, om = adamw_update(params, acc, opt, tc, total_steps)
        om["loss"] = total
        return params, opt, om

    return step


@dataclass
class TrainerEvents:
    stragglers: List[dict] = field(default_factory=list)
    restarts: int = 0
    checkpoints: int = 0


class Trainer:
    """The reference's trainer on ``device`` (the card unless the caller
    asks for the CPU). Parameters are random by the reference's init law
    from ``seed`` (a ``torch.Generator``), or, with no random draw, restored
    with the optimizer state from the latest checkpoint under
    ``ckpt_dir``."""

    def __init__(self, cfg: ModelConfig, tc: TrainConfig, ckpt_dir: str,
                 global_batch: int, seq_len: int, seed: int = 0,
                 total_steps: int = 1000, ckpt_every: int = 20,
                 straggler_factor: float = 3.0, device="cuda"):
        self.cfg, self.tc = cfg, tc
        self.device = resolve(device)
        self.ckpt_dir = ckpt_dir
        self.global_batch, self.seq_len = global_batch, seq_len
        self.total_steps, self.ckpt_every = total_steps, ckpt_every
        self.straggler_factor = straggler_factor
        self.events = TrainerEvents()
        self.step_fn = make_train_step(cfg, tc, total_steps)
        resume = ckpt_lib.latest_step(ckpt_dir) is not None
        gen = None if resume else torch.Generator(
            self.device).manual_seed(seed)
        self.params = trainable(init_params(cfg, gen, self.device))
        self.opt = init_opt_state(self.params)
        self.start_step = 0
        if resume:
            state = self.state()
            self.start_step, saved = ckpt_lib.restore(ckpt_dir, like=state)
            with torch.no_grad():
                for name, t in state.items():
                    t.copy_(saved[name])
            self.events.restarts += 1
        self.rng = torch.Generator(self.device).manual_seed(seed + 17)

    def state(self) -> Dict[str, torch.Tensor]:
        """The checkpointed tensors by dotted name: ``params.*``,
        ``opt.m.*``, ``opt.v.*`` and ``opt.step``."""
        out = {f"params.{n}": t for n, t in named_leaves(self.params)}
        for k in ("m", "v"):
            out.update({f"opt.{k}.{n}": t for n, t in self.opt[k].items()})
        out["opt.step"] = self.opt["step"]
        return out

    def run(self, n_steps: int, data_fn: Callable[[int], np.ndarray],
            crash_at: Optional[int] = None, quiet: bool = True) -> List[dict]:
        """data_fn(step) -> tokens [G, S]. ``crash_at`` simulates a node
        failure (raises) for the restart test."""
        logs = []
        durations: List[float] = []
        pending_io = None
        for s in range(self.start_step, self.start_step + n_steps):
            if crash_at is not None and s == crash_at:
                raise RuntimeError(f"simulated node failure at step {s}")
            t0 = time.perf_counter()
            tokens = to_device(data_fn(s), self.device)
            self.params, self.opt, m = self.step_fn(
                self.params, self.opt, tokens, self.rng)
            # the step's one host read: its metrics
            keys = sorted(m)
            vals = torch.stack([m[k] for k in keys])
            m = dict(zip(keys, vals.tolist()))  # lint: allow(host-sync)
            dt = time.perf_counter() - t0
            durations.append(dt)
            med = float(np.median(durations))
            if len(durations) > 5 and dt > self.straggler_factor * med:
                self.events.stragglers.append({"step": s, "dt": dt,
                                               "median": med})
            m.update(step=s, dt=dt)
            logs.append(m)
            if not quiet:
                print(f"step {s}: loss={m['loss']:.4f} dt={dt*1e3:.0f}ms")
            if (s + 1) % self.ckpt_every == 0:
                if pending_io is not None:
                    pending_io.join()
                pending_io = ckpt_lib.save(self.ckpt_dir, s + 1, self.state())
                self.events.checkpoints += 1
        if pending_io is not None:
            pending_io.join()
        self.start_step += n_steps
        return logs
