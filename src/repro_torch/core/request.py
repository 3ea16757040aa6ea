"""Request lifecycle + phase state machine (paper §5.2 control plane).

A copy of ``repro.core.request`` (host-side numpy, no device work). A request
iterates over denoising steps, alternating **Refresh** and **Reuse** phases:
the first step of every block refreshes (block transition), and a fixed
``refresh_interval`` forces periodic refreshes inside a block.

Lifecycle::

    WAITING --admit--> RUNNING --all blocks done--> FINISHED
       |  ^               |
       |  '---preempt-----'      (rollback_block + tail requeue)
       +--deadline expired--> SHED
       +--never admittable--> REJECTED
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.configs.base import ServeConfig
from repro_torch.core import diffusion


class State(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"
    SHED = "shed"            # terminal: dropped by deadline/backpressure policy
    REJECTED = "rejected"    # terminal: never admittable (oversized/queue full)


class Outcome(enum.Enum):
    """Structured terminal outcome (``submitted == finished + shed +
    rejected``)."""
    FINISHED = "finished"
    REJECTED_OVERSIZED = "rejected_oversized"
    REJECTED_QUEUE_FULL = "rejected_queue_full"
    SHED_DEADLINE = "shed_deadline"
    SHED_QUEUE = "shed_queue"


class Phase(enum.Enum):
    REFRESH = "refresh"
    REUSE = "reuse"


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # [P] int32
    gen_len: int
    arrival: float                      # seconds (trace time)
    cfg: ServeConfig
    mask_id: int = 0
    # modality-frontend embeddings (vlm/audio); None for text-only archs
    frontend: Optional[np.ndarray] = None
    deadline: float = math.inf          # absolute trace-time deadline

    state: State = State.WAITING
    # control-plane mirror of the active block: how many positions are still
    # masked, tracked from commit counts alone (commit_tokens unmasks exactly
    # min(n_commit, masked) positions and never writes the mask id)
    masked_left: int = 0
    # bumped by every rollback: an in-flight commit whose epoch no longer
    # matches is stale and its values are dropped on sync
    commit_epoch: int = 0
    slot: Optional[int] = None
    # generation of ``slot`` at allocation (KVPool.take); a mismatch means
    # the slot was freed and recycled under this request
    slot_gen: Optional[int] = None
    tokens: Optional[np.ndarray] = None  # [max_seq_len]
    block_idx: int = 0
    step_in_block: int = 0
    steps_done: int = 0
    n_preempted: int = 0
    recomputed_tokens: int = 0
    outcome: Optional[Outcome] = None
    error: Optional[str] = None
    t_admitted: float = -1.0
    t_first_commit: float = -1.0
    t_finished: float = -1.0

    def __post_init__(self):
        pad = (-self.gen_len) % self.cfg.block_size
        self.gen_len += pad
        # oversized geometry stays constructable (tokens=None) so admission
        # control can reject it with a structured outcome
        if self.total_len <= self.cfg.max_seq_len:
            self.tokens = diffusion.build_sequence(
                self.prompt, self.gen_len, self.cfg.max_seq_len, self.mask_id)
        self.masked_left = self.cfg.block_size

    # -- geometry ----------------------------------------------------------
    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.gen_len

    @property
    def frontend_len(self) -> int:
        return 0 if self.frontend is None else len(self.frontend)

    @property
    def refresh_len(self) -> int:
        """Rows one Refresh materializes: frontend prefix + full text."""
        return self.frontend_len + self.total_len

    @property
    def n_blocks(self) -> int:
        return self.gen_len // self.cfg.block_size

    @property
    def block_start(self) -> int:
        return self.prompt_len + self.block_idx * self.cfg.block_size

    # -- phase machine -------------------------------------------------------
    @property
    def phase(self) -> Phase:
        if self.step_in_block == 0:
            return Phase.REFRESH
        if self.cfg.refresh_interval and \
                self.step_in_block % self.cfg.refresh_interval == 0:
            return Phase.REFRESH
        return Phase.REUSE

    @property
    def query_tokens(self) -> int:
        """Scheduling currency (§4.4): full sequence in Refresh, one block
        in Reuse."""
        if self.phase == Phase.REFRESH:
            return self.refresh_len
        return self.cfg.block_size

    def block_tokens(self) -> np.ndarray:
        s = self.block_start
        return self.tokens[s: s + self.cfg.block_size]

    def block_masked(self) -> int:
        return int((self.block_tokens() == self.mask_id).sum())

    def advance_control(self, n_commit: int, now: float) -> int:
        """Advance the state machine by one committed denoising step without
        the token values; returns the number of newly committed positions."""
        n_act = min(n_commit, self.masked_left)
        if self.t_first_commit < 0 and n_act > 0:
            self.t_first_commit = now
        self.masked_left -= n_act
        self.steps_done += 1
        self.step_in_block += 1
        done_block = self.masked_left == 0 or \
            self.step_in_block >= self.cfg.steps_per_block
        if done_block:
            self.block_idx += 1
            self.step_in_block = 0
            self.masked_left = self.cfg.block_size
            if self.block_idx >= self.n_blocks:
                self.state = State.FINISHED
                self.outcome = Outcome.FINISHED
                self.t_finished = now
        return n_act

    def rollback_block(self) -> int:
        """Preemption rollback: the active block returns to all-mask; returns
        the number of discarded commits (recompute debt)."""
        n = self.cfg.block_size - self.masked_left
        self.block_tokens()[:] = self.mask_id
        self.step_in_block = 0
        self.masked_left = self.cfg.block_size
        self.commit_epoch += 1
        self.recomputed_tokens += n
        return n

    def output_tokens(self) -> np.ndarray:
        return self.tokens[self.prompt_len: self.total_len]

    @property
    def latency(self) -> float:
        return self.t_finished - self.arrival

    @property
    def met_deadline(self) -> bool:
        return self.state == State.FINISHED and self.t_finished <= self.deadline
