"""Roofline analysis of one dry-run cell (no card required).

Terms (per device; every figure is one rank's):

  compute    = FLOPs / PEAK_FLOPS        (H100 SXM bf16 dense peak)
  memory     = HBM bytes / HBM_BW        (H100 SXM HBM3)
  collective = Σ collective bytes / LINK_BW   (NVLink 4, one direction)

The FLOPs and HBM bytes are the analytic model's (``roofline.flops``).
The collective bytes are the raw result bytes of every collective one
rank's step issued on the dry run's ``launch.mesh.MetaMesh``, by kind
(``all_reduce``, ``all_gather``, ``broadcast``): the reference's
convention (for a ring all-reduce the wire carries 2(n−1)/n × bytes and
for an all-gather (n−1)/n; the raw result bytes are uniform and
conservative).

The reference reads its compiled program's text for two more figures,
``collective_bytes`` (collectives in the XLA HLO, loop-corrected) and
``f32_upcast_bytes`` (the CPU backend's bf16→f32 weight copies). Neither
has a torch counterpart: the port dispatches eagerly and compiles no
program to read, and the meta device upcasts nothing. The dry run's
collective log stands in for the first; the second is 0 by construction.
Beside the analytic FLOPs a record keeps the FLOPs torch counted on the
meta step (``counted_flops_per_device``, ``torch.utils.flop_counter``:
matmuls and attention only).

Peaks are the datasheet's for the NVIDIA H100 80GB HBM3 SXM at its 700 W
limit; a card set below that limit runs slower under load.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Dict

# NVIDIA H100 80GB HBM3 SXM, 700 W: datasheet peaks per card
PEAK_FLOPS = 989e12          # bf16 dense tensor-core FLOP/s
PEAK_FLOPS_F32 = 67e12       # float32 (non-tensor-core) FLOP/s
HBM_BW = 3.35e12             # HBM3 B/s
LINK_BW = 450e9              # NVLink 4, one direction, B/s


@dataclass
class Roofline:
    name: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: Dict[str, int] = field(default_factory=dict)
    temp_bytes_per_device: int = 0
    arg_bytes_per_device: int = 0
    model_flops: float = 0.0         # 6ND (train) / 2ND (serve), global
    counted_flops_per_device: float = 0.0   # torch's count on the meta step
    top_components: list = field(default_factory=list)

    # -- derived terms (seconds) ------------------------------------------
    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_device / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Roofline step time: overlapped model = max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (FLOPs × chips): remat/dispatch waste detector."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization at the roofline step time."""
        denom = self.step_time * PEAK_FLOPS * self.chips
        return self.model_flops / denom if denom else 0.0

    @property
    def counted_to_analytic(self) -> float:
        """Torch's counted FLOPs over the analytic model's, per device."""
        return (self.counted_flops_per_device / self.flops_per_device
                if self.flops_per_device else 0.0)

    def to_dict(self) -> dict:
        d = asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, bottleneck=self.bottleneck,
                 step_time=self.step_time, mfu=self.mfu,
                 useful_flops_ratio=self.useful_flops_ratio,
                 counted_to_analytic=self.counted_to_analytic)
        return d

    def row(self) -> str:
        return (f"{self.name:42s} comp={self.t_compute*1e3:9.3f}ms "
                f"mem={self.t_memory*1e3:9.3f}ms coll={self.t_collective*1e3:9.3f}ms "
                f"[{self.bottleneck:10s}] mfu={self.mfu*100:5.1f}% "
                f"useful={self.useful_flops_ratio*100:5.1f}%")


def analyze_meta(name: str, chips: int, model_flops: float, analytic: dict,
                 coll_breakdown: Dict[str, int], arg_bytes: int,
                 temp_bytes: int, counted_flops: float) -> Roofline:
    """Roofline record of one dry-run cell: the compute and memory terms
    from ``analytic`` (``flops.analytic_cost``), the collective term from
    the meta step's collective log, the buffer sizes and the counted FLOPs
    from the meta step itself."""
    return Roofline(
        name=name, chips=chips,
        flops_per_device=analytic["flops_per_device"],
        bytes_per_device=analytic["bytes_per_device"],
        coll_bytes_per_device=float(sum(coll_breakdown.values())),
        coll_breakdown=dict(coll_breakdown),
        temp_bytes_per_device=int(temp_bytes),
        arg_bytes_per_device=int(arg_bytes),
        model_flops=model_flops,
        counted_flops_per_device=float(counted_flops),
        top_components=analytic.get("top_components", []))


def save_records(path: str, records: list) -> None:
    with open(path, "w") as f:
        json.dump([r if isinstance(r, dict) else r.to_dict() for r in records],
                  f, indent=1)
