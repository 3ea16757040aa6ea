"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheet, SXM part, dense rates without sparsity, at the full 700 W limit).
A roofline share or an MFU is taken against these."""
from __future__ import annotations

PEAKS = {
    "H100": dict(bf16_flops=989e12, hbm_bytes_s=3.35e12),
}


def peaks(kind: str) -> dict:
    """The peaks of the card whose ``torch.cuda.get_device_name`` is
    ``kind``."""
    for key, p in PEAKS.items():
        if key in kind:
            return p
    raise KeyError(f"no published peaks for {kind!r}")
