"""CPU tests of the serving benchmark: the harness's modules on the path,
and torch's intra-op threads capped so several test workers share the
cores."""
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (HERE, HERE.parent / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    import torch
    torch.set_num_threads(max(1, min(2, (os.cpu_count() or 1) // 6)))
