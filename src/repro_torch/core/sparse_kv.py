"""Head-Centric Sparse KV management (paper C3): public entry points, as
``repro.core.sparse_kv``.

The selection and packing math lives in ``repro_torch.models.sparse_select``
(it runs inside the layer loop); the physical slot pool in
``repro_torch.core.kv_pool``. This module re-exports both, so the
paper-facing names are the reference's.
"""
from repro_torch.core.kv_pool import KVPool                     # noqa: F401
from repro_torch.models.sparse_select import (                  # noqa: F401
    PackedKV, head_scores, pack, select_and_pack, select_indices)
