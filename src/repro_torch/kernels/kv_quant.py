"""int8 KV slot storage: per-(layer, slot) abs-max quantization, as
``repro.kernels.kv_quant`` (plain jnp there, torch ops here: no kernel).

The slot pool's float KV leaves (``PackedKV.k`` / ``PackedKV.v`` — dense,
hybrid's attention group, never the SSM float32 recurrent state, whose
dynamic range a per-slot scale cannot honestly cover) are stored as int8
with one float32 scale per (layer, slot). Quantization runs inside the
pool's write, in the Refresh entry; dequantization at the KV load of the
Reuse entries (``kernels.ops.dequantize_gathered``), so the pool and the
gather out of it stay int8 on the device and the dequantized tensors are
transient activations of the Reuse stage: the gathered cache at its
serving dtype, as an exact pool's gather makes it, beside the int8 gather
(half a bfloat16 gather's bytes). Both directions widen to float32 one
layer at a time, so a captured entry's float32 transient is one layer's.

The quantizer is the reference's op for op: a float32 abs-max over each
leaf's content dims, ``max(amax, 1e-12) / 127``, a *division* by that scale
(a reciprocal multiply would move some values across a rounding boundary
and change their codes), round half to even, clip to ±127, int8.

Error contract: symmetric round-to-nearest over the per-(layer, slot)
abs-max means

    |x - dequant(quant(x))|  <=  scale / 2  =  absmax / 254

for float32 leaves, plus one target-dtype rounding step (~``absmax/256``)
for bfloat16 (:func:`roundtrip_bound`).
"""
from __future__ import annotations

import itertools
from typing import Dict, Tuple

import torch

from repro_torch.core.kv_pool import tree_leaves, tree_map
from repro_torch.models.sparse_select import PackedKV

_QMAX = 127.0


def quant_mask(tree):
    """Same-structure tree of bools: True at the leaves int8 slot storage
    applies to (PackedKV ``k``/``v``), False elsewhere (positions, validity,
    SSM state and conv tails). The one predicate the pool's writes and
    ``budgeting.kv_slot_bytes``'s billing both read."""
    if isinstance(tree, PackedKV):
        return PackedKV(k=True, v=True, pos=False, valid=False)
    if isinstance(tree, dict):
        return {k: quant_mask(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        fields = [quant_mask(f) for f in tree]
        return (type(tree)(*fields) if hasattr(tree, "_fields")
                else type(tree)(fields))
    return False


def quant_leaf_flags(tree) -> list:
    """Flattened :func:`quant_mask`, aligned with ``kv_pool.tree_leaves``
    (the order ``jax.tree.leaves`` gives the reference's same tree)."""
    return tree_leaves(quant_mask(tree))


def map_leaves(fn, tree):
    """``tree`` with ``fn(i, leaf)`` at its ``i``-th leaf (tree_leaves
    order)."""
    index = itertools.count()
    return tree_map(lambda leaf: fn(next(index), leaf), tree)


def _bcast(scale: torch.Tensor, ndim: int) -> torch.Tensor:
    """[L, B] scale broadcast over a leaf's trailing content dims."""
    return scale.reshape(tuple(scale.shape) + (1,) * (ndim - 2))


def quantize_slot_leaves(cache) -> Tuple[object, Dict[str, torch.Tensor]]:
    """Quantize a cache tree's KV leaves (``[L, B, ...]``, slot axis 1).

    Returns the same-structure tree with int8 KV leaves, plus a dict of
    per-leaf ``[L, B]`` float32 scales keyed by the flattened-leaf index
    as a string (the reference's keys)."""
    flags = quant_leaf_flags(cache)
    scales: Dict[str, torch.Tensor] = {}

    def quantize(i, x):
        if not flags[i]:
            return x
        # the abs-max in the leaf's dtype is the float32 one (widening is
        # exact and keeps the order), taken as max(max, -min) so no |x|
        # copy of the leaf is made
        dims = tuple(range(2, x.ndim))
        amax = torch.maximum(x.amax(dim=dims), x.amin(dim=dims).neg())
        scale = amax.float().clamp_min(1e-12) / _QMAX
        scales[str(i)] = scale
        s = _bcast(scale, x.ndim)
        q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
        # dividing by the float32 scale widens x to float32: one layer at a
        # time, so the float32 quotient a captured entry keeps in its pool
        # is a layer's, not the leaf's
        for layer in range(x.shape[0]):
            q[layer] = (x[layer] / s[layer]).round_().clamp_(-_QMAX, _QMAX)
        return q

    return map_leaves(quantize, cache), scales


def dequantize_slot_leaves(qcache, scales: Dict[str, torch.Tensor],
                           dtypes: Dict[str, torch.dtype]):
    """Inverse of :func:`quantize_slot_leaves` for a (gathered) pool view:
    int8 KV leaves scaled back to their original dtype (``dtypes`` carries
    the pre-quantization leaf dtypes under the same keys)."""
    def dequantize(i, x):
        s = scales.get(str(i))
        if s is None:
            return x
        # int8 times a float32 scale is a float32 product, rounded to the
        # leaf's dtype: one layer at a time, so the float32 transient is a
        # layer's; the output is the gathered cache at its serving dtype
        sb = _bcast(s, x.ndim)
        out = torch.empty(x.shape, dtype=dtypes[str(i)], device=x.device)
        for layer in range(x.shape[0]):
            out[layer] = x[layer] * sb[layer]
        return out

    return map_leaves(dequantize, qcache)


def roundtrip_bound(absmax: float, dtype) -> float:
    """Worst-case |x - dq(q(x))| for one value with per-slot abs-max
    ``absmax``: half a quantization step, plus one ulp-scale term when the
    storage round-trips through bfloat16."""
    step = absmax / _QMAX
    extra = absmax / 256.0 if dtype == torch.bfloat16 else 0.0
    return step / 2.0 + extra
