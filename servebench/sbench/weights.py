"""Random weights drawn from ``--seed`` on the device, in the type they are
served in, one call a stacked leaf: the same weights go to the program and
to the plain reference.

The layout is the configuration's reference's: its ``layout(model)``
gives ``(path, shape, std)`` of every leaf in draw order, a path's groups
joined by ``/`` (``embed/table``, ``stack/wq``, ``stack/mamba/w_z``), at
any depth. Here only the drawing: one generator from the seed, one
``normal_`` a leaf in the declared order, in the model's ``dtype``. A new
family is a reference that declares its layout; nothing here changes.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import torch

from sbench import spec

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

Leaves = List[Tuple[str, tuple, float]]


def layout(config: dict, root: Path) -> Leaves:
    """(path, shape, std) of every leaf, in draw order, as the
    configuration's reference declares them."""
    return spec.reference(config["reference"], root).layout(config["model"])


def _parent(tree: Dict[str, object], path: str, make: bool = False):
    *groups, name = path.split("/")
    for g in groups:
        tree = tree.setdefault(g, {}) if make else tree[g]
    return tree, name


def leaf(tree: Dict[str, object], path: str) -> torch.Tensor:
    node, name = _parent(tree, path)
    return node[name]


def allocate(leaves: Leaves, dtype: str, device) -> Dict[str, object]:
    tree: Dict[str, object] = {}
    for path, shape, _ in leaves:
        node, name = _parent(tree, path, make=True)
        node[name] = torch.empty(shape, dtype=DTYPES[dtype], device=device)
    return tree


def draw(tree: Dict[str, object], leaves: Leaves, seed: int) -> None:
    """Fill ``tree`` in place from ``seed``: the same seed gives the same
    weights, whatever the tree held."""
    dev = leaf(tree, leaves[0][0]).device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) & (2 ** 63 - 1))
    for path, _, std in leaves:
        leaf(tree, path).normal_(0.0, std, generator=gen)


def make(leaves: Leaves, dtype: str, seed: int, device) -> Dict[str, object]:
    tree = allocate(leaves, dtype, device)
    draw(tree, leaves, seed)
    return tree
