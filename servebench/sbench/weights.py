"""Random weights drawn from ``--seed`` on the device, in the type they are
served in, one call a stacked leaf: the same weights go to the program and
to the plain reference.

The layout is the dense family's (the port's ``params`` tree): ``embed``
(``table [V, D]``, ``lm_head [D, V]``), ``final_norm [D]`` and ``stack``
(``attn_norm``, ``mlp_norm [L, D]``; ``wq [L, D, H, dh]``; ``wk``, ``wv
[L, D, K, dh]``; ``wo [L, H, dh, D]``; ``bq [L, H, dh]``, ``bk``, ``bv
[L, K, dh]`` with a QKV bias; ``w_gate``, ``w_up [L, D, F]``; ``w_down
[L, F, D]``). Matrices are N(0, 0.02); norm scales (the ``1 + scale``
convention) and biases are drawn too, N(0, 0.05) and N(0, 0.02), so the
check sees every leaf.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def leaves(cfg: dict) -> List[Tuple[str, str, tuple, float]]:
    """(group, name, shape, std) of every leaf, in draw order."""
    L, D, F, V = (cfg["n_layers"], cfg["d_model"], cfg["d_ff"],
                  cfg["vocab_size"])
    H, K = cfg["n_heads"], cfg["n_kv_heads"]
    dh = cfg.get("head_dim") or D // H
    out = [("embed", "table", (V, D), 0.02),
           ("embed", "lm_head", (D, V), 0.02),
           ("", "final_norm", (D,), 0.05),
           ("stack", "attn_norm", (L, D), 0.05),
           ("stack", "mlp_norm", (L, D), 0.05),
           ("stack", "wq", (L, D, H, dh), 0.02),
           ("stack", "wk", (L, D, K, dh), 0.02),
           ("stack", "wv", (L, D, K, dh), 0.02),
           ("stack", "wo", (L, H, dh, D), 0.02)]
    if cfg.get("qkv_bias"):
        out += [("stack", "bq", (L, H, dh), 0.02),
                ("stack", "bk", (L, K, dh), 0.02),
                ("stack", "bv", (L, K, dh), 0.02)]
    out += [("stack", "w_gate", (L, D, F), 0.02),
            ("stack", "w_up", (L, D, F), 0.02),
            ("stack", "w_down", (L, F, D), 0.02)]
    return out


def allocate(cfg: dict, device) -> Dict[str, object]:
    dtype = DTYPES[cfg["dtype"]]
    tree: Dict[str, object] = {"embed": {}, "stack": {}}
    for group, name, shape, _ in leaves(cfg):
        t = torch.empty(shape, dtype=dtype, device=device)
        (tree[group] if group else tree)[name] = t
    return tree


def draw(tree: Dict[str, object], cfg: dict, seed: int) -> None:
    """Fill ``tree`` in place from ``seed``: the same seed gives the same
    weights, whatever the tree held."""
    dev = tree["embed"]["table"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) & (2 ** 63 - 1))
    for group, name, _, std in leaves(cfg):
        t = (tree[group] if group else tree)[name]
        t.normal_(0.0, std, generator=gen)


def make(cfg: dict, seed: int, device) -> Dict[str, object]:
    tree = allocate(cfg, device)
    draw(tree, cfg, seed)
    return tree
