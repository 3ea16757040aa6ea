"""Model parameters: the module that holds them, random init, and the bridge
from the reference's parameter tree.

The layout is the reference's (``repro.models.backbone.init_params``):
``embed.table [V, D]``, ``embed.lm_head [D, V]`` (absent when tied),
``final_norm [D]`` and the stacked ``stack.{attn_norm, mlp_norm [L, D];
wq [L, D, H, dh]; wk, wv [L, D, K, dh]; wo [L, H, dh, D]; w_gate, w_up
[L, D, F]; w_down [L, F, D]}``. Modules index like the reference's dicts
(``params["stack"]["wq"]``), so the model code reads the same in both
packages.
"""
from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


class Group(nn.Module):
    """A named group of frozen tensors, indexable like a dict."""

    def __init__(self, tensors: Mapping[str, object]):
        super().__init__()
        for name, t in tensors.items():
            if isinstance(t, nn.Module):
                self.add_module(name, t)
            else:
                self.register_parameter(name, nn.Parameter(t,
                                                           requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def items(self) -> Iterator[Tuple[str, torch.Tensor]]:
        return self.named_parameters(recurse=False)


def shapes(cfg: ModelConfig) -> Dict[str, Dict[str, tuple]]:
    """Parameter shapes of a dense-family arch, by group."""
    if cfg.family != "dense" or cfg.frontend_dim:
        raise NotImplementedError(
            f"parameters of family {cfg.family!r} are not ported yet "
            f"(ROADMAP Queue A)")
    nl, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    H, K, dh, V = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, \
        cfg.vocab_size
    embed = {"table": (V, D)}
    if not cfg.tie_embeddings:
        embed["lm_head"] = (D, V)
    stack = {"attn_norm": (nl, D), "mlp_norm": (nl, D),
             "wq": (nl, D, H, dh), "wk": (nl, D, K, dh), "wv": (nl, D, K, dh),
             "wo": (nl, H, dh, D)}
    if cfg.qkv_bias:
        stack.update(bq=(nl, H, dh), bk=(nl, K, dh), bv=(nl, K, dh))
    stack.update(w_gate=(nl, D, F), w_up=(nl, D, F), w_down=(nl, F, D))
    return {"embed": embed, "final_norm": (D,), "stack": stack}


def _is_zero_init(name: str) -> bool:
    return name.endswith("norm") or name in ("bq", "bk", "bv")


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Group:
    """Random weights N(0, 0.02) and zero norms/biases, drawn directly on
    ``device`` in ``cfg.dtype`` (a full-size model is never staged in host
    float32). ``generator`` must live on ``device``."""
    dtype = DTYPES[cfg.dtype]

    def make(name, shape):
        t = torch.empty(shape, dtype=dtype, device=device)
        if _is_zero_init(name):
            return t.zero_()
        return t.normal_(0.0, 0.02, generator=generator)

    tree = shapes(cfg)
    return Group({
        "embed": Group({n: make(n, s) for n, s in tree["embed"].items()}),
        "final_norm": make("final_norm", tree["final_norm"]),
        "stack": Group({n: make(n, s) for n, s in tree["stack"].items()}),
    })


def from_jax(tree, cfg: ModelConfig, device, dtype=None) -> Group:
    """The reference's parameter tree, as numpy arrays, onto ``device``
    (``dtype`` defaults to ``cfg.dtype``). Names and shapes are checked."""
    dtype = dtype or DTYPES[cfg.dtype]
    want = shapes(cfg)

    def conv(x, shape, name):
        a = np.asarray(x)
        if a.shape != tuple(shape):
            raise ValueError(f"{name}: shape {a.shape}, expected {shape}")
        return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                         dtype=dtype)

    groups = {}
    for g in ("embed", "stack"):
        if set(tree[g]) != set(want[g]):
            raise ValueError(f"{g}: names {sorted(tree[g])}, expected "
                             f"{sorted(want[g])}")
        groups[g] = Group({n: conv(tree[g][n], s, f"{g}.{n}")
                           for n, s in want[g].items()})
    return Group({"embed": groups["embed"],
                  "final_norm": conv(tree["final_norm"], want["final_norm"],
                                     "final_norm"),
                  "stack": groups["stack"]})
