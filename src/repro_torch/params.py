"""Model parameters: the module that holds them, random init, and the bridge
from the reference's parameter tree.

The layout is the reference's (``repro.models.backbone.init_params``):
``embed.table [V, D]``, ``embed.lm_head [D, V]`` (absent when tied),
``final_norm [D]`` and ``stack``, which is per family

* dense: ``{attn_norm, mlp_norm [L, D]; wq [L, D, H, dh]; wk, wv
  [L, D, K, dh]; wo [L, H, dh, D]; w_gate, w_up [L, D, F]; w_down
  [L, F, D]}``;
* moe: the dense stack with the experts in place of the MLP: ``router
  [L, D, E]; w_gate, w_up [L, E, D, F]; w_down [L, E, F, D]``;
* ssm: the Mamba2 stack ``{norm [L, D]; w_z [L, D, Din]; w_xbc [L, D, ch];
  w_dt [L, D, Hs]; dt_bias [L, Hs]; conv_w [L, ck, ch]; conv_b [L, ch];
  A_log, D_skip [L, Hs]; gate_norm [L, Din]; out_proj [L, Din, D]}``;
* hybrid: ``{mamba: <the ssm stack>, shared: <one dense layer, unstacked>}``;
* vlm / audio: the dense stack, and beside it ``frontend.proj
  [frontend_dim, D]``, which projects each request's precomputed
  patch or frame embeddings into the model width.

Modules index like the reference's dicts (``params["stack"]["wq"]``), so
the model code reads the same in both packages.
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


def _attn_stack(cfg: ModelConfig, nl: int) -> Dict[str, tuple]:
    D, F = cfg.d_model, cfg.d_ff
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    stack = {"attn_norm": (nl, D), "mlp_norm": (nl, D),
             "wq": (nl, D, H, dh), "wk": (nl, D, K, dh), "wv": (nl, D, K, dh),
             "wo": (nl, H, dh, D)}
    if cfg.qkv_bias:
        stack.update(bq=(nl, H, dh), bk=(nl, K, dh), bv=(nl, K, dh))
    if cfg.is_moe:
        E = cfg.n_experts
        stack.update(router=(nl, D, E), w_gate=(nl, E, D, F),
                     w_up=(nl, E, D, F), w_down=(nl, E, F, D))
    else:
        stack.update(w_gate=(nl, D, F), w_up=(nl, D, F), w_down=(nl, F, D))
    return stack


def _ssm_stack(cfg: ModelConfig, nl: int) -> Dict[str, tuple]:
    D, Din, Hs = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    ch = Din + 2 * cfg.ssm_groups * cfg.ssm_state
    return {"norm": (nl, D), "w_z": (nl, D, Din), "w_xbc": (nl, D, ch),
            "w_dt": (nl, D, Hs), "dt_bias": (nl, Hs),
            "conv_w": (nl, cfg.ssm_conv_kernel, ch), "conv_b": (nl, ch),
            "A_log": (nl, Hs), "D_skip": (nl, Hs), "gate_norm": (nl, Din),
            "out_proj": (nl, Din, D)}


def shapes(cfg: ModelConfig) -> Dict[str, object]:
    """Parameter shapes of an arch, as a tree of dicts with shape leaves."""
    if cfg.family not in ("dense", "moe", "ssm", "hybrid", "vlm", "audio"):
        raise ValueError(f"unknown family {cfg.family!r}")
    embed = {"table": (cfg.vocab_size, cfg.d_model)}
    if not cfg.tie_embeddings:
        embed["lm_head"] = (cfg.d_model, cfg.vocab_size)
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        stack = _attn_stack(cfg, cfg.n_layers)
    elif cfg.family == "ssm":
        stack = _ssm_stack(cfg, cfg.n_layers)
    else:
        shared = {n: s[1:] for n, s in _attn_stack(cfg, 1).items()}
        stack = {"mamba": _ssm_stack(cfg, cfg.n_layers), "shared": shared}
    out = {"embed": embed, "final_norm": (cfg.d_model,), "stack": stack}
    if cfg.frontend_dim:
        out["frontend"] = {"proj": (cfg.frontend_dim, cfg.d_model)}
    return out


_ZERO_INIT = ("bq", "bk", "bv", "dt_bias", "conv_b", "A_log")


def _init(t: torch.Tensor, name: str, generator) -> torch.Tensor:
    """The reference's init law: zero norms and biases, ``A_log = 0`` (so
    A = -1), ``D_skip = 1``, N(0, 0.2) conv taps, N(0, 0.02) elsewhere."""
    if name.endswith("norm") or name in _ZERO_INIT:
        return t.zero_()
    if name == "D_skip":
        return t.fill_(1.0)
    return t.normal_(0.0, 0.2 if name == "conv_w" else 0.02,
                     generator=generator)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Group:
    """Random weights by the reference's init law, drawn directly on
    ``device`` in ``cfg.dtype`` (a full-size model is never staged in host
    float32). ``generator`` must live on ``device``."""
    dtype = DTYPES[cfg.dtype]

    def make(tree):
        return Group({n: make(s) if isinstance(s, dict) else _init(
            torch.empty(s, dtype=dtype, device=device), n, generator)
            for n, s in tree.items()})

    return make(shapes(cfg))


def from_jax(tree, cfg: ModelConfig, device, dtype=None) -> Group:
    """The reference's parameter tree, as numpy arrays, onto ``device``
    (``dtype`` defaults to ``cfg.dtype``). Names and shapes are checked at
    every level of the tree."""
    dtype = dtype or DTYPES[cfg.dtype]

    def conv(node, want, path):
        if isinstance(want, dict):
            if set(node) != set(want):
                raise ValueError(f"{path or 'params'}: names {sorted(node)}, "
                                 f"expected {sorted(want)}")
            return Group({n: conv(node[n], w, f"{path}.{n}" if path else n)
                          for n, w in want.items()})
        a = np.asarray(node)
        if a.shape != tuple(want):
            raise ValueError(f"{path}: shape {a.shape}, expected {want}")
        return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                         dtype=dtype)

    return conv(tree, shapes(cfg), "")


def copy_to(tree: Group, device) -> Group:
    """A copy of a parameter tree on ``device``, nested groups included."""
    out = {n: copy_to(m, device) for n, m in tree.named_children()}
    out.update({n: t.detach().to(device) for n, t in tree.items()})
    return Group(out)
