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
the model code reads the same in both packages. Serving holds the leaves
frozen; the trainer makes its tree :func:`trainable`. On a serving mesh
each rank holds its shard of every leaf (:func:`shard_params`).
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Mapping, Optional, Tuple

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


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                device, cut: Optional[Callable] = None) -> Group:
    """Random weights by the reference's init law, drawn directly on
    ``device`` in ``cfg.dtype`` (a full-size model is never staged in host
    float32). ``generator`` must live on ``device``; with None the leaves
    are left uninitialised, for a checkpoint's restore to fill. ``cut``
    (:func:`shard_cut`) cuts each leaf to this rank's shard as soon as it
    is drawn, so a rank never holds more than one whole leaf."""
    dtype = DTYPES[cfg.dtype]

    def leaf(shape, name, path):
        t = torch.empty(shape, dtype=dtype, device=device)
        t = t if generator is None else _init(t, name, generator)
        return t if cut is None else cut(path, t)

    def make(tree, path):
        return Group({n: make(s, f"{path}{n}/") if isinstance(s, dict)
                      else leaf(s, n, path + n) for n, s in tree.items()})

    return make(shapes(cfg), "")


def from_jax(tree, cfg: ModelConfig, device, dtype=None,
             cut: Optional[Callable] = None) -> Group:
    """The reference's parameter tree, as numpy arrays, onto ``device``
    (``dtype`` defaults to ``cfg.dtype``). Names and shapes are checked at
    every level of the tree. ``cut`` cuts each leaf to this rank's shard
    as it lands, as in :func:`init_params`."""
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
        t = torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                      dtype=dtype)
        return t if cut is None else cut(path.replace(".", "/"), t)

    return conv(tree, shapes(cfg), "")


def shard_cut(rules, mesh) -> Callable:
    """``cut(path, t)``: this rank's shard of the whole leaf ``t`` at
    ``path`` (``stack/wq``) under ``rules`` (``launch.sharding.Rules.
    leaf_spec`` at serve time), a copy of its own; ``t`` itself when the
    rules keep it whole."""
    from repro_torch.launch.sharding import local_slice

    def cut(path: str, t: torch.Tensor) -> torch.Tensor:
        return local_slice(t.detach(), rules.leaf_spec(path, tuple(t.shape)),
                           mesh)
    return cut


def shard_params(tree: Group, rules, mesh) -> Group:
    """This rank's shard of every leaf of ``tree`` under ``rules``: the
    same weights the one-device engine holds, cut by the reference's
    placement law (:func:`shard_cut`). Leaves the rules keep whole stay the
    same tensors, and a tree that is already this rank's shard comes back
    as it is."""
    from repro_torch.launch.sharding import local_slice
    want, cut = shapes(rules.cfg), shard_cut(rules, mesh)

    def walk(group: Group, want, path: str) -> Group:
        out = {n: walk(m, want[n], f"{path}/{n}" if path else n)
               for n, m in group.named_children()}
        for n, t in group.items():
            full, name = tuple(want[n]), f"{path}/{n}" if path else n
            if tuple(t.shape) == full:
                t = cut(name, t)
            elif tuple(t.shape) != tuple(local_slice(
                    torch.empty(full, device="meta"),
                    rules.leaf_spec(name, full), mesh).shape):
                raise ValueError(f"{name}: shape {tuple(t.shape)} is "
                                 f"neither {full} nor this rank's shard")
            out[n] = t
        return Group(out)

    return walk(tree, want, "")


def tree_order(name: str) -> Tuple[str, ...]:
    """Sort key of a dotted leaf name: the order ``jax.tree.flatten`` gives
    the reference's nested dicts (keys sorted at every level)."""
    return tuple(name.split("."))


def named_leaves(tree: Group) -> List[Tuple[str, torch.Tensor]]:
    """Every leaf of a tree with its dotted name (``stack.mamba.w_z``), in
    :func:`tree_order`."""
    return sorted(tree.named_parameters(), key=lambda kv: tree_order(kv[0]))


def trainable(tree: Group) -> Group:
    """The tree itself, its leaves now recording gradients (the trainer's
    parameters; serving keeps them frozen)."""
    for t in tree.parameters():
        t.requires_grad_(True)
    return tree


def copy_to(tree: Group, device) -> Group:
    """A copy of a parameter tree on ``device``, nested groups included."""
    out = {n: copy_to(m, device) for n, m in tree.named_children()}
    out.update({n: t.detach().to(device) for n, t in tree.items()})
    return Group(out)
