"""Grid auditor: every arch × serving mesh, no devices, as
``repro.analysis.trace_audit``.

Three checks per ``(arch, mesh_shape)`` cell, all CPU-fast:

1. **Partition-plan law** — ``kernel_partition_plan(full_cfg, serve)`` with
   the kernel flags on (``use_flash_kernel=True, logit_mode='fused'``):
   the cell either yields a plan (every kernel dim divides the model axis)
   or raises the documented divisibility error. An *undocumented* exception
   is a failure.
2. **Rules divisibility walk** — the full parameter spec tree over a
   :class:`~repro_torch.launch.mesh.SimMesh` of that shape (leaf shapes
   from ``params.shapes``; no tensors are built): every sharded dim must
   divide exactly by its mesh axes (``sharding.local_slice`` refuses an
   uneven cut, and rank 0's shard of every leaf is cut on meta under a
   ``MetaMesh``), and the serving cache and batch specs must generate for
   the pool geometry.
3. **Stage shapes** — every engine stage (refresh, refresh_packed, reuse,
   reuse_packed, decode, decode_packed) runs on meta tensors on a
   ``reduced()`` config with the warmup's dummy geometry, and each
   output leaf's shape is recorded under the reference's ``keystr``
   path. The stages run their plain versions: a kernel wrapper computes
   nothing on meta, and each kernel's contract is its plain version's
   shapes. No mesh is active, so the traces are mesh-independent and run
   once per arch; checks 1-2 cover the per-mesh law.

``run_grid_audit()`` returns an :class:`AuditReport`; the CLI
(``python -m repro_torch.analysis --grid-audit``) fails on any ``error``
cell.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import ServeConfig, reduced
from repro_torch.launch.mesh import MetaMesh, SimMesh, axis_size
from repro_torch.launch.sharding import (Rules, kernel_partition_plan,
                                         spec_axes)
from repro_torch.params import DTYPES, init_params, shard_cut
from repro_torch.params import shapes as param_shapes

MESH_SHAPES: Tuple[Tuple[int, int], ...] = ((1, 1), (1, 2), (2, 1), (2, 2))

# the documented divisibility error (launch/sharding.kernel_partition_plan)
_DOC_ERR = "cannot partition over the"
META = torch.device("meta")


def _serve_for(mesh_shape: Tuple[int, int]) -> ServeConfig:
    """Kernel-flag serve knobs at audit geometry (tiny)."""
    return ServeConfig(max_seq_len=64, block_size=8, token_bucket=32,
                       max_slots=4, max_num_batched_tokens=512,
                       max_num_logits=64, vocab_tile=64,
                       use_flash_kernel=True, logit_mode="fused",
                       varlen_pack=True,
                       mesh_shape=None if mesh_shape == (1, 1)
                       else mesh_shape)


@dataclass
class AuditCell:
    arch: str
    mesh: Tuple[int, int]
    status: str                    # "ok" | "expected-raise" | "error"
    detail: str = ""
    plan: Optional[dict] = None

    def to_dict(self) -> dict:
        return {"arch": self.arch, "mesh": list(self.mesh),
                "status": self.status, "detail": self.detail,
                "plan": self.plan}


@dataclass
class AuditReport:
    cells: List[AuditCell] = field(default_factory=list)
    stage_shapes: Dict[str, dict] = field(default_factory=dict)
    elapsed_s: float = 0.0

    @property
    def errors(self) -> List[AuditCell]:
        return [c for c in self.cells if c.status == "error"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def to_dict(self) -> dict:
        return {"ok": self.ok, "elapsed_s": round(self.elapsed_s, 2),
                "cells": [c.to_dict() for c in self.cells],
                "stage_shapes": self.stage_shapes}


# ---------------------------------------------------------------------------
# check 2: Rules divisibility walk
# ---------------------------------------------------------------------------

def _leaves(tree, path=""):
    """``(path, shape)`` of every leaf of a ``params.shapes`` tree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}" if path else k)
    else:
        yield path, tuple(tree)


def _check_rules_divisibility(cfg, mesh: SimMesh, pshapes) -> List[str]:
    """Every sharded dim of every param spec must divide by its axes."""
    rules = Rules(cfg, mesh, train=False)
    bad: List[str] = []
    for path, shape in _leaves(pshapes):
        spec = rules.leaf_spec(path, shape)
        for dim, entry in zip(shape, spec):
            axes = spec_axes(entry)
            if not axes:
                continue
            n = axis_size(mesh, axes)
            if n and dim % n:
                bad.append(f"{path}: dim {dim} % {axes}={n} != 0")
    # rank 0's shard of every leaf cuts (on meta, under the same rules)
    if not bad:
        init_params(cfg, None, META,
                    cut=shard_cut(rules, MetaMesh(tuple(mesh.shape.values()))))
    # serving cache layouts must generate (and divide) for the pool geometry
    serve = _serve_for((axis_size(mesh, "data"), axis_size(mesh, "model")))
    retain = min(serve.retained_len, serve.max_seq_len - serve.block_size)
    rules.cache(serve.max_slots + 1, retain, data_parallel=False)
    rules.cache(serve.max_slots + 1, retain, data_parallel=False,
                slot_data_parallel=True)
    rules.tokens(serve.max_slots)
    return bad


# ---------------------------------------------------------------------------
# check 3: stage shapes on meta tensors (mesh-independent, once per arch)
# ---------------------------------------------------------------------------

def keystr_shapes(out) -> Dict[str, list]:
    """``{path: shape}`` of every tensor leaf of ``out``, each path spelled
    as ``jax.tree_util.keystr`` spells the reference's (``.field`` for a
    named tuple, ``[i]`` for a tuple, ``''`` for a bare tensor)."""
    shapes: Dict[str, list] = {}

    def walk(node, path):
        if isinstance(node, torch.Tensor):
            shapes[path] = list(node.shape)
        elif hasattr(node, "_fields"):
            for f in node._fields:
                walk(getattr(node, f), f"{path}.{f}")
        elif isinstance(node, tuple):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")
    walk(out, "")
    return shapes


def _trace_stages(name: str) -> dict:
    """All six engine stages on meta tensors at the warmup's dummy
    geometry; their output shapes."""
    from repro_torch.models import backbone as BB
    from repro_torch.models import layers as L
    from repro_torch.models import lm_head as LM
    from repro_torch.models import transformer as T

    cfg = reduced(get_config(name))
    serve = _serve_for((1, 1))
    S, Sb = serve.max_seq_len, serve.block_size
    F = cfg.frontend_len if cfg.frontend_dim else 0
    retain = min(serve.retained_len, S - Sb)
    # the plain versions: a kernel wrapper computes nothing on meta
    ctx = T.ServeContext(
        block_size=Sb, retain=retain, kernel_size=serve.kernel_size,
        selection=serve.selection,
        q_chunk=min(L.DEFAULT_Q_CHUNK, S),
        use_flash_kernel=False, max_seq_len=S)
    mode = "chunked"

    def e(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=META)

    i32, b = torch.int32, 2
    params = init_params(cfg, None, META)
    fe = e((b, F, cfg.frontend_dim), torch.float32) if F else None
    dt = DTYPES[cfg.dtype]
    shapes: dict = {}
    # padded refresh: tokens [b, S], valid [b, F+S], block_start [b]
    ref = BB.serve_refresh(params, cfg, e((b, S), i32), e((b,), i32), ctx,
                           token_valid=e((b, F + S), torch.bool),
                           frontend=fe)
    shapes["refresh"] = keystr_shapes(ref)
    # packed refresh: one ragged stream of tp tokens over b segments
    tp = -(-(b * (S + F)) // serve.token_bucket) * serve.token_bucket
    refp = BB.serve_refresh_packed(
        params, cfg, e((tp,), i32), e((tp,), i32), e((tp,), i32),
        e((tp,), torch.bool), e((b,), i32), e((b,), i32), e((b,), i32), ctx,
        frontend=fe)
    shapes["refresh_packed"] = keystr_shapes(refp)
    # reuse consumes refresh's captured cache
    reu = BB.serve_reuse(params, cfg, e((b, Sb), i32), e((b, Sb), i32),
                         ref.cache, ctx)
    shapes["reuse"] = keystr_shapes(reu)
    reup = BB.serve_reuse_packed(params, cfg, e((b * Sb,), i32),
                                 e((b * Sb,), i32), refp.cache, ctx)
    shapes["reuse_packed"] = keystr_shapes(reup)
    n = serve.max_num_logits
    dec = LM.decode_tokens(params["embed"], cfg, e((n, cfg.d_model), dt),
                           max_num_logits=serve.max_num_logits, mode=mode)
    shapes["decode"] = keystr_shapes(dec)
    decp = LM.decode_tokens_packed(
        params["embed"], cfg, e((n, cfg.d_model), dt), e((n,), torch.bool),
        max_num_logits=serve.max_num_logits, mode=mode)
    shapes["decode_packed"] = keystr_shapes(decp)
    # block-hidden sanity: refresh must hand the decode stage d_model rows
    for stage, out in (("refresh", ref), ("refresh_packed", refp),
                       ("reuse", reu), ("reuse_packed", reup)):
        bh = getattr(out, "block_hidden", out)
        if bh.shape[-1] != cfg.d_model:
            raise AssertionError(
                f"{name}/{stage}: hidden last dim {bh.shape[-1]} != "
                f"d_model {cfg.d_model}")
    return shapes


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def run_grid_audit(archs: Optional[Sequence[str]] = None,
                   mesh_shapes: Sequence[Tuple[int, int]] = MESH_SHAPES,
                   trace_stages: bool = True) -> AuditReport:
    t0 = time.perf_counter()
    report = AuditReport()
    names = list(archs) if archs is not None else sorted(ARCHS)
    for name in names:
        full_cfg = get_config(name)
        pshapes = param_shapes(full_cfg)
        if trace_stages:
            try:
                report.stage_shapes[name] = _trace_stages(name)
            except Exception as e:  # a stage that cannot run is an error
                report.cells.append(AuditCell(
                    name, (0, 0), "error", f"stage trace failed: {e!r}"))
                continue
        for mesh_shape in mesh_shapes:
            serve = _serve_for(mesh_shape)
            try:
                plan = kernel_partition_plan(full_cfg, serve)
            except ValueError as e:
                if _DOC_ERR in str(e):
                    report.cells.append(AuditCell(
                        name, mesh_shape, "expected-raise", str(e)))
                else:
                    report.cells.append(AuditCell(
                        name, mesh_shape, "error",
                        f"undocumented ValueError: {e}"))
                continue
            except Exception as e:
                report.cells.append(AuditCell(
                    name, mesh_shape, "error", f"unexpected: {e!r}"))
                continue
            try:
                bad = _check_rules_divisibility(
                    full_cfg, SimMesh(mesh_shape), pshapes)
            except Exception as e:
                report.cells.append(AuditCell(
                    name, mesh_shape, "error", f"Rules walk failed: {e!r}",
                    plan=plan))
                continue
            if bad:
                report.cells.append(AuditCell(
                    name, mesh_shape, "error",
                    "uneven shards: " + "; ".join(bad[:5]), plan=plan))
            else:
                report.cells.append(AuditCell(
                    name, mesh_shape, "ok", plan=plan))
    report.elapsed_s = time.perf_counter() - t0
    return report
