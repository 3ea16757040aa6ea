"""Sharding rules: the parameter and serving-cache partition specs of any
arch on a ``(data, model)`` or ``(pod, data, model)`` mesh, as
``repro.launch.sharding``.

Strategy (the reference's):

* **TP** over ``model``: attention heads, the FFN hidden, the SSM inner
  width (when the state heads divide), the vocabulary (embedding table
  and output head), and the MoE experts.
* **FSDP** over ``data`` in training; serving replicates the weights over
  ``data``, except the MoE expert stacks (``fsdp_always``). The pod axis
  is pure data parallelism: no weight shards over it.
* **The MoE placement, as the reference computes it**: ``w_gate`` /
  ``w_up`` ``[nl, E, D, F]`` split ``E`` over ``model`` and ``D`` over
  ``data``; ``w_down`` ``[nl, E, F, D]`` fails the reference's
  ``shape[-3] == F`` test (``shape[-3]`` is ``E``) and so takes the dense
  rule, ``F`` over ``model`` with every expert on every rank; the router
  is whole. ``models.moe`` computes on this placement.
* **Divisibility**: a dimension is sharded only when the axis divides it
  exactly; otherwise it stays whole on every rank (gemma-2b's one KV head
  on a 2-way model axis).

Serving caches: the slot pool shards its slot axis over the data axes
(``slot_data_parallel``: ``data``, or ``('pod', 'data')``) and, within a
slot, the KV heads over ``model``
when they divide, else the retained length (the idle-TP fallback); SSM
states shard over their heads, conv tails stay whole. The streams a stage
computes use the same within-slot layout with the slot axis whole
(``data_parallel=False``).

A spec is a plain tuple with one entry per dimension: an axis name, a
tuple of names, or None. :func:`local_slice` cuts a rank's shard of a
tensor by its spec; :func:`kernel_partition_plan` is the per-shard law of
the kernels, checked before any group is built.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import axis_size, data_axes


def P(*entries) -> tuple:
    """A partition spec (the reference's ``PartitionSpec``) as a tuple."""
    return tuple(entries)


def kernel_partition_plan(cfg: ModelConfig, serve) -> dict:
    """``{dim_name: shard_count}`` for every kernel dimension the serve
    config enables under ``serve.mesh_model``-way tensor parallelism: the
    attention kernels shard query and KV heads, the SSD scan state heads,
    the fused argmax the vocabulary. Raises ValueError naming every
    indivisible dimension: a kernel runs per shard or the engine refuses
    to start. Pure arithmetic over the configs."""
    m = serve.mesh_model
    plan, bad = {}, []

    def need(dim: str, n: int) -> None:
        if m > 1 and n % m:
            bad.append(f"{dim}={n}")
        else:
            plan[dim] = m

    if serve.use_flash_kernel:
        if cfg.has_attention:
            need("n_heads", cfg.n_heads)
            need("n_kv_heads", cfg.n_kv_heads)
        if cfg.ssm_state:
            need("ssm_heads", cfg.ssm_heads)
    if serve.logit_mode == "fused":
        need("vocab_size", cfg.vocab_size)
    if bad:
        raise ValueError(
            "Pallas kernel paths cannot partition over the "
            f"{m}-way model axis: {', '.join(bad)} must divide it exactly "
            "(use a divisible mesh, or the jnp paths — "
            "use_flash_kernel=False / logit_mode='chunked')")
    return plan


class Rules:
    def __init__(self, cfg: ModelConfig, mesh, train: bool):
        self.cfg = cfg
        self.mesh = mesh
        self.train = train
        self.m = axis_size(mesh, "model")
        self.d = axis_size(mesh, "data")
        self.dp = data_axes(mesh)             # ('pod','data') or ('data',)

    def div(self, n: int, axis: str = "model") -> Optional[str]:
        sz = axis_size(self.mesh, axis)
        return axis if n and n % sz == 0 and n >= sz else None

    def fsdp(self, n: int) -> Optional[str]:
        if not self.train:
            return None
        return "data" if n % self.d == 0 and n >= self.d else None

    def fsdp_always(self, n: int) -> Optional[str]:
        """Storage sharding applied at serve time too (MoE expert
        stacks)."""
        return "data" if n % self.d == 0 and n >= self.d else None

    # ------------------------------------------------------------------
    def leaf_spec(self, path: str, shape) -> tuple:
        cfg = self.cfg
        name = path.split("/")[-1]
        D, V = cfg.d_model, cfg.vocab_size
        H, K = cfg.n_heads, cfg.n_kv_heads
        F, E = cfg.d_ff, cfg.n_experts
        Hs = cfg.ssm_heads if cfg.ssm_state else 0

        def pad(*trailing):
            lead = len(shape) - len(trailing)
            return P(*([None] * lead), *trailing)

        if name == "table":
            return pad(self.div(V), self.fsdp(D))
        if name == "lm_head":
            return pad(self.fsdp(D), self.div(V))
        if name == "wq":
            return pad(self.fsdp(D), self.div(H), None)
        if name in ("wk", "wv"):
            return pad(self.fsdp(D), self.div(K), None)
        if name == "bq":
            return pad(self.div(H), None)
        if name in ("bk", "bv"):
            return pad(self.div(K), None)
        if name == "wo":
            return pad(self.div(H), None, self.fsdp(D))
        if name in ("w_gate", "w_up"):
            if E and len(shape) >= 3 and shape[-3] == E:
                return pad(self.div(E), self.fsdp_always(D), None)
            return pad(self.fsdp(D), self.div(F))
        if name == "w_down":
            if E and len(shape) >= 3 and shape[-3] == F:
                return pad(self.div(E), None, self.fsdp_always(D))
            return pad(self.div(F), self.fsdp(D))
        if name == "w_z":
            inner = self.div(cfg.d_inner) if Hs and Hs % self.m == 0 else None
            return pad(self.fsdp(D), inner)
        if name in ("w_xbc", "w_dt"):
            return pad(self.fsdp(D), None)
        if name == "out_proj":
            inner = self.div(cfg.d_inner) if Hs and Hs % self.m == 0 else None
            return pad(inner, self.fsdp(D))
        if name == "proj":   # modality frontend
            return pad(None, self.fsdp(D))
        return P(*([None] * len(shape)))   # norms, scalars, conv, router

    def params(self, shapes) -> dict:
        """The spec tree of a parameter shape tree (``params.shapes``:
        nested dicts of shape tuples)."""
        def walk(node, path):
            if isinstance(node, dict):
                return {k: walk(v, f"{path}/{k}" if path else k)
                        for k, v in node.items()}
            return self.leaf_spec(path, tuple(node))
        return walk(shapes, "")

    # -- serving cache ------------------------------------------------------
    def _divisible_axes(self, n: int, axes: tuple) -> tuple:
        """Greedy prefix of ``axes`` whose combined size divides ``n``."""
        kept, prod = [], 1
        for a in axes:
            sz = prod * axis_size(self.mesh, a)
            if n % sz == 0 and n >= sz:
                kept.append(a)
                prod = sz
        return tuple(kept)

    def packed_kv(self, batch: int, retain: int, *,
                  data_parallel: bool = True,
                  slot_data_parallel: bool = False):
        """PackedKV specs: ``[L, B, K, R, dh]`` (pos/valid ``[L, B, K,
        R]``). ``data_parallel=False`` keeps the data axes out of batch
        and retained length (the engine's streams); ``slot_data_parallel``
        then shards the slot axis over them (the engine's pool)."""
        from repro_torch.models.sparse_select import PackedKV
        cfg = self.cfg
        dpn = axis_size(self.mesh, self.dp)
        if not data_parallel:
            seq_axes = ()
            b_ax = self.dp if (slot_data_parallel and batch % dpn == 0
                               and batch >= dpn) else None
        elif batch % dpn == 0 and batch >= dpn:
            b_ax, seq_axes = self.dp, ()
        else:
            b_ax, seq_axes = None, self.dp    # batch=1: sequence parallelism
        k_ax = self.div(cfg.n_kv_heads)
        r_axes = tuple(seq_axes)
        if k_ax is None:
            r_axes = r_axes + ("model",)      # engage idle TP on retained len
        r_axes = self._divisible_axes(retain, r_axes)
        r_ax = r_axes if r_axes else None
        kv = P(None, b_ax, k_ax, r_ax, None)
        meta = P(None, b_ax, k_ax, r_ax)
        return PackedKV(k=kv, v=kv, pos=meta, valid=meta)

    def ssm_cache(self, batch: int, *, data_parallel: bool = True,
                  slot_data_parallel: bool = False):
        from repro_torch.models.ssm import SSMCache
        cfg = self.cfg
        dpn = axis_size(self.mesh, self.dp)
        b_ax = self.dp if (data_parallel or slot_data_parallel) \
            and batch % dpn == 0 and batch >= dpn else None
        h_ax = self.div(cfg.ssm_heads)
        return SSMCache(state=P(None, b_ax, h_ax, None, None),
                        conv=P(None, b_ax, None, None))

    def hybrid_cache(self, batch: int, retain: int, *,
                     data_parallel: bool = True,
                     slot_data_parallel: bool = False):
        from repro_torch.models.hybrid import HybridCache
        sc = self.ssm_cache(batch, data_parallel=data_parallel,
                            slot_data_parallel=slot_data_parallel)
        return HybridCache(ssm_state=sc.state, conv=sc.conv,
                           kv=self.packed_kv(
                               batch, retain, data_parallel=data_parallel,
                               slot_data_parallel=slot_data_parallel))

    def cache(self, batch: int, retain: int, *, data_parallel: bool = True,
              slot_data_parallel: bool = False):
        fam = self.cfg.family
        if fam == "ssm":
            return self.ssm_cache(batch, data_parallel=data_parallel,
                                  slot_data_parallel=slot_data_parallel)
        if fam == "hybrid":
            return self.hybrid_cache(batch, retain,
                                     data_parallel=data_parallel,
                                     slot_data_parallel=slot_data_parallel)
        return self.packed_kv(batch, retain, data_parallel=data_parallel,
                              slot_data_parallel=slot_data_parallel)


def spec_leaves(tree) -> list:
    """The specs of a spec tree in leaf order: dicts in sorted key order,
    named tuples in field order, each plain tuple one spec."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in spec_leaves(tree[k])]
    if hasattr(tree, "_fields"):
        return [s for f in tree for s in spec_leaves(f)]
    return [tree]


def spec_axes(entry) -> tuple:
    """The mesh axes one spec entry names, in order."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_index(mesh, axes: tuple) -> tuple:
    """(shard count, this rank's shard) of a dimension sharded over
    ``axes``: the axes combine major to minor, as listed."""
    n, idx = 1, 0
    for a in axes:
        sz = axis_size(mesh, a)
        idx = idx * sz + mesh.coords[a]
        n *= sz
    return n, idx


def local_slice(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's shard of ``t`` under ``spec``: each sharded dimension
    cut to its ``1/n`` block (the spec's law: ``n`` divides it). The
    tensor itself when nothing is cut, else a copy of its own."""
    out, cut = t, False
    for dim, entry in enumerate(spec):
        n, idx = shard_index(mesh, spec_axes(entry))
        if n == 1:
            continue
        size = t.shape[dim]
        if size % n:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                             f"divide into {n} shards ({spec})")
        step = size // n
        out = out.narrow(dim, idx * step, step)
        cut = True
    return out.clone(memory_format=torch.contiguous_format) if cut else out
