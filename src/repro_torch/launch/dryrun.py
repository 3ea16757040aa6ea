"""Meta-device dry run: one rank's step of every (arch × shape × mesh)
cell, shapes only, as ``repro.launch.dryrun``.

The reference lowers and compiles each cell for 512 placeholder devices
and reads the compiled program. The port has no program to compile: it
runs rank 0's step eagerly on ``torch.device("meta")`` under a
:class:`~repro_torch.launch.mesh.MetaMesh` of the production shape,
single-pod ``(16, 16)`` = (data, model) or multi-pod ``(2, 16, 16)`` =
(pod, data, model). Nothing is computed, allocated or launched on any
device, and importing this module touches neither CUDA nor the
environment.

For each cell:

1. rank 0's arguments, as meta tensors cut by the reference's placement
   (``sharding.Rules``): the parameters (``params.init_params`` with
   ``cut=shard_cut``), for ``train`` the optimizer state (moments follow
   the parameters, ZeRO-1), for ``decode`` / ``long_decode`` the serving
   cache (``Rules.cache``), and the inputs; the batch shards over the
   data axes where it divides (``Rules.tokens``);
2. the step, on those tensors: ``train_4k`` one microbatch's forward and
   backward (``train_loop.microbatch_grads``, remat on) counted × M (a
   rank with fewer rows than M runs one row a microbatch), the
   FSDP weights gathered over ``data`` first and the gradients
   reduce-scattered back, then AdamW on the shards; ``prefill_32k``
   ``serve_refresh`` and the C1 ``decode_tokens``; ``decode_32k`` /
   ``long_500k`` ``serve_reuse`` and ``decode_tokens`` on rank 0's shard
   of the cache: where its spec cuts the retained length (over the data
   axes at batch 1, the reference's sequence-parallel decode; over
   ``model`` where the KV heads do not divide it), the Reuse merges its
   shard's attention across those axes (``ServeContext.kv_split``);
3. four figures: ``arg_bytes_per_device`` (the meta arguments' bytes,
   split in ``arg_breakdown``), ``temp_bytes_per_device`` (the peak of
   the storages the step creates and holds at once, outputs included:
   :class:`MetaMemory`), ``counted_flops_per_device``
   (``torch.utils.flop_counter``: matmuls and attention as torch
   dispatches them) and ``coll_breakdown`` (the mesh's collective log,
   raw result bytes by kind); the compute and memory terms come from
   ``roofline.flops.analytic_cost``, as in the reference.

The plain paths run, as the reference's dry run runs jnp. With
``--flash-refresh`` the Refresh attention goes through the
``flash_refresh`` wrapper on the reference's placement (the rank's query
heads, or its share of the query rows where the heads do not divide the
model axis), whose meta branch returns the kernel's output shape; a
hand-written kernel's FLOPs are invisible to the flop counter.

A cell either gives a record or raises the port's documented divisibility
error (``mesh.require_divisible`` / ``sharding.kernel_partition_plan``:
"cannot partition over the", ``moe_impl='ep'``: "do not divide"), which
the grid records as a refusal; anything else fails the run.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
      --out results/dryrun_torch.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
import weakref
from typing import Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs import ASSIGNED, SHAPES_BY_NAME, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.kernels.flash_refresh import REFRESH
from repro_torch.launch import mesh as M
from repro_torch.launch.sharding import (Rules, local_slice, retained_axes,
                                        spec_axes)
from repro_torch.models import backbone as BB
from repro_torch.models import lm_head as LM
from repro_torch.models import transformer as T
from repro_torch.models.hybrid import HybridCache, group_shape
from repro_torch.models.sparse_select import PackedKV
from repro_torch.models.ssm import SSMCache, conv_channels
from repro_torch.params import (DTYPES, Group, init_params, named_leaves,
                                shapes, shard_cut, trainable)
from repro_torch.roofline.analysis import analyze_meta
from repro_torch.roofline.flops import analytic_cost

BLOCK = 32                 # dLLM active block (paper Table 3)
RETENTION = 0.5            # paper default r
MAX_NUM_LOGITS = 2048      # paper Table 3
Q_CHUNK = 1024             # refresh attention query tile
META = torch.device("meta")
# the port's documented divisibility refusals
REFUSALS = ("cannot partition over the", "do not divide")


class MetaMemory(TorchDispatchMode):
    """The bytes of the storages created under it and still alive, and
    their peak: every op's output storage is counted once, when first
    seen, and uncounted when it is freed. Storages that exist before
    (:meth:`hold`: the arguments) are never counted, nor are views of
    them."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()

    def hold(self, tree) -> None:
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self._seen[t.untyped_storage()] = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = n
            weakref.finalize(st, self._free, n)
            self.live += n
            self.peak = max(self.peak, self.live)
        return out


def tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def serve_ctx(cfg: ModelConfig, shape: ShapeConfig, *, block: int,
              retention: float, selection: str) -> T.ServeContext:
    retain = max(block, int(shape.seq_len * retention))
    # keep SSD chunking + retained length block-aligned
    retain = -(-retain // block) * block
    # prefill at 32k: a [B, H, q_chunk, S] f32 score tile must stay small
    # per device -> shrink the query tile for long refreshes
    qc = Q_CHUNK if shape.seq_len <= 8192 else 256
    return T.ServeContext(block_size=block, retain=retain, kernel_size=3,
                          selection=selection, q_chunk=qc)


def text_len(cfg: ModelConfig, S: int) -> int:
    return S - (cfg.frontend_len if cfg.frontend_dim else 0)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N_active·D for training; 2·N_active·D for forward-only serving."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    # decode: one active block of 1 token per sequence
    return 2.0 * n * shape.global_batch


def production_shape(multi_pod: bool) -> Tuple[int, ...]:
    return (2, 16, 16) if multi_pod else (16, 16)


def mesh_name(shape) -> str:
    return "x".join(str(d) for d in shape)


# ---------------------------------------------------------------------------
# rank 0's arguments
# ---------------------------------------------------------------------------

def _spec_shape(shape, spec, mesh) -> tuple:
    """The rank's shard shape of a leaf under ``spec``."""
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        out.append(dim // M.axis_size(mesh, spec_axes(entry)))
    return tuple(out)


def _input(shape, dtype, spec, mesh) -> torch.Tensor:
    return torch.empty(_spec_shape(shape, spec, mesh), dtype=dtype,
                       device=META)


def _local_batch(batch: int, mesh, rules: Rules) -> int:
    """Rows of the batch rank 0 computes: its data shard where the data
    axes divide the batch (``Rules.tokens``), else all of them."""
    spec = rules.tokens(batch)
    return batch // M.axis_size(mesh, spec_axes(spec[0]))


def cache_tensors(cfg: ModelConfig, mesh, rules: Rules, batch: int,
                  retain: int):
    """Rank 0's shard of the serving cache of each family (``Rules.cache``
    specs, the batch data-parallel where it divides), as meta tensors."""
    dt = DTYPES[cfg.dtype]
    spec = rules.cache(batch, retain)
    dh = cfg.resolved_head_dim if cfg.n_heads else 0
    K = cfg.n_kv_heads

    def kv(n_layers, sp: PackedKV):
        kshape = (n_layers, batch, K, retain, dh)
        mshape = kshape[:-1]
        return PackedKV(k=_input(kshape, dt, sp.k, mesh),
                        v=_input(kshape, dt, sp.v, mesh),
                        pos=_input(mshape, torch.int32, sp.pos, mesh),
                        valid=_input(mshape, torch.bool, sp.valid, mesh))

    def ssm(sp_state, sp_conv):
        st = (cfg.n_layers, batch, cfg.ssm_heads, cfg.ssm_head_dim,
              cfg.ssm_state)
        cv = (cfg.n_layers, batch, cfg.ssm_conv_kernel - 1,
              conv_channels(cfg))
        return (_input(st, torch.float32, sp_state, mesh),
                _input(cv, dt, sp_conv, mesh))

    if cfg.family == "ssm":
        return SSMCache(*ssm(spec.state, spec.conv)), spec
    if cfg.family == "hybrid":
        state, conv = ssm(spec.ssm_state, spec.conv)
        return HybridCache(ssm_state=state, conv=conv,
                           kv=kv(group_shape(cfg)[0], spec.kv)), spec
    return kv(cfg.n_layers, spec), spec


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

class _Counts:
    """What one cell's step measured."""

    def __init__(self):
        self.flops = 0.0
        self.coll: Dict[str, int] = {}
        self.microbatches = 0       # a train step's, on this rank

    def add_coll(self, log: dict, times: int = 1) -> None:
        for k, v in log.items():
            self.coll[k] = self.coll.get(k, 0) + v * times


def _run_counted(fn, counts: _Counts, mesh, times: int = 1):
    """``fn()`` under a flop counter, its FLOPs and the collective bytes it
    logged on ``mesh`` added to ``counts`` ``times`` over."""
    mesh.log.clear()
    fc = FlopCounterMode(display=False)
    with fc:
        out = fn()
    counts.flops += fc.get_total_flops() * times
    counts.add_coll(mesh.log, times)
    return out


def _fsdp_dims(train_spec, serve_spec) -> list:
    """The dims the training placement cuts over ``data`` and the serving
    placement does not: FSDP's, gathered before use."""
    return [d for d, (a, b) in enumerate(zip(train_spec, serve_spec))
            if "data" in spec_axes(a) and "data" not in spec_axes(b)]


def train_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
               tc: TrainConfig, counts: _Counts, mem: MetaMemory):
    """One FSDP × TP training step of rank 0 on meta tensors."""
    from repro_torch.train.optimizer import adamw_update, init_opt_state
    from repro_torch.train.train_loop import microbatch_grads

    rules = Rules(cfg, mesh, train=True)
    serve_rules = Rules(cfg, mesh, train=False)
    pshapes = shapes(cfg)
    params = init_params(cfg, None, META, cut=shard_cut(rules, mesh))
    opt = init_opt_state(params)
    G, S = shape.global_batch, text_len(cfg, shape.seq_len)
    tokens = _input((G, S), torch.int32, rules.tokens(G), mesh)
    fe = (_input((G, cfg.frontend_len, cfg.frontend_dim), torch.bfloat16,
                 rules.frontend(), mesh) if cfg.frontend_dim else None)
    args = {"params": params, "opt_state": opt,
            "inputs": [tokens] + ([fe] if fe is not None else [])}
    # the rank's rows in M microbatches; a rank whose rows M does not
    # divide (fewer rows than M: the batch over many data ranks) runs them
    # one row at a time
    rows = tokens.shape[0]
    Mb = tc.microbatches if rows % tc.microbatches == 0 else rows
    counts.microbatches = Mb
    dpn = M.axis_size(mesh, M.data_axes(mesh))
    generator = torch.Generator().manual_seed(0)   # the masks' host draws

    def step():
        with mem:
            plan = []
            for name, t in named_leaves(params):
                path = name.replace(".", "/")
                full = _full_shape(pshapes, path)
                plan.append((name, t, rules.leaf_spec(path, full),
                             serve_rules.leaf_spec(path, full)))

            def microbatch():
                whole = {}
                for name, t, tspec, sspec in plan:
                    g = t.detach()
                    for d in _fsdp_dims(tspec, sspec):
                        g = mesh.all_gather(g, "data", dim=d)
                    whole[name] = g
                tree = trainable(_regroup(whole))
                tleaves = [t for _, t in named_leaves(tree)]
                n = tokens.shape[0] // Mb
                loss, grads = microbatch_grads(
                    tree, tleaves, cfg, tc, tokens[:n], generator,
                    None if fe is None else fe[:n])
                out = []
                for (name, t, tspec, sspec), g in zip(plan, grads):
                    dims = _fsdp_dims(tspec, sspec)
                    if dims:
                        g = local_slice(g, tuple(
                            "data" if d in dims else None
                            for d in range(g.dim())), mesh)
                        g = mesh.record("reduce-scatter", g)
                        if "pod" in mesh.shape and mesh.shape["pod"] > 1:
                            g = mesh.all_reduce(g, "pod")
                    elif dpn > 1:
                        g = mesh.all_reduce(g, M.data_axes(mesh))
                    out.append(g.detach())
                return loss.detach(), out

            loss, grads = _run_counted(microbatch, counts, mesh, times=Mb)
            acc = [g.float() for g in grads]
            _, new_opt, om = adamw_update(params, acc, opt, tc)
            return loss, om
    return step, args


def _full_shape(tree: dict, path: str) -> tuple:
    """The whole shape at ``path`` of a ``params.shapes`` tree."""
    node = tree
    for k in path.split("/"):
        node = node[k]
    return tuple(node)


def _regroup(flat: Dict[str, torch.Tensor]) -> Group:
    """A parameter tree from dotted leaf names."""
    tree: dict = {}
    for name, t in flat.items():
        node = tree
        *head, last = name.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t

    def build(node):
        return Group({k: build(v) if isinstance(v, dict) else v
                      for k, v in node.items()})
    return build(tree)


def prefill_step(cfg: ModelConfig, shape: ShapeConfig, mesh, selection: str,
                 retention: float, logit_mode: str, flash_refresh: bool,
                 counts: _Counts, mem: MetaMemory):
    rules = Rules(cfg, mesh, train=False)
    params = init_params(cfg, None, META, cut=shard_cut(rules, mesh))
    B, S = shape.global_batch, shape.seq_len
    St = text_len(cfg, S)
    ctx = serve_ctx(cfg, shape, block=BLOCK, retention=retention,
                    selection=selection)
    if flash_refresh:
        ctx = dataclasses.replace(ctx, use_flash_refresh=True)
    tspec = rules.tokens(B)
    tokens = _input((B, St), torch.int32, tspec, mesh)
    valid = _input((B, S), torch.bool, tspec, mesh)
    # the reference's block_start spec: its first data axis where the
    # batch divides the data axes
    dp = rules.dp
    bs_spec = (dp[0] if B % M.axis_size(mesh, dp) == 0 else None,)
    block_start_arg = _input((B,), torch.int32, bs_spec, mesh)
    fe = (_input((B, cfg.frontend_len, cfg.frontend_dim), torch.bfloat16,
                 rules.frontend(), mesh) if cfg.frontend_dim else None)
    args = {"params": params,
            "inputs": [tokens, block_start_arg, valid]
            + ([fe] if fe is not None else [])}
    b = tokens.shape[0]

    def step():
        with mem:
            def run():
                # billed by the reference's spec, which cuts the batch no
                # finer than the tokens' (it may be coarser: pod alone)
                block_start = block_start_arg[:b]
                out = BB.serve_refresh(params, cfg, tokens, block_start, ctx,
                                       token_valid=valid, frontend=fe)
                h = out.block_hidden.reshape(-1, cfg.d_model)
                ids, conf = LM.decode_tokens(params["embed"], cfg, h,
                                             max_num_logits=MAX_NUM_LOGITS,
                                             mode=logit_mode)
                return ids, conf, out.cache
            return _run_counted(run, counts, mesh)
    return step, args


def decode_step(cfg: ModelConfig, shape: ShapeConfig, mesh, selection: str,
                retention: float, logit_mode: str, counts: _Counts,
                mem: MetaMemory):
    rules = Rules(cfg, mesh, train=False)
    params = init_params(cfg, None, META, cut=shard_cut(rules, mesh))
    B, S = shape.global_batch, shape.seq_len
    Sb = 1   # decode shapes: one new token over a seq_len KV cache
    retain = max(BLOCK, int(S * retention))
    retain = -(-retain // BLOCK) * BLOCK
    cache, cspec = cache_tensors(cfg, mesh, rules, B, retain)
    # the Reuse attends rank 0's shard of the retained length and merges
    # across the axes that cut it
    ctx = dataclasses.replace(
        serve_ctx(cfg, shape, block=BLOCK, retention=retention,
                  selection=selection), block_size=Sb,
        kv_split=retained_axes(cspec))
    dpn = M.axis_size(mesh, rules.dp)
    bspec = (rules.dp if B % dpn == 0 and B >= dpn else None, None)
    btok = _input((B, Sb), torch.int32, bspec, mesh)
    bpos = _input((B, Sb), torch.int32, bspec, mesh)
    args = {"params": params, "cache": cache, "inputs": [btok, bpos]}

    def step():
        with mem:
            def run():
                h = BB.serve_reuse(params, cfg, btok, bpos, cache, ctx)
                return LM.decode_tokens(params["embed"], cfg,
                                        h.reshape(-1, cfg.d_model),
                                        max_num_logits=MAX_NUM_LOGITS,
                                        mode=logit_mode)
            return _run_counted(run, counts, mesh)
    return step, args


# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             mesh_shape: Optional[Tuple[int, ...]] = None,
             selection: str = "head", retention: float = RETENTION,
             logit_mode: str = "chunked", moe_impl: str = "gather",
             microbatches: int = 8, grad_compression: str = "none",
             opt_loss: bool = False, flash_refresh: bool = False,
             pad_vocab: bool = False, loss_chunk: int = MAX_NUM_LOGITS,
             verbose: bool = True) -> dict:
    """One cell's record. ``mesh_shape`` overrides the production mesh
    (``(16, 16)``, or ``(2, 16, 16)`` with ``multi_pod``)."""
    if opt_loss:
        raise ValueError(
            "--opt-loss sets an XLA sharding policy at the point of use in "
            "the reference; torch has no counterpart to it")
    shape_dims = tuple(mesh_shape) if mesh_shape else \
        production_shape(multi_pod)
    mesh = M.MetaMesh(shape_dims)
    cfg = get_config(arch)
    if cfg.is_moe and moe_impl != cfg.moe_impl:
        cfg = dataclasses.replace(cfg, moe_impl=moe_impl)
    if pad_vocab and cfg.vocab_size % 128:
        # Megatron-style vocab padding: shardability for CE/logits
        v = -(-cfg.vocab_size // 128) * 128
        cfg = dataclasses.replace(cfg, vocab_size=v)
    shape = SHAPES_BY_NAME[shape_name]
    mname = mesh_name(shape_dims)
    name = f"{arch}×{shape_name}×{mname}"
    mesh.kernel_dims = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                            ssm_heads=cfg.ssm_heads if cfg.ssm_state else 0,
                            vocab_size=cfg.vocab_size)
    t0 = time.time()
    counts, mem = _Counts(), MetaMemory()
    meta0 = REFRESH.meta_calls
    with M.using(mesh):
        if shape.kind == "train":
            tc = TrainConfig(microbatches=microbatches, remat=True,
                             loss_chunk=loss_chunk,
                             grad_compression=grad_compression)
            step, args = train_step(cfg, shape, mesh, tc, counts, mem)
        elif shape.kind == "prefill":
            step, args = prefill_step(cfg, shape, mesh, selection,
                                      retention, logit_mode, flash_refresh,
                                      counts, mem)
        else:
            step, args = decode_step(cfg, shape, mesh, selection, retention,
                                     logit_mode, counts, mem)
        mem.hold(list(args["params"].parameters()))
        mem.hold([v for k, v in args.items() if k != "params"])
        out = step()
        del out
    breakdown = {k: (tensor_bytes(list(v.parameters())) if k == "params"
                     else tensor_bytes(v)) for k, v in args.items()}
    dp_n = M.axis_size(mesh, M.data_axes(mesh))
    tp_n = M.axis_size(mesh, "model")
    analytic = analytic_cost(cfg, shape, dp=dp_n, tp=tp_n,
                             retention=retention, microbatches=microbatches,
                             remat=True, q_chunk=Q_CHUNK,
                             flash_refresh=flash_refresh)
    roof = analyze_meta(name, mesh.size, model_flops(cfg, shape), analytic,
                        counts.coll, sum(breakdown.values()), mem.peak,
                        counts.flops)
    rec = roof.to_dict()
    rec.update(arch=arch, shape=shape_name, mesh=mname,
               selection=selection, retention=retention,
               logit_mode=logit_mode, moe_impl=moe_impl,
               opt_loss=opt_loss, flash_refresh=flash_refresh,
               pad_vocab=pad_vocab, microbatches=microbatches,
               rank_microbatches=counts.microbatches,
               arg_breakdown=breakdown,
               flash_refresh_meta_calls=REFRESH.meta_calls - meta0,
               run_s=round(time.time() - t0, 1), ok=True)
    if verbose:
        gib = 2 ** 30
        print(f"[ok] {name}  run={rec['run_s']}s")
        print(f"     mem/device: args={roof.arg_bytes_per_device / gib:.2f}"
              f"GiB temp={roof.temp_bytes_per_device / gib:.2f}GiB "
              f"counted/analytic={roof.counted_to_analytic:.3f}")
        print("     " + roof.row())
    return rec


def is_refusal(err: Exception) -> bool:
    """The port's documented divisibility errors."""
    return isinstance(err, ValueError) and any(r in str(err)
                                               for r in REFUSALS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--selection", default="head")
    ap.add_argument("--retention", type=float, default=RETENTION)
    ap.add_argument("--logit-mode", default="chunked")
    ap.add_argument("--moe-impl", default="gather")
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--grad-compression", default="none")
    ap.add_argument("--opt-loss", action="store_true",
                    help="the reference's CE reshard policy (an XLA "
                         "sharding policy; raises here)")
    ap.add_argument("--flash-refresh", action="store_true",
                    help="the flash_refresh kernel for Refresh attention "
                         "(its meta branch: shapes only)")
    ap.add_argument("--pad-vocab", action="store_true",
                    help="pad vocab to a 128 multiple for shardability")
    ap.add_argument("--loss-chunk", type=int, default=MAX_NUM_LOGITS)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.opt_loss:
        raise ValueError(
            "--opt-loss sets an XLA sharding policy at the point of use in "
            "the reference; torch has no counterpart to it")

    archs = list(ASSIGNED) if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES_BY_NAME) if args.all or not args.shape \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multipod]
    # activation budget: the two 80-layer dense archs take deeper grad
    # accumulation, as in the reference
    deep_accum = {"qwen2-72b", "internvl2-76b"}

    records = []
    t0 = time.time()
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mb = 16 if arch in deep_accum and shape == "train_4k" \
                    else args.microbatches
                try:
                    rec = run_cell(arch, shape, multi_pod=mp,
                                   selection=args.selection,
                                   retention=args.retention,
                                   logit_mode=args.logit_mode,
                                   moe_impl=args.moe_impl,
                                   microbatches=mb,
                                   grad_compression=args.grad_compression,
                                   flash_refresh=args.flash_refresh,
                                   pad_vocab=args.pad_vocab,
                                   loss_chunk=args.loss_chunk)
                except Exception as e:
                    refused = is_refusal(e)
                    if not refused:
                        traceback.print_exc()
                    rec = dict(arch=arch, shape=shape,
                               mesh=mesh_name(production_shape(mp)),
                               ok=False, refused=refused,
                               error=f"{type(e).__name__}: {e}")
                    print(f"[{'refused' if refused else 'FAIL'}] "
                          f"{arch}×{shape}: {e}")
                records.append(rec)
                if args.out:
                    with open(args.out, "w") as f:
                        json.dump(records, f, indent=1)
    n_ok = sum(r["ok"] for r in records)
    n_ref = sum(bool(r.get("refused")) for r in records)
    print(f"\n{n_ok}/{len(records)} cells ran, {n_ref} refused (documented "
          f"divisibility), {len(records) - n_ok - n_ref} failed in "
          f"{time.time() - t0:.1f}s")
    return 0 if n_ok + n_ref == len(records) else 1


if __name__ == "__main__":
    raise SystemExit(main())
