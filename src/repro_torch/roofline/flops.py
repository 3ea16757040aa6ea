"""Analytic per-cell FLOPs / HBM-bytes model (sharding-aware), as
``repro.roofline.flops``: the same arithmetic, number for number.

Why analytic: a dry run on the meta device counts the FLOPs of one rank's
step as torch dispatches it (``torch.utils.flop_counter``), but it sees
only matmuls and attention, none of the bytes, and nothing a hand-written
kernel does. So the compute and memory terms come from the architecture
itself, split by component, each component divided by the number of
devices it actually parallelizes over (attention stays model-replicated
when heads don't divide the TP axis, etc.). Collective bytes and buffer
sizes come from the dry run (``launch.dryrun``).

Conventions: matmul [m,k]×[k,n] = 2mkn FLOPs; attention = 4·T·Sk·H·dh
(scores + PV); training = fwd × (4 with remat: fwd + recompute + 2·bwd);
HBM bytes: every weight read once per traversal, activations c·T·D per layer,
attention score tensors counted (the plain path spills them; the flash
Refresh kernel keeps them on chip).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass
class Component:
    name: str
    flops: float          # global per step
    bytes: float          # global HBM traffic per step
    parallel: int         # devices this component divides over

    def per_device(self) -> Tuple[float, float]:
        return self.flops / self.parallel, self.bytes / self.parallel


def _dtype_bytes(cfg: ModelConfig) -> int:
    return 2 if cfg.dtype == "bfloat16" else 4


def components(
    cfg: ModelConfig,
    shape: ShapeConfig,
    *,
    dp: int,                  # data-parallel ways (incl. pod)
    tp: int,                  # model-parallel ways
    retention: float = 0.5,
    microbatches: int = 8,
    remat: bool = True,
    q_chunk: int = 1024,
    flash_refresh: bool = False,
) -> List[Component]:
    B, S = shape.global_batch, shape.seq_len
    db = _dtype_bytes(cfg)
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    Lh = cfg.n_layers
    kind = shape.kind
    train = kind == "train"
    # tokens processed by the backbone this step
    if kind in ("train", "prefill"):
        T = B * S
        Sk = S
    else:
        T = B * 1          # decode: one-token active block
        Sk = int(S * retention) + 1
    # attention TP degree: head-sharded when divisible; the flash-refresh
    # kernel falls back to query-sequence sharding over the model axis, so
    # it always engages the full TP degree
    h_par = tp if (H and H % tp == 0) or (flash_refresh and not train) else 1
    w_par = tp                                       # weight-sharded matmuls
    fwd_mult = (4.0 if remat else 3.0) if train else 1.0
    mem_mult = 3.0 if train else 1.0                 # fwd+bwd traversals

    comps: List[Component] = []

    def add(name, flops, byts, par):
        comps.append(Component(name, flops * fwd_mult, byts * mem_mult,
                               max(par, 1)))

    if cfg.family in ("dense", "moe", "vlm", "audio", "hybrid"):
        n_attn = Lh if cfg.family != "hybrid" else Lh // cfg.shared_attn_interval
        qkv_f = 2 * T * D * (H + 2 * K) * dh * n_attn
        wqkv_b = D * (H + 2 * K) * dh * db * n_attn * (microbatches if train else 1)
        add("qkv_proj", qkv_f, wqkv_b + 4 * T * D * db * n_attn, dp * w_par)
        # attention: local layers see a bounded window
        if cfg.layer_pattern == "alt_local_global" and cfg.sliding_window:
            sk_eff = (min(Sk, 2 * cfg.sliding_window + 1) + Sk) / 2
        else:
            sk_eff = Sk
        attn_f = 4 * T * sk_eff * H * dh * n_attn
        if flash_refresh and not train:
            # flash kernel: scores/probs never leave the SM. HBM traffic
            # = q/out (2·T·H·dh) + K/V re-streamed once per q-tile pass
            # (T/q_tile passes over Sk·K·dh·2 bytes; q_tile = 256).
            attn_b = (2 * T * H * dh * db * n_attn
                      + (T // 256 + 1) * sk_eff * K * dh * 2 * db * n_attn)
        else:
            # plain path: f32 scores written + read
            attn_b = (T * sk_eff * H * 4 * 2 + 2 * T * H * dh * db) * n_attn
        add("attention", attn_f, attn_b, dp * h_par)
        add("o_proj", 2 * T * D * H * dh * n_attn,
            H * dh * D * db * n_attn * (microbatches if train else 1), dp * w_par)
        if cfg.is_moe:
            kt, E = cfg.experts_per_token, cfg.n_experts
            add("moe_ffn", 6 * T * kt * D * F * Lh,
                3 * E * D * F * db * Lh * (microbatches if train else 1),
                dp * w_par)
            add("router", 2 * T * D * E * Lh, T * E * 4 * Lh, dp)
        else:
            add("ffn", 6 * T * D * F * Lh,
                3 * D * F * db * Lh * (microbatches if train else 1)
                + 4 * T * F * db * Lh, dp * w_par)
        act_b = 8 * T * D * db * n_attn
        add("residual_norms", 0.0, act_b, dp)

    if cfg.family in ("ssm", "hybrid"):
        Din, N = cfg.d_inner, cfg.ssm_state
        Hs, P = cfg.ssm_heads, cfg.ssm_head_dim
        Q = cfg.ssm_chunk
        G = cfg.ssm_groups
        Lm = Lh
        Tm = B * S if kind in ("train", "prefill") else B * 1
        proj_f = 2 * Tm * D * (2 * Din + 2 * G * N + Hs) * Lm
        ssd_tok = 2 * Q * N + 2 * Q * Hs * P + 4 * N * Hs * P
        ssd_f = (Tm * ssd_tok if kind in ("train", "prefill")
                 else Tm * 4 * N * Hs * P)          # decode: recurrent update
        out_f = 2 * Tm * Din * D * Lm
        ssm_par = tp if Hs % tp == 0 else 1
        add("ssm_proj", proj_f,
            D * (2 * Din + 2 * G * N + Hs) * db * Lm
            * (microbatches if train else 1) + 6 * Tm * Din * db * Lm, dp)
        add("ssd_scan", ssd_f * Lm, 6 * Tm * (Hs * P + N) * 4 * Lm,
            dp * ssm_par)
        add("ssm_out", out_f, Din * D * db * Lm
            * (microbatches if train else 1), dp * ssm_par)

    # logits / loss (C1 stage)
    if train:
        # chunked CE is remat'd: fwd + recompute + dL/dh + dL/dW = 4 × 2TDV
        comps.append(Component(
            "loss_logits", 8.0 * T * D * V,
            3 * (V * D * db * microbatches + T * D * db + T * V * 4),
            dp * w_par))
        # optimizer: read P,m,v + write (f32 moments)
        n = cfg.n_params()
        comps.append(Component("adamw", 10.0 * n, n * (db + 16.0), dp * tp))
    else:
        t_logit = B * (32 if kind == "prefill" else 1)
        comps.append(Component(
            "decode_logits", 2.0 * t_logit * D * V,
            V * D * db + t_logit * V * 4, w_par))
    if kind == "prefill" and cfg.has_attention:
        # C3 selection: scoring + pack gather
        n_attn = Lh if cfg.family != "hybrid" else Lh // cfg.shared_attn_interval
        comps.append(Component(
            "select_pack", 2.0 * B * 32 * H * dh * S * n_attn,
            2.0 * B * S * K * dh * db * n_attn, dp))

    return comps


def analytic_cost(cfg: ModelConfig, shape: ShapeConfig, *, dp: int, tp: int,
                  **kw) -> Dict[str, float]:
    comps = components(cfg, shape, dp=dp, tp=tp, **kw)
    fl = sum(c.per_device()[0] for c in comps)
    by = sum(c.per_device()[1] for c in comps)
    top = sorted(comps, key=lambda c: -c.per_device()[0])[:3]
    return {
        "flops_per_device": fl,
        "bytes_per_device": by,
        "flops_global": sum(c.flops for c in comps),
        "top_components": [
            dict(name=c.name, flops_dev=c.per_device()[0],
                 bytes_dev=c.per_device()[1]) for c in top],
    }
