"""Model and serving configs: the fields and defaults of ``repro.configs.base``.

* ModelConfig  — architecture hyperparameters.
* ServeConfig  — the paper's serving knobs (max_num_batched_tokens,
                 max_num_logits, retention ratio, block size, ...).
* TrainConfig  — the masked-diffusion trainer's knobs (microbatches,
                 AdamW, gradient compression, the loss chunk).

Frozen dataclasses, so a config hashes and compares by value. The port keeps
every field of the reference, so a config means the same thing in both
packages.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # --- attention flavour -------------------------------------------------
    qkv_bias: bool = False
    activation: str = "silu"         # silu -> SwiGLU, gelu -> GeGLU
    attn_softcap: float = 0.0        # gemma2 logit softcapping (pre-softmax)
    final_softcap: float = 0.0       # gemma2 final-logit softcapping
    sliding_window: int = 0          # window size for local layers
    layer_pattern: str = "global"    # "global" | "alt_local_global"
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    moe_impl: str = "gather"
    capacity_factor: float = 1.25
    # --- SSM (mamba2) --------------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_conv_kernel: int = 4
    ssm_chunk: int = 64
    # --- hybrid (zamba2) ------------------------------------------------------
    shared_attn_interval: int = 0
    # --- modality frontend stubs ----------------------------------------------
    frontend_dim: int = 0
    frontend_len: int = 0
    # --- numerics ---------------------------------------------------------------
    dtype: str = "bfloat16"          # activation/param dtype

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def n_params(self) -> int:
        """Analytic parameter count (the modeled clock bills 2·N per token)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        dh = self.resolved_head_dim
        H, K = self.n_heads, self.n_kv_heads
        emb = V * D * (1 if self.tie_embeddings else 2)
        total = emb + D  # final norm
        if self.family == "ssm":
            return total + L * self._ssm_layer_params()
        attn = D * H * dh + 2 * D * K * dh + H * dh * D
        if self.qkv_bias:
            attn += H * dh + 2 * K * dh
        if self.is_moe:
            mlp = self.n_experts * (3 * D * F) + D * self.n_experts
        else:
            mlp = 3 * D * F
        block = attn + mlp + 2 * D
        if self.family == "hybrid":
            total += L * (self._ssm_layer_params() + D)
            total += D * H * dh + 2 * D * K * dh + H * dh * D + 3 * D * F + 2 * D
        else:
            total += L * block
        return total

    def _ssm_layer_params(self) -> int:
        D, Din = self.d_model, self.d_inner
        N, G, Hs = self.ssm_state, self.ssm_groups, self.ssm_heads
        conv_ch = Din + 2 * G * N
        in_proj = D * (2 * Din + 2 * G * N + Hs)
        return in_proj + conv_ch * (self.ssm_conv_kernel + 1) + 3 * Hs + Din + Din * D + D

    def n_active_params(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if not self.is_moe:
            return self.n_params()
        D, F, L = self.d_model, self.d_ff, self.n_layers
        dense = self.n_params() - L * self.n_experts * 3 * D * F
        return dense + L * self.experts_per_token * 3 * D * F


@dataclass(frozen=True)
class ServeConfig:
    """The paper's serving-system knobs (Table 3) plus the reference's
    engine knobs. See ``repro.configs.base.ServeConfig`` for the long form
    of each field."""
    max_num_batched_tokens: int = 4096   # scheduler query-token budget
    max_num_logits: int = 2048           # logit decomposition chunk (C1)
    block_size: int = 32                 # dLLM decode block B_size
    retention_ratio: float = 0.5         # sparse KV retention r (C3)
    kernel_size: int = 3                 # local max-pool window w
    refresh_interval: int = 8            # K_int: refresh cadence in steps
    steps_per_block: int = 32            # denoising steps per block
    max_seq_len: int = 512               # per-request L cap (slot KV region)
    max_slots: int = 16                  # concurrent request slots
    max_refresh_per_iter: int = 4        # refresh sub-batch bucket cap
    selection: str = "head"              # head | uniform | none (dense)
    scheduler: str = "phase"             # phase | request (baseline)
    logit_mode: str = "fused"            # fused (kernel) | chunked | monolithic
    varlen_pack: bool = False            # whole-iteration token packing
    token_bucket: int = 128              # packed-stream size granularity
    use_flash_kernel: bool = False       # attention/select kernels in steps
    vocab_tile: int = 1024               # V-tile of the reference's kernel
    dtype: str = "float32"
    mesh_shape: Optional[Tuple[int, ...]] = None
    prefix_sharing: bool = False
    kv_quant: str = "none"
    iter_log_cap: int = 0                # keep only the last N iter_log rows
    clock: str = "wall"                  # "wall" (host time) | "modeled"
    pipeline: bool = True                # dispatch-ahead loop
    donate_buffers: bool = True          # a JAX buffer-lifetime hint
    queue_cap: int = 0                   # bounded waiting queue (0 = unbounded)
    queue_policy: str = "reject"         # "reject" new arrivals | "evict" oldest
    preempt_starvation_s: float = 0.0    # 0 = preemption disabled
    max_preemptions: int = 2
    fault_retries: int = 3

    @property
    def mesh_devices(self) -> int:
        n = 1
        for d in self.mesh_shape or ():
            n *= d
        return n

    @property
    def mesh_model(self) -> int:
        """Size of the tensor-parallel (``model``) axis: the trailing mesh
        dim."""
        return self.mesh_shape[-1] if self.mesh_shape else 1

    @property
    def mesh_data(self) -> int:
        """The data-parallel axis: every leading mesh dim together."""
        return self.mesh_devices // self.mesh_model

    @property
    def retained_len(self) -> int:
        return max(self.block_size, int(self.max_seq_len * self.retention_ratio))

    @property
    def refresh_slots(self) -> int:
        """Per-iteration Refresh cap; ``max_refresh_per_iter=0`` means no cap
        beyond ``max_slots`` residency."""
        if self.max_refresh_per_iter > 0:
            return min(self.max_slots, self.max_refresh_per_iter)
        return self.max_slots


@dataclass(frozen=True)
class TrainConfig:
    """Training-substrate knobs for train_step."""
    microbatches: int = 16               # grad-accumulation steps
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    remat: bool = True
    zero1: bool = True                   # shard Adam moments over data axis
                                         # (a mesh's; no effect on one device)
    grad_compression: str = "none"       # none | bf16 | int8
    mask_ratio_min: float = 0.1          # masked-diffusion mask schedule
    mask_ratio_max: float = 1.0
    loss_chunk: int = 2048               # token-axis chunk for the CE (C1 in training)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU tests."""
    small = dict(
        n_layers=max(2, min(cfg.n_layers, 3)),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads else 4,
        d_ff=128,
        vocab_size=256,
        head_dim=16,
        sliding_window=8 if cfg.sliding_window else 0,
        n_experts=4 if cfg.n_experts else 0,
        experts_per_token=2 if cfg.n_experts else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=8,
        ssm_chunk=8,
        shared_attn_interval=2 if cfg.shared_attn_interval else 0,
        frontend_dim=32 if cfg.frontend_dim else 0,
        frontend_len=4 if cfg.frontend_len else 0,
        dtype="float32",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
