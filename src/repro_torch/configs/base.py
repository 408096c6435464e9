"""Configuration dataclasses of the PyTorch port.

A field-for-field copy of the JAX package's ``repro/configs/base.py``: the
port keeps its own copy so that it imports nothing of the JAX package.  A
single :class:`ModelConfig` describes every architecture family (dense GQA,
MoE, MLA, SSM, RG-LRU hybrid, encoder-decoder audio, VLM backbone); the port
serves every family, and configs compare equal field by field with the
reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration."""

    num_experts: int = 0            # routed experts
    top_k: int = 0                  # experts per token
    num_shared_experts: int = 0     # always-on experts (DeepSeek style)
    expert_d_ff: int = 0            # per-expert hidden dim (may differ from dense d_ff)
    capacity_factor: float = 1.25   # dispatch capacity multiplier
    router_aux_loss_weight: float = 0.01
    router_z_loss_weight: float = 1e-3

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2) configuration."""

    kv_lora_rank: int = 0           # compressed KV dim (c_kv)
    q_lora_rank: int = 0            # compressed Q dim (0 = full-rank Q proj)
    qk_nope_head_dim: int = 128     # non-rotary head dim
    qk_rope_head_dim: int = 64      # rotary (shared-key) head dim
    v_head_dim: int = 128

    @property
    def enabled(self) -> bool:
        return self.kv_lora_rank > 0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD configuration."""

    state_dim: int = 0              # N, per-head SSM state size
    head_dim: int = 64              # P, channels per SSD head
    expand: int = 2                 # d_inner = expand * d_model
    chunk_size: int = 256           # SSD chunk length
    conv_width: int = 4             # causal depthwise conv width
    dt_rank: int = 0                # unused by SSD (kept for mamba1 compat)

    @property
    def enabled(self) -> bool:
        return self.state_dim > 0


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU hybrid configuration."""

    lru_width: int = 0              # recurrence width (0 = disabled)
    conv_width: int = 4
    block_pattern: Tuple[str, ...] = ("recurrent", "recurrent", "attention")
    local_attn_window: int = 2048

    @property
    def enabled(self) -> bool:
        return self.lru_width > 0


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    """Encoder-decoder (Whisper-style) configuration."""

    num_encoder_layers: int = 0
    encoder_seq_len: int = 1500     # post-conv frame count (frontend is a stub)
    frontend_dim: int = 80          # mel bins (stub input spec documentation only)

    @property
    def enabled(self) -> bool:
        return self.num_encoder_layers > 0


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    """Vision-language backbone configuration (Qwen2-VL style)."""

    mrope_sections: Tuple[int, int, int] = (0, 0, 0)  # (temporal, height, width) rope splits
    num_visual_tokens: int = 0      # patch embeddings per image (stub frontend)
    visual_embed_dim: int = 0       # pre-projector dim (stub provides post-projector)

    @property
    def enabled(self) -> bool:
        return sum(self.mrope_sections) > 0


@dataclasses.dataclass(frozen=True)
class SharePrefillConfig:
    """Hyper-parameters of the paper's technique (§5, §6.1 defaults)."""

    enabled: bool = True
    block_size: int = 128           # TPU-aligned block granularity (paper: 64/128 Triton)
    gamma: float = 0.9              # cumulative attention threshold γ
    tau: float = 0.2                # similarity threshold τ (JS distance)
    delta: float = 0.3              # sparsity threshold δ (JS distance vs uniform)
    num_clusters: int = 0           # 0 → derived from clustering artifact
    min_cluster_size: int = 5       # smaller clusters become noise (paper A.4)
    min_seq_blocks: int = 8         # below this many blocks, dense attention is used


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Unified architecture description."""

    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    citation: str                   # source paper / model card

    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0               # 0 → d_model // num_heads
    d_ff: int = 0
    vocab_size: int = 0
    max_seq_len: int = 131072

    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    tie_embeddings: bool = False
    attn_logit_softcap: float = 0.0
    sliding_window: int = 0         # 0 = full attention; >0 = SWA width (Mixtral)
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # activation checkpointing for the layer scan: none | full | dots
    # (full = nothing_saveable, dots = dots_with_no_batch_dims_saveable)
    remat_policy: str = "none"

    moe: MoEConfig = MoEConfig()
    mla: MLAConfig = MLAConfig()
    ssm: SSMConfig = SSMConfig()
    rglru: RGLRUConfig = RGLRUConfig()
    encdec: EncDecConfig = EncDecConfig()
    vlm: VLMConfig = VLMConfig()
    share_prefill: SharePrefillConfig = SharePrefillConfig()

    # --- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def gqa_groups(self) -> int:
        if self.num_kv_heads == 0:
            return 1
        return self.num_heads // self.num_kv_heads

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS = 6·N·D)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        hd = self.resolved_head_dim
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family == "ssm":
            s = self.ssm
            d_in = s.expand * d
            per_layer = d * (2 * d_in) + d_in * d            # in_proj(x,z), out_proj
            nheads = d_in // s.head_dim
            per_layer += d_in * s.conv_width                  # depthwise conv
            per_layer += d_in * 2 * nheads * s.state_dim // nheads  # B,C proj approx
            per_layer += d_in * nheads                        # dt
        else:
            if self.mla.enabled:
                m = self.mla
                q_dim = self.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                per_layer += d * q_dim                                   # q proj
                per_layer += d * (m.kv_lora_rank + m.qk_rope_head_dim)   # kv down
                per_layer += m.kv_lora_rank * self.num_heads * (
                    m.qk_nope_head_dim + m.v_head_dim)                   # kv up
                per_layer += self.num_heads * m.v_head_dim * d           # o proj
            else:
                per_layer += d * self.num_heads * hd          # q
                per_layer += 2 * d * self.num_kv_heads * hd   # k, v
                per_layer += self.num_heads * hd * d          # o
            if self.moe.enabled:
                mo = self.moe
                eff = mo.expert_d_ff or self.d_ff
                active = (mo.top_k + mo.num_shared_experts)
                per_layer += d * mo.num_experts               # router
                per_layer += active * 3 * d * eff             # active expert FFNs
            else:
                per_layer += 3 * d * self.d_ff                # SwiGLU
        total = emb + L * per_layer
        if self.encdec.enabled:
            total += self.encdec.num_encoder_layers * (
                4 * d * self.num_heads * hd + 3 * d * self.d_ff)
            total += L * (2 * d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd)
        return int(total)

    def total_param_count(self) -> int:
        """Full parameter count including all (not only active) experts."""
        if not self.moe.enabled:
            return self.param_count()
        mo = self.moe
        eff = mo.expert_d_ff or self.d_ff
        active = mo.top_k + mo.num_shared_experts
        total_experts = mo.num_experts + mo.num_shared_experts
        delta = self.num_layers * (total_experts - active) * 3 * self.d_model * eff
        return self.param_count() + int(delta)


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One assigned (seq_len, global_batch) workload."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def reduced_config(cfg: ModelConfig, *, num_layers: int = 2,
                   d_model: int = 256, vocab_size: int = 512) -> ModelConfig:
    """Smoke-test variant of the same family (≤2 layers, d_model≤512, ≤4 experts)."""
    heads = max(2, min(4, cfg.num_heads))
    kv = max(1, min(heads, cfg.num_kv_heads)) if cfg.num_kv_heads else heads
    while heads % kv:
        kv -= 1
    updates = dict(
        num_layers=num_layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=64,
        d_ff=2 * d_model,
        vocab_size=vocab_size,
        max_seq_len=2048,
    )
    if cfg.moe.enabled:
        updates["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=2,
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
            expert_d_ff=d_model)
    if cfg.mla.enabled:
        updates["mla"] = dataclasses.replace(
            cfg.mla, kv_lora_rank=64, q_lora_rank=0,
            qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32)
    if cfg.ssm.enabled:
        updates["ssm"] = dataclasses.replace(
            cfg.ssm, state_dim=16, head_dim=32, chunk_size=64)
        updates["num_heads"] = 0
        updates["num_kv_heads"] = 0
    if cfg.rglru.enabled:
        updates["rglru"] = dataclasses.replace(
            cfg.rglru, lru_width=d_model, local_attn_window=256)
        updates["num_layers"] = 3          # one full (rec, rec, attn) block
    if cfg.encdec.enabled:
        updates["encdec"] = dataclasses.replace(
            cfg.encdec, num_encoder_layers=2, encoder_seq_len=64)
    if cfg.vlm.enabled:
        updates["vlm"] = dataclasses.replace(
            cfg.vlm, mrope_sections=(16, 8, 8), num_visual_tokens=16)
    if cfg.sliding_window:
        updates["sliding_window"] = 128
    updates["share_prefill"] = dataclasses.replace(
        cfg.share_prefill, block_size=64, min_seq_blocks=2)
    return dataclasses.replace(cfg, **updates)
