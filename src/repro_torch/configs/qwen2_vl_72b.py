"""qwen2-vl-72b — VLM backbone, M-RoPE + dynamic resolution [arXiv:2409.12191].

Transformer backbone only; the ViT vision encoder and projector are a stub:
callers pass pre-projected patch embeddings (``Model.prefill(embeds=)``)
with 3-D ``(t, h, w)`` positions.
"""
from repro_torch.configs.base import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    citation="arXiv:2409.12191",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    rope_theta=1000000.0,
    vlm=VLMConfig(mrope_sections=(16, 24, 24),  # head_dim=128 → t/h/w rope sections
                  num_visual_tokens=1024,
                  visual_embed_dim=1280),
)
