"""deepseek-v2-236b — MLA kv_lora=512, MoE 2 shared + 160 routed top-6 [arXiv:2405.04434]."""
from repro_torch.configs.base import ModelConfig, MoEConfig, MLAConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    citation="arXiv:2405.04434",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,             # MLA: per-q-head keys decompressed from latent
    d_ff=12288,                   # dense FFN of layer 0 (DeepSeek uses dense first layer)
    vocab_size=102400,
    rope_theta=10000.0,
    moe=MoEConfig(num_experts=160, top_k=6, num_shared_experts=2,
                  expert_d_ff=1536),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
)
