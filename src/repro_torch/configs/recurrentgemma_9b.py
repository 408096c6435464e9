"""recurrentgemma-9b — RG-LRU + local attention hybrid, 1:2 ratio [arXiv:2402.19427]
(the port's copy of ``repro/configs/recurrentgemma_9b.py``)."""
from repro_torch.configs.base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    citation="arXiv:2402.19427",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,               # MQA on the attention layers
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    rope_theta=10000.0,
    attn_logit_softcap=0.0,
    rglru=RGLRUConfig(lru_width=4096, conv_width=4,
                      block_pattern=("recurrent", "recurrent", "attention"),
                      local_attn_window=2048),
)
