"""qwen2.5-7b — the paper's second evaluation model [hf:Qwen/Qwen2.5-7B-Instruct].

Not part of the assigned pool; included because the paper's own experiments run
on this model.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-7b",
    family="dense",
    citation="hf:Qwen/Qwen2.5-7B-Instruct",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    rope_theta=1000000.0,
    max_seq_len=131072,
)
