"""llama3-8b-262k — the paper's primary evaluation model
[hf:gradientai/Llama-3-8B-Instruct-Gradient-262k] (Pekelis et al., 2024).

Not part of the assigned pool; included because the paper's own experiments
(Tables 1-2, Figures 1/4/5/6) run on this model.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b-262k",
    family="dense",
    citation="hf:gradientai/Llama-3-8B-Instruct-Gradient-262k",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=283461213.0,        # gradient.ai long-context theta
    max_seq_len=262144,
)
