"""mamba2-370m — SSD state-space duality, attention-free [arXiv:2405.21060]
(the port's copy of ``repro/configs/mamba2_370m.py``)."""
from repro_torch.configs.base import ModelConfig, SSMConfig, SharePrefillConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    citation="arXiv:2405.21060",
    num_layers=48,
    d_model=1024,
    num_heads=0,                # attention-free
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk_size=256),
    # SharePrefill is inapplicable to an attention-free SSM
    share_prefill=SharePrefillConfig(enabled=False),
)
