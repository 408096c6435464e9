"""whisper-base — encoder-decoder audio backbone [arXiv:2212.04356] (the
port's copy of ``repro/configs/whisper_base.py``).

Transformer backbone only; the mel-spectrogram + conv feature extractor is a
stub: prefill takes precomputed frame embeddings (B, T_enc, D).
"""
from repro_torch.configs.base import ModelConfig, EncDecConfig, SharePrefillConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    citation="arXiv:2212.04356",
    num_layers=6,                 # decoder layers
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    rope_theta=0.0,               # whisper uses learned/sinusoidal positions
    encdec=EncDecConfig(num_encoder_layers=6, encoder_seq_len=1500,
                        frontend_dim=80),
    share_prefill=SharePrefillConfig(enabled=True, block_size=64,
                                     min_seq_blocks=4),
)
