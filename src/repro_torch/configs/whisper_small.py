"""Whisper-small (twin of ``repro/configs/whisper_small.py``): encoder-decoder,
conv frontend STUB (the caller supplies frame embeddings).
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    is_encoder_decoder=True,
    n_layers=12,           # decoder layers
    encoder_layers=12,
    encoder_seq=1500,      # natural frame count
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,      # padded to 51968 internally
    use_rope=False,        # absolute sinusoidal positions
    mlp_act="gelu",
    norm="layernorm",
    source="arXiv:2212.04356 (unverified tier)",
)
