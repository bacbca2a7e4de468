"""Qwen2-0.5B (twin of ``repro/configs/qwen2_0_5b.py``): GQA (kv=2), QKV
bias, tied embeddings. [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    head_dim=64,
    qkv_bias=True,
    mlp_act="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
    rope_theta=1e6,
    source="arXiv:2407.10671; hf:Qwen/Qwen2-0.5B",
)
