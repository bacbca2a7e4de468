"""Qwen2-7B (twin of ``repro/configs/qwen2_7b.py``): GQA (kv=4), QKV bias,
untied embeddings. [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    mlp_act="swiglu",
    norm="rmsnorm",
    rope_theta=1e6,
    source="arXiv:2407.10671; hf:Qwen/Qwen2-7B",
)
