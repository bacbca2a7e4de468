"""Zamba2-7B (twin of ``repro/configs/zamba2_7b.py``): Mamba2 backbone and
a shared attention block applied after every 6th layer (one set of shared
weights, one KV cache per application). [arXiv:2411.15242; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    block_pattern="mamba_shared_attn",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,            # shared block MLP width
    vocab_size=32000,
    head_dim=112,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_chunk=128,
    expand=2,
    d_conv=4,
    shared_attn_every=6,
    mlp_act="swiglu",
    norm="rmsnorm",
    source="arXiv:2411.15242 (unverified tier)",
)
