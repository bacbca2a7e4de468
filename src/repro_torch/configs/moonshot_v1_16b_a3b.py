"""Moonlight-16B-A3B (kimi/moonshot; twin of
``repro/configs/moonshot_v1_16b_a3b.py``): 64-expert top-6 MoE.
[hf:moonshotai/Moonlight-16B-A3B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,            # per-expert FFN width
    vocab_size=163840,
    n_experts=64,
    top_k=6,
    mlp_act="swiglu",
    norm="rmsnorm",
    source="hf:moonshotai/Moonlight-16B-A3B",
)
