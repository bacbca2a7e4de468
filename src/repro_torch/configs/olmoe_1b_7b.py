"""OLMoE-1B-7B (twin of ``repro/configs/olmoe_1b_7b.py``): 64-expert top-8
MoE. [arXiv:2409.02060; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,            # per-expert FFN width
    vocab_size=50304,
    n_experts=64,
    top_k=8,
    mlp_act="swiglu",
    norm="rmsnorm",
    source="arXiv:2409.02060; hf:allenai/OLMoE-1B-7B-0924",
)
