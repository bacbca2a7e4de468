"""Qwen2-VL-72B backbone (twin of ``repro/configs/qwen2_vl_72b.py``): M-RoPE,
dynamic-resolution vision (frontend STUB: the caller supplies patch
embeddings). [arXiv:2409.12191; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    mrope=True,
    mrope_sections=(16, 24, 24),
    mlp_act="swiglu",
    norm="rmsnorm",
    rope_theta=1e6,
    vision_patches=256,
    source="arXiv:2409.12191; hf:Qwen/Qwen2-VL-72B",
)
