"""Nemotron-4-15B (twin of ``repro/configs/nemotron_4_15b.py``): GQA
(kv=8), squared-ReLU MLP, LayerNorm, untied embeddings.
[arXiv:2402.16819; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    head_dim=128,
    mlp_act="sq_relu",
    norm="layernorm",
    source="arXiv:2402.16819 (unverified tier)",
)
