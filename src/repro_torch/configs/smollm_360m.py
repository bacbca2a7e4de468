"""SmolLM-360M (twin of ``repro/configs/smollm_360m.py``): llama-arch small
dense LM. [hf:HuggingFaceTB/SmolLM-360M]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    head_dim=64,
    mlp_act="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-360M",
)
