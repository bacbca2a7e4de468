"""xLSTM-350M (twin of ``repro/configs/xlstm_350m.py``): mLSTM and sLSTM
blocks, 7:1 (every 8th block is an sLSTM). [arXiv:2405.04517; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    block_pattern="xlstm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,               # xLSTM blocks carry their own up/down projections
    vocab_size=50304,
    expand=2,
    slstm_every=8,
    ssm_chunk=128,
    norm="rmsnorm",
    source="arXiv:2405.04517 (unverified tier)",
)
