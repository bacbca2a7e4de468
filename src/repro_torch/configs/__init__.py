"""Config registry (twin of ``repro/configs/__init__.py``): the LM configs
the port serves, scores and trains, their reduced smoke variants, and the
vision configs."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import (  # noqa: F401
    LONG_CONTEXT_ARCHS,
    SHAPES,
    ModelConfig,
    ShapeCell,
    VisionConfig,
)

_MODULES = {
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "qwen2-0.5b": "repro_torch.configs.qwen2_0_5b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "nemotron-4-15b": "repro_torch.configs.nemotron_4_15b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "qwen2-vl-72b": "repro_torch.configs.qwen2_vl_72b",
    "whisper-small": "repro_torch.configs.whisper_small",
}

_VISION_MODULES = {
    "resnet-tiny": "repro_torch.configs.resnet_tiny",
}


def list_archs() -> List[str]:
    return list(_MODULES)


def list_vision_archs() -> List[str]:
    return list(_VISION_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG


def get_vision_config(name: str) -> VisionConfig:
    if name not in _VISION_MODULES:
        raise KeyError(
            f"unknown vision arch {name!r}; known: {list(_VISION_MODULES)}")
    return importlib.import_module(_VISION_MODULES[name]).CONFIG


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU tests: small widths, few layers, a
    tiny vocab that is not a multiple of 128 (so the padding is exercised);
    the JAX package's ``smoke_config`` with its M-RoPE override (sections
    (2, 3, 3), 4 vision patches), its MoE one (4 experts, top 2), its two
    recurrent ones (xLSTM: 4 layers, an sLSTM every 2nd; Zamba2: 5 layers,
    the shared block after every 2nd, so a tail of 1) and its
    encoder-decoder one (2 encoder layers over 24 frames)."""
    cfg = get_config(name)
    kv = max(1, min(cfg.n_kv_heads, 2))
    over = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=kv,
        d_ff=96 if cfg.d_ff else 0,
        vocab_size=503,
        head_dim=16,
        max_seq_len=64,
        dtype="float32",
        param_dtype="float32",
        remat=False,
    )
    if cfg.mrope:
        over["mrope_sections"] = (2, 3, 3)  # sums to head_dim/2 = 8
        over["vision_patches"] = 4
    if cfg.is_moe:
        over.update(n_experts=4, top_k=2)
    if cfg.block_pattern == "xlstm":
        over.update(n_layers=4, slstm_every=2, n_heads=2, n_kv_heads=2,
                    ssm_chunk=8, expand=2)
    if cfg.block_pattern == "mamba_shared_attn":
        over.update(n_layers=5, shared_attn_every=2, ssm_head_dim=16,
                    ssm_state=8, ssm_chunk=8, n_heads=4, n_kv_heads=kv)
    if cfg.is_encoder_decoder:
        over.update(encoder_layers=2, encoder_seq=24)
    return cfg.with_(**over)
