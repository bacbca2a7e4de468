"""SwiGLU MLP over the (possibly compressed) linear layer (twin of
``repro/models/mlp.py``'s SwiGLU branch)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sparse_linear import linear_apply, linear_init


def mlp_init(generator: torch.Generator, cfg: ModelConfig, device=None):
    if cfg.mlp_act != "swiglu":
        raise NotImplementedError(
            f"mlp_act={cfg.mlp_act!r}: the port has the SwiGLU MLP only")
    d, f = cfg.d_model, cfg.d_ff
    opts = dict(dtype=getattr(torch, cfg.param_dtype), device=device)
    return {
        "gate": linear_init(generator, d, f, cfg.sparsity, **opts),
        "up": linear_init(generator, d, f, cfg.sparsity, **opts),
        "down": linear_init(generator, f, d, cfg.sparsity, mode="reduce",
                            **opts),
    }


def mlp_apply(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    g = linear_apply(params["gate"], x)
    u = linear_apply(params["up"], x)
    return linear_apply(params["down"], F.silu(g) * u)
