"""MLP variants over the (possibly compressed) linear layer (twin of
``repro/models/mlp.py``): SwiGLU (the llama/qwen family), squared ReLU
(nemotron) and GELU, the tanh approximation (whisper)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sparse_linear import linear_apply, linear_init

MLP_ACTS = ("swiglu", "sq_relu", "gelu")


def mlp_init(generator: torch.Generator, cfg: ModelConfig, device=None,
             d_ff=None):
    """``{"gate", "up", "down"}`` for SwiGLU, ``{"up", "down"}`` for the
    others; ``d_ff`` overrides ``cfg.d_ff``."""
    if cfg.mlp_act not in MLP_ACTS:
        raise ValueError(f"mlp_act={cfg.mlp_act!r}: one of {MLP_ACTS}")
    d, f = cfg.d_model, d_ff or cfg.d_ff
    opts = dict(dtype=getattr(torch, cfg.param_dtype), device=device)
    p = {}
    if cfg.mlp_act == "swiglu":
        p["gate"] = linear_init(generator, d, f, cfg.sparsity, in_ax="embed",
                                out_ax="ffn", **opts)
    p["up"] = linear_init(generator, d, f, cfg.sparsity, in_ax="embed",
                          out_ax="ffn", **opts)
    p["down"] = linear_init(generator, f, d, cfg.sparsity, in_ax="ffn",
                            out_ax="embed", mode="reduce", **opts)
    return p


def mlp_apply(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """On laid-out params (the twin of JAX's ``shd`` over ``act_ffn``) gate
    and up give the rank's ``ffn`` columns and down is row parallel: the
    REDUCE layer multiplies the rank's groups and sums over the model
    axis, a dense one its rows likewise, and a compressed one gathers its
    input whole first."""
    if cfg.mlp_act == "swiglu":
        g = linear_apply(params["gate"], x, split="cols")
        h = F.silu(g) * linear_apply(params["up"], x, split="cols")
    elif cfg.mlp_act == "sq_relu":
        h = torch.square(F.relu(linear_apply(params["up"], x, split="cols")))
    else:  # gelu
        h = F.gelu(linear_apply(params["up"], x, split="cols"),
                   approximate="tanh")
    return linear_apply(params["down"], h, split="rows", d_in=cfg.d_ff)
