"""Linear layers in the dense, masked and compressed formats (twin of
``repro/core/sparse_linear.py``).

Params are plain dicts of tensors: ``{"w"}`` (dense), ``{"w", "mask"}``
(masked), ``{"values", "idx"}`` (compressed), each with an optional ``"b"``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch._compat import resolve_device
from repro_torch.core import formats
from repro_torch.core.pruning import SparsityConfig, colwise_nm_mask, rowwise_nm_mask
from repro_torch.kernels.colwise_nm.ref import colwise_nm_matmul_ref


def _dense_init(generator, d_in, d_out, dtype, scale):
    if scale is None:
        scale = 1.0 / np.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator, dtype=torch.float32)
    return (w * scale).to(dtype)


def linear_init(generator: torch.Generator, d_in: int, d_out: int,
                cfg: SparsityConfig, *, dtype=torch.float32,
                use_bias: bool = False, scale: Optional[float] = None,
                device=None) -> Dict[str, Any]:
    """Create a (possibly pruned) linear layer's params on ``device``
    (``None``: the CUDA card).  ``generator`` is a CPU generator, so the
    weights do not depend on the device."""
    dev = resolve_device(device)
    prune = cfg.applies_to(d_in, d_out)
    params: Dict[str, Any] = {}
    if prune and cfg.compressed:
        params["values"], params["idx"] = formats.init_compressed(
            generator, d_in, d_out, cfg, dtype, scale, device=dev)
    elif prune and cfg.format == "masked":
        w = _dense_init(generator, d_in, d_out, dtype, scale)
        if cfg.scheme == "rowwise":
            mask = rowwise_nm_mask(w, cfg.sparsity, m=cfg.m)
        else:
            mask = colwise_nm_mask(w, cfg.sparsity, m=cfg.m, tile=cfg.tile)
        params["w"] = (w * mask.to(dtype)).to(dev)
        params["mask"] = mask.to(dev)
    else:
        params["w"] = _dense_init(generator, d_in, d_out, dtype, scale).to(dev)
    if use_bias:
        params["b"] = torch.zeros((d_out,), dtype=dtype, device=dev)
    return params


def forward_masked(x: torch.Tensor, w: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    return x @ (w * mask.to(w.dtype))


def linear_apply(params, x: torch.Tensor) -> torch.Tensor:
    """Apply a layer created by ``linear_init`` to ``x`` [..., d_in]."""
    if "values" in params:
        if x.device.type != "cpu":
            raise NotImplementedError(
                "compressed linear layers have no CUDA kernel yet: "
                "colwise_nm_matmul_pallas is ROADMAP queue-2 item 1")
        y = colwise_nm_matmul_ref(x, params["values"], params["idx"])
    elif "mask" in params:
        y = forward_masked(x, params["w"], params["mask"])
    else:
        y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y
