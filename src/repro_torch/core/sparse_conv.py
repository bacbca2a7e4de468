"""Conv layers in the dense, masked and compressed formats (twin of
``repro/core/sparse_conv.py``).

The GEMM view of a conv is [O, Kh*Kw*C]: pruning is column-wise over the
flattened (kh, kw, c) reduction dim, and a compressed layer holds
``{"values": [n_tiles, k_kept, T], "idx": [n_tiles, k_kept], "conv_geom":
[kh, kw, c_in]}``; ``conv_geom`` is the int32 leaf that tells a compressed
conv from a compressed linear layer.  Dense and masked layers hold an OHWI
``w`` (and a bool ``mask``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch._compat import resolve_device
from repro_torch.core import formats
from repro_torch.core.pruning import (
    SparsityConfig,
    colwise_nm_mask,
    conv_colwise_nm_mask,
)
from repro_torch.kernels.conv_gemm.ops import compress_conv_weights, conv2d_sparse
from repro_torch.kernels.conv_gemm.ref import conv2d_cnhw_ref


def _conv_geom(kh: int, kw: int, c_in: int, device) -> torch.Tensor:
    return torch.tensor([kh, kw, c_in], dtype=torch.int32, device=device)


def conv_init(generator: torch.Generator, c_in: int, c_out: int, kh: int,
              kw: int, cfg: SparsityConfig, *, dtype=torch.float32,
              use_bias: bool = False, scale: Optional[float] = None,
              device=None) -> Dict[str, Any]:
    """Create a (possibly pruned) conv layer's params on ``device`` (``None``:
    the CUDA card), drawing from the CPU ``generator``."""
    dev = resolve_device(device)
    d_in = kh * kw * c_in
    prune = cfg.applies_to(d_in, c_out)
    params: Dict[str, Any] = {}
    if prune and cfg.compressed:
        params["values"], params["idx"] = formats.init_compressed(
            generator, d_in, c_out, cfg, dtype, scale, device=dev)
        params["conv_geom"] = _conv_geom(kh, kw, c_in, dev)
    else:
        if scale is None:
            scale = 1.0 / np.sqrt(d_in)
        w = torch.randn((c_out, kh, kw, c_in), generator=generator,
                        dtype=torch.float32)
        w = (w * scale).to(dtype)
        if prune and cfg.format == "masked":
            meta = formats.meta_for(d_in, c_out, cfg)
            mask = conv_colwise_nm_mask(w, cfg.sparsity, m=cfg.m,
                                        tile=meta.tile)
            w = (w * mask).to(dtype)
            params["mask"] = mask.to(dev)
        elif prune:
            raise ValueError(
                f"conv_init does not support pruning format {cfg.format!r}")
        params["w"] = w.to(dev)
    if use_bias:
        params["b"] = torch.zeros((c_out,), dtype=dtype, device=dev)
    return params


def conv_apply(params, x_cnhw: torch.Tensor, *, kh: int, kw: int,
               stride: int = 1, pad: int = 0, v: int = 128,
               impl: Optional[str] = None) -> torch.Tensor:
    """Apply a layer created by ``conv_init`` to a CNHW map.

    Compressed layers run ``conv2d_sparse``: the plan dispatch resolves
    for the conv's shape and device, or the one ``impl`` names; masked and
    dense layers run the library convolution on ``w`` (times ``mask``).
    Returns CNHW [O, B, Ho, Wo].
    """
    if "values" in params:
        y = conv2d_sparse(x_cnhw.contiguous(), params["values"], params["idx"],
                          kh=kh, kw=kw, stride=stride, pad=pad, v=v, impl=impl)
    else:
        w = params["w"]
        if "mask" in params:
            w = w * params["mask"].to(w.dtype)
        y = conv2d_cnhw_ref(x_cnhw, w, stride=stride, pad=pad)
    if "b" in params:
        y = y + params["b"][:, None, None, None]
    return y


def apply_conv_mask(params):
    """Project a masked layer's ``w`` onto its stored ``mask``: the per-step
    projection of masked finetuning (the optimizer moves every position,
    the projection zeroes the pruned ones, so the support stays fixed).  A
    layer without both passes through unchanged; so does the input dict."""
    if "mask" not in params or "w" not in params:
        return params
    w = params["w"]
    return {**params, "w": w * params["mask"].to(w.dtype)}


def refresh_conv_mask(params, cfg: SparsityConfig):
    """Recompute a masked conv layer's column-wise mask from its current
    weights and apply it: the mask-refresh hook of masked finetuning, which
    lets the kept (kh, kw, c) taps follow the finetuned weights.  A layer
    without a mask passes through unchanged."""
    if "mask" not in params or "w" not in params:
        return params
    w = params["w"]
    o, kh, kw, c_in = w.shape
    meta = formats.meta_for(kh * kw * c_in, o, cfg)
    mask = conv_colwise_nm_mask(w, cfg.sparsity, m=cfg.m, tile=meta.tile)
    return {**params, "w": (w * mask).to(w.dtype), "mask": mask}


def compress_conv_layer(params, kh: int, kw: int, cfg: SparsityConfig):
    """Convert a dense or masked conv layer (OHWI ``w``) to the compressed
    format.  A stored ``mask`` pins the kept support exactly, so the packed
    layer reproduces the masked forward; without one the column-wise mask is
    recomputed from ``|w|``."""
    w = params["w"]
    mask = params.get("mask")
    if mask is not None:
        o, _kh, _kw, c_in = w.shape
        d_in = _kh * _kw * c_in
        meta = formats.meta_for(d_in, o, cfg)
        values, idx = formats.pack_colwise(
            w.reshape(o, d_in).T, mask.reshape(o, d_in).T, meta)
    else:
        values, idx, _meta = compress_conv_weights(w, cfg)
    out = {"values": values, "idx": idx,
           "conv_geom": _conv_geom(kh, kw, w.shape[3], w.device)}
    if "b" in params:
        out["b"] = params["b"]
    return out


def _walk(t, layer_fn):
    """Rebuild a params tree, passing each layer dict through ``layer_fn``
    (which returns the new layer, or None to descend into it)."""
    if isinstance(t, dict):
        new = layer_fn(t)
        if new is not None:
            return new
        return {k: _walk(v, layer_fn) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_walk(v, layer_fn) for v in t)
    return t


def compress_conv_tree(params, cfg: SparsityConfig):
    """Compress every masked conv layer (4-D ``w`` with a ``mask``) of a
    params tree; dense convs and linear layers pass through unchanged."""

    def layer(t):
        w = t.get("w")
        if w is not None and "mask" in t and w.dim() == 4:
            return compress_conv_layer(t, int(w.shape[1]), int(w.shape[2]), cfg)
        return None

    return _walk(params, layer)


def prune_conv_tree(params, cfg: SparsityConfig):
    """One-shot column-wise prune of a vision params tree into the masked
    format: every conv (4-D OHWI ``w``) and linear (2-D ``w``) layer whose
    GEMM dims clear ``cfg.min_dim`` gets a ``mask`` and a masked ``w``."""

    def prune_layer(layer):
        w = layer["w"]
        if w.dim() == 4:
            o, _kh, _kw, c_in = w.shape
            d_in, d_out = _kh * _kw * c_in, o
        elif w.dim() == 2:
            d_in, d_out = w.shape
        else:
            return layer
        if not cfg.applies_to(d_in, d_out):
            return layer
        tile = formats.meta_for(d_in, d_out, cfg).tile
        if w.dim() == 4:
            mask = conv_colwise_nm_mask(w, cfg.sparsity, m=cfg.m, tile=tile)
        else:
            mask = colwise_nm_mask(w, cfg.sparsity, m=cfg.m, tile=tile)
        return {**layer, "w": (w * mask).to(w.dtype), "mask": mask}

    def layer(t):
        if "w" in t and "mask" not in t:
            out = {k: _walk(v, layer) for k, v in t.items()}
            return prune_layer(out)
        return None

    return _walk(params, layer)
