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


def _dense_init(generator, d_in, d_out, dtype, scale):
    if scale is None:
        scale = 1.0 / np.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator, dtype=torch.float32)
    return (w * scale).to(dtype)


def linear_init(generator: torch.Generator, d_in: int, d_out: int,
                cfg: SparsityConfig, *, dtype=torch.float32,
                use_bias: bool = False, scale: Optional[float] = None,
                mode: str = "concat", device=None) -> Dict[str, Any]:
    """Create a (possibly pruned) linear layer's params on ``device``
    (``None``: the CUDA card).  ``generator`` is a CPU generator, so the
    weights do not depend on the device.

    ``mode="reduce"`` marks a layer whose reduction dim a tensor-parallel
    mesh would shard (the o and down projections).  The JAX package gives
    such a layer its group-local format only under
    ``SparsityConfig.shard_local_reduce``, which the port, on one card, does
    not have: in either mode the layer takes the ordinary format.
    """
    if mode not in ("concat", "reduce"):
        raise ValueError(f"mode must be 'concat' or 'reduce', got {mode!r}")
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


def forward_compressed_xla(x: torch.Tensor, values: torch.Tensor,
                           idx: torch.Tensor) -> torch.Tensor:
    """Tiled gather + dense einsum, the twin of the JAX package's XLA path:
    ``y[..., t*T:(t+1)*T] = x[..., idx[t]] @ values[t]``."""
    n_tiles, _, tile = values.shape
    xg = x[..., idx.long()]  # [..., n_tiles, k]
    y = torch.einsum("...tk,tkf->...tf", xg, values)
    return y.reshape(*x.shape[:-1], n_tiles * tile)


def forward_masked(x: torch.Tensor, w: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    return x @ (w * mask.to(w.dtype))


def linear_apply(params, x: torch.Tensor, *,
                 impl: Optional[str] = None) -> torch.Tensor:
    """Apply a layer created by ``linear_init`` to ``x`` [..., d_in].

    A compressed layer runs the candidate ``repro_torch.dispatch`` resolves
    for its shape, device and serving phase (profile DB, else the heuristic:
    the sparse linear kernel on the card, the gather-einsum on the CPU), or
    the one ``impl`` (else an ambient ``dispatch.force_scope``) names.  A
    candidate that cannot run raises.
    """
    if "values" in params:
        from repro_torch import dispatch

        phase = dispatch.current_phase()
        site = ("linear", x.shape, params["values"].shape, x.dtype, x.device,
                phase)
        spec = dispatch.site_impl(
            site, lambda: dispatch.linear_key_from(
                x.shape, params["values"].shape, x.dtype, phase=phase),
            param_keys=("values", "idx"),
            force=dispatch.forced_impl("linear", impl), device=x.device)
        y = spec.apply(params, x)
    elif "mask" in params:
        y = forward_masked(x, params["w"], params["mask"])
    else:
        y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y
