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
    the one ``impl`` (else an ambient ``dispatch.force_scope``) names,
    through ``dispatch.run_guarded``: a candidate that refuses to run is
    quarantined and the next one runs; raises when none is left.
    """
    if "values" in params:
        from repro_torch import dispatch

        phase = dispatch.current_phase()
        site = ("linear", x.shape, params["values"].shape, x.dtype, x.device,
                phase)

        def make_key():
            return dispatch.linear_key_from(
                x.shape, params["values"].shape, x.dtype, phase=phase)

        spec = dispatch.site_impl(
            site, make_key, param_keys=("values", "idx"),
            force=dispatch.forced_impl("linear", impl), device=x.device)
        # execution guard: a candidate that refuses to run is quarantined
        # and the key re-resolves down the ladder
        y = dispatch.run_guarded(make_key, spec, lambda s: s.apply(params, x),
                                 param_keys=("values", "idx"),
                                 device=x.device)
    elif "mask" in params:
        y = forward_masked(x, params["w"], params["mask"])
    else:
        y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y


# ---------------------------------------------------------------------------
# Conversions (prune a trained dense layer -> compressed)
# ---------------------------------------------------------------------------


def compress_layer(params, cfg: SparsityConfig):
    """Convert a dense/masked layer's params into the compressed format,
    ``{"values", "idx"[, "b"]}``.  A layer without a ``mask`` is pruned
    by ``cfg`` first.  Stacked weights ([L, ..., d_in, d_out]) are packed
    one layer at a time, and the stacked (values, idx) feed the layer loop
    as they are."""
    w = params["w"]
    lead = tuple(w.shape[:-2])
    d_in, d_out = w.shape[-2:]
    meta = formats.meta_for(d_in, d_out, cfg)
    mask = params.get("mask")

    def pack2d(w2, m2):
        if m2 is None:
            if cfg.scheme == "rowwise":
                m2 = rowwise_nm_mask(w2, cfg.sparsity, m=cfg.m)
            else:
                m2 = colwise_nm_mask(w2, cfg.sparsity, m=cfg.m, tile=meta.tile)
        return formats.pack_colwise(w2, m2, meta)

    if lead:
        wf = w.reshape((-1, d_in, d_out))
        mf = (mask.reshape((-1, d_in, d_out)) if mask is not None
              else [None] * wf.shape[0])
        packed = [pack2d(a, m) for a, m in zip(wf, mf)]
        values = torch.stack([v for v, _ in packed])
        idx = torch.stack([i for _, i in packed])
        values = values.reshape(lead + tuple(values.shape[1:]))
        idx = idx.reshape(lead + tuple(idx.shape[1:]))
    else:
        values, idx = pack2d(w, mask)
    out = {"values": values, "idx": idx}
    if "b" in params:
        out["b"] = params["b"]
    return out
