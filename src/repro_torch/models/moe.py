"""Mixture-of-Experts layer (twin of ``repro/models/moe.py``): top-k routing,
the capacity-clipped scatter dispatch into an ``[E, capacity, d]`` buffer per
group, the expert FFN over per-expert column-wise N:M pruned linears, and the
weighted combine.

Every shape is static and no step reads a tensor on the host: each (token,
slot) assignment takes its position in its expert from a cumsum over one-hot
expert ids, kept assignments land on unique ``(expert, position)`` pairs of
the buffer in one plain scatter, and dropped ones go to a trash slot that is
sliced off.

The experts run as the twin of the JAX package's XLA path
(``jax.vmap(forward_compressed_xla)`` over the experts): a batched gather of
each expert's kept rows and one einsum, on the CPU and on the card alike.  No
Pallas kernel computes them there, so none does here.  ``moe_apply_shard_map``
(manual expert parallelism over a mesh) is not ported: the port has no mesh,
and without one the JAX package runs ``moe_apply`` for it as well.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch._compat import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.sparse_linear import forward_masked, linear_init


def _stacked_linear_init(generator: torch.Generator, e: int, d_in: int,
                         d_out: int, cfg: ModelConfig, device=None):
    """``e`` experts' linears under ``cfg.sparsity``, every leaf stacked on a
    leading [E] axis: a compressed expert stack is values [E, n_tiles, k, T]
    and idx [E, n_tiles, k].  Drawn and stacked on the host, then moved."""
    dtype = getattr(torch, cfg.param_dtype)
    experts = [linear_init(generator, d_in, d_out, cfg.sparsity, dtype=dtype,
                           device="cpu") for _ in range(e)]
    return {k: torch.stack([p[k] for p in experts]).to(device)
            for k in experts[0]}


def _stacked_linear_apply(params, x: torch.Tensor) -> torch.Tensor:
    """x [G, E, C, d_in] -> [G, E, C, d_out] with each expert's weights."""
    if "values" in params:
        values, idx = params["values"], params["idx"]
        e, n_tiles, k, tile = values.shape
        # each expert's kept rows of every tile, gathered for all its slots
        index = idx.long().reshape(e, 1, n_tiles * k).expand(
            *x.shape[:-1], n_tiles * k)
        xg = torch.gather(x, -1, index).reshape(*x.shape[:-1], n_tiles, k)
        y = torch.einsum("gectk,etkf->gectf", xg, values)
        return y.reshape(*x.shape[:-1], n_tiles * tile)
    if "mask" in params:
        return forward_masked(x, params["w"], params["mask"])
    return torch.einsum("gecd,edf->gecf", x, params["w"])


def moe_init(generator: torch.Generator, cfg: ModelConfig,
             device=None) -> Dict[str, Any]:
    """``{"router", "gate", "up", "down"}`` (no ``gate`` unless SwiGLU).  The
    router [d_model, E] is float32 whatever ``param_dtype`` is."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dev = resolve_device(device)
    router = torch.randn((d, e), generator=generator, dtype=torch.float32)
    p = {"router": (router * (1.0 / math.sqrt(d))).to(dev)}
    if cfg.mlp_act == "swiglu":
        p["gate"] = _stacked_linear_init(generator, e, d, f, cfg, dev)
    p["up"] = _stacked_linear_init(generator, e, d, f, cfg, dev)
    p["down"] = _stacked_linear_init(generator, e, f, d, cfg, dev)
    return p


def moe_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)  # multiple of 8, as the JAX package's


def _route(params, cfg: ModelConfig, xg: torch.Tensor):
    """The router over each group's tokens xg [G, Tg, d]: (probs [G, Tg, E],
    top_p [G, Tg, K] renormalised, top_i [G, Tg, K]), all float32 but the
    ids.  The operands are in ``xg``'s dtype and the products summed in
    float32.  A stable descending sort picks the top k, so among equal
    probabilities the lower expert id comes first, as ``jax.lax.top_k``
    orders them."""
    router = params["router"].to(xg.dtype)
    logits = torch.matmul(xg.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :cfg.top_k], top_i[..., :cfg.top_k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_i


def _dispatch_group(xt: torch.Tensor, top_i: torch.Tensor, e: int, cap: int,
                    k: int):
    """Every group's scatter dispatch, group-local (no cumsum across
    groups).  xt [G, Tg, d], top_i [G, Tg, K] -> (buf [G, E, cap, d],
    e_flat, pos, keep [G, Tg * K]), assignments in (token, slot) order."""
    g = xt.shape[0]
    e_flat = top_i.reshape(g, -1)
    onehot = (e_flat[..., None] == torch.arange(e, device=xt.device)).to(
        torch.int32)
    pos_in_e = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    pos = torch.gather(pos_in_e, -1, e_flat[..., None])[..., 0]
    keep = pos < cap
    # the kept (expert, position) pairs are unique: one plain scatter, with
    # the dropped assignments sent to the trash slot ``cap``
    buf = xt.new_zeros((g, e, cap + 1, xt.shape[-1]))
    rows = torch.arange(g, device=xt.device)[:, None].expand_as(e_flat)
    xt_rep = xt[:, :, None].expand(g, xt.shape[1], k, xt.shape[-1])
    buf[rows, e_flat, torch.where(keep, pos, cap).long()] = xt_rep.reshape(
        g, -1, xt.shape[-1])
    return buf[:, :, :cap], e_flat, pos, keep


def _expert_ffn(params, cfg: ModelConfig, buf: torch.Tensor) -> torch.Tensor:
    """The experts over the dispatch buffer [G, E, C, d]: SwiGLU, else the
    squared ReLU (the JAX package's MoE knows these two)."""
    if cfg.mlp_act == "swiglu":
        h = (F.silu(_stacked_linear_apply(params["gate"], buf))
             * _stacked_linear_apply(params["up"], buf))
    else:
        h = torch.square(F.relu(_stacked_linear_apply(params["up"], buf)))
    return _stacked_linear_apply(params["down"], h)


def moe_apply(params, cfg: ModelConfig,
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (y [B, S, d], aux): grouped dispatch over ``cfg.dp``
    groups of whole sequences, the experts, and the combine weighted by the
    renormalised top-k probabilities.  aux is the Switch load-balancing
    loss, averaged over the groups."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    g = max(1, min(cfg.dp, b))
    while b % g != 0:
        g -= 1
    tg = b * s // g
    xg = x.reshape(g, tg, d)

    probs, top_p, top_i = _route(params, cfg, xg)
    me = probs.mean(dim=1)  # [G, E]
    ce = (top_i.reshape(g, -1, 1) == torch.arange(e, device=x.device)).sum(
        dim=1).to(torch.float32) / (tg * k)
    aux = e * (me * ce).sum(dim=-1).mean()

    cap = moe_capacity(tg, cfg)
    buf, e_flat, pos, keep = _dispatch_group(xg, top_i, e, cap, k)
    out_buf = _expert_ffn(params, cfg, buf)  # [G, E, C, d]

    rows = torch.arange(g, device=x.device)[:, None].expand_as(e_flat)
    gathered = out_buf[rows, e_flat, torch.clamp(pos, max=cap - 1).long()]
    gathered = gathered * keep[..., None].to(gathered.dtype)
    w = top_p.reshape(g, -1)[..., None].to(gathered.dtype)
    y = (gathered * w).reshape(g, tg, k, d).sum(dim=2)
    return y.reshape(b, s, d), aux
