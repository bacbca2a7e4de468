"""Mixture-of-Experts layer (twin of ``repro/models/moe.py``): top-k routing,
the capacity-clipped scatter dispatch into an ``[E, capacity, d]`` buffer per
group, the expert FFN over per-expert column-wise N:M pruned linears, and the
weighted combine; and ``moe_apply_shard_map``, the manual expert parallelism
over a mesh's ``"model"`` axis.

Every shape is static and no step reads a tensor on the host: each (token,
slot) assignment takes its position in its expert from a cumsum over one-hot
expert ids, kept assignments land on unique ``(expert, position)`` pairs of
the buffer in one plain scatter, and dropped ones go to a trash slot that is
sliced off.  The layer trains: the router takes the gradient of the combine
weights and of the auxiliary loss, the experts and ``x`` that of their
assignments; the integer routing takes none.

The experts run as the twin of the JAX package's XLA path
(``jax.vmap(forward_compressed_xla)`` over the experts): a batched gather of
each expert's kept rows and one einsum, on the CPU and on the card alike.  No
Pallas kernel computes them there, so none does here.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch._compat import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.sparse_linear import (Boxed, box, forward_masked,
                                            linear_init, unbox)


def _stacked_linear_init(generator: torch.Generator, e: int, d_in: int,
                         d_out: int, cfg: ModelConfig, device=None):
    """``e`` experts' linears under ``cfg.sparsity``, every leaf stacked on a
    leading [E] axis (logical name ``"expert"``): a compressed expert stack
    is values [E, n_tiles, k, T] and idx [E, n_tiles, k].  Drawn and stacked
    on the host, then moved; on the ``meta`` device nothing is drawn."""
    dtype = getattr(torch, cfg.param_dtype)
    meta = torch.device(device).type == "meta"
    experts = [linear_init(generator, d_in, d_out, cfg.sparsity, dtype=dtype,
                           in_ax="embed", out_ax="ffn",
                           device="meta" if meta else "cpu")
               for _ in range(1 if meta else e)]

    def stack(leaves):
        v = [unbox(t) for t in leaves]
        v = (v[0].expand(e, *v[0].shape) if meta else torch.stack(v)).to(device)
        if isinstance(leaves[0], Boxed):
            return Boxed(v, ("expert",) + leaves[0].spec)
        return v

    return {k: stack([p[k] for p in experts]) for k in experts[0]}


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
    p = {"router": box((router * (1.0 / math.sqrt(d))).to(dev),
                       ("embed", "expert"))}
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


def _combine(out_buf, e_flat, pos, keep, top_p, cap: int, k: int):
    """Each token's kept assignments gathered back from the experts' output
    [G, E, C, d] and summed, weighted by ``top_p`` [G, Tg, K]: y [G, Tg, d].
    A dropped assignment reads a clamped slot and is zeroed."""
    g, tg, d = top_p.shape[0], top_p.shape[1], out_buf.shape[-1]
    rows = torch.arange(g, device=out_buf.device)[:, None].expand_as(e_flat)
    gathered = out_buf[rows, e_flat, torch.clamp(pos, max=cap - 1).long()]
    gathered = gathered * keep[..., None].to(gathered.dtype)
    w = top_p.reshape(g, -1)[..., None].to(gathered.dtype)
    return (gathered * w).reshape(g, tg, k, d).sum(dim=2)


def _balance(probs, top_i, e: int) -> torch.Tensor:
    """Each group's sum of mean router probability times routed share over
    the experts, [G]: the Switch load-balancing loss over ``e``."""
    g, tg, k = top_i.shape
    me = probs.mean(dim=1)  # [G, E]
    ce = (top_i.reshape(g, -1, 1) == torch.arange(e, device=probs.device)).sum(
        dim=1).to(torch.float32) / (tg * k)
    return (me * ce).sum(dim=-1)


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
    aux = e * _balance(probs, top_i, e).mean()
    cap = moe_capacity(tg, cfg)
    buf, e_flat, pos, keep = _dispatch_group(xg, top_i, e, cap, k)
    out_buf = _expert_ffn(params, cfg, buf)  # [G, E, C, d]
    y = _combine(out_buf, e_flat, pos, keep, top_p, cap, k)
    return y.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# Expert parallelism over the mesh's "model" axis
# ---------------------------------------------------------------------------


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``group``.  It
    marks where a value replicated over the model group feeds work split
    over it (this rank's experts), so each rank's part of the gradient
    joins the others'."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _SumOverGroup(torch.autograd.Function):
    """Sum over ``group`` forward; identity backward: every rank of the group
    goes on with the same sum, and so hands back the whole gradient."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed as dist

        out = t.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def moe_apply_shard_map(params, cfg: ModelConfig,
                        x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Manual expert parallelism over the installed mesh's ``"model"``
    axis, the JAX package's ``shard_map`` body with explicit collectives.

    ``x`` [b, S, d] is this rank's data shard, replicated over its model
    group, and every tensor is a plain local one.  Each rank routes all its
    tokens, keeps only the assignments to its ``E / tp`` experts (capacity
    ``moe_capacity(b * S)``), computes those, and the group sums ``y``; aux
    is averaged over the ``"pod"``/``"data"`` groups.  The expert leaves
    hold all E experts (this rank takes its slice) or this rank's E / tp.

    The gradient is the unsharded one: the sum of ``y`` hands every rank
    the whole cotangent, and the inputs of the split work (the dispatched
    tokens, the combine weights, all-E expert stacks) sum their gradient
    over the model group, while the routing and aux, computed alike on
    every rank, are not summed.  With no context, a model axis of 1, or
    ``E % tp != 0``, this is :func:`moe_apply`, as in JAX.
    """
    from repro_torch.sharding.api import axis_sizes, get_ctx

    ctx = get_ctx()
    sizes = axis_sizes(ctx.mesh) if ctx is not None else {}
    tp = sizes.get("model", 1)
    e, k = cfg.n_experts, cfg.top_k
    if tp == 1 or e % tp:
        return moe_apply(params, cfg, x)
    from torch.distributed.nn.functional import all_reduce

    mesh = ctx.mesh
    model = mesh.get_group("model")
    e_loc = e // tp
    e0 = mesh.get_local_rank("model") * e_loc
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(1, t, d)

    probs, top_p, top_i = _route(params, cfg, xt)
    aux = e * _balance(probs, top_i, e)[0]
    for ax in ("pod", "data"):
        if sizes.get(ax, 1) > 1:
            aux = all_reduce(aux, group=mesh.get_group(ax)) / sizes[ax]

    # this rank's assignments; the others go to a phantom expert e_loc whose
    # rows are sliced off, so the positions count only this rank's
    mine = (top_i >= e0) & (top_i < e0 + e_loc)
    el = torch.where(mine, top_i - e0, e_loc)
    cap = moe_capacity(t, cfg)
    buf, e_flat, pos, keep = _dispatch_group(
        _CopyToGroup.apply(xt, model), el, e_loc + 1, cap, k)
    keep = keep & mine.reshape(1, -1)

    def local(leaf):
        if leaf.shape[0] != e:
            return leaf
        if leaf.is_floating_point():
            leaf = _CopyToGroup.apply(leaf, model)
        return leaf[e0:e0 + e_loc]

    ew = {n: {kk: local(v) for kk, v in params[n].items()}
          for n in params if n != "router"}
    out_buf = _expert_ffn(ew, cfg, buf[:, :e_loc])
    y = _combine(out_buf, torch.clamp(e_flat, max=e_loc - 1), pos, keep,
                 _CopyToGroup.apply(top_p, model), cap, k)
    return _SumOverGroup.apply(y, model).reshape(b, s, d), aux
