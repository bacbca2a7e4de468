"""The transformer block of the scoring forward and the serving steps,
Zamba2's shared attention block, and the stacked-layers layout (twin of
``repro/models/blocks.py``: the attention block under ``cfg.norm`` and
``cfg.mlp_act``, with an MLP or, where ``cfg.is_moe``, a mixture of
experts).

Every leaf of ``params["layers"]`` carries a leading ``[L, ...]`` axis, as
the JAX package stacks its layers for ``scan``: the two trees compare leaf
for leaf.  The layer loop takes ``t[l]`` views of the stacked leaves.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sparse_linear import Boxed, linear_apply, linear_init
from repro_torch.models import attention as attn
from repro_torch.models.common import norm_apply, norm_init
from repro_torch.models.mlp import mlp_apply, mlp_init
from repro_torch.models.moe import moe_apply, moe_apply_shard_map, moe_init
from repro_torch.sharding.api import current_layout, gather_tree, select_layer


def stack_layers(layers: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack per-layer trees of one structure along a leading layers axis
    (a :class:`Boxed` leaf's spec gains ``"layers"`` in front, as JAX's
    ``stack_init`` names it)."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: stack_layers([t[k] for t in layers]) for k in first}
    if isinstance(first, Boxed):
        return Boxed(torch.stack([b.value for b in layers]),
                     ("layers",) + first.spec)
    return torch.stack(layers)


def _select(stacked, l: int):
    if isinstance(stacked, dict):
        return {k: _select(v, l) for k, v in stacked.items()}
    if type(stacked) is torch.Tensor:
        return stacked[l]
    return select_layer(stacked, l)


def layer_params(stacked, l: int):
    """Layer ``l``'s params: views into the stacked leaves.  On laid-out
    params (``sharding.layout_scope``) the layer's leaves keep their model
    split and are gathered whole over the data axis, one all-gather a
    dtype for the layer (FSDP)."""
    layer = _select(stacked, l)
    if isinstance(layer, dict) and current_layout() is not None:
        return gather_tree(layer)
    return layer


def block_init(generator: torch.Generator, cfg: ModelConfig, device=None):
    dtype = getattr(torch, cfg.param_dtype)
    p = {
        "ln1": norm_init(cfg.d_model, cfg.norm, dtype, device),
        "attn": attn.attn_init(generator, cfg, device),
        "ln2": norm_init(cfg.d_model, cfg.norm, dtype, device),
    }
    if cfg.is_moe:
        p["moe"] = moe_init(generator, cfg, device)
    else:
        p["mlp"] = mlp_init(generator, cfg, device)
    return p


def ffn_apply(params, cfg: ModelConfig, x):
    """The block's feed-forward half over the normed x: (y, aux).  A mixture
    of experts with its auxiliary loss (``moe_apply_shard_map`` under
    ``cfg.moe_impl="shard_map"``, as JAX's five block functions read it),
    else the MLP and ``None``."""
    if cfg.is_moe:
        fn = moe_apply_shard_map if cfg.moe_impl == "shard_map" else moe_apply
        return fn(params["moe"], cfg, x)
    return mlp_apply(params["mlp"], cfg, x), None


def block_apply(params, cfg: ModelConfig, h, *, positions,
                mrope_positions=None, causal=True):
    """Full self-attention block over h [B, S, d] (the scoring forward, and
    Whisper's encoder with ``causal=False``).  Returns (h, aux): the layer's
    auxiliary loss, zero for an MLP block."""
    x = norm_apply(params["ln1"], h, cfg.norm)
    h = h + attn.attn_apply(params["attn"], cfg, x, positions=positions,
                            causal=causal, mrope_positions=mrope_positions)
    y, aux = ffn_apply(params, cfg, norm_apply(params["ln2"], h, cfg.norm))
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h + y, aux


def block_decode(params, cfg: ModelConfig, h, layer_cache, *, pos,
                 mrope_positions=None):
    """One-token decode through a block against a contiguous cache.

    layer_cache (k, v) [B, S_max, KV, D]; pos a scalar or [B].  Returns
    (h, (k_new, v_new)); the caller writes the new K/V after the layer loop.
    """
    x = norm_apply(params["ln1"], h, cfg.norm)
    a, new_kv = attn.attn_decode(params["attn"], cfg, x, layer_cache, pos=pos,
                                 mrope_positions=mrope_positions)
    h = h + a
    x = norm_apply(params["ln2"], h, cfg.norm)
    return h + ffn_apply(params, cfg, x)[0], new_kv


# ---------------------------------------------------------------------------
# Zamba2 shared attention block (one set of weights reused across the stack)
# ---------------------------------------------------------------------------


def shared_block_init(generator: torch.Generator, cfg: ModelConfig,
                      device=None):
    """``{"fuse", "block"}``: Zamba concatenates the current hidden with the
    original embedding, and ``fuse`` (2d -> d) maps it back before the
    ordinary block."""
    fuse = linear_init(generator, 2 * cfg.d_model, cfg.d_model, cfg.sparsity,
                       dtype=getattr(torch, cfg.param_dtype), in_ax="embed",
                       out_ax="embed2", device=device)
    return {"fuse": fuse, "block": block_init(generator, cfg, device)}


def shared_block_apply(params, cfg: ModelConfig, h, h0, *, positions):
    """The shared block over h [B, S, d] beside the embedding output h0."""
    x = linear_apply(params["fuse"], torch.cat([h, h0], dim=-1))
    out, _ = block_apply(params["block"], cfg, x, positions=positions)
    return h + out


def shared_block_decode(params, cfg: ModelConfig, h, h0, layer_cache, *, pos):
    """One-token decode through the shared block against this
    application's own contiguous cache.  Returns (h, (k_new, v_new))."""
    x = linear_apply(params["fuse"], torch.cat([h, h0], dim=-1))
    out, new_kv = block_decode(params["block"], cfg, x, layer_cache, pos=pos)
    return h + out, new_kv


def block_prefill_chunk(params, cfg: ModelConfig, h, layer_cache, *, start,
                        mrope_positions=None):
    """Chunked prefill through a block: h [B, C, d] at positions [start,
    start + C) against a contiguous layer cache.  Returns (h, (k_chunk,
    v_chunk))."""
    x = norm_apply(params["ln1"], h, cfg.norm)
    a, kv_new = attn.attn_prefill_chunk(params["attn"], cfg, x, layer_cache,
                                        start=start,
                                        mrope_positions=mrope_positions)
    h = h + a
    x = norm_apply(params["ln2"], h, cfg.norm)
    return h + ffn_apply(params, cfg, x)[0], kv_new


def block_paged_decode(params, cfg: ModelConfig, h, layer_cache, *, pos,
                       tables, page_size: int):
    """One-token decode through a block against a paged cache.

    layer_cache (k_pages, v_pages) [P, page_size, KV, D]; pos [B]; tables
    [B, n_max].  Returns (h, (k_new, v_new)); the caller scatters the new
    K/V through the tables after the layer loop.
    """
    x = norm_apply(params["ln1"], h, cfg.norm)
    a, new_kv = attn.paged_attn_decode(params["attn"], cfg, x, layer_cache,
                                       pos=pos, tables=tables,
                                       page_size=page_size)
    h = h + a
    x = norm_apply(params["ln2"], h, cfg.norm)
    return h + ffn_apply(params, cfg, x)[0], new_kv


def block_prefill_packed(params, cfg: ModelConfig, h, *, seq_ids, positions):
    """Packed multi-prompt prefill through a block.

    h [1, T, d] is the concatenated padding-free stream; seq_ids/positions
    [T].  Returns (h, (k [1, T, KV, D], v)).
    """
    x = norm_apply(params["ln1"], h, cfg.norm)
    a, kv_new = attn.attn_prefill_packed(params["attn"], cfg, x,
                                         seq_ids=seq_ids, positions=positions)
    h = h + a
    x = norm_apply(params["ln2"], h, cfg.norm)
    return h + ffn_apply(params, cfg, x)[0], kv_new
