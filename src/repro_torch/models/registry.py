"""Model facade (twin of ``repro/models/registry.py``): params, the scoring
forward and loss, and the serving step functions the engine calls, for the
decoder-only families (``lm.py``) and the encoder-decoder one
(``encdec.py``); the contiguous cache serves every family, the paged one
the decoder-only attention families only, as in the JAX package.  And the
logical specs of the params, batches and caches, which the sharding layer
resolves on a mesh; and ``input_specs``, the ``meta`` inputs of one cell of
the dry-run grid."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.core.sparse_linear import boxing, unbox_tree
from repro_torch.models import attention as attn_mod
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import lm as lm_mod


def init_params(cfg: ModelConfig, seed: int, device=None):
    """Random params from ``seed`` (the JAX package's tree layout)."""
    if cfg.is_encoder_decoder:
        return encdec_mod.encdec_init(cfg, seed, device)
    return lm_mod.lm_init(cfg, seed, device)


def abstract_params(cfg: ModelConfig):
    """(params, logical specs) with no allocation and no draw on the host:
    the params' leaves are ``meta`` tensors of their shapes and dtypes (the
    twin of ``jax.eval_shape``), the specs tuples of logical dim names, one
    a dim, as JAX's ``Boxed`` leaves carry them."""
    with torch.device("meta"), boxing():
        return unbox_tree(init_params(cfg, 0, device="meta"))


def param_specs(cfg: ModelConfig):
    """The params' logical spec tree (:func:`abstract_params`'s second)."""
    return abstract_params(cfg)[1]


def loss_fn(cfg: ModelConfig):
    """(params, batch) -> (loss, {"nll", "aux"}): next-token cross-entropy
    of the scoring forward.  An encoder-decoder batch carries
    ``"enc_embeds"`` beside ``"tokens"``."""
    if cfg.is_encoder_decoder:
        return lambda params, batch: encdec_mod.encdec_loss(params, cfg, batch)
    return lambda params, batch: lm_mod.loss_fn(params, cfg, batch)


def forward_fn(cfg: ModelConfig):
    """(params, batch) -> logits [B, S, padded_vocab]."""
    if cfg.is_encoder_decoder:
        def f(params, batch):
            enc = encdec_mod.encode(params, cfg, batch["enc_embeds"])
            return encdec_mod.decode_forward(params, cfg, batch["tokens"], enc)
        return f
    return lambda params, batch: lm_mod.lm_forward(params, cfg, batch)[0]


def prefill_fn(cfg: ModelConfig):
    """(params, batch) -> (last-token logits [B, 1, V], cache of the
    prompt's [L, B, S, KV, D] rows, and an encoder-decoder's cross K/V of
    ``batch["enc_embeds"]``); a recurrent pattern's cache is ``None`` (the
    engine runs the prompt through the decode step).  A decoder-only model
    reads only ``batch["tokens"]``."""
    if cfg.is_encoder_decoder:
        return lambda params, batch: encdec_mod.encdec_prefill(
            params, cfg, batch["enc_embeds"], batch["tokens"])
    return lambda params, batch: lm_mod.prefill(params, cfg, batch["tokens"])


def decode_fn(cfg: ModelConfig):
    """Decode step against the family's contiguous cache: tokens [B, 1],
    pos a scalar or [B] (an encoder-decoder: a scalar)."""
    if cfg.is_encoder_decoder:
        return lambda params, cache, tokens, pos: encdec_mod.encdec_decode_step(
            params, cfg, cache, tokens, pos)
    return lambda params, cache, tokens, pos: lm_mod.decode_step(
        params, cfg, cache, tokens, pos)


def _require_attn_family(cfg: ModelConfig, what: str) -> None:
    """The JAX registry's refusal of an encoder-decoder model or a
    recurrent pattern where the step needs slot-addressable KV rows."""
    if cfg.is_encoder_decoder or cfg.block_pattern != "attn":
        raise NotImplementedError(
            f"{what} requires a decoder-only attention family; "
            f"{cfg.name} has block_pattern={cfg.block_pattern!r}"
            + (" (encoder-decoder)" if cfg.is_encoder_decoder else ""))


def prefill_chunk_fn(cfg: ModelConfig):
    """Chunked prefill (continuous batching): tokens [B, C] at positions
    [start, start + C) into a preallocated contiguous cache.  Attention
    families only."""
    _require_attn_family(cfg, "chunked prefill")
    return lambda params, cache, tokens, start, with_logits=True: (
        lm_mod.prefill_chunk(params, cfg, cache, tokens, start, with_logits))


def cache_init_fn(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """The family's contiguous decode cache on ``device``: ``lm.cache_init``,
    or an encoder-decoder's with cross K/V of ``cfg.encoder_seq`` rows."""
    if cfg.is_encoder_decoder:
        return lambda: encdec_mod.encdec_cache_init(cfg, batch, max_len,
                                                    cfg.encoder_seq, device)
    return lambda: lm_mod.cache_init(cfg, batch, max_len, device)


def paged_decode_fn(cfg: ModelConfig, page_size: int):
    """Decode step against a paged KV cache: tokens [B, 1], pos [B],
    tables [B, n_max].  Attention families only."""
    _require_attn_family(cfg, "paged decode")
    return lambda params, cache, tokens, pos, tables: lm_mod.paged_decode_step(
        params, cfg, cache, tokens, pos, tables, page_size)


def prefill_packed_fn(cfg: ModelConfig, page_size: int):
    """Packed padding-free prefill into a paged cache: one concatenated
    [T]-token stream with per-token slot ids and positions.  Attention
    families only."""
    _require_attn_family(cfg, "packed prefill")
    return lambda params, cache, tokens, slot_ids, positions, tables, last_idx: (
        lm_mod.prefill_packed(params, cfg, cache, tokens, slot_ids, positions,
                              tables, last_idx, page_size))


def paged_cache_init_fn(cfg: ModelConfig, n_pages: int, page_size: int,
                        device=None):
    """Physical paged cache, [L, n_pages + 1, page_size, KV, D] per leaf
    (the +1 is the trash page), on ``device``.  Attention families only."""
    _require_attn_family(cfg, "paged cache")
    return lambda: attn_mod.paged_cache_init(
        cfg, n_pages, page_size, cfg.n_layers, getattr(torch, cfg.dtype),
        device)


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int):
    """The contiguous decode cache as ``meta`` tensors: no allocation."""
    with torch.device("meta"):
        return cache_init_fn(cfg, batch, max_len, device="meta")()


# ---------------------------------------------------------------------------
# Logical specs for batches and caches
# ---------------------------------------------------------------------------


BATCH_NAMES = {
    "tokens": ("act_batch", None),
    "mrope_positions": ("act_batch", None, None),
    "vision_embeds": ("act_batch", None, None),
    "vision_pos": ("act_batch", None),
    "enc_embeds": ("act_batch", None, None),
}


def batch_specs(cfg: ModelConfig, batch: Dict[str, Any]):
    """Logical dim names of each batch entry."""
    return {k: BATCH_NAMES[k] for k in batch}


def cache_specs(cfg: ModelConfig, cache) -> Any:
    """The logical dim-name tree of the family's contiguous cache."""
    kv = (None, "act_batch", "act_kv_seq", "act_kv_heads", None)
    if cfg.is_encoder_decoder:
        return {k: kv for k in ("k", "v", "xk", "xv")}
    pat = cfg.block_pattern
    if pat == "attn":
        return {"k": kv, "v": kv}
    if pat == "xlstm":
        return {
            "mlstm": {
                "C": (None, None, "act_batch", "act_heads", None, None),
                "n": (None, None, "act_batch", "act_heads", None),
                "m": (None, None, "act_batch", "act_heads"),
            },
            "slstm": {k: (None, "act_batch", "act_heads", None)
                      for k in ("c", "n", "h", "m")},
        }
    if pat == "mamba_shared_attn":
        spec = {
            "mamba": {
                "ssm": (None, None, "act_batch", "act_heads", None, None),
                "conv": (None, None, "act_batch", None, "act_ffn"),
            },
            "shared_kv": {"k": kv, "v": kv},
        }
        if isinstance(cache, dict) and "mamba_tail" in cache:
            spec["mamba_tail"] = {
                "ssm": (None, "act_batch", "act_heads", None, None),
                "conv": (None, "act_batch", None, "act_ffn"),
            }
        return spec
    raise ValueError(pat)


# ---------------------------------------------------------------------------
# input_specs: meta stand-ins per (arch x shape)
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, Any]:
    """The step inputs of one cell as ``meta`` tensors (JAX's
    ``ShapeDtypeStruct``s): ``{"kind": "train" | "prefill", "batch"}`` or
    ``{"kind": "decode", "cache", "tokens" [B, 1], "pos" (0-d int32)}``.
    A VLM's train batch carries its M-RoPE positions and vision embeddings,
    its prefill batch the positions; an encoder-decoder's carries
    ``enc_embeds``, and its prefill puts the cell's length on the frame
    axis beside a 128-token decoder prompt."""
    b, s = cell.global_batch, cell.seq_len
    dt = getattr(torch, cfg.dtype)
    i32 = torch.int32

    def sds(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if cell.kind == "train":
        batch = {"tokens": sds((b, s), i32)}
        if cfg.family == "vlm":
            batch["mrope_positions"] = sds((b, 3, s), i32)
            batch["vision_embeds"] = sds((b, cfg.vision_patches, cfg.d_model),
                                         dt)
            batch["vision_pos"] = sds((b, cfg.vision_patches), i32)
        if cfg.is_encoder_decoder:
            batch["enc_embeds"] = sds((b, s, cfg.d_model), dt)
        return {"kind": "train", "batch": batch}
    if cell.kind == "prefill":
        if cfg.is_encoder_decoder:
            return {"kind": "prefill",
                    "batch": {"enc_embeds": sds((b, s, cfg.d_model), dt),
                              "tokens": sds((b, 128), i32)}}
        batch = {"tokens": sds((b, s), i32)}
        if cfg.family == "vlm":
            batch["mrope_positions"] = sds((b, 3, s), i32)
        return {"kind": "prefill", "batch": batch}
    return {"kind": "decode", "cache": abstract_cache(cfg, b, s),
            "tokens": sds((b, 1), i32), "pos": sds((), i32)}
