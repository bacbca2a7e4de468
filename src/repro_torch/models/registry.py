"""Model facade (twin of ``repro/models/registry.py``): params, the scoring
forward and loss, and the serving step functions the engine calls, for the
decoder-only families (``lm.py``) and the encoder-decoder one
(``encdec.py``); the contiguous cache serves every family, the paged one
the decoder-only attention families only, as in the JAX package.  And the
logical specs of the params, batches and caches, which the sharding layer
resolves on a mesh; and ``input_specs``, the ``meta`` inputs of one cell of
the dry-run grid.

Params laid out on a mesh (``sharding.lay_out``) switch the dense attention
LM's scoring forward and serving steps onto each rank's shards
(:func:`laid_out`): each takes the global batch, as JAX's jitted steps
do, computes this rank's rows, and returns its outputs laid out
(``sharding.full`` gives the global tensors) and the loss averaged over
the batch's ranks.  Whole params run as before, under a ``ShardingCtx``
or not."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.core.sparse_linear import boxing, unbox_tree
from repro_torch.models import attention as attn_mod
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import lm as lm_mod
from repro_torch.sharding import api as sh


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


# ---------------------------------------------------------------------------
# Laid-out params: the dense attention LM on each rank's shards
# ---------------------------------------------------------------------------


LOGITS_NAMES = ("act_batch", None, "act_vocab")


def layout_covers(cfg: ModelConfig) -> bool:
    """The config is a dense attention LM, the family that runs on
    laid-out params (smollm-360m, qwen2-0.5b, qwen2-7b, nemotron-4-15b)."""
    return not (cfg.is_encoder_decoder or cfg.block_pattern != "attn"
                or cfg.is_moe or cfg.mrope or cfg.family == "vlm")


def laid_out(cfg: ModelConfig, params, what: str):
    """The mesh of laid-out ``params``, else ``None``.  Raises
    ``ValueError`` where they reach a family other than the dense attention
    LM (slice 25), or heads that the model axis does not divide."""
    mesh = sh.laid_out_mesh(params)
    if mesh is None:
        return None
    if not layout_covers(cfg):
        kind = ("encoder-decoder" if cfg.is_encoder_decoder else
                f"{cfg.family} ({cfg.block_pattern})")
        raise ValueError(
            f"{what} of {cfg.name}: laid-out params run the dense attention "
            f"LM only; the {kind} family under the layout is slice 25")
    tp = sh.axis_sizes(mesh).get("model", 1)
    if cfg.padded_heads % tp:
        raise ValueError(
            f"{what} of {cfg.name}: {cfg.padded_heads} heads (cfg.tp="
            f"{cfg.tp}) do not split over the model axis of {tp}; set "
            f"cfg.tp to {tp}")
    return mesh


def _local_params(params):
    """Laid-out params as the layer loop takes them: every leaf but the
    layers' through ``sharding.gather_tree`` once a call (the embedding and
    unembedding gathered over the data axis); the layers go through it one
    at a time (``blocks.layer_params``)."""
    return dict(params, **sh.gather_tree({k: v for k, v in params.items()
                                          if k != "layers"}))


def _rules():
    ctx = sh.get_ctx()
    return ctx.rules if ctx is not None else sh.RULES


def batch_rows(batch: Dict[str, Any], mesh):
    """(this rank's rows of every leaf of a global batch, the mesh axes that
    split the rows): each leaf's batch dim split as its logical spec
    (``BATCH_NAMES``: ``act_batch``, ``"pod"`` major) resolves on ``mesh``.
    A laid-out leaf is the rank's rows already.  Raises where the rows do
    not split over every data-parallel axis of more than one rank: the
    cache would then split its sequence over ``"data"`` (``act_kv_seq``),
    which this port does not lay out."""
    sizes = sh.axis_sizes(mesh)
    want = tuple(ax for ax in ("pod", "data") if sizes.get(ax, 1) > 1)
    rows = {}
    for k, v in batch.items():
        if sh.is_laid_out(v):
            rows[k] = v.to_local()
            continue
        v = torch.as_tensor(v)
        names = BATCH_NAMES.get(k, ("act_batch",) + (None,) * (v.dim() - 1))
        spec = sh.resolve_spec(v.shape, names, _rules(), mesh)
        split = tuple(ax for ax in sh.entry_axes(spec[0]) if sizes[ax] > 1)
        if split != want:
            raise ValueError(
                f"batch leaf {k!r} of {v.shape[0]} rows splits over {split}, "
                f"not over every data-parallel axis {want}")
        rows[k] = sh.shard_of(v, spec, mesh)
    return rows, want


def _batch_mean(t: torch.Tensor, axes, mesh) -> torch.Tensor:
    """A per-rank mean averaged over the ranks of ``axes`` (equal rows)."""
    if not axes:
        return t
    out = t.reshape(1).clone()
    n = 1
    for ax in axes:
        sh.all_reduce_sum(out, ax, mesh)
        n *= sh.axis_sizes(mesh)[ax]
    return (out / n).reshape(t.shape)


def _laid_out_logits(cfg: ModelConfig, logits, b: int, mesh):
    return sh.laid_out_as(logits, LOGITS_NAMES,
                          (b,) + tuple(logits.shape[1:-1])
                          + (cfg.padded_vocab,), mesh, _rules())


def _laid_loss(cfg, mesh, params, batch):
    rows, axes = batch_rows(batch, mesh)
    with sh.layout_scope(mesh):
        loss, m = lm_mod.loss_fn(_local_params(params), cfg, rows)
    nll = _batch_mean(m["nll"], axes, mesh)
    return nll + (loss - m["nll"]), {"nll": nll, "aux": m["aux"]}


def _laid_forward(cfg, mesh, params, batch):
    rows, _ = batch_rows(batch, mesh)
    with sh.layout_scope(mesh):
        logits, _ = lm_mod.lm_forward(_local_params(params), cfg, rows)
    return _laid_out_logits(cfg, logits, torch.as_tensor(
        batch["tokens"]).shape[0], mesh)


def _laid_prefill(cfg, mesh, params, batch):
    rows, _ = batch_rows({"tokens": batch["tokens"]}, mesh)
    with sh.layout_scope(mesh):
        logits, cache = lm_mod.prefill(_local_params(params), cfg,
                                       rows["tokens"])
    b = batch["tokens"].shape[0]
    names = cache_specs(cfg, cache)
    cache = {k: sh.laid_out_as(v, names[k], (v.shape[0], b, v.shape[2],
                                             cfg.n_kv_heads, v.shape[4]),
                               mesh, _rules())
             for k, v in cache.items()}
    return _laid_out_logits(cfg, logits, b, mesh), cache


def _laid_decode(cfg, mesh, params, cache, tokens, pos):
    if any(not sh.is_laid_out(t) or sh.split_dim(t, "data") == 2
           for t in cache.values()):
        raise ValueError("laid-out params decode against a laid-out cache "
                         "whose rows split as the batch's: cache_init_fn("
                         "..., mesh=mesh) or sharding.lay_out")
    pos_t = torch.as_tensor(pos)
    step_in = {"tokens": tokens}
    if pos_t.dim():
        step_in["pos"] = pos_t
    rows, _ = batch_rows(step_in, mesh)
    local = {k: v.to_local() for k, v in cache.items()}
    with sh.layout_scope(mesh):
        logits, _ = lm_mod.decode_step(_local_params(params), cfg,
                                       local, rows["tokens"],
                                       rows.get("pos", pos))
    return _laid_out_logits(cfg, logits, tokens.shape[0], mesh), cache


def loss_fn(cfg: ModelConfig):
    """(params, batch) -> (loss, {"nll", "aux"}): next-token cross-entropy
    of the scoring forward.  An encoder-decoder batch carries
    ``"enc_embeds"`` beside ``"tokens"``.  On laid-out params (the dense
    attention LM): the global batch in, the NLL of the vocab gathered whole
    and averaged over the batch's ranks out; forward only."""
    def f(params, batch):
        mesh = laid_out(cfg, params, "the loss")
        if mesh is not None:
            return _laid_loss(cfg, mesh, params, batch)
        if cfg.is_encoder_decoder:
            return encdec_mod.encdec_loss(params, cfg, batch)
        return lm_mod.loss_fn(params, cfg, batch)
    return f


def forward_fn(cfg: ModelConfig):
    """(params, batch) -> logits [B, S, padded_vocab]; on laid-out params,
    the logits laid out (rows over the batch's ranks, vocab over the model
    axis)."""
    def f(params, batch):
        mesh = laid_out(cfg, params, "the forward")
        if mesh is not None:
            return _laid_forward(cfg, mesh, params, batch)
        if cfg.is_encoder_decoder:
            enc = encdec_mod.encode(params, cfg, batch["enc_embeds"])
            return encdec_mod.decode_forward(params, cfg, batch["tokens"], enc)
        return lm_mod.lm_forward(params, cfg, batch)[0]
    return f


def prefill_fn(cfg: ModelConfig):
    """(params, batch) -> (last-token logits [B, 1, V], cache of the
    prompt's [L, B, S, KV, D] rows, and an encoder-decoder's cross K/V of
    ``batch["enc_embeds"]``); a recurrent pattern's cache is ``None`` (the
    engine runs the prompt through the decode step).  A decoder-only model
    reads only ``batch["tokens"]``.  On laid-out params the logits and the
    cache come back laid out (``cache_specs`` resolved)."""
    def f(params, batch):
        mesh = laid_out(cfg, params, "prefill")
        if mesh is not None:
            return _laid_prefill(cfg, mesh, params, batch)
        if cfg.is_encoder_decoder:
            return encdec_mod.encdec_prefill(params, cfg, batch["enc_embeds"],
                                             batch["tokens"])
        return lm_mod.prefill(params, cfg, batch["tokens"])
    return f


def decode_fn(cfg: ModelConfig):
    """Decode step against the family's contiguous cache: tokens [B, 1],
    pos a scalar or [B] (an encoder-decoder: a scalar).  On laid-out
    params the cache must be laid out too (:func:`cache_init_fn` with a
    mesh); its shards are written in place and the logits come back laid
    out."""
    def f(params, cache, tokens, pos):
        mesh = laid_out(cfg, params, "the decode step")
        if mesh is not None:
            return _laid_decode(cfg, mesh, params, cache, tokens, pos)
        if cfg.is_encoder_decoder:
            return encdec_mod.encdec_decode_step(params, cfg, cache, tokens,
                                                 pos)
        return lm_mod.decode_step(params, cfg, cache, tokens, pos)
    return f


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


def cache_init_fn(cfg: ModelConfig, batch: int, max_len: int, device=None,
                  mesh=None):
    """The family's contiguous decode cache on ``device``: ``lm.cache_init``,
    or an encoder-decoder's with cross K/V of ``cfg.encoder_seq`` rows.
    With a ``mesh`` of more than one rank, the dense attention LM's cache
    laid out by ``cache_specs`` resolved (JAX's ``cache_auto=False``
    layout): each rank allocates only its shard."""
    if mesh is not None and mesh.size() > 1:
        if not layout_covers(cfg):
            raise ValueError(f"a laid-out cache of {cfg.name}: the dense "
                             "attention LM only; the other families under "
                             "the layout are slice 25")

        def laid():
            from repro_torch._compat import resolve_device

            dev = resolve_device(device)
            shapes = abstract_cache(cfg, batch, max_len)
            names = cache_specs(cfg, shapes)
            out = {}
            for k, t in shapes.items():
                spec = sh.resolve_spec(t.shape, names[k], _rules(), mesh)
                local = torch.zeros(sh.shard_of(t, spec, mesh).shape,
                                    dtype=t.dtype, device=dev)
                out[k] = sh.laid_out_as(local, names[k], t.shape, mesh,
                                        _rules())
            return out
        return laid
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
