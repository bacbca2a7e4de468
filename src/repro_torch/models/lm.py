"""The decoder-only LM (twin of the attention-pattern half of
``repro/models/lm.py``, dense or mixture-of-experts): init; the scoring
forward (``lm_forward``) and its next-token loss (``loss_fn``); and the
serving steps: prefill, chunked prefill and one decode step against a
contiguous KV cache, and packed prefill and one decode step against a
paged one.

No step moves a tensor to the host: the caller reads only the logits it
samples from.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch._compat import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.sparse_linear import linear_apply
from repro_torch.models import attention as attn_mod
from repro_torch.models.blocks import (
    block_apply,
    block_decode,
    block_init,
    block_paged_decode,
    block_prefill_chunk,
    block_prefill_packed,
    ffn_apply,
    layer_params,
    stack_layers,
)
from repro_torch.models.common import embed_init, embed_lookup, norm_apply, norm_init


def _check_supported(cfg: ModelConfig) -> None:
    """Refuse what the port does not have yet: the recurrent patterns and
    M-RoPE (ROADMAP queue 1 item 10)."""
    if cfg.block_pattern != "attn":
        raise NotImplementedError(
            f"{cfg.name}: block_pattern={cfg.block_pattern!r} waits for the "
            "recurrent families (ROADMAP queue 1 item 10)")
    if cfg.mrope:
        raise NotImplementedError(
            f"{cfg.name}: M-RoPE waits for ROADMAP queue 1 item 10")


def lm_init(cfg: ModelConfig, seed: int, device=None) -> Dict[str, Any]:
    """Random params from ``seed`` on ``device`` (``None``: the CUDA card),
    drawn from a CPU generator so they do not depend on the device.  The
    tree is the JAX package's: ``{"embed", "final_norm", "layers"}``, and
    ``"unembed"`` [d_model, padded_vocab] where the embeddings are untied,
    with every layer leaf stacked on a leading [L] axis."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    dtype = getattr(torch, cfg.param_dtype)
    p = {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype, dev),
        "final_norm": norm_init(cfg.d_model, cfg.norm, dtype, dev),
    }
    if not cfg.tie_embeddings:
        u = torch.randn((cfg.d_model, cfg.padded_vocab), generator=gen,
                        dtype=torch.float32) * 0.02
        p["unembed"] = u.to(dev, dtype)
    p["layers"] = stack_layers([block_init(gen, cfg, dev)
                                for _ in range(cfg.n_layers)])
    return p


def _embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return embed_lookup(params["embed"], tokens).to(getattr(torch, cfg.dtype))


def _unembed(params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """h [B, S, d] -> logits [B, S, padded_vocab]: by the embedding table
    where the embeddings are tied, else by ``unembed``."""
    _check_supported(cfg)
    if cfg.tie_embeddings:
        return torch.matmul(h, params["embed"].to(h.dtype).T)
    return torch.matmul(h, params["unembed"].to(h.dtype))


def lm_forward(params, cfg: ModelConfig, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scoring forward: ``batch["tokens"]`` [B, S] (a tensor or a numpy
    array, moved to the params' device) -> (logits [B, S, padded_vocab],
    aux), with causal full self-attention in every layer as
    ``cfg.attn_impl`` picks it.  aux is the mean of the blocks' auxiliary
    losses (zero for a dense model)."""
    tokens = torch.as_tensor(batch["tokens"], device=params["embed"].device)
    h = _embed_tokens(params, cfg, tokens)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    auxs = []
    for l in range(cfg.n_layers):
        h, a = block_apply(layer_params(params["layers"], l), cfg, h,
                           positions=positions)
        auxs.append(a)
    h = norm_apply(params["final_norm"], h, cfg.norm)
    return _unembed(params, cfg, h), torch.stack(auxs).mean()


def loss_fn(params, cfg: ModelConfig, batch, aux_weight: float = 0.01):
    """Next-token cross-entropy of the scoring forward.  The padded vocab
    ids can never be labels, so their logits are set to -1e30 in f32
    before the logsumexp.  Returns (nll + aux_weight * aux, {"nll",
    "aux"})."""
    logits, aux = lm_forward(params, cfg, batch)
    logits = logits[:, :-1].float()
    tokens = torch.as_tensor(batch["tokens"], device=logits.device)
    labels = tokens[:, 1:].long()
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, attn_mod.NEG)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = (logz - gold).mean()
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}


def _check_attn(cfg: ModelConfig, what: str) -> None:
    if cfg.block_pattern != "attn":
        raise NotImplementedError(
            f"{what} of block_pattern={cfg.block_pattern!r} ({cfg.name}) "
            "waits for the recurrent families (ROADMAP queue 1 item 10); "
            "the port serves attention families only")


def cache_init(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Contiguous decode cache ``{"k", "v"}`` of [L, B, max_len, KV, D] on
    ``device`` (``None``: the CUDA card)."""
    _check_attn(cfg, "the decode cache")
    return attn_mod.cache_init(cfg, batch, max_len, cfg.n_layers,
                               getattr(torch, cfg.dtype), device)


def decode_step(params, cfg: ModelConfig, cache, tokens: torch.Tensor, pos):
    """One decode step against a contiguous cache.

    tokens [B, 1]; pos a scalar (the current length) or a per-sequence [B]
    vector (slots at mixed lengths decode in one step).  The layers only
    read the cache; one :func:`attention.cache_write` after the loop
    commits every layer's new K/V in place.  Returns (logits [B, 1, V],
    cache).
    """
    _check_attn(cfg, "decode_step")
    h = _embed_tokens(params, cfg, tokens)
    pos_b = attn_mod._pos_vector(pos, tokens.shape[0], tokens.device)
    k_news, v_news = [], []
    for l in range(cfg.n_layers):
        h, (kn, vn) = block_decode(layer_params(params["layers"], l), cfg, h,
                                   (cache["k"][l], cache["v"][l]), pos=pos_b)
        k_news.append(kn)
        v_news.append(vn)
    attn_mod.cache_write(cache["k"], cache["v"], torch.stack(k_news),
                         torch.stack(v_news), pos_b)
    h = norm_apply(params["final_norm"], h, cfg.norm)
    return _unembed(params, cfg, h), cache


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor):
    """Run prompts tokens [B, S] through the model.  Returns (last-token
    logits [B, 1, V], cache {"k", "v"} of [L, B, S, KV, D]).

    Attention is :func:`attention.sdpa_gqa`, or the online-softmax
    :func:`attention.sdpa_gqa_chunked` under ``attn_impl="chunked"`` when S
    exceeds ``attn_chunk``; never the flash kernel, as in the JAX package.
    """
    _check_attn(cfg, "prefill")
    b, s = tokens.shape
    h = _embed_tokens(params, cfg, tokens)
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    ks, vs = [], []
    for l in range(cfg.n_layers):
        lp = layer_params(params["layers"], l)
        x = norm_apply(lp["ln1"], h, cfg.norm)
        q, k, v = attn_mod._qkv(lp["attn"], cfg, x, positions)
        if cfg.attn_impl == "chunked" and s > cfg.attn_chunk:
            o = attn_mod.sdpa_gqa_chunked(q, k, v, causal=True,
                                          chunk=cfg.attn_chunk)
        else:
            o = attn_mod.sdpa_gqa(q, k, v, causal=True)
        h = h + linear_apply(lp["attn"]["o"], o.reshape(b, s, -1))
        h = h + ffn_apply(lp, cfg, norm_apply(lp["ln2"], h, cfg.norm))[0]
        ks.append(k)
        vs.append(v)
    h = norm_apply(params["final_norm"], h[:, -1:], cfg.norm)
    return _unembed(params, cfg, h), {"k": torch.stack(ks), "v": torch.stack(vs)}


def prefill_chunk(params, cfg: ModelConfig, cache, tokens: torch.Tensor,
                  start, with_logits: bool = True):
    """Prefill one chunk of a prompt into a contiguous cache.

    tokens [B, C] sit at positions [start, start + C); the cache's rows <
    start hold the sequence's earlier chunks.  The cache may be a view of
    one slot's rows of a pool: the chunk's K/V are written through it in
    place.  Returns (logits [B, C, V], cache); ``with_logits=False`` skips
    the final norm and unembedding and returns (None, cache).
    """
    _check_attn(cfg, "prefill_chunk")
    h = _embed_tokens(params, cfg, tokens)
    k_news, v_news = [], []
    for l in range(cfg.n_layers):
        h, (kn, vn) = block_prefill_chunk(
            layer_params(params["layers"], l), cfg, h,
            (cache["k"][l], cache["v"][l]), start=start)
        k_news.append(kn)
        v_news.append(vn)
    attn_mod.cache_write(cache["k"], cache["v"], torch.stack(k_news),
                         torch.stack(v_news), start)
    if not with_logits:
        return None, cache
    h = norm_apply(params["final_norm"], h, cfg.norm)
    return _unembed(params, cfg, h), cache


def paged_decode_step(params, cfg: ModelConfig, cache, tokens: torch.Tensor,
                      pos: torch.Tensor, tables: torch.Tensor, page_size: int):
    """One decode step against a paged KV cache.

    tokens [B, 1]; pos [B] int32 per-slot lengths; tables [B, n_max] int32;
    ``cache`` leaves [L, P, page_size, KV, D] (P includes the trash page).
    Returns (logits [B, 1, V], cache).  The layers only read the cache; one
    scatter through the tables commits every layer's new K/V after the
    loop (inactive slots' rows land on the trash page).
    """
    h = _embed_tokens(params, cfg, tokens)
    b = tokens.shape[0]
    pos = pos.to(torch.int32)
    k_news, v_news = [], []
    for l in range(cfg.n_layers):
        h, (kn, vn) = block_paged_decode(
            layer_params(params["layers"], l), cfg, h,
            (cache["k"][l], cache["v"][l]), pos=pos, tables=tables,
            page_size=page_size)
        k_news.append(kn[:, 0])
        v_news.append(vn[:, 0])
    rows = attn_mod.page_rows(
        tables, torch.arange(b, dtype=torch.int32, device=tokens.device), pos,
        page_size)
    attn_mod.paged_cache_write(cache["k"], cache["v"], torch.stack(k_news),
                               torch.stack(v_news), rows)
    h = norm_apply(params["final_norm"], h, cfg.norm)
    return _unembed(params, cfg, h), cache


def prefill_packed(params, cfg: ModelConfig, cache, tokens: torch.Tensor,
                   slot_ids: torch.Tensor, positions: torch.Tensor,
                   tables: torch.Tensor, last_idx: torch.Tensor,
                   page_size: int):
    """Packed (padding-free) multi-prompt prefill into a paged cache.

    tokens/slot_ids/positions [T]: several prompts concatenated into one
    stream (``serve.kv_pages.pack_prompts``); tables [n_slots, n_max];
    last_idx [n_new] stream index of each prompt's last token.  Attention is
    block-diagonal causal over the stream, and only the ``n_new`` last rows
    pay the unembedding.  Returns (logits [n_new, 1, V], cache with every
    prompt's K/V written through its page table).
    """
    h = _embed_tokens(params, cfg, tokens[None, :])
    k_news, v_news = [], []
    for l in range(cfg.n_layers):
        h, (kn, vn) = block_prefill_packed(
            layer_params(params["layers"], l), cfg, h, seq_ids=slot_ids,
            positions=positions)
        k_news.append(kn[0])
        v_news.append(vn[0])
    rows = attn_mod.page_rows(tables, slot_ids, positions, page_size)
    attn_mod.paged_cache_write(cache["k"], cache["v"], torch.stack(k_news),
                               torch.stack(v_news), rows)
    h = norm_apply(params["final_norm"], h, cfg.norm)
    h_last = h[0, last_idx.long()]  # [n_new, d]
    return _unembed(params, cfg, h_last[:, None, :]), cache
