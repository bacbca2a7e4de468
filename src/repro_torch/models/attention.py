"""GQA attention (twin of ``repro/models/attention.py``): the QKV/O
projections with RoPE or Qwen2-VL's M-RoPE; full self-attention for the
scoring forward (``attn_apply``: naive, chunked online-softmax, or the flash
kernel under ``attn_impl="pallas"``); chunked prefill and one-token decode
against a contiguous KV cache (plain PyTorch, as the JAX package leaves
them to XLA); packed multi-prompt prefill over one padding-free token
stream; one-token decode against a paged KV cache through the
paged-attention kernel; and Whisper's cross-attention over K/V made once
from the encoder output.

GQA runs grouped (q reshaped [B, S, KV, G, D]) so the KV tensors are never
expanded to H heads; only H % KV != 0 takes the head-mapped expansion.

The contiguous cache is ``{"k", "v"}`` of ``[L, B, S_max, KV, D]``, the
paged one of ``[L, n_pages + 1, page_size, KV, D]``.  The port writes the
step's new K/V into either in place (the JAX package returns a new cache
and donates the old one): the engine or the scheduler owns the cache alone,
so nothing else holds the old value.

On laid-out params (``sharding.layout_scope``; the twin of JAX's ``shd``
of q, k and v over ``act_heads``/``act_kv_heads``) a rank computes its
``padded_heads / tp`` q heads (:func:`_heads`).  Where the model axis
divides the KV heads it computes and caches its own KV heads, which are
the ones its q heads read; else k/v split inside a head, so they are
gathered whole over the model axis, cached whole, and each q head reads
its KV head by JAX's map ``(h * KV) // H`` (:func:`_rank_kv`).
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch._compat import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.sparse_linear import linear_apply, linear_init, unbox
from repro_torch.models.common import apply_rope, mrope_cos_sin, rope_cos_sin
from repro_torch.sharding.api import all_gather, current_layout

NEG = -1e30


def attn_init(generator: torch.Generator, cfg: ModelConfig, device=None):
    """QKV/O projections, each a (possibly compressed) linear layer; o is
    reduce-oriented.  A dense o zeroes the padded heads' rows, so padding
    changes nothing."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.padded_heads, cfg.n_kv_heads
    scfg = cfg.sparsity
    opts = dict(dtype=getattr(torch, cfg.param_dtype), device=device)
    p = {
        "q": linear_init(generator, d, h * hd, scfg, use_bias=cfg.qkv_bias,
                         in_ax="embed", out_ax="heads_flat", **opts),
        "k": linear_init(generator, d, kv * hd, scfg, use_bias=cfg.qkv_bias,
                         in_ax="embed", out_ax="kv_flat", **opts),
        "v": linear_init(generator, d, kv * hd, scfg, use_bias=cfg.qkv_bias,
                         in_ax="embed", out_ax="kv_flat", **opts),
        "o": linear_init(generator, h * hd, d, scfg, in_ax="heads_flat",
                         out_ax="embed", mode="reduce", **opts),
    }
    if cfg.n_heads != cfg.padded_heads and "w" in p["o"]:
        w = unbox(p["o"]["w"]).reshape(h, hd, d)
        w[cfg.n_heads:] = 0.0
    return p


def _heads(cfg: ModelConfig) -> Tuple[int, int]:
    """(q heads, KV heads) this rank computes: ``(padded_heads,
    n_kv_heads)``, or on laid-out params its ``padded_heads / tp`` q heads
    and its ``KV / tp`` KV heads where the model axis divides them, else
    every KV head."""
    h, kv = cfg.padded_heads, cfg.n_kv_heads
    lay = current_layout()
    if lay is None or lay.tp == 1:
        return h, kv
    return h // lay.tp, (kv // lay.tp if kv % lay.tp == 0 else kv)


def _kv_whole(k: torch.Tensor, v: torch.Tensor, kv: int, hd: int):
    """The k and v projections' columns as the cache holds them: where the
    model axis split them inside a head, gathered whole over it (one
    all-gather for both)."""
    if k.shape[-1] == kv * hd:
        return k, v
    # each rank's q heads read the whole k and v in part
    both = all_gather(torch.stack([k, v]), -1, "model", current_layout().mesh,
                      cotangent="partial")
    return both[0], both[1]


@functools.lru_cache(maxsize=None)
def _rank_kv_map(h: int, kv: int, tp: int, rank: int,
                 device: torch.device) -> torch.Tensor:
    hl = h // tp
    return (torch.arange(rank * hl, (rank + 1) * hl, device=device) * kv) // h


def _rank_kv(cfg: ModelConfig, t: torch.Tensor) -> torch.Tensor:
    """K or V [B, S, KV', D] as this rank's q heads read it: as it is, or on
    laid-out params where the cache holds every KV head and the rank only
    some q heads, one KV head a q head by JAX's map ``(h * KV) // H``."""
    lay = current_layout()
    if lay is None or lay.tp == 1 or t.shape[2] != cfg.n_kv_heads:
        return t
    return t[:, :, _rank_kv_map(cfg.padded_heads, cfg.n_kv_heads, lay.tp,
                                lay.model_rank(), t.device)]


def _o_proj(params, cfg: ModelConfig, o: torch.Tensor) -> torch.Tensor:
    """The o projection of o [..., heads * D]: row parallel on laid-out
    params (the rank's heads in, the whole d_model out)."""
    return linear_apply(params["o"], o, split="rows",
                        d_in=cfg.padded_heads * cfg.resolved_head_dim)


def _qkv(params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
         mrope_positions: Optional[torch.Tensor] = None):
    """q [B, S, H, D], k/v [B, S, KV, D] of x [B, S, d], rotated by 1-D RoPE
    at ``positions`` [B, S], or by M-RoPE at ``mrope_positions`` [B, 3, S]
    where the config has M-RoPE and the caller passes them.  On laid-out
    params H and KV are the rank's (:func:`_heads`)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    h, kv = _heads(cfg)
    lay = current_layout()
    if lay is not None:
        # q, k and v feed only this rank's heads: their shared input's
        # gradient is summed over the model axis once
        x = lay.copy_to_model(x)
    q = linear_apply(params["q"], x, split="cols").reshape(b, s, h, hd)
    k, v = _kv_whole(linear_apply(params["k"], x, split="cols"),
                     linear_apply(params["v"], x, split="cols"), kv, hd)
    k, v = k.reshape(b, s, kv, hd), v.reshape(b, s, kv, hd)
    if cfg.use_rope:
        if cfg.mrope and mrope_positions is not None:
            cos, sin = mrope_cos_sin(mrope_positions, hd, cfg.rope_theta,
                                     cfg.mrope_sections)
        else:
            cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def _expand_kv(k: torch.Tensor, n_q_heads: int) -> torch.Tensor:
    """Head-mapped expansion [B, S, KV, D] -> [B, S, H, D] for H % KV != 0."""
    kvh = k.shape[2]
    if n_q_heads == kvh:
        return k
    mapping = (torch.arange(n_q_heads, device=k.device) * kvh) // n_q_heads
    return k[:, :, mapping]


def sdpa_gqa(q, k, v, *, causal: bool, q_offset=0,
             kv_len=None) -> torch.Tensor:
    """Scaled dot-product attention with native GQA grouping.

    q [B, Sq, H, D]; k/v [B, Sk, KV, D]; query i sits at position
    ``q_offset + i`` for the causal mask; ``kv_len`` [B] masks keys past
    each sequence's length.  Returns [B, Sq, H, D].
    """
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    if h % kvh != 0:
        k, v = _expand_kv(k, h), _expand_kv(v, h)
        kvh = h
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * scale
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + q_offset
        ki = torch.arange(sk, device=q.device)[None, :]
        scores = torch.where(ki <= qi, scores, NEG)
    if kv_len is not None:
        ki = torch.arange(sk, device=q.device).reshape(1, 1, 1, 1, sk)
        scores = torch.where(ki < kv_len.reshape(b, 1, 1, 1, 1), scores, NEG)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return o.reshape(b, sq, h, d)


def sdpa_gqa_chunked(q, k, v, *, causal: bool, q_offset=0, kv_len=None,
                     chunk: int = 512) -> torch.Tensor:
    """Blockwise attention: an online softmax over KV chunks of ``chunk``
    keys, so the [Sq, Sk] scores never materialise.  Plain PyTorch, as
    the JAX package leaves it to XLA; each chunk's K/V is expanded to the H
    heads.  Same arguments and result as :func:`sdpa_gqa`.
    """
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    chunk = min(chunk, sk)
    n_chunks = -(-sk // chunk)
    pad = n_chunks * chunk - sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    mapping = ((torch.arange(h, device=q.device) * kvh) // h
               if h % kvh else None)
    qi = torch.arange(sq, device=q.device)[:, None] + q_offset  # [Sq, 1]
    m = torch.full((b, h, sq), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    for ci in range(n_chunks):
        kx = k[:, ci * chunk:(ci + 1) * chunk]
        vx = v[:, ci * chunk:(ci + 1) * chunk]
        if mapping is not None:
            kx, vx = kx[:, :, mapping], vx[:, :, mapping]
        elif h != kvh:
            kx = kx.repeat_interleave(h // kvh, dim=2)
            vx = vx.repeat_interleave(h // kvh, dim=2)
        s = torch.einsum("bqhd,bchd->bhqc", q, kx).float() * scale
        kpos = ci * chunk + torch.arange(chunk, device=q.device)[None, :]
        valid = (kpos <= qi) if causal else torch.ones(
            (sq, chunk), dtype=torch.bool, device=q.device)
        valid = valid & (kpos < sk)
        if kv_len is not None:
            valid = valid[None] & (kpos[None] < kv_len[:, None, None])
            s = torch.where(valid[:, None], s, NEG)
        else:
            s = torch.where(valid[None, None], s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])  # [B, H, Sq, chunk] f32
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        pv = torch.einsum("bhqc,bchd->bqhd", p.to(vx.dtype), vx).float()
        acc = acc * alpha.transpose(1, 2)[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def attn_apply(params, cfg: ModelConfig, x: torch.Tensor, *,
               positions: torch.Tensor, causal: bool = True,
               mrope_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full self-attention over x [B, S, d] (the scoring forward, and
    Whisper's non-causal encoder).

    ``cfg.attn_impl`` picks the attention as the JAX package does: "pallas"
    runs the flash kernel (its plain version for a CPU tensor), "chunked"
    the online-softmax :func:`sdpa_gqa_chunked` when S > ``attn_chunk``,
    and anything else :func:`sdpa_gqa`.  Returns [B, S, d].
    """
    b, s, _ = x.shape
    q, k, v = _qkv(params, cfg, x, positions, mrope_positions)
    k, v = _rank_kv(cfg, k), _rank_kv(cfg, v)
    if cfg.attn_impl == "pallas":
        from repro_torch.kernels.flash_attn import flash_attention

        o = flash_attention(q, k, v, causal=causal)
    elif cfg.attn_impl == "chunked" and s > cfg.attn_chunk:
        o = sdpa_gqa_chunked(q, k, v, causal=causal, chunk=cfg.attn_chunk)
    else:
        o = sdpa_gqa(q, k, v, causal=causal)
    return _o_proj(params, cfg, o.reshape(b, s, -1))


# ---------------------------------------------------------------------------
# Cross attention (the Whisper decoder)
# ---------------------------------------------------------------------------


def cross_attn_apply(params, cfg: ModelConfig, x: torch.Tensor,
                     enc_kv) -> torch.Tensor:
    """x [B, Sq, d] against enc_kv = (k, v) [B, S_enc, KV, D] made by
    :func:`cross_kv` (no RoPE): plain non-causal :func:`sdpa_gqa` under
    every ``attn_impl``, as in the JAX package.  Returns [B, Sq, d]."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = linear_apply(params["q"], x).reshape(b, s, cfg.padded_heads, hd)
    k, v = enc_kv
    o = sdpa_gqa(q, k, v, causal=False).reshape(b, s, -1)
    return linear_apply(params["o"], o)


def cross_kv(params, cfg: ModelConfig, enc_out: torch.Tensor):
    """The cross-attention's (k, v) [B, S_enc, KV, D] of the encoder output
    [B, S_enc, d]."""
    b, s, _ = enc_out.shape
    hd = cfg.resolved_head_dim
    k = linear_apply(params["k"], enc_out).reshape(b, s, cfg.n_kv_heads, hd)
    v = linear_apply(params["v"], enc_out).reshape(b, s, cfg.n_kv_heads, hd)
    return k, v


def _cached_attention(q, k_new, v_new, kc, vc, *, limit: torch.Tensor,
                      causal: bool) -> torch.Tensor:
    """softmax over (cache rows < limit[b]) ++ this step's new keys.

    q [B, C, H, D]; k_new/v_new [B, C, KV, D]; kc/vc [B, S_max, KV, D];
    limit [B] int32.  ``causal`` masks the new keys within the chunk (j <=
    i); cache rows >= limit may hold junk and are always masked.  Returns
    o [B, C, H, D].
    """
    b, c_len, h, d = q.shape
    kvh, s_max = kc.shape[2], kc.shape[1]
    scale = 1.0 / math.sqrt(d)
    qi = torch.arange(c_len, device=q.device)
    ki = torch.arange(s_max, device=q.device)
    cache_ok = ki[None, :] < limit.to(q.device)[:, None]  # [B, S_max]
    new_ok = ((qi[None, :] <= qi[:, None]) if causal and c_len > 1
              else torch.ones((c_len, c_len), dtype=torch.bool,
                              device=q.device))  # [Cq, Ck]

    if h % kvh == 0:
        g = h // kvh
        qg = q.reshape(b, c_len, kvh, g, d)
        s_c = torch.einsum("bqkgd,bskd->bkgqs", qg, kc.to(q.dtype)).float() * scale
        s_c = torch.where(cache_ok[:, None, None, None, :], s_c, NEG)
        s_n = torch.einsum("bqkgd,bskd->bkgqs", qg,
                           k_new.to(q.dtype)).float() * scale
        s_n = torch.where(new_ok, s_n, NEG)
        w = torch.softmax(torch.cat([s_c, s_n], dim=-1), dim=-1).to(q.dtype)
        o = torch.einsum("bkgqs,bskd->bqkgd", w[..., :s_max], vc.to(q.dtype))
        o = o + torch.einsum("bkgqs,bskd->bqkgd", w[..., s_max:],
                             v_new.to(q.dtype))
        return o.reshape(b, c_len, h, d)

    kx, vx = _expand_kv(kc, h).to(q.dtype), _expand_kv(vc, h).to(q.dtype)
    kn, vn = _expand_kv(k_new, h).to(q.dtype), _expand_kv(v_new, h).to(q.dtype)
    s_c = torch.einsum("bqhd,bshd->bhqs", q, kx).float() * scale
    s_c = torch.where(cache_ok[:, None, None, :], s_c, NEG)
    s_n = torch.einsum("bqhd,bshd->bhqs", q, kn).float() * scale
    s_n = torch.where(new_ok, s_n, NEG)
    w = torch.softmax(torch.cat([s_c, s_n], dim=-1), dim=-1).to(q.dtype)
    o = torch.einsum("bhqs,bshd->bqhd", w[..., :s_max], vx)
    return o + torch.einsum("bhqs,bshd->bqhd", w[..., s_max:], vn)


# ---------------------------------------------------------------------------
# Contiguous KV cache
# ---------------------------------------------------------------------------


def cache_init(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
               dtype, device=None):
    """Contiguous decode cache, [L, B, max_len, KV, D] per leaf, on
    ``device`` (``None``: the CUDA card).  The laid-out cache is
    ``registry.cache_init_fn``'s with a mesh."""
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (n_layers, batch, max_len, kv, hd)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _pos_vector(pos, b: int, device) -> torch.Tensor:
    """A scalar or [B] position (int, numpy or tensor) as a [B] int32
    tensor on ``device``."""
    pos = torch.as_tensor(pos, dtype=torch.int32).to(device)
    return pos.reshape(-1).expand(b)


def attn_decode(params, cfg: ModelConfig, x: torch.Tensor,
                layer_cache: Tuple[torch.Tensor, torch.Tensor], *, pos,
                mrope_positions: Optional[torch.Tensor] = None):
    """One-token decode against a contiguous cache it only reads.

    x [B, 1, d]; layer_cache (k, v) [B, S_max, KV, D]; pos a scalar or a
    per-sequence [B] vector (each slot at its own length); an M-RoPE
    model's ``mrope_positions`` [B, 3, 1].  Attention is the softmax over
    (cache rows < pos) ++ the new token.  Returns (out, (k_new [B, 1, KV,
    D], v_new)): the caller writes the new K/V with one :func:`cache_write`
    after the layer loop.
    """
    b = x.shape[0]
    pos_b = _pos_vector(pos, b, x.device)
    q, k_new, v_new = _qkv(params, cfg, x, pos_b[:, None], mrope_positions)
    kc, vc = layer_cache
    o = _cached_attention(q, _rank_kv(cfg, k_new), _rank_kv(cfg, v_new),
                          _rank_kv(cfg, kc), _rank_kv(cfg, vc), limit=pos_b,
                          causal=False)
    return _o_proj(params, cfg, o.reshape(b, 1, -1)), (k_new, v_new)


def attn_prefill_chunk(params, cfg: ModelConfig, x: torch.Tensor,
                       layer_cache: Tuple[torch.Tensor, torch.Tensor], *,
                       start, mrope_positions: Optional[torch.Tensor] = None):
    """Chunked prefill through one layer against a contiguous cache.

    x [B, C, d] holds the tokens at positions [start, start + C); the
    cache's rows < start hold the sequence's earlier chunks; an M-RoPE
    model's ``mrope_positions`` are [B, 3, C].  Attention is the softmax
    over (cache rows < start) ++ the chunk, causal within it.  Returns
    (out, (k_chunk [B, C, KV, D], v_chunk)); the caller writes them with
    one :func:`cache_write` after the layer loop.
    """
    b, c_len = x.shape[:2]
    start_b = _pos_vector(start, b, x.device)
    positions = start_b[:, None] + torch.arange(
        c_len, dtype=torch.int32, device=x.device)[None, :]
    q, k_new, v_new = _qkv(params, cfg, x, positions, mrope_positions)
    kc, vc = layer_cache
    o = _cached_attention(q, k_new, v_new, kc, vc, limit=start_b, causal=True)
    return linear_apply(params["o"], o.reshape(b, c_len, -1)), (k_new, v_new)


def cache_write(cache_k, cache_v, k_news, v_news, pos):
    """Write the step's new K/V into the stacked cache, in place.

    cache_* [L, B, S, KV, D]; *_news [L, B, C, KV, D] (C = 1 for decode,
    the chunk width for chunked prefill).  ``pos`` is the scalar row where
    every sequence's write starts, or a per-sequence [B] vector.  The start
    is taken as ``jax.lax.dynamic_update_slice`` takes it: a negative one
    counts from the end, then it clamps to [0, S - C], so an idle slot
    parked at its last row writes in bounds.  The cache may be
    a view (one slot's rows of a pool): only rows [start, start + C) of
    each sequence change.  Returns the two caches.
    """
    _, b, s, _, _ = cache_k.shape
    c_len = k_news.shape[2]
    dev = cache_k.device
    start = _pos_vector(pos, b, dev).long()
    start = torch.where(start < 0, start + s, start).clamp(0, s - c_len)
    rows = start[:, None] + torch.arange(c_len, device=dev)[None, :]  # [B, C]
    seqs = torch.arange(b, device=dev)[:, None]
    cache_k[:, seqs, rows] = k_news.to(cache_k.dtype)
    cache_v[:, seqs, rows] = v_news.to(cache_v.dtype)
    return cache_k, cache_v


# ---------------------------------------------------------------------------
# Paged KV cache
# ---------------------------------------------------------------------------


def paged_cache_init(cfg: ModelConfig, n_pages: int, page_size: int,
                     n_layers: int, dtype, device=None):
    """Physical paged cache, [L, n_pages + 1, page_size, KV, D] per leaf.

    The extra page at index ``n_pages`` is the trash page: padded table
    entries name it, so inactive slots write there.  Its rows are junk and
    every read masks them by the sequence's length.
    """
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (n_layers, n_pages + 1, page_size, kv, hd)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def page_rows(tables: torch.Tensor, seq_idx: torch.Tensor, pos: torch.Tensor,
              page_size: int) -> torch.Tensor:
    """Flat physical row of each (sequence, position) pair.

    tables [n_slots, n_max] int32; seq_idx [N] slot of each token; pos [N]
    logical position.  Returns [N] int32 rows of the ``[P * page_size]``-row
    flattened cache.
    """
    pos = pos.to(torch.int32)
    page_id = tables[seq_idx.long(), (pos // page_size).long()]
    return page_id * page_size + pos % page_size


def paged_cache_write(cache_k, cache_v, k_news, v_news, rows):
    """Scatter the step's new K/V through page-table rows, in place.

    cache_* [L, P, page_size, KV, D]; *_news [L, N, KV, D]; rows [N] (from
    :func:`page_rows`).  Inactive slots' rows all name the trash page; which
    of their duplicate writes lands there does not matter, as those rows are
    never read.  Returns the two caches.
    """
    l, p, ps, kv, hd = cache_k.shape
    r = rows.long()
    cache_k.view(l, p * ps, kv, hd)[:, r] = k_news.to(cache_k.dtype)
    cache_v.view(l, p * ps, kv, hd)[:, r] = v_news.to(cache_v.dtype)
    return cache_k, cache_v


def paged_attn_decode(params, cfg: ModelConfig, x: torch.Tensor,
                      layer_cache: Tuple[torch.Tensor, torch.Tensor], *,
                      pos: torch.Tensor, tables: torch.Tensor,
                      page_size: int):
    """One-token decode against a paged cache it only reads.

    x [B, 1, d]; layer_cache (k_pages, v_pages) [P, page_size, KV, D]; pos
    [B] int32 per-slot lengths; tables [B, n_max] int32.  Returns (out,
    (k_new, v_new)): the caller scatters the new K/V through the tables
    once, after the layer loop.
    """
    from repro_torch.kernels.flash_attn import paged_attention

    b = x.shape[0]
    q, k_new, v_new = _qkv(params, cfg, x, pos[:, None])
    kc, vc = layer_cache
    o = paged_attention(q, k_new, v_new, kc, vc, tables, pos,
                        page_size=page_size)
    return linear_apply(params["o"], o.reshape(b, 1, -1)), (k_new, v_new)


def packed_sdpa(q, k, v, *, seq_ids: torch.Tensor) -> torch.Tensor:
    """Block-diagonal causal attention over one packed token stream.

    q [1, T, H, D]; k/v [1, T, KV, D]; seq_ids [T]: token t attends token s
    iff they share a sequence and s <= t (prompts are contiguous in the
    stream with rising positions, so stream order is causal order).
    """
    b, t, h, d = q.shape
    kvh = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    ar = torch.arange(t, device=q.device)
    mask = (seq_ids[:, None] == seq_ids[None, :]) & (ar[None, :] <= ar[:, None])
    if h % kvh == 0:
        g = h // kvh
        qg = q.reshape(b, t, kvh, g, d)
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(q.dtype)).float() * scale
        s = torch.where(mask, s, NEG)
        w = torch.softmax(s, dim=-1).to(q.dtype)
        o = torch.einsum("bkgqs,bskd->bqkgd", w, v.to(q.dtype))
        return o.reshape(b, t, h, d)
    kx, vx = _expand_kv(k, h).to(q.dtype), _expand_kv(v, h).to(q.dtype)
    s = torch.einsum("bqhd,bshd->bhqs", q, kx).float() * scale
    s = torch.where(mask, s, NEG)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshd->bqhd", w, vx)


def attn_prefill_packed(params, cfg: ModelConfig, x: torch.Tensor, *,
                        seq_ids: torch.Tensor, positions: torch.Tensor):
    """Packed multi-prompt prefill through one layer (no cache read).

    x [1, T, d] is the concatenated stream; seq_ids/positions [T].  Returns
    (out [1, T, d], (k [1, T, KV, D], v)): the caller scatters every layer's
    K/V through the page tables after the layer loop.
    """
    q, k_new, v_new = _qkv(params, cfg, x, positions[None, :])
    o = packed_sdpa(q, k_new, v_new, seq_ids=seq_ids)
    return linear_apply(params["o"], o.reshape(1, x.shape[1], -1)), (k_new, v_new)
