"""Whisper-style encoder-decoder (twin of ``repro/models/encdec.py``).

The conv frontend is a stub: the caller supplies frame embeddings [B,
S_enc, d_model].  The encoder is the ordinary attention block run
non-causally; each decoder block adds cross-attention over K/V made from
the encoder output.  Both stacks add fixed sinusoidal positions (no RoPE),
and the decoder's unembedding is tied to its embedding.

The stacks are Python loops over the stacked layers where the JAX package
scans.  Attention runs where the JAX package runs it: the encoder's and
the scoring decoder's self-attention through ``attn_apply`` (the flash
kernel under ``attn_impl="pallas"``), the prefill's self-attention through
``sdpa_gqa`` or its chunked form (never flash), and cross-attention
through plain ``sdpa_gqa``.

The serving cache is ``{"k", "v"}`` of [L, B, S_max, KV, D] (the decoder's
self-attention) and ``{"xk", "xv"}`` of [L, B, S_enc, KV, D] (the cross
K/V, made once by the prefill).  The decode step writes its new K/V into
``k``/``v`` in place and only reads ``xk``/``xv``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch._compat import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.sparse_linear import linear_apply
from repro_torch.models import attention as attn_mod
from repro_torch.models.blocks import (block_apply, block_init, layer_params,
                                       stack_layers)
from repro_torch.models.common import (embed_init, embed_lookup, norm_apply,
                                       norm_init, sinusoidal_on)
from repro_torch.models.lm import next_token_nll
from repro_torch.models.mlp import mlp_apply, mlp_init


def _dec_block_init(generator: torch.Generator, cfg: ModelConfig, device):
    dtype = getattr(torch, cfg.param_dtype)
    return {
        "ln1": norm_init(cfg.d_model, cfg.norm, dtype, device),
        "self_attn": attn_mod.attn_init(generator, cfg, device),
        "ln_x": norm_init(cfg.d_model, cfg.norm, dtype, device),
        "cross_attn": attn_mod.attn_init(generator, cfg, device),
        "ln2": norm_init(cfg.d_model, cfg.norm, dtype, device),
        "mlp": mlp_init(generator, cfg, device),
    }


def encdec_init(cfg: ModelConfig, seed: int, device=None) -> Dict[str, Any]:
    """Random params from ``seed`` on ``device`` (``None``: the CUDA card),
    drawn from a CPU generator.  The JAX package's tree: ``"dec_embed"``
    [padded_vocab, d], ``"enc_layers"`` (the ordinary block, stacked
    [encoder_layers, ...]), ``"dec_layers"`` (``ln1``, ``self_attn``,
    ``ln_x``, ``cross_attn``, ``ln2``, ``mlp``, stacked [n_layers, ...]),
    ``"enc_norm"`` and ``"dec_norm"``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    dtype = getattr(torch, cfg.param_dtype)
    return {
        "dec_embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype, dev),
        "enc_layers": stack_layers([block_init(gen, cfg, dev)
                                    for _ in range(cfg.encoder_layers)]),
        "dec_layers": stack_layers([_dec_block_init(gen, cfg, dev)
                                    for _ in range(cfg.n_layers)]),
        "enc_norm": norm_init(cfg.d_model, cfg.norm, dtype, dev),
        "dec_norm": norm_init(cfg.d_model, cfg.norm, dtype, dev),
    }


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None, :].expand(b, s)


def encode(params, cfg: ModelConfig, enc_embeds) -> torch.Tensor:
    """enc_embeds [B, S_enc, d] (the stub frontend's output; a tensor or a
    numpy array, moved to the params' device) -> the encoder states [B,
    S_enc, d]: sinusoidal positions added, then every encoder block with
    non-causal self-attention, then the final norm."""
    dev = params["dec_embed"].device
    dt = getattr(torch, cfg.dtype)
    enc_embeds = torch.as_tensor(enc_embeds, device=dev)
    b, s, d = enc_embeds.shape
    h = enc_embeds.to(dt) + sinusoidal_on(s, d, dev).to(dt)
    positions = _positions(b, s, dev)
    for l in range(cfg.encoder_layers):
        h, _ = block_apply(layer_params(params["enc_layers"], l), cfg, h,
                           positions=positions, causal=False)
    return norm_apply(params["enc_norm"], h, cfg.norm)


def _dec_block_apply(lp, cfg: ModelConfig, h, positions, enc_out,
                     causal=True):
    x = norm_apply(lp["ln1"], h, cfg.norm)
    h = h + attn_mod.attn_apply(lp["self_attn"], cfg, x, positions=positions,
                                causal=causal)
    x = norm_apply(lp["ln_x"], h, cfg.norm)
    kv = attn_mod.cross_kv(lp["cross_attn"], cfg, enc_out)
    h = h + attn_mod.cross_attn_apply(lp["cross_attn"], cfg, x, kv)
    x = norm_apply(lp["ln2"], h, cfg.norm)
    return h + mlp_apply(lp["mlp"], cfg, x)


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor, pos_rows):
    """Token embeddings [B, S, d] plus the sinusoidal rows ``pos_rows`` [S,
    d] (or [1, d])."""
    h = embed_lookup(params["dec_embed"], tokens).to(getattr(torch, cfg.dtype))
    return h + pos_rows[None].to(h.dtype)


def _unembed(params, h: torch.Tensor) -> torch.Tensor:
    """Logits by the decoder's (tied) embedding table."""
    return torch.matmul(h, params["dec_embed"].to(h.dtype).T)


def decode_forward(params, cfg: ModelConfig, tokens,
                   enc_out: torch.Tensor) -> torch.Tensor:
    """The scoring decoder: tokens [B, S] against the encoder states ->
    logits [B, S, padded_vocab], causal self-attention in every block."""
    tokens = torch.as_tensor(tokens, device=params["dec_embed"].device)
    b, s = tokens.shape
    h = _embed(params, cfg, tokens,
               sinusoidal_on(s, cfg.d_model, tokens.device))
    positions = _positions(b, s, tokens.device)
    for l in range(cfg.n_layers):
        h = _dec_block_apply(layer_params(params["dec_layers"], l), cfg, h,
                             positions, enc_out)
    h = norm_apply(params["dec_norm"], h, cfg.norm)
    return _unembed(params, h)


def encdec_loss(params, cfg: ModelConfig, batch):
    """Next-token cross-entropy of ``batch["tokens"]`` given
    ``batch["enc_embeds"]`` (``lm.next_token_nll``).  There is no
    auxiliary loss: returns (nll, {"nll", "aux"}) with aux zero."""
    enc_out = encode(params, cfg, batch["enc_embeds"])
    logits = decode_forward(params, cfg, batch["tokens"], enc_out)
    nll = next_token_nll(cfg, logits, batch["tokens"])
    return nll, {"nll": nll,
                 "aux": torch.zeros((), dtype=torch.float32, device=nll.device)}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def encdec_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                      enc_len: int, device=None):
    """``{"k", "v"}`` [L, B, max_len, KV, D] and ``{"xk", "xv"}`` [L, B,
    enc_len, KV, D] of zeros on ``device`` (``None``: the CUDA card)."""
    dtype = getattr(torch, cfg.dtype)
    dev = resolve_device(device)
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim

    def zeros(rows):
        return torch.zeros((cfg.n_layers, batch, rows, kv, hd), dtype=dtype,
                           device=dev)

    return {"k": zeros(max_len), "v": zeros(max_len),
            "xk": zeros(enc_len), "xv": zeros(enc_len)}


def encdec_prefill(params, cfg: ModelConfig, enc_embeds, tokens: torch.Tensor):
    """The encoder forward and the decoder's prefill of prompts tokens [B,
    S].  Returns (last-token logits [B, 1, V], cache): the prompt's self
    K/V [L, B, S, KV, D] and the cross K/V [L, B, S_enc, KV, D] of the
    encoder output."""
    enc_out = encode(params, cfg, enc_embeds)
    b, s = tokens.shape
    h = _embed(params, cfg, tokens,
               sinusoidal_on(s, cfg.d_model, tokens.device))
    positions = _positions(b, s, tokens.device)
    ks, vs, xks, xvs = [], [], [], []
    for l in range(cfg.n_layers):
        lp = layer_params(params["dec_layers"], l)
        x = norm_apply(lp["ln1"], h, cfg.norm)
        q, k, v = attn_mod._qkv(lp["self_attn"], cfg, x, positions)
        if cfg.attn_impl == "chunked" and s > cfg.attn_chunk:
            o = attn_mod.sdpa_gqa_chunked(q, k, v, causal=True,
                                          chunk=cfg.attn_chunk)
        else:
            o = attn_mod.sdpa_gqa(q, k, v, causal=True)
        h = h + linear_apply(lp["self_attn"]["o"], o.reshape(b, s, -1))
        x = norm_apply(lp["ln_x"], h, cfg.norm)
        xk, xv = attn_mod.cross_kv(lp["cross_attn"], cfg, enc_out)
        h = h + attn_mod.cross_attn_apply(lp["cross_attn"], cfg, x, (xk, xv))
        h = h + mlp_apply(lp["mlp"], cfg, norm_apply(lp["ln2"], h, cfg.norm))
        for out, t in ((ks, k), (vs, v), (xks, xk), (xvs, xv)):
            out.append(t)
    h = norm_apply(params["dec_norm"], h[:, -1:], cfg.norm)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs),
             "xk": torch.stack(xks), "xv": torch.stack(xvs)}
    return _unembed(params, h), cache


def encdec_decode_step(params, cfg: ModelConfig, cache, tokens: torch.Tensor,
                       pos):
    """One decoder token: tokens [B, 1] at the scalar position ``pos``
    (every sequence at one length, as ``generate`` runs them) against the
    self K/V cache and the prefill's cross K/V.  The position's sinusoidal
    row comes from a table of the cache's S_max rows (``pos`` clamped into
    it, as JAX's dynamic slice clamps).  Returns (logits [B, 1, V], cache
    with the new K/V written in place)."""
    dev = tokens.device
    pos_t = torch.as_tensor(pos, device=dev).reshape(-1).long()
    if pos_t.numel() != 1:
        raise ValueError(f"encdec_decode_step takes a scalar pos, got "
                         f"{tuple(pos_t.shape)}")
    smax = cache["k"].shape[2]
    row = sinusoidal_on(smax, cfg.d_model, dev).index_select(
        0, pos_t.clamp(0, smax - 1))
    h = _embed(params, cfg, tokens, row)
    k_news, v_news = [], []
    for l in range(cfg.n_layers):
        lp = layer_params(params["dec_layers"], l)
        x = norm_apply(lp["ln1"], h, cfg.norm)
        a, (kn, vn) = attn_mod.attn_decode(
            lp["self_attn"], cfg, x, (cache["k"][l], cache["v"][l]), pos=pos)
        h = h + a
        x = norm_apply(lp["ln_x"], h, cfg.norm)
        h = h + attn_mod.cross_attn_apply(lp["cross_attn"], cfg, x,
                                          (cache["xk"][l], cache["xv"][l]))
        h = h + mlp_apply(lp["mlp"], cfg, norm_apply(lp["ln2"], h, cfg.norm))
        k_news.append(kn)
        v_news.append(vn)
    h = norm_apply(params["dec_norm"], h, cfg.norm)
    attn_mod.cache_write(cache["k"], cache["v"], torch.stack(k_news),
                         torch.stack(v_news), pos)
    return _unembed(params, h), cache
