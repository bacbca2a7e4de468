"""The decoder-only LMs (twin of ``repro/models/lm.py``), one init/apply
pair for every block pattern:

  - ``"attn"``: dense, mixture-of-experts and VLM transformers, a loop over
    the stacked blocks (a VLM scatters the caller's vision embeddings over
    the token embeddings and rotates by M-RoPE where the batch carries its
    3-D positions);
  - ``"xlstm"``: superblocks of ``slstm_every - 1`` mLSTM blocks followed
    by one sLSTM block;
  - ``"mamba_shared_attn"`` (Zamba2): superblocks of ``shared_attn_every``
    Mamba2 blocks, each followed by one application of the *shared*
    attention block (one set of weights, one KV cache per application),
    and a tail of Mamba2 blocks where the superblocks do not divide the
    layers.

Init; the scoring forward (``lm_forward``) and its next-token loss
(``loss_fn``); and the serving steps: prefill and one decode step against
a contiguous cache (every pattern), and, for the attention pattern only as
in the JAX package, chunked prefill, packed prefill and one decode step
against a paged cache.  The serving steps of an M-RoPE model rotate text
positions: its three components equal the 1-D position (the contiguous
steps, as in the JAX package) or are not passed at all (the paged ones,
which run 1-D RoPE: the same bits).  The encoder-decoder family lives in
``encdec.py``.

No step moves a tensor to the host: the caller reads only the logits it
samples from.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch._compat import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.sparse_linear import box
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.blocks import (
    block_apply,
    block_decode,
    block_init,
    block_paged_decode,
    block_prefill_chunk,
    block_prefill_packed,
    ffn_apply,
    layer_params,
    shared_block_apply,
    shared_block_decode,
    shared_block_init,
    stack_layers,
)
from repro_torch.models.common import embed_init, embed_lookup, norm_apply, norm_init
from repro_torch.sharding.api import all_gather, current_layout, gather_leaf

PATTERNS = ("attn", "xlstm", "mamba_shared_attn")


def _check_supported(cfg: ModelConfig) -> None:
    """Refuse a block pattern no family has."""
    if cfg.block_pattern not in PATTERNS:
        raise ValueError(f"unknown block_pattern {cfg.block_pattern!r}")


def _n_super(cfg: ModelConfig):
    """(superblocks, blocks a superblock, tail blocks) of a recurrent
    pattern."""
    every = (cfg.slstm_every if cfg.block_pattern == "xlstm"
             else cfg.shared_attn_every)
    n_super = cfg.n_layers // every
    return n_super, every, cfg.n_layers - n_super * every


def n_shared_applications(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.shared_attn_every


def _stacked(make, n: int, m=None):
    """``make()``'s trees stacked [n, ...], or [n, m, ...]."""
    if m is None:
        return stack_layers([make() for _ in range(n)])
    return stack_layers([stack_layers([make() for _ in range(m)])
                         for _ in range(n)])


def lm_init(cfg: ModelConfig, seed: int, device=None) -> Dict[str, Any]:
    """Random params from ``seed`` on ``device`` (``None``: the CUDA card),
    drawn from a CPU generator so they do not depend on the device.  The
    tree is the JAX package's: ``{"embed", "final_norm"}``, ``"unembed"``
    [d_model, padded_vocab] where the embeddings are untied, and the
    pattern's blocks: ``"layers"`` stacked [L, ...]; ``"mlstm"`` [n_super,
    every - 1, ...] and ``"slstm"`` [n_super, ...]; or ``"mamba"``
    [n_super, every, ...], ``"mamba_tail"`` [rem, ...] where the
    superblocks leave ``rem`` layers, and one ``"shared"`` block."""
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
        p["unembed"] = box(u.to(dev, dtype), ("embed", "vocab"))
    pat = cfg.block_pattern
    if pat == "attn":
        p["layers"] = _stacked(lambda: block_init(gen, cfg, dev), cfg.n_layers)
    elif pat == "xlstm":
        n_super, every, rem = _n_super(cfg)
        if rem:
            raise ValueError(f"{cfg.name}: xlstm needs n_layers % "
                             f"slstm_every == 0, got {cfg.n_layers} % {every}")
        p["mlstm"] = _stacked(lambda: xlstm_mod.mlstm_init(gen, cfg, dev),
                              n_super, every - 1)
        p["slstm"] = _stacked(lambda: xlstm_mod.slstm_init(gen, cfg, dev),
                              n_super)
    else:
        n_super, every, rem = _n_super(cfg)
        p["mamba"] = _stacked(lambda: ssm_mod.mamba_init(gen, cfg, dev),
                              n_super, every)
        if rem:
            p["mamba_tail"] = _stacked(
                lambda: ssm_mod.mamba_init(gen, cfg, dev), rem)
        p["shared"] = shared_block_init(gen, cfg, dev)
    return p


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return embed_lookup(params["embed"], tokens).to(getattr(torch, cfg.dtype))


def _embed_tokens(params, cfg: ModelConfig, batch) -> torch.Tensor:
    """The batch's token embeddings [B, S, d]; a VLM's batch may carry
    ``vision_embeds`` [B, P, d], written (in the activation dtype, not
    added) over the embeddings at ``vision_pos`` [B, P]."""
    h = _embed(params, cfg, batch["tokens"])
    if cfg.family == "vlm" and "vision_embeds" in batch:
        dev = h.device
        ve = torch.as_tensor(batch["vision_embeds"], device=dev).to(h.dtype)
        cols = torch.as_tensor(batch["vision_pos"], device=dev).long()
        rows = torch.arange(h.shape[0], device=dev)[:, None].expand_as(cols)
        h = h.index_put((rows, cols), ve)
    return h


def _unembed(params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """h [B, S, d] -> logits [B, S, padded_vocab]: by the embedding table
    where the embeddings are tied, else by ``unembed``.  A laid-out table
    is gathered over the data axis and gives the rank's vocab columns."""
    _check_supported(cfg)
    if cfg.tie_embeddings:
        table = gather_leaf(params["embed"], keep=("model",))
        return torch.matmul(h, table.to(h.dtype).T)
    return torch.matmul(h, gather_leaf(params["unembed"],
                                       keep=("model",)).to(h.dtype))


def _whole_vocab(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Logits of the rank's vocab columns gathered whole over the model
    axis (exact: a gather, no arithmetic); whole logits as they are."""
    if logits.shape[-1] == cfg.padded_vocab:
        return logits
    return all_gather(logits, -1, "model", current_layout().mesh)


# The outputs "dots" keeps: those of the matrix products.  JAX's
# ``dots_with_no_batch_dims_saveable`` keeps only dots without batch dims, so
# it recomputes attention's batched QK and PV products, which this policy
# saves (``bmm``, SDPA); both keep the projections' ``mm``/``addmm``.
_DOTS = (torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm,
         torch.ops.aten._scaled_dot_product_flash_attention,
         torch.ops.aten._scaled_dot_product_efficient_attention,
         torch.ops.aten._scaled_dot_product_cudnn_attention,
         torch.ops.aten._scaled_dot_product_flash_attention_for_cpu)


def _dots_policy(ctx, op, *args, **kwargs):
    if op.overloadpacket in _DOTS:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, cfg: ModelConfig):
    """``fn`` recomputed in the backward under ``cfg.remat`` (JAX's
    ``jax.checkpoint``), keeping nothing (``"nothing"``) or the matrix
    products' outputs (``"dots"``); else ``fn``.  The recompute runs the
    sparse layers' autograd twins as the first pass does, so their kernels
    run with autograd off there too."""
    if not cfg.remat:
        return fn
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _dots_policy)
    elif cfg.remat_policy != "nothing":
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    # the blocks draw no random numbers, so no RNG state is kept for the
    # recompute
    return lambda *a: _ckpt.checkpoint(fn, *a, use_reentrant=False,
                                       preserve_rng_state=False, **kw)


def lm_forward(params, cfg: ModelConfig, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scoring forward: ``batch["tokens"]`` [B, S] (a tensor or a numpy
    array, moved to the params' device) -> (logits [B, S, padded_vocab],
    aux), with causal full self-attention in every attention block as
    ``cfg.attn_impl`` picks it.  aux is the mean of the blocks' auxiliary
    losses (zero for a dense or recurrent model).  An M-RoPE model reads
    ``batch["mrope_positions"]`` [B, 3, S] where the batch has them (else
    1-D RoPE), and a VLM its vision embeddings (:func:`_embed_tokens`)."""
    _check_supported(cfg)
    dev = params["embed"].device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    h = _embed_tokens(params, cfg, dict(batch, tokens=tokens))
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    mrope_positions = batch.get("mrope_positions") if cfg.mrope else None
    if mrope_positions is not None:
        mrope_positions = torch.as_tensor(mrope_positions, device=dev)
    pat = cfg.block_pattern
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if pat == "attn":
        def body(lp, hh):
            return block_apply(lp, cfg, hh, positions=positions,
                               mrope_positions=mrope_positions)

        body = _maybe_remat(body, cfg)
        auxs = []
        for l in range(cfg.n_layers):
            h, a = body(layer_params(params["layers"], l), h)
            auxs.append(a)
        aux = torch.stack(auxs).mean()
    elif pat == "xlstm":
        n_super, every, _ = _n_super(cfg)

        def super_body(mp, sp, hh):
            for j in range(every - 1):
                hh = hh + xlstm_mod.mlstm_apply(layer_params(mp, j), cfg, hh)
            return hh + xlstm_mod.slstm_apply(sp, cfg, hh)

        super_body = _maybe_remat(super_body, cfg)
        for i in range(n_super):
            h = super_body(layer_params(params["mlstm"], i),
                           layer_params(params["slstm"], i), h)
    else:
        h0 = h
        n_super, every, rem = _n_super(cfg)

        def super_body(mp, hh):
            for j in range(every):
                hh = hh + ssm_mod.mamba_apply(layer_params(mp, j), cfg, hh)
            return shared_block_apply(params["shared"], cfg, hh, h0,
                                      positions=positions)

        def tail(lp, hh):
            return hh + ssm_mod.mamba_apply(lp, cfg, hh)

        super_body, tail = (_maybe_remat(super_body, cfg),
                            _maybe_remat(tail, cfg))
        for i in range(n_super):
            h = super_body(layer_params(params["mamba"], i), h)
        for j in range(rem):
            h = tail(layer_params(params["mamba_tail"], j), h)
    h = norm_apply(params["final_norm"], h, cfg.norm)
    return _unembed(params, cfg, h), aux


def next_token_nll(cfg: ModelConfig, logits: torch.Tensor, tokens) -> torch.Tensor:
    """Mean next-token cross-entropy of logits [B, S, padded_vocab] against
    ``tokens`` [B, S].  The padded vocab ids can never be labels, so their
    logits are set to -1e30 in f32 before the logsumexp."""
    logits = logits[:, :-1].float()
    labels = torch.as_tensor(tokens, device=logits.device)[:, 1:].long()
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, attn_mod.NEG)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (logz - gold).mean()


def loss_fn(params, cfg: ModelConfig, batch, aux_weight: float = 0.01):
    """Next-token cross-entropy of the scoring forward
    (:func:`next_token_nll`).  Returns (nll + aux_weight * aux, {"nll",
    "aux"})."""
    logits, aux = lm_forward(params, cfg, batch)
    nll = next_token_nll(cfg, _whole_vocab(cfg, logits), batch["tokens"])
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}


def _check_attn(cfg: ModelConfig, what: str) -> None:
    """Refuse a recurrent pattern where only the attention families'
    random-access KV rows will do, as the JAX package does."""
    if cfg.block_pattern != "attn":
        raise NotImplementedError(
            f"{what} supports attention families only, not "
            f"block_pattern={cfg.block_pattern!r}")


def cache_init(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """The pattern's decode cache on ``device`` (``None``: the CUDA card):
    ``{"k", "v"}`` of [L, B, max_len, KV, D]; ``{"mlstm": {"C", "n", "m"},
    "slstm": {"c", "n", "h", "m"}}`` stacked [n_super, every - 1, B, ...]
    and [n_super, B, ...]; or ``{"mamba": {"ssm", "conv"}, "shared_kv":
    {"k", "v"}, "mamba_tail"?}`` stacked [n_super, every, B, ...], one KV
    cache [n_super, B, max_len, KV, D] for each application of the shared
    block, and [rem, B, ...]."""
    dtype = getattr(torch, cfg.dtype)
    dev = resolve_device(device)
    pat = cfg.block_pattern
    if pat == "attn":
        return attn_mod.cache_init(cfg, batch, max_len, cfg.n_layers, dtype,
                                   dev)
    if pat not in PATTERNS:
        raise ValueError(f"unknown block_pattern {pat!r}")
    n_super, every, rem = _n_super(cfg)
    if pat == "xlstm":
        return {
            "mlstm": _stacked(lambda: xlstm_mod.mlstm_cache_init(cfg, batch, dev),
                              n_super, every - 1),
            "slstm": _stacked(lambda: xlstm_mod.slstm_cache_init(cfg, batch, dev),
                              n_super),
        }
    out = {
        "mamba": _stacked(lambda: ssm_mod.mamba_cache_init(cfg, batch, dtype,
                                                           dev),
                          n_super, every),
        "shared_kv": attn_mod.cache_init(cfg, batch, max_len, n_super, dtype,
                                         dev),
    }
    if rem:
        out["mamba_tail"] = _stacked(
            lambda: ssm_mod.mamba_cache_init(cfg, batch, dtype, dev), rem)
    return out


def _write(stacked, new) -> None:
    """Copy a layer's new state tree into its slot of the stacked cache."""
    for k, v in new.items():
        stacked[k].copy_(v)


def _recurrent_decode(params, cfg: ModelConfig, cache, h, pos_b):
    """The recurrent patterns' layers of one decode step: each block's new
    state is written into its slot of ``cache`` in place, the shared
    block's new K/V after the loop."""
    n_super, every, rem = _n_super(cfg)
    if cfg.block_pattern == "xlstm":
        for i in range(n_super):
            mp, mc = layer_params(params["mlstm"], i), layer_params(
                cache["mlstm"], i)
            for j in range(every - 1):
                dh, new = xlstm_mod.mlstm_decode(layer_params(mp, j), cfg, h,
                                                 layer_params(mc, j))
                _write(layer_params(mc, j), new)
                h = h + dh
            sc = layer_params(cache["slstm"], i)
            dh, new = xlstm_mod.slstm_decode(layer_params(params["slstm"], i),
                                             cfg, h, sc)
            _write(sc, new)
            h = h + dh
        return h
    h0 = h
    kv = cache["shared_kv"]
    k_news, v_news = [], []
    for i in range(n_super):
        mp, mc = layer_params(params["mamba"], i), layer_params(cache["mamba"], i)
        for j in range(every):
            dh, new = ssm_mod.mamba_decode(layer_params(mp, j), cfg, h,
                                           layer_params(mc, j))
            _write(layer_params(mc, j), new)
            h = h + dh
        h, (kn, vn) = shared_block_decode(params["shared"], cfg, h, h0,
                                          (kv["k"][i], kv["v"][i]), pos=pos_b)
        k_news.append(kn)
        v_news.append(vn)
    attn_mod.cache_write(kv["k"], kv["v"], torch.stack(k_news),
                         torch.stack(v_news), pos_b)
    for j in range(rem):
        tc = layer_params(cache["mamba_tail"], j)
        dh, new = ssm_mod.mamba_decode(layer_params(params["mamba_tail"], j),
                                       cfg, h, tc)
        _write(tc, new)
        h = h + dh
    return h


def decode_step(params, cfg: ModelConfig, cache, tokens: torch.Tensor, pos):
    """One decode step against the pattern's contiguous cache.

    tokens [B, 1]; pos a scalar (the current length) or a per-sequence [B]
    vector (slots at mixed lengths decode in one step); the recurrent
    blocks read no position, the shared attention block does, and an
    M-RoPE model rotates by three components equal to it.  The
    attention layers only read the cache, and one
    :func:`attention.cache_write` after the loop commits their new K/V in
    place; each recurrent block writes its new state into its slot in
    place.  Returns (logits [B, 1, V], cache).
    """
    _check_supported(cfg)
    h = _embed(params, cfg, tokens)
    b = tokens.shape[0]
    pos_b = attn_mod._pos_vector(pos, b, tokens.device)
    if cfg.block_pattern != "attn":
        h = _recurrent_decode(params, cfg, cache, h, pos_b)
        h = norm_apply(params["final_norm"], h, cfg.norm)
        return _unembed(params, cfg, h), cache
    mrope_positions = (pos_b.reshape(b, 1, 1).expand(b, 3, 1) if cfg.mrope
                       else None)
    k_news, v_news = [], []
    for l in range(cfg.n_layers):
        h, (kn, vn) = block_decode(layer_params(params["layers"], l), cfg, h,
                                   (cache["k"][l], cache["v"][l]), pos=pos_b,
                                   mrope_positions=mrope_positions)
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
    A recurrent pattern returns (the last position's logits of
    :func:`lm_forward`, ``None``), as the JAX package does: its state cache
    is filled by running the prompt through :func:`decode_step`
    (``Engine.prefill_step``).  An M-RoPE model rotates the prompt by
    three components equal to ``arange(S)``, and a VLM reads no vision
    input here, as in the JAX package.
    """
    _check_supported(cfg)
    b, s = tokens.shape
    batch = {"tokens": tokens}
    if cfg.mrope:
        batch["mrope_positions"] = torch.arange(
            s, device=tokens.device)[None, None, :].expand(b, 3, s)
    if cfg.block_pattern != "attn":
        logits, _ = lm_forward(params, cfg, batch)
        return logits[:, -1:], None
    h = _embed_tokens(params, cfg, batch)
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)

    def body(lp, hh):
        x = norm_apply(lp["ln1"], hh, cfg.norm)
        q, k, v = attn_mod._qkv(lp["attn"], cfg, x, positions,
                                batch.get("mrope_positions"))
        kr, vr = attn_mod._rank_kv(cfg, k), attn_mod._rank_kv(cfg, v)
        if cfg.attn_impl == "chunked" and s > cfg.attn_chunk:
            o = attn_mod.sdpa_gqa_chunked(q, kr, vr, causal=True,
                                          chunk=cfg.attn_chunk)
        else:
            o = attn_mod.sdpa_gqa(q, kr, vr, causal=True)
        hh = hh + attn_mod._o_proj(lp["attn"], cfg, o.reshape(b, s, -1))
        hh = hh + ffn_apply(lp, cfg, norm_apply(lp["ln2"], hh, cfg.norm))[0]
        return hh, k, v

    body = _maybe_remat(body, cfg)
    ks, vs = [], []
    for l in range(cfg.n_layers):
        h, k, v = body(layer_params(params["layers"], l), h)
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
    the final norm and unembedding and returns (None, cache).  An M-RoPE
    model rotates by three components equal to the 1-D positions.
    Attention families only: a recurrent state has no random-access rows
    to chunk into.
    """
    _check_attn(cfg, "prefill_chunk")
    b, c_len = tokens.shape
    h = _embed(params, cfg, tokens)
    mrope_positions = None
    if cfg.mrope:
        pos1 = attn_mod._pos_vector(start, b, tokens.device)[:, None] + \
            torch.arange(c_len, dtype=torch.int32, device=tokens.device)
        mrope_positions = pos1[:, None, :].expand(b, 3, c_len)
    k_news, v_news = [], []
    for l in range(cfg.n_layers):
        h, (kn, vn) = block_prefill_chunk(
            layer_params(params["layers"], l), cfg, h,
            (cache["k"][l], cache["v"][l]), start=start,
            mrope_positions=mrope_positions)
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
    loop (inactive slots' rows land on the trash page).  Attention families
    only.
    """
    _check_attn(cfg, "paged_decode_step")
    h = _embed(params, cfg, tokens)
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
    prompt's K/V written through its page table).  Attention families only.
    """
    _check_attn(cfg, "prefill_packed")
    h = _embed(params, cfg, tokens[None, :])
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
