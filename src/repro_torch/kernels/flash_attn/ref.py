"""Plain PyTorch versions of the attention kernels: flash attention (twin
of ``repro/kernels/flash_attn/ref.py``) and paged attention (twin of
``paged_attention_ref`` in ``repro/kernels/flash_attn/paged.py``)."""
from __future__ import annotations

import math

import torch

NEG = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """Naive full-softmax attention, the scores materialised (exactly what
    the kernel avoids).  q [BH, Sq, D]; k/v [BH, Sk, D]; the causal mask is
    top-left, ``kpos <= qpos``.  Scores and softmax in f32, the output in
    q's dtype."""
    sq, d = q.shape[1], q.shape[2]
    sk = k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(d)
    if causal:
        mask = (torch.arange(sk, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None])
        s = torch.where(mask[None], s, NEG)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", w, v.float()).to(q.dtype)


def flash_attention_gqa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            *, causal: bool = True) -> torch.Tensor:
    """:func:`flash_attention_ref` in the GQA layout, as the JAX package's
    ``ops.flash_attention`` feeds its kernel: q [B, Sq, H, D] and k/v
    [B, Sk, KV, D], KV head (h * KV) // H expanded to each q head h, the
    transposes to [BH, S, D] and back.  Returns [B, Sq, H, D]."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if h != kvh:
        mapping = (torch.arange(h, device=k.device) * kvh) // h
        k, v = k[:, :, mapping], v[:, :, mapping]
    o = flash_attention_ref(q.transpose(1, 2).reshape(b * h, sq, d),
                            k.transpose(1, 2).reshape(b * h, sk, d),
                            v.transpose(1, 2).reshape(b * h, sk, d),
                            causal=causal)
    return o.reshape(b, h, sq, d).transpose(1, 2)


def paged_attention_ref(q: torch.Tensor, k_new: torch.Tensor,
                        v_new: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, tables: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """Gather the pages, then the serving step's combine-attention.

    q [B, Sq, H, D]; k_new/v_new [B, Sq, KV, D]; k_pages/v_pages
    [P, page_size, KV, D]; tables [B, n_max] int32; lengths [B] int32.
    Materialises the gathered ``[B, n_max * page_size, KV, D]`` cache: the
    kernel's plain version, whose bytes grow with the table width and not
    with the lengths.
    """
    from repro_torch.models.attention import _cached_attention

    ps, kv, d = k_pages.shape[1:]
    b, n_max = tables.shape
    t = tables.long()
    kc = k_pages[t].reshape(b, n_max * ps, kv, d)
    vc = v_pages[t].reshape(b, n_max * ps, kv, d)
    return _cached_attention(q, k_new, v_new, kc, vc,
                             limit=lengths.to(torch.int32), causal=True)


def paged_split_tiles(lengths: torch.Tensor, sq: int, page_size: int,
                      n_max: int) -> tuple:
    """The work list of ``csrc/paged_attention_split.cu`` for each sequence:
    its cache pages that hold valid rows, then this step's new keys in
    chunks of ``page_size`` rows.  Returns ``(n_used, n_tiles)``, int64
    tensors of shape [B]; tile ``u`` of a sequence goes to warp ``u % W``."""
    n_used = ((lengths.long().clamp(min=0) + page_size - 1)
              // page_size).clamp(max=n_max)
    return n_used, n_used + -(-sq // page_size)


def paged_attention_split_ref(q: torch.Tensor, k_new: torch.Tensor,
                              v_new: torch.Tensor, k_pages: torch.Tensor,
                              v_pages: torch.Tensor, tables: torch.Tensor,
                              lengths: torch.Tensor, *,
                              warps: int) -> torch.Tensor:
    """The split kernel's arithmetic in plain PyTorch: each of ``warps``
    warps takes the tiles ``u % warps == w`` of :func:`paged_split_tiles`
    and keeps its own softmax partial (m, l, acc) over the rows they hold,
    masked as :func:`paged_attention_ref` masks them (cache rows below
    ``lengths[b]``, new key t for query row i where ``t <= i``); then one
    combine: ``m* = max m_w``, ``l = sum e^(m_w - m*) l_w`` and acc the same
    way, a warp that saw no valid row weighted 0, ``out = acc / max(l,
    1e-30)``.  Requires H % KV == 0 (head h reads KV head h // g).  The
    same function as :func:`paged_attention_ref` up to the order of its
    sums; the main path never calls it."""
    b, sq, h, d = q.shape
    ps, kv = k_pages.shape[1], k_pages.shape[2]
    n_max = tables.shape[1]
    g, cap = h // kv, n_max * ps
    t = tables.long()
    pos = torch.arange(cap, device=q.device)
    live = pos[None, :] < lengths.long()[:, None]  # [B, cap]: rows read
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    kc = torch.where(live[..., None, None],
                     k_pages[t].reshape(b, cap, kv, d).float(), zero)
    vc = torch.where(live[..., None, None],
                     v_pages[t].reshape(b, cap, kv, d).float(), zero)
    keys = torch.cat([kc, k_new.float()], 1)  # [B, cap + Sq, KV, D]
    vals = torch.cat([vc, v_new.float()], 1)
    i = torch.arange(sq, device=q.device)
    valid = torch.cat([live[:, None, :].expand(b, sq, cap),
                       (i[None, :] <= i[:, None])[None].expand(b, sq, sq)],
                      -1)  # [B, Sq (query), cap + Sq (key)]
    n_used, _ = paged_split_tiles(lengths, sq, ps, n_max)
    tile = torch.cat([(pos // ps)[None].expand(b, cap),
                      n_used[:, None] + (i // ps)[None]], 1)  # [B, cap + Sq]
    qf = q.float().reshape(b, sq, kv, g, d)
    s = torch.einsum("bikgd,bjkd->bkgij", qf, keys) / math.sqrt(d)
    ms, ls, accs = [], [], []
    for w in range(warps):
        mask = (valid & (tile % warps == w)[:, None, :])[:, None, None]
        m = torch.where(mask, s, NEG).amax(-1, keepdim=True)
        p = torch.exp(torch.where(mask, s, NEG) - m) * mask
        ms.append(m[..., 0])
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bkgij,bjkd->bkgid", p, vals))
    m_w, l_w, acc_w = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    m_star = m_w.amax(0)
    wt = torch.where(m_w > NEG, torch.exp(m_w - m_star), zero)
    l_sum = (wt * l_w).sum(0)
    out = (wt[..., None] * acc_w).sum(0) / l_sum.clamp(min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)
