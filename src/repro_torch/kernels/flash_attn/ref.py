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
