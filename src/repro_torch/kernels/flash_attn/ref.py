"""Plain PyTorch paged attention (twin of ``paged_attention_ref`` in
``repro/kernels/flash_attn/paged.py``)."""
from __future__ import annotations

import torch


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
