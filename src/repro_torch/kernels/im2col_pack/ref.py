"""Plain PyTorch im2col + packing (twin of
``repro/kernels/im2col_pack/ref.py``): the two passes the fused kernel
replaces, first the full patch matrix, then V-wide strips.

Layouts follow the paper: CNHW map ``[C, B, H, W]``; patch-matrix rows
``(kh, kw, c)`` flattened (``row = k*C + c``), columns ``(b, oh, ow)``;
packed strips ``[n_strips, Kh*Kw*C, V]``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def out_size(h: int, k: int, stride: int, pad: int) -> int:
    return (h + 2 * pad - k) // stride + 1


def im2col_cnhw(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
                pad: int = 0) -> torch.Tensor:
    """im2col of a CNHW map -> [Kh*Kw*C, B*Ho*Wo] patch matrix."""
    c, b, h, w = x.shape
    ho = out_size(h, kh, stride, pad)
    wo = out_size(w, kw, stride, pad)
    xp = F.pad(x, (pad, pad, pad, pad))
    rows = [
        xp[:, :, ikh: ikh + (ho - 1) * stride + 1: stride,
           ikw: ikw + (wo - 1) * stride + 1: stride].reshape(c, b * ho * wo)
        for ikh in range(kh) for ikw in range(kw)
    ]
    return torch.stack(rows, dim=0).reshape(kh * kw * c, b * ho * wo)


def pack_strips(mat: torch.Tensor, v: int) -> torch.Tensor:
    """Pack a [R, P] matrix into V-wide strips [ceil(P/V), R, V]."""
    r, p = mat.shape
    n_strips = -(-p // v)
    mat = F.pad(mat, (0, n_strips * v - p))
    return mat.reshape(r, n_strips, v).permute(1, 0, 2).contiguous()


def im2col_pack_ref(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
                    pad: int = 0, v: int = 128) -> torch.Tensor:
    """Two-pass im2col, then pack: [n_strips, Kh*Kw*C, V]; the fused
    kernel's plain version (exact copy, so bit-identical)."""
    return pack_strips(im2col_cnhw(x, kh, kw, stride, pad), v)
