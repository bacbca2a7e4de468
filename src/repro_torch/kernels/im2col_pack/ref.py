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


def im2col_pack_tiled_ref(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
                          pad: int = 0, v: int = 128, cb: int = 16,
                          tg: int = 1) -> torch.Tensor:
    """The tiled pack kernel's plain version (the walk of
    ``csrc/im2col_pack_tiled.cu``): block (strip, ``tg`` taps, channels
    [c0, c0 + cb)) finds each of its taps' source offsets once through
    ``tap_coords`` and copies the block's channel rows with them, zero off
    the map and past the last position.  The kernel's grid over tap groups
    and channel chunks, each step taken for every strip side by side.  Same
    function and bits as :func:`im2col_pack_ref`: [n_strips, Kh*Kw*C, V]."""
    # kernel.py imports this module for out_size: import its index rule here
    from repro_torch.kernels.im2col_pack.kernel import tap_coords

    c, b, h, w = x.shape
    ho, wo = out_size(h, kh, stride, pad), out_size(w, kw, stride, pad)
    n_strips = -(-b * ho * wo // v)
    out = torch.empty((n_strips, kh * kw * c, v), dtype=x.dtype,
                      device=x.device)
    planes = x.reshape(c, b * h * w)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    p = torch.arange(n_strips * v, device=x.device)  # every strip's positions
    for t0 in range(0, kh * kw, tg):
        for c0 in range(0, c, cb):
            for tap in range(t0, min(t0 + tg, kh * kw)):
                valid, bc, ihc, iwc = tap_coords(
                    p, ikh=tap // kw, ikw=tap % kw, stride=stride, pad=pad,
                    b=b, h=h, w=w, ho=ho, wo=wo)
                off = (bc * h + ihc) * w + iwc  # one a position, all channels
                block = torch.where(valid, planes[c0:c0 + cb][:, off], zero)
                out[:, tap * c + c0:tap * c + c0 + block.shape[0]] = (
                    block.view(-1, n_strips, v).transpose(0, 1))
    return out
