"""Fused im2col + pack on Hopper (``csrc/im2col_pack.cu``), and the im2col
index arithmetic every conv path shares.

``tap_coords`` is the twin of ``repro/kernels/im2col_pack/kernel.py``'s: the
plain versions gather with it, and ``csrc/common.cuh::tap_coords`` computes
the same coordinates on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import (CudaKernel, FLOAT_DTYPES,
                                        check_cuda_tensor, check_no_grad)
from repro_torch.kernels.im2col_pack.ref import out_size


def tap_coords(p, *, ikh, ikw, stride, pad, b, h, w, ho, wo,
               band_origin=None, band_rows=None):
    """Source coordinates of flat output positions ``p`` at kernel tap
    (ikh, ikw).

    ``p`` is an integer tensor of flattened ``(batch, oh, ow)`` positions;
    ``ikh``/``ikw`` broadcast against it.  Returns ``(valid, bc, ihc, iwc)``:
    the off-map / past-the-end mask and clamped (always in-bounds) batch, row
    and column coordinates.

    Band mode (``band_origin``/``band_rows`` set), for the banded conv that
    keeps only a row band of the ``[C, B*H, W]`` map: the row coordinate is
    band-local in the flattened ``(batch*h)`` row space,
    ``bb*h + ih - band_origin`` clamped to ``[0, band_rows)``, and the batch
    coordinate is dropped; returns ``(valid, rowc, iwc)``.  ``band_origin``
    may be a tensor that broadcasts against ``p``.
    """
    n_pos = b * ho * wo
    bb = p // (ho * wo)
    rem = p % (ho * wo)
    oh = rem // wo
    ow = rem % wo
    ih = oh * stride - pad + ikh
    iw = ow * stride - pad + ikw
    valid = (p < n_pos) & (ih >= 0) & (ih < h) & (iw >= 0) & (iw < w)
    if band_origin is not None:
        row = bb * h + ih - band_origin
        return (valid, row.clamp(0, band_rows - 1), iw.clamp(0, w - 1))
    return (valid, bb.clamp(0, b - 1), ih.clamp(0, h - 1), iw.clamp(0, w - 1))


def strip_tap_coords(s, *, v, ikh, ikw, stride, pad, b, h, w, ho, wo,
                     band_origin=None, band_rows=None, device=None):
    """:func:`tap_coords` over strip ``s``'s positions ``s*v + arange(v)``
    (band mode included)."""
    p = s * v + torch.arange(v, dtype=torch.int32, device=device)
    return tap_coords(p, ikh=ikh, ikw=ikw, stride=stride, pad=pad, b=b, h=h,
                      w=w, ho=ho, wo=wo, band_origin=band_origin,
                      band_rows=band_rows)


IM2COL_PACK = CudaKernel(
    "im2col_pack", "repro_im2col_pack",
    [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 13,
    source="src/repro_torch/csrc/im2col_pack.cu",
    replaces="src/repro/kernels/im2col_pack/kernel.py:124 im2col_pack_pallas",
)


def im2col_pack_cuda(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
                     pad: int = 0, v: int = 128) -> torch.Tensor:
    """Launch the fused im2col+pack kernel: CNHW ``x`` -> [n_strips, Kh*Kw*C, V]."""
    check_no_grad("im2col_pack", x)
    check_cuda_tensor("x", x, FLOAT_DTYPES, 4)
    c, b, h, w = x.shape
    ho = out_size(h, kh, stride, pad)
    wo = out_size(w, kw, stride, pad)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"empty output {ho}x{wo} for map {h}x{w}")
    n_strips = -(-b * ho * wo // v)
    out = torch.empty((n_strips, kh * kw * c, v), dtype=x.dtype, device=x.device)
    IM2COL_PACK.launch(x.device, x.data_ptr(), out.data_ptr(), x.element_size(),
                       c, b, h, w, kh, kw, stride, pad, ho, wo, v, n_strips)
    return out
