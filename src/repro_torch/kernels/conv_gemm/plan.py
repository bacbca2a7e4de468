"""Band geometry of the banded conv (twins of ``band_plan`` and
``_band_origin`` in ``repro/kernels/conv_gemm/kernel.py``).

The map is viewed as ``[C, B*H, W]``.  A band groups ``hb`` consecutive
strips (``hb*v`` output positions); the input rows its positions read are one
contiguous window of that flattened row space, so a band needs one fixed-size
window of ``band_rows`` rows, starting at its origin.  The plain version, the
CUDA kernel (``csrc/conv2d_fused_banded.cu``) and the dispatch predicate all
size and place the window with these two functions.
"""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=1024)  # ints in, ints out; called per launch
def band_plan(*, b: int, h: int, kh: int, stride: int, pad: int, ho: int,
              wo: int, v: int, hb: int):
    """``(n_bands, band_rows)``: the number of bands and the exact maximum
    window height over them (ragged final band included), clamped to the
    whole ``b*h``."""
    n_pos = b * ho * wo
    n_strips = -(-n_pos // v)
    hb = max(min(hb, n_strips), 1)
    n_bands = -(-n_strips // hb)
    bh = b * h

    def first_row(p):  # top input row touched by output position p (tap 0)
        bb, rem = divmod(p, ho * wo)
        return bb * h + (rem // wo) * stride - pad

    rows = 1
    for g in range(n_bands):
        p0 = g * hb * v
        p1 = min((g + 1) * hb * v, n_pos) - 1
        r0 = max(first_row(p0), 0)
        r1 = min(first_row(p1) + kh - 1, bh - 1)
        rows = max(rows, r1 - r0 + 1)
    return n_bands, min(rows, bh)


def _band_origin(g, *, hb, v, h, ho, wo, pad, stride, bh, band_rows):
    """First flattened (batch*h) row of band ``g``'s window: the band's top
    row, clamped so the fixed-size window never passes the map's last row
    (it then starts earlier than needed, which only widens coverage).
    ``g`` is an int or an integer tensor."""
    p0 = g * (hb * v)
    bb0 = p0 // (ho * wo)
    oh0 = (p0 % (ho * wo)) // wo
    r0 = bb0 * h + oh0 * stride - pad
    if isinstance(r0, torch.Tensor):
        return r0.clamp(min=0).clamp(max=bh - band_rows)
    return min(max(r0, 0), bh - band_rows)
