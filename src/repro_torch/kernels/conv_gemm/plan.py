"""Band geometry of the banded conv (twins of ``band_plan`` and
``_band_origin`` in ``repro/kernels/conv_gemm/kernel.py``).

The map is viewed as ``[C, B*H, W]``.  A band groups ``hb`` consecutive
strips (``hb*v`` output positions); the input rows its positions read are one
contiguous window of that flattened row space, so a band needs one fixed-size
window of ``band_rows`` rows, starting at its origin.  The plain version, the
CUDA kernel (``csrc/conv2d_fused_banded.cu``) and the dispatch predicate all
size and place the window with these two functions.  The tiled kernel
(``csrc/conv2d_fused_banded_tiled.cu``) reads a zero-padded window instead,
sized by :func:`tiled_band_plan` and placed by :func:`tiled_band_origin`.
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


@functools.lru_cache(maxsize=1024)  # ints in, ints out; called per launch
def tiled_band_plan(*, b: int, h: int, w: int, kh: int, stride: int,
                    pad: int, ho: int, wo: int, v: int, hb: int,
                    itemsize: int):
    """Geometry of the tiled banded conv's zero-padded window
    (``csrc/conv2d_fused_banded_tiled.cu``): ``(n_bands, band_rows, lead,
    pitch, plane)``.

    Each image gets ``pad`` zero rows above and below, so the padded row
    space has ``h + 2*pad`` rows an image, and output position
    ``(bb, oh, ow)`` reads padded row ``bb*(h + 2*pad) + oh*stride + ikh``
    at tap ``ikh``.  A band's window holds ``band_rows`` consecutive padded
    rows from its top row (:func:`tiled_band_origin`): the exact maximum
    over the bands, never clamped (rows past the map land as zeros).  In a
    channel's window row ``r``'s ``w`` values start at ``lead + r*pitch``
    and the ``pitch - w`` elements after them are zeros, the row's right pad
    and the next row's left pad; a channel takes ``plane = lead +
    band_rows*pitch`` elements.  ``lead`` and the gap are whole 16-byte
    copies of at least ``pad`` elements; the pitch is bumped by one copy
    where it would be a multiple of the 32 banks."""
    n_pos = b * ho * wo
    n_strips = -(-n_pos // v)
    hb = max(min(hb, n_strips), 1)
    n_bands = -(-n_strips // hb)
    og = dict(hb=hb, v=v, h=h, ho=ho, wo=wo, pad=pad, stride=stride)
    rows = 1
    for g in range(n_bands):
        last = min((g + 1) * hb * v, n_pos) - 1
        top = tiled_band_origin(g, **og)
        rows = max(rows, _padded_row(last, h=h, ho=ho, wo=wo, pad=pad,
                                     stride=stride) + kh - top)
    vec = 16 // itemsize
    lead = vec * max(1, -(-pad // vec))
    pitch = vec * -(-w // vec) + lead
    if (pitch * itemsize // 4) % 32 == 0:
        pitch += vec
    return n_bands, rows, lead, pitch, lead + rows * pitch


def _padded_row(p, *, h, ho, wo, pad, stride):
    """Padded row of output position ``p`` at tap row 0."""
    bb = p // (ho * wo)
    oh = (p % (ho * wo)) // wo
    return bb * (h + 2 * pad) + oh * stride


def tiled_band_origin(g, *, hb, v, h, ho, wo, pad, stride):
    """First padded row of band ``g``'s window in the tiled kernel: its
    first position's tap row 0 (``g`` an int or an integer tensor)."""
    return _padded_row(g * (hb * v), h=h, ho=ho, wo=wo, pad=pad,
                       stride=stride)
