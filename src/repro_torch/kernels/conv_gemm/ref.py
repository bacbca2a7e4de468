"""Plain PyTorch convolutions in the paper's CNHW/OHWI layouts (twin of
``repro/kernels/conv_gemm/ref.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.conv_gemm.plan import (_band_origin, band_plan,
                                               tiled_band_origin,
                                               tiled_band_plan)
from repro_torch.kernels.im2col_pack.kernel import tap_coords
from repro_torch.kernels.im2col_pack.ref import out_size


def conv2d_cnhw_ref(x: torch.Tensor, w_ohwi: torch.Tensor, stride: int = 1,
                    pad: int = 0) -> torch.Tensor:
    """x: [C, B, H, W]; w: [O, Kh, Kw, C] -> CNHW output [O, B, Ho, Wo].

    A library convolution, independent of the im2col and sparse kernels it
    checks (the twin of ``lax.conv_general_dilated`` in the JAX package).
    """
    y = F.conv2d(x.permute(1, 0, 2, 3), w_ohwi.permute(0, 3, 1, 2),
                 stride=stride, padding=pad)
    return y.permute(1, 0, 2, 3).contiguous()


def conv2d_fused_ref(x: torch.Tensor, values: torch.Tensor, idx: torch.Tensor,
                     *, kh: int, kw: int, stride: int = 1, pad: int = 0,
                     v: int = 128) -> torch.Tensor:
    """The fused conv kernel's plain version: kept im2col rows gathered
    straight from the CNHW map with :func:`tap_coords`, then the sparse
    GEMM with float32 accumulation.  Returns [O, n_strips*V] in ``x``'s
    dtype, zero past the last position."""
    c, b, h, w = x.shape
    ho = out_size(h, kh, stride, pad)
    wo = out_size(w, kw, stride, pad)
    n_strips = -(-b * ho * wo // v)
    n_tiles, _, tile = values.shape
    ids = idx.long()
    k_of, c_of = ids // c, ids % c  # [n_tiles, k]: tap ikh*kw + ikw, channel
    p = torch.arange(n_strips * v, dtype=torch.int64, device=x.device)
    valid, bc, ihc, iwc = tap_coords(
        p, ikh=(k_of // kw)[..., None], ikw=(k_of % kw)[..., None],
        stride=stride, pad=pad, b=b, h=h, w=w, ho=ho, wo=wo)  # [n_tiles, k, P]
    fidx = ((c_of[..., None] * b + bc) * h + ihc) * w + iwc
    patch = torch.where(valid, x.reshape(-1)[fidx].float(), 0.0)
    y = torch.einsum("tkf,tkp->tfp", values.float(), patch)
    return y.reshape(n_tiles * tile, n_strips * v).to(x.dtype)


def conv2d_fused_banded_ref(x: torch.Tensor, values: torch.Tensor,
                            idx: torch.Tensor, *, kh: int, kw: int,
                            stride: int = 1, pad: int = 0, v: int = 128,
                            hb: int = 2) -> torch.Tensor:
    """The banded conv kernel's plain version: every position reads its
    band's ``band_rows``-row window of the ``[C, B*H, W]`` map at the band's
    origin, with the band-local coordinates of :func:`tap_coords`, so a
    window that missed a row the position needs would give a wrong result.
    Same function as :func:`conv2d_fused_ref`: [O, n_strips*V]."""
    c, b, h, w = x.shape
    ho = out_size(h, kh, stride, pad)
    wo = out_size(w, kw, stride, pad)
    n_strips = -(-b * ho * wo // v)
    hb = max(min(hb, n_strips), 1)
    _, band_rows = band_plan(b=b, h=h, kh=kh, stride=stride, pad=pad, ho=ho,
                             wo=wo, v=v, hb=hb)
    n_tiles, _, tile = values.shape
    ids = idx.long()
    k_of, c_of = ids // c, ids % c
    p = torch.arange(n_strips * v, dtype=torch.int64, device=x.device)
    org = _band_origin(p // (hb * v), hb=hb, v=v, h=h, ho=ho, wo=wo, pad=pad,
                       stride=stride, bh=b * h, band_rows=band_rows)
    valid, rowc, iwc = tap_coords(
        p, ikh=(k_of // kw)[..., None], ikw=(k_of % kw)[..., None],
        stride=stride, pad=pad, b=b, h=h, w=w, ho=ho, wo=wo,
        band_origin=org, band_rows=band_rows)  # [n_tiles, k, P]
    fidx = (c_of[..., None] * (b * h) + org + rowc) * w + iwc
    patch = torch.where(valid, x.reshape(-1)[fidx].float(), 0.0)
    y = torch.einsum("tkf,tkp->tfp", values.float(), patch)
    return y.reshape(n_tiles * tile, n_strips * v).to(x.dtype)


def conv2d_fused_banded_tiled_ref(x: torch.Tensor, values: torch.Tensor,
                                  idx: torch.Tensor, *, kh: int, kw: int,
                                  stride: int = 1, pad: int = 0, v: int = 128,
                                  hb: int = 2) -> torch.Tensor:
    """The tiled banded conv kernel's plain version: every tap is read at
    the kernel's address in the zero-padded row space of
    :func:`tiled_band_plan` (the position's padded row and column plus the
    kept row's channel, row and column offset), with no bounds test; a
    position whose taps would leave its band's ``band_rows``-row window, and
    every position of a tile with an index outside ``[0, K)``, give NaN.
    Same function as :func:`conv2d_fused_ref`: [O, n_strips*V]."""
    c, b, h, w = x.shape
    ho = out_size(h, kh, stride, pad)
    wo = out_size(w, kw, stride, pad)
    n_pos = b * ho * wo
    n_strips = -(-n_pos // v)
    hb = max(min(hb, n_strips), 1)
    _, rows, _, pitch, _ = tiled_band_plan(
        b=b, h=h, w=w, kh=kh, stride=stride, pad=pad, ho=ho, wo=wo, v=v,
        hb=hb, itemsize=x.element_size())
    hp = h + 2 * pad
    # one zero row first (the left pad of row 0), then the padded rows, then
    # the rows a window may hold past the map; the pitch - w zeros after a
    # row's values are its right pad and the next row's left pad
    n_rows = 1 + b * hp + rows
    xp = x.new_zeros((c, n_rows, pitch))
    xp[:, 1:1 + b * hp].view(c, b, hp, pitch)[:, :, pad:pad + h, :w] = x
    n_tiles, k_kept, tile = values.shape
    ids = idx.long()
    bad = ((ids < 0) | (ids >= kh * kw * c)).any(1)  # [n_tiles]
    ids = ids.clamp(0, kh * kw * c - 1)
    tap, ch = ids // c, ids % c
    off = ch * (n_rows * pitch) + (tap // kw) * pitch + tap % kw  # [n_tiles, k]
    p = torch.arange(n_strips * v, dtype=torch.int64, device=x.device)
    live = p < n_pos
    pc = p.clamp(max=n_pos - 1)
    ow = pc % wo
    row = (pc // (ho * wo)) * hp + ((pc % (ho * wo)) // wo) * stride
    top = tiled_band_origin(pc // (hb * v), hb=hb, v=v, h=h, ho=ho, wo=wo,
                            pad=pad, stride=stride)
    inside = (row - top >= 0) & (row - top + kh <= rows)
    base = (1 + row) * pitch + ow * stride - pad  # [P]
    patch = xp.reshape(-1)[off[..., None] + base].float()  # [n_tiles, k, P]
    y = torch.einsum("tkf,tkp->tfp", values.float(), patch)
    nan = bad[:, None, None] | ~inside
    y = torch.where(nan, torch.full_like(y, float("nan")), y)
    y = torch.where(live, y, torch.zeros_like(y))
    return y.reshape(n_tiles * tile, n_strips * v).to(x.dtype)
