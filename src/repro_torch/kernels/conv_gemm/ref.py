"""Plain PyTorch convolutions in the paper's CNHW/OHWI layouts (twin of
``repro/kernels/conv_gemm/ref.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

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
