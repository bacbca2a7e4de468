"""Fused im2col + pack + sparse GEMM conv on Hopper
(``csrc/conv2d_fused.cu``): the packed strips never reach device memory."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import (
    DTYPE_CODE,
    FLOAT_DTYPES,
    CudaKernel,
    check_compressed,
    check_cuda_tensor,
)
from repro_torch.kernels.im2col_pack.ref import out_size

CONV2D_FUSED = CudaKernel(
    "conv2d_fused", "repro_conv2d_fused",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 17,
    source="src/repro_torch/csrc/conv2d_fused.cu",
    replaces="src/repro/kernels/conv_gemm/kernel.py:99 conv2d_fused_pallas",
)


def conv2d_fused_cuda(x: torch.Tensor, values: torch.Tensor, idx: torch.Tensor,
                      *, kh: int, kw: int, stride: int = 1, pad: int = 0,
                      v: int = 128, block_k: int = 128) -> torch.Tensor:
    """Launch the fused conv: CNHW ``x`` [C, B, H, W] with ``values``
    [n_tiles, k_kept, T] / ``idx`` [n_tiles, k_kept] over the (kh, kw, c)
    rows -> [O, n_strips*V], zero past the last position."""
    check_cuda_tensor("x", x, FLOAT_DTYPES, 4)
    n_tiles, k_kept, tile = values.shape
    block_k = min(block_k, k_kept)
    check_compressed(values, idx, x.dtype, block_k, 4 * tile + 16)
    if values.device != x.device or idx.device != x.device:
        raise ValueError("x, values and idx must be on one device")
    c, b, h, w = x.shape
    ho = out_size(h, kh, stride, pad)
    wo = out_size(w, kw, stride, pad)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"empty output {ho}x{wo} for map {h}x{w}")
    n_strips = -(-b * ho * wo // v)
    out = torch.empty((n_tiles * tile, n_strips * v), dtype=x.dtype,
                      device=x.device)
    CONV2D_FUSED.launch(
        x.device, x.data_ptr(), values.data_ptr(), idx.data_ptr(),
        out.data_ptr(), DTYPE_CODE[x.dtype], c, b, h, w, kh, kw, stride, pad,
        ho, wo, v, n_strips, n_tiles, k_kept, tile, block_k)
    return out
