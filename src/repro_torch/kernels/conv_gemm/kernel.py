"""Fused im2col + pack + sparse GEMM convs on Hopper: the whole-map kernel
(``csrc/conv2d_fused.cu``) and the banded one (``csrc/conv2d_fused_banded.cu``);
the packed strips never reach device memory.

Each ``*_smem_bytes`` function is the shared memory its kernel's launch
requests, and what the dispatch registry's feasibility predicate compares
with a block's 227 KB.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import (
    DTYPE_CODE,
    FLOAT_DTYPES,
    KROWS,
    CudaKernel,
    check_compressed,
    check_cuda_tensor,
    check_same_device,
)
from repro_torch.kernels.conv_gemm.plan import band_plan
from repro_torch.kernels.im2col_pack.ref import out_size

CONV2D_FUSED = CudaKernel(
    "conv2d_fused", "repro_conv2d_fused",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 17,
    source="src/repro_torch/csrc/conv2d_fused.cu",
    replaces="src/repro/kernels/conv_gemm/kernel.py:99 conv2d_fused_pallas",
)

CONV2D_FUSED_BANDED = CudaKernel(
    "conv2d_fused_banded", "repro_conv2d_fused_banded",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 20,
    source="src/repro_torch/csrc/conv2d_fused_banded.cu",
    replaces=("src/repro/kernels/conv_gemm/kernel.py:300 "
              "conv2d_fused_banded_pallas"),
    sized_smem=True,
)


def fused_smem_bytes(tile: int, block_k: int) -> int:
    """Shared memory of one fused-conv launch: a ``block_k`` chunk of
    ``values[t]`` in f32 and each kept row's channel offset and tap."""
    return block_k * (4 * tile + 16)


def banded_smem_bytes(c: int, w: int, band_rows: int, block_k: int,
                      itemsize: int) -> int:
    """Shared memory of one banded-conv launch: two ``[C, band_rows, W]``
    windows of the map (the double buffer), plus a ``block_k`` chunk of f32
    values for KROWS output rows and each kept row's channel offset and
    tap."""
    return 2 * c * band_rows * w * itemsize + block_k * (KROWS * 4 + 12)


def _conv_out(x: torch.Tensor, kh: int, kw: int, stride: int, pad: int,
              v: int):
    c, b, h, w = x.shape
    ho = out_size(h, kh, stride, pad)
    wo = out_size(w, kw, stride, pad)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"empty output {ho}x{wo} for map {h}x{w}")
    return ho, wo, -(-b * ho * wo // v)


def conv2d_fused_cuda(x: torch.Tensor, values: torch.Tensor, idx: torch.Tensor,
                      *, kh: int, kw: int, stride: int = 1, pad: int = 0,
                      v: int = 128, block_k: int = 128) -> torch.Tensor:
    """Launch the fused conv: CNHW ``x`` [C, B, H, W] with ``values``
    [n_tiles, k_kept, T] / ``idx`` [n_tiles, k_kept] over the (kh, kw, c)
    rows -> [O, n_strips*V], zero past the last position."""
    check_cuda_tensor("x", x, FLOAT_DTYPES, 4)
    n_tiles, k_kept, tile = values.shape
    block_k = min(block_k, k_kept)
    check_compressed(values, idx, x.dtype, block_k,
                     fused_smem_bytes(tile, block_k))
    check_same_device(x, values, idx)
    c, b, h, w = x.shape
    ho, wo, n_strips = _conv_out(x, kh, kw, stride, pad, v)
    out = torch.empty((n_tiles * tile, n_strips * v), dtype=x.dtype,
                      device=x.device)
    CONV2D_FUSED.launch(
        x.device, x.data_ptr(), values.data_ptr(), idx.data_ptr(),
        out.data_ptr(), DTYPE_CODE[x.dtype], c, b, h, w, kh, kw, stride, pad,
        ho, wo, v, n_strips, n_tiles, k_kept, tile, block_k)
    return out


def conv2d_fused_banded_cuda(x: torch.Tensor, values: torch.Tensor,
                             idx: torch.Tensor, *, kh: int, kw: int,
                             stride: int = 1, pad: int = 0, v: int = 128,
                             block_k: int = 128, hb: int = 2) -> torch.Tensor:
    """Launch the banded conv: the fused conv's function with only two
    ``[C, band_rows, W]`` windows of the map (bands of ``hb`` strips) in
    shared memory.  Takes a map whose rows are a multiple of 4 bytes."""
    check_cuda_tensor("x", x, FLOAT_DTYPES, 4)
    c, b, h, w = x.shape
    if (w * x.element_size()) % 4:
        raise ValueError(f"map rows of W={w} {x.dtype} elements are not a "
                         "multiple of 4 bytes")
    ho, wo, n_strips = _conv_out(x, kh, kw, stride, pad, v)
    n_tiles, k_kept, tile = values.shape
    block_k = min(block_k, k_kept)
    hb = max(min(hb, n_strips), 1)
    n_bands, band_rows = band_plan(b=b, h=h, kh=kh, stride=stride, pad=pad,
                                   ho=ho, wo=wo, v=v, hb=hb)
    smem = banded_smem_bytes(c, w, band_rows, block_k, x.element_size())
    check_compressed(values, idx, x.dtype, block_k, smem)
    check_same_device(x, values, idx)
    out = torch.empty((n_tiles * tile, n_strips * v), dtype=x.dtype,
                      device=x.device)
    CONV2D_FUSED_BANDED.launch(
        x.device, x.data_ptr(), values.data_ptr(), idx.data_ptr(),
        out.data_ptr(), DTYPE_CODE[x.dtype], c, b, h, w, kh, kw, stride, pad,
        ho, wo, v, n_strips, n_tiles, k_kept, tile, block_k, hb, band_rows,
        n_bands, smem_bytes=smem)
    return out
