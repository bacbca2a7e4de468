"""Strip-major column-wise N:M sparse GEMM on Hopper
(``csrc/colwise_nm_strips.cu``)."""
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

COLWISE_NM_STRIPS = CudaKernel(
    "colwise_nm_matmul_strips", "repro_colwise_nm_strips",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8,
    source="src/repro_torch/csrc/colwise_nm_strips.cu",
    replaces=("src/repro/kernels/colwise_nm/kernel.py:143 "
              "colwise_nm_matmul_strips_pallas"),
)


def colwise_nm_matmul_strips_cuda(strips: torch.Tensor, values: torch.Tensor,
                                  idx: torch.Tensor, *,
                                  block_k: int = 128) -> torch.Tensor:
    """Launch the strip GEMM: [n_strips, K, V] strips -> [n_tiles*T, n_strips*V]."""
    check_cuda_tensor("strips", strips, FLOAT_DTYPES, 3)
    n_tiles, k_kept, tile = values.shape
    block_k = min(block_k, k_kept)
    check_compressed(values, idx, strips.dtype, block_k, 4 * tile + 4)
    if values.device != strips.device or idx.device != strips.device:
        raise ValueError("strips, values and idx must be on one device")
    n_strips, k_rows, v = strips.shape
    out = torch.empty((n_tiles * tile, n_strips * v), dtype=strips.dtype,
                      device=strips.device)
    COLWISE_NM_STRIPS.launch(
        strips.device, strips.data_ptr(), values.data_ptr(), idx.data_ptr(),
        out.data_ptr(), DTYPE_CODE[strips.dtype], n_strips, k_rows, v,
        n_tiles, k_kept, tile, block_k)
    return out
