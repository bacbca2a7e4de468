"""Column-wise N:M sparse GEMMs on Hopper: the linear layer
(``csrc/colwise_nm_linear.cu``, any tile width), its register-tiled,
double-buffered twin for tile widths that are a multiple of 64
(``csrc/colwise_nm_linear_tiled.cu``), the strip-major GEMM of the
two-kernel conv plan (``csrc/colwise_nm_strips.cu``) and its pipelined twin
(``csrc/colwise_nm_strips_pipelined.cu``).

Each ``*_smem_bytes`` function is the shared memory its kernel's launch
requests: the wrapper sizes the launch with it, the C side refuses any other
size, and the dispatch registry's feasibility predicates call the same
function.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import (
    DTYPE_CODE,
    FLOAT_DTYPES,
    KROWS,
    KTHREADS,
    CudaKernel,
    check_compressed,
    check_cuda_tensor,
    check_no_grad,
    check_same_device,
)

COLWISE_NM_STRIPS = CudaKernel(
    "colwise_nm_matmul_strips", "repro_colwise_nm_strips",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8,
    source="src/repro_torch/csrc/colwise_nm_strips.cu",
    replaces=("src/repro/kernels/colwise_nm/kernel.py:143 "
              "colwise_nm_matmul_strips_pallas"),
)

COLWISE_NM_LINEAR = CudaKernel(
    "colwise_nm_matmul", "repro_colwise_nm_linear",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8,
    source="src/repro_torch/csrc/colwise_nm_linear.cu",
    replaces="src/repro/kernels/colwise_nm/kernel.py:65 colwise_nm_matmul_pallas",
    sized_smem=True,
)

COLWISE_NM_LINEAR_TILED = CudaKernel(
    "colwise_nm_matmul_tiled", "repro_colwise_nm_linear_tiled",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7,
    source="src/repro_torch/csrc/colwise_nm_linear_tiled.cu",
    replaces="src/repro/kernels/colwise_nm/kernel.py:65 colwise_nm_matmul_pallas",
    sized_smem=True,
)

COLWISE_NM_STRIPS_PIPELINED = CudaKernel(
    "colwise_nm_matmul_strips_pipelined", "repro_colwise_nm_strips_pipelined",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9,
    source="src/repro_torch/csrc/colwise_nm_strips_pipelined.cu",
    replaces=("src/repro/kernels/colwise_nm/kernel.py:261 "
              "colwise_nm_matmul_strips_pipelined_pallas"),
    sized_smem=True,
)

MAX_PIPELINED_V = 2 * KTHREADS  # columns a block's threads cover per strip
LINEAR_CHUNK = 32  # columns of T per linear block (csrc/colwise_nm_linear.cu)
MAX_BLOCK_B = 256  # rows per linear block: 32 row lanes x 8 rows a thread
# csrc/colwise_nm_linear_tiled.cu: columns of T and kept rows per step of a
# block, its rows per block (the BM template instances), and one block on
# each of the H100's 132 SMs
TILED_BN, TILED_BK = 64, 32
TILED_BLOCK_ROWS = (16, 64, 128)
TILED_WAVE_BLOCKS = 132


def strips_smem_bytes(tile: int, block_k: int) -> int:
    """Shared memory of one strip-GEMM launch: a ``block_k`` chunk of
    ``values[t]`` in f32 and its indices."""
    return block_k * (4 * tile + 4)


def linear_smem_bytes(tile: int, block_b: int, block_k: int) -> int:
    """Shared memory of one linear launch: for a ``block_k`` chunk of kept
    rows, the gathered activations of ``block_b`` rows (rows padded by one
    against bank conflicts), the values of one column chunk (at most 32
    columns of T, so it does not grow with T) and the indices, all 4 bytes
    wide."""
    return block_k * (block_b + 1 + min(tile, LINEAR_CHUNK) + 1) * 4


def linear_tiled_smem_bytes(bm: int, bk: int, itemsize: int) -> int:
    """Shared memory of one tiled linear launch: two stages of the gathered
    activations of ``bm`` rows for ``bk`` kept rows in f32 (rows padded by 4
    floats against bank conflicts) and of the ``[bk, 64]`` values tile in
    the operands' dtype."""
    return 2 * bk * ((bm + 4) * 4 + TILED_BN * itemsize)


def tiled_block_rows(n_rows: int, d_out: int) -> int:
    """Rows per block of the tiled linear (its template parameter BM), a
    rule of the shape alone.  A block's k-steps take longer the more rows it
    holds, and under one block per SM the steps' latency, not the FMAs, sets
    the time; so take the smallest BM, 16 then 64, whose grid,
    ``ceil(n_rows / BM) * d_out / 64`` blocks, puts at most one block on
    each SM (``TILED_WAVE_BLOCKS``) or that holds every row already, and 128
    beyond, where the 8 x 4 register tile of a thread reuses each staged
    value most.  Fitted to ``repro_torch.kernels.colwise_nm.tune``'s sweep
    of smollm-360m's linear shapes on the H100 (PERF.md).  It rises with
    ``n_rows``, so a dispatch key's bucketed row count never asks for less
    shared memory than the launch."""
    cols = d_out // TILED_BN
    for bm in TILED_BLOCK_ROWS[:-1]:
        if n_rows <= bm or -(-n_rows // bm) * cols <= TILED_WAVE_BLOCKS:
            return bm
    return TILED_BLOCK_ROWS[-1]


def pipelined_smem_bytes(v: int, block_k: int, itemsize: int) -> int:
    """Shared memory of one pipelined strip-GEMM launch: two ring slots, each
    a ``[block_k, V]`` slice of gathered strip rows and its f32 values for
    KROWS output rows."""
    return 2 * block_k * v * itemsize + 2 * block_k * KROWS * 4


def colwise_nm_matmul_strips_cuda(strips: torch.Tensor, values: torch.Tensor,
                                  idx: torch.Tensor, *,
                                  block_k: int = 128) -> torch.Tensor:
    """Launch the strip GEMM: [n_strips, K, V] strips -> [n_tiles*T, n_strips*V]."""
    check_no_grad("colwise_nm_matmul_strips", strips, values)
    check_cuda_tensor("strips", strips, FLOAT_DTYPES, 3)
    n_tiles, k_kept, tile = values.shape
    block_k = min(block_k, k_kept)
    check_compressed(values, idx, strips.dtype, block_k,
                     strips_smem_bytes(tile, block_k))
    check_same_device(strips, values, idx)
    n_strips, k_rows, v = strips.shape
    out = torch.empty((n_tiles * tile, n_strips * v), dtype=strips.dtype,
                      device=strips.device)
    COLWISE_NM_STRIPS.launch(
        strips.device, strips.data_ptr(), values.data_ptr(), idx.data_ptr(),
        out.data_ptr(), DTYPE_CODE[strips.dtype], n_strips, k_rows, v,
        n_tiles, k_kept, tile, block_k)
    return out


def colwise_nm_matmul_cuda(x: torch.Tensor, values: torch.Tensor,
                           idx: torch.Tensor, *, block_b: int = 128,
                           block_k: int = 128) -> torch.Tensor:
    """Launch the sparse linear: x [B, d_in] -> [B, n_tiles*T];
    ``block_b`` rows per block, ``block_k`` kept rows staged at a time."""
    check_no_grad("colwise_nm_matmul", x, values)
    check_cuda_tensor("x", x, FLOAT_DTYPES, 2)
    if not 0 < block_b <= MAX_BLOCK_B:
        raise ValueError(f"block_b={block_b} must be in [1, {MAX_BLOCK_B}]")
    n_tiles, k_kept, tile = values.shape
    block_k = min(block_k, k_kept)
    smem = linear_smem_bytes(tile, block_b, block_k)
    check_compressed(values, idx, x.dtype, block_k, smem)
    check_same_device(x, values, idx)
    n_rows, d_in = x.shape
    out = torch.empty((n_rows, n_tiles * tile), dtype=x.dtype, device=x.device)
    if n_rows == 0:
        return out
    COLWISE_NM_LINEAR.launch(
        x.device, x.data_ptr(), values.data_ptr(), idx.data_ptr(),
        out.data_ptr(), DTYPE_CODE[x.dtype], n_rows, d_in, n_tiles, k_kept,
        tile, block_b, block_k, smem_bytes=smem)
    return out


def colwise_nm_matmul_tiled_cuda(x: torch.Tensor, values: torch.Tensor,
                                 idx: torch.Tensor, *,
                                 block_rows: Optional[int] = None
                                 ) -> torch.Tensor:
    """Launch the tiled sparse linear: x [B, d_in] -> [B, n_tiles*T], the
    same function and bits as :func:`colwise_nm_matmul_cuda`.  Takes T a
    multiple of 64 and 16-byte aligned ``x`` and ``values``.  The rows per
    block are ``block_rows`` (16, 64 or 128; every choice gives the same
    bits), by default :func:`tiled_block_rows`'s."""
    check_no_grad("colwise_nm_matmul_tiled", x, values)
    check_cuda_tensor("x", x, FLOAT_DTYPES, 2)
    n_tiles, k_kept, tile = values.shape
    if tile % TILED_BN:
        raise ValueError(f"tile width T={tile} must be a multiple of "
                         f"{TILED_BN}")
    n_rows, d_in = x.shape
    bm = (tiled_block_rows(n_rows, n_tiles * tile) if block_rows is None
          else block_rows)
    if bm not in TILED_BLOCK_ROWS:
        raise ValueError(f"block_rows={bm} must be one of {TILED_BLOCK_ROWS}")
    smem = linear_tiled_smem_bytes(bm, TILED_BK, x.element_size())
    check_compressed(values, idx, x.dtype, TILED_BK, smem)
    check_same_device(x, values, idx)
    if x.data_ptr() % 16 or values.data_ptr() % 16:
        raise ValueError("x and values must be 16-byte aligned")
    out = torch.empty((n_rows, n_tiles * tile), dtype=x.dtype, device=x.device)
    if n_rows == 0:
        return out
    COLWISE_NM_LINEAR_TILED.launch(
        x.device, x.data_ptr(), values.data_ptr(), idx.data_ptr(),
        out.data_ptr(), DTYPE_CODE[x.dtype], n_rows, d_in, n_tiles, k_kept,
        tile, bm, smem_bytes=smem)
    return out


def colwise_nm_matmul_strips_pipelined_cuda(strips: torch.Tensor,
                                            values: torch.Tensor,
                                            idx: torch.Tensor, *,
                                            block_k: int = 128,
                                            hb: int = 2) -> torch.Tensor:
    """Launch the pipelined strip GEMM: the strip GEMM's function with
    ``hb`` strips per block and a two-slot cp.async ring of gathered rows.
    Takes V <= 256 with V * itemsize a multiple of 16 bytes."""
    check_no_grad("colwise_nm_matmul_strips_pipelined", strips, values)
    check_cuda_tensor("strips", strips, FLOAT_DTYPES, 3)
    n_strips, k_rows, v = strips.shape
    if v > MAX_PIPELINED_V or (v * strips.element_size()) % 16:
        raise ValueError(f"strip width V={v} must be at most {MAX_PIPELINED_V} "
                         "with V * itemsize a multiple of 16 bytes")
    if strips.data_ptr() % 16:
        raise ValueError("strips must be 16-byte aligned")
    n_tiles, k_kept, tile = values.shape
    block_k = min(block_k, k_kept)
    smem = pipelined_smem_bytes(v, block_k, strips.element_size())
    check_compressed(values, idx, strips.dtype, block_k, smem)
    check_same_device(strips, values, idx)
    hb = max(min(hb, n_strips), 1)
    out = torch.empty((n_tiles * tile, n_strips * v), dtype=strips.dtype,
                      device=strips.device)
    COLWISE_NM_STRIPS_PIPELINED.launch(
        strips.device, strips.data_ptr(), values.data_ptr(), idx.data_ptr(),
        out.data_ptr(), DTYPE_CODE[strips.dtype], n_strips, k_rows, v,
        n_tiles, k_kept, tile, block_k, hb, smem_bytes=smem)
    return out
