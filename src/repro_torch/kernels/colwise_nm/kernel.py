"""Column-wise N:M sparse GEMMs on Hopper: the linear layer
(``csrc/colwise_nm_linear.cu``, any tile width), its register-tiled,
double-buffered twin for tile widths that are a multiple of 64
(``csrc/colwise_nm_linear_tiled.cu``), the strip-major GEMM of the
two-kernel conv plan and its pipelined twin.  The strip GEMMs take
``csrc/colwise_nm_strips_tiled.cu`` (one register-tiled kernel over a
``cp.async`` ring of gathered strip rows, one strip or ``hb`` strips a
block) where :func:`strips_tiled_takes` holds, and
``csrc/colwise_nm_strips.cu`` / ``csrc/colwise_nm_strips_pipelined.cu``
elsewhere; all give the same bits.

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
    SMEM_BYTES,
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

COLWISE_NM_STRIPS_TILED = CudaKernel(
    "colwise_nm_matmul_strips_tiled", "repro_colwise_nm_strips_tiled",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9,
    source="src/repro_torch/csrc/colwise_nm_strips_tiled.cu",
    replaces=("src/repro/kernels/colwise_nm/kernel.py:143 "
              "colwise_nm_matmul_strips_pallas"),
    sized_smem=True,
)

COLWISE_NM_STRIPS_PIPELINED_TILED = CudaKernel(
    "colwise_nm_matmul_strips_pipelined_tiled",
    "repro_colwise_nm_strips_pipelined_tiled",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11,
    source="src/repro_torch/csrc/colwise_nm_strips_tiled.cu",
    replaces=("src/repro/kernels/colwise_nm/kernel.py:261 "
              "colwise_nm_matmul_strips_pipelined_pallas"),
    sized_smem=True,
)

MAX_PIPELINED_V = 2 * KTHREADS  # columns a block's threads cover per strip
LINEAR_CHUNK = 32  # columns of T per linear block (csrc/colwise_nm_linear.cu)
MAX_BLOCK_B = 256  # rows per linear block: 32 row lanes x 8 rows a thread
H100_SMS = 132
# csrc/colwise_nm_linear_tiled.cu: columns of T and kept rows per step of a
# block, its rows per block (the BM template instances), and one block on
# each of the H100's SMs
TILED_BN, TILED_BK = 64, 32
TILED_BLOCK_ROWS = (16, 64, 128)
TILED_WAVE_BLOCKS = H100_SMS


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


def colwise_nm_matmul_strips_scalar_cuda(strips: torch.Tensor,
                                         values: torch.Tensor,
                                         idx: torch.Tensor, *,
                                         block_k: int = 128) -> torch.Tensor:
    """Launch ``csrc/colwise_nm_strips.cu``: [n_strips, K, V] strips ->
    [n_tiles*T, n_strips*V], ``block_k`` kept rows staged at a time.
    :func:`colwise_nm_matmul_strips_cuda` routes to it the calls
    :func:`strips_tiled_takes` refuses; called directly, it is the bitwise
    yardstick of the tiled kernel."""
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


def colwise_nm_matmul_strips_pipelined_scalar_cuda(
        strips: torch.Tensor, values: torch.Tensor, idx: torch.Tensor, *,
        block_k: int = 128, hb: int = 2) -> torch.Tensor:
    """Launch ``csrc/colwise_nm_strips_pipelined.cu``: the strip GEMM's
    function with ``hb`` strips per block and a two-slot cp.async ring of
    gathered rows.  Takes V <= 256 with V * itemsize a multiple of 16 bytes.
    :func:`colwise_nm_matmul_strips_pipelined_cuda` routes to it the calls
    :func:`strips_tiled_takes` refuses; called directly, it is the bitwise
    yardstick of the tiled kernel."""
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


# ---------------------------------------------------------------------------
# csrc/colwise_nm_strips_tiled.cu: the strip GEMMs' register-tiled kernel
# ---------------------------------------------------------------------------

# its instances (columns a thread), its ring (slots of 16 kept rows), and
# its threads a block at most
STRIPS_TILED_CPT = (1, 2, 4)
STRIPS_TILED_STAGES, STRIPS_TILED_BK = 2, 16
STRIPS_TILED_THREADS = 256
# the instance rule: threads it wants resident on each SM, and an H100 SM's
# shared memory (1 KB of it reserved a block), threads and blocks
STRIPS_TILED_SM_THREADS = 224
SM_SMEM_BYTES, SM_THREADS, SM_BLOCKS = 228 * 1024, 2048, 32


def strips_tiled_smem_bytes(k_kept: int, tile: int, rg: int, v: int,
                            itemsize: int, lanes: int = 1) -> int:
    """Shared memory of one tiled strip-GEMM launch: the tile's values,
    rows padded to whole passes of ``rg`` 8-row groups, and the ring of
    slices of 16 gathered rows by ``v`` columns for each of ``lanes``
    strips, both in the operands' dtype, and the tile's indices."""
    groups = -(-tile // KROWS)
    tp = -(-groups // rg) * rg * KROWS
    ring = STRIPS_TILED_STAGES * lanes * STRIPS_TILED_BK * v
    return (k_kept * tp + ring) * itemsize + 4 * k_kept


def _strips_tiled_launch(n_strips, v, n_tiles, k_kept, tile, itemsize, hb,
                         cpt, lanes) -> Optional[dict]:
    """The launch of instance ``cpt`` (``lanes`` strip lanes, by default as
    many of ``hb`` as 256 threads hold), or ``None`` where it does not fit."""
    nc = v // cpt
    if cpt not in STRIPS_TILED_CPT or v % cpt or nc > STRIPS_TILED_THREADS:
        return None
    rg = max(1, min(-(-tile // KROWS), STRIPS_TILED_THREADS // nc))
    if lanes is None:
        lanes = max(1, min(hb, STRIPS_TILED_THREADS // (nc * rg)))
    smem = strips_tiled_smem_bytes(k_kept, tile, rg, v, itemsize, lanes)
    if (not 1 <= lanes <= hb or nc * rg * lanes > STRIPS_TILED_THREADS
            or smem > SMEM_BYTES):
        return None
    return dict(hb=hb, lanes=lanes, cpt=cpt, rg=rg, threads=nc * rg * lanes,
                smem=smem, blocks=-(-n_strips // hb) * n_tiles)


def strips_tiled_sm_threads(geo: dict) -> float:
    """Threads of a launch resident on each of the H100's SMs: its blocks
    spread over the SMs, as many as a SM's shared memory, threads and block
    slots hold."""
    per_sm = min(geo["blocks"] / H100_SMS,
                 SM_SMEM_BYTES // (geo["smem"] + 1024),
                 SM_THREADS // geo["threads"], SM_BLOCKS)
    return per_sm * geo["threads"]


def strips_tiled_config(n_strips: int, v: int, n_tiles: int, k_kept: int,
                        tile: int, itemsize: int, hb: int) -> Optional[tuple]:
    """The tiled strip GEMM's default instance for a shape, ``(cpt,
    lanes)``, or ``None`` where no instance fits: a rule of the shape
    alone, fitted to ``repro_torch.kernels.colwise_nm.tune``'s sweep on the
    H100 (PERF.md).  A block's time is its warps' serial slices, so an SM
    wants threads: the most columns a thread (4, 2 then 1 in bf16; 2 then 1
    in f32, where 4 never won) that keep ``STRIPS_TILED_SM_THREADS``
    threads resident on each SM (:func:`strips_tiled_sm_threads`), else 1,
    with all of a block's ``hb`` strips side by side."""
    pick = None
    for cpt in (4, 2, 1) if itemsize == 2 else (2, 1):
        geo = _strips_tiled_launch(n_strips, v, n_tiles, k_kept, tile,
                                   itemsize, hb, cpt, None)
        if geo is not None:
            pick = (cpt, geo["lanes"])
            if strips_tiled_sm_threads(geo) >= STRIPS_TILED_SM_THREADS:
                break
    return pick


def strips_tiled_geometry(n_strips: int, v: int, n_tiles: int, k_kept: int,
                          tile: int, itemsize: int, hb: int = 1, *,
                          cpt: Optional[int] = None,
                          lanes: Optional[int] = None) -> Optional[dict]:
    """The tiled strip GEMM's launch for this shape, or ``None`` where the
    kernel takes no such shape: strip rows of whole 16-byte copies, at most
    256 threads for one 8-row group of one strip (``v / cpt``), and the
    staged values plus the ring within a block's shared memory.  The
    instance is :func:`strips_tiled_config`'s unless given, its lanes as
    many of ``hb`` as 256 threads hold unless given.  ``rg`` is the 8-row
    groups the block's threads take at once, all of the tile's where 256
    threads allow."""
    if (n_strips <= 0 or v <= 0 or n_tiles <= 0 or k_kept <= 0 or tile <= 0
            or (v * itemsize) % 16):
        return None
    hb = max(min(hb, n_strips), 1)
    if cpt is None:
        config = strips_tiled_config(n_strips, v, n_tiles, k_kept, tile,
                                     itemsize, hb)
        if config is None:
            return None
        cpt = config[0]
    return _strips_tiled_launch(n_strips, v, n_tiles, k_kept, tile, itemsize,
                                hb, cpt, lanes)


def _strips_geometry_of(strips: torch.Tensor, values: torch.Tensor, hb: int,
                        **instance) -> Optional[dict]:
    if (strips.dim() != 3 or values.dim() != 3
            or strips.dtype not in FLOAT_DTYPES or strips.data_ptr() % 16):
        return None
    n_strips, _, v = strips.shape
    n_tiles, k_kept, tile = values.shape
    return strips_tiled_geometry(n_strips, v, n_tiles, k_kept, tile,
                                 strips.element_size(), hb, **instance)


def strips_tiled_takes(strips: torch.Tensor, values: torch.Tensor, *,
                       hb: int = 1) -> bool:
    """Whether the tiled strip GEMM takes this call (``hb`` strips a block):
    the shape rule of :func:`strips_tiled_geometry` and 16-byte aligned
    strips.  A rule of the shape and the pointer alone: the wrappers never
    react to a failed build or launch."""
    return _strips_geometry_of(strips, values, hb) is not None


def _launch_strips_tiled(kernel: CudaKernel, strips, values, idx, geo,
                         pipelined: bool) -> torch.Tensor:
    """The tiled strip-GEMM launch of ``kernel`` for a geometry
    :func:`strips_tiled_geometry` gave for ``strips`` and ``values``."""
    check_compressed(values, idx, strips.dtype, STRIPS_TILED_BK, geo["smem"])
    check_same_device(strips, values, idx)
    n_strips, k_rows, v = strips.shape
    n_tiles, k_kept, tile = values.shape
    out = torch.empty((n_tiles * tile, n_strips * v), dtype=strips.dtype,
                      device=strips.device)
    strips_a_block = (geo["hb"], geo["lanes"]) if pipelined else ()
    kernel.launch(
        strips.device, strips.data_ptr(), values.data_ptr(), idx.data_ptr(),
        out.data_ptr(), DTYPE_CODE[strips.dtype], n_strips, k_rows, v,
        n_tiles, k_kept, tile, *strips_a_block, geo["cpt"], geo["rg"],
        smem_bytes=geo["smem"])
    return out


def _refused(strips, values, hb) -> ValueError:
    return ValueError(
        f"strips {tuple(strips.shape)} {strips.dtype}, values "
        f"{tuple(values.shape)}, hb {hb}: the tiled strip GEMM takes strip "
        "rows of whole 16-byte copies, 16-byte aligned strips, at most "
        f"{STRIPS_TILED_THREADS} threads for one 8-row group of one strip, "
        "1 to hb strip lanes within them, the values and the ring within "
        f"{SMEM_BYTES} bytes of shared memory, and cpt in {STRIPS_TILED_CPT}")


def colwise_nm_matmul_strips_tiled_cuda(strips: torch.Tensor,
                                        values: torch.Tensor,
                                        idx: torch.Tensor, *,
                                        cpt: Optional[int] = None
                                        ) -> torch.Tensor:
    """Launch ``csrc/colwise_nm_strips_tiled.cu`` with one strip a block:
    the strip GEMM's function and bits for the calls
    :func:`strips_tiled_takes` accepts (raises on any other).  The instance,
    ``cpt`` columns a thread (each gives the same bits), is by default
    :func:`strips_tiled_config`'s."""
    check_no_grad("colwise_nm_matmul_strips_tiled", strips, values)
    check_cuda_tensor("strips", strips, FLOAT_DTYPES, 3)
    geo = _strips_geometry_of(strips, values, 1, cpt=cpt)
    if geo is None:
        raise _refused(strips, values, 1)
    return _launch_strips_tiled(COLWISE_NM_STRIPS_TILED, strips, values, idx,
                                geo, pipelined=False)


def colwise_nm_matmul_strips_pipelined_tiled_cuda(
        strips: torch.Tensor, values: torch.Tensor, idx: torch.Tensor, *,
        hb: int = 2, cpt: Optional[int] = None,
        lanes: Optional[int] = None) -> torch.Tensor:
    """Launch ``csrc/colwise_nm_strips_tiled.cu`` with ``hb`` strips a block,
    ``lanes`` of them side by side and the ring running across the steps:
    the pipelined strip GEMM's function and bits for the calls
    :func:`strips_tiled_takes` accepts at ``hb`` (raises on any other); the
    instance as in :func:`colwise_nm_matmul_strips_tiled_cuda`, ``lanes``
    (1 .. hb; each gives the same bits) by default
    :func:`strips_tiled_config`'s."""
    check_no_grad("colwise_nm_matmul_strips_pipelined_tiled", strips, values)
    check_cuda_tensor("strips", strips, FLOAT_DTYPES, 3)
    geo = _strips_geometry_of(strips, values, hb, cpt=cpt, lanes=lanes)
    if geo is None:
        raise _refused(strips, values, hb)
    return _launch_strips_tiled(COLWISE_NM_STRIPS_PIPELINED_TILED, strips,
                                values, idx, geo, pipelined=True)


def colwise_nm_matmul_strips_cuda(strips: torch.Tensor, values: torch.Tensor,
                                  idx: torch.Tensor, *,
                                  block_k: int = 128) -> torch.Tensor:
    """Launch the strip GEMM: [n_strips, K, V] strips -> [n_tiles*T,
    n_strips*V].  Takes the tiled kernel (one strip a block) where
    :func:`strips_tiled_takes` says so, and ``colwise_nm_strips.cu``
    elsewhere; both give the same bits, and a failed launch raises.
    ``block_k`` chunks only the other kernel's staged values: the tiled
    kernel stages all of a tile's values once, so it does not change the
    tiled launch."""
    check_no_grad("colwise_nm_matmul_strips", strips, values)
    check_cuda_tensor("strips", strips, FLOAT_DTYPES, 3)
    geo = _strips_geometry_of(strips, values, 1)
    if geo is not None:
        return _launch_strips_tiled(COLWISE_NM_STRIPS_TILED, strips, values,
                                    idx, geo, pipelined=False)
    return colwise_nm_matmul_strips_scalar_cuda(strips, values, idx,
                                                block_k=block_k)


def colwise_nm_matmul_strips_pipelined_cuda(strips: torch.Tensor,
                                            values: torch.Tensor,
                                            idx: torch.Tensor, *,
                                            block_k: int = 128,
                                            hb: int = 2) -> torch.Tensor:
    """Launch the pipelined strip GEMM: the strip GEMM's function with
    ``hb`` strips per block, the gathered rows copied ahead of the
    multiply.  Takes the tiled kernel where :func:`strips_tiled_takes` says
    so at ``hb``, and ``colwise_nm_strips_pipelined.cu`` elsewhere (V <=
    256, V * itemsize a multiple of 16 bytes); both give the same bits, and
    a failed launch raises.  ``block_k`` sizes only the other kernel's ring
    slices; it does not change the tiled launch."""
    check_no_grad("colwise_nm_matmul_strips_pipelined", strips, values)
    check_cuda_tensor("strips", strips, FLOAT_DTYPES, 3)
    geo = _strips_geometry_of(strips, values, hb)
    if geo is not None:
        return _launch_strips_tiled(COLWISE_NM_STRIPS_PIPELINED_TILED, strips,
                                    values, idx, geo, pipelined=True)
    return colwise_nm_matmul_strips_pipelined_scalar_cuda(
        strips, values, idx, block_k=block_k, hb=hb)
