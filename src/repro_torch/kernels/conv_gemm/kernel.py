"""Fused im2col + pack + sparse GEMM convs on Hopper; the packed strips never
reach device memory.

Two whole-map kernels with the same bits: ``csrc/conv2d_fused_tiled.cu``
(dense im2col slices gathered once a block for a group of tiles) for the
shapes :func:`fused_tiled_takes` accepts, and ``csrc/conv2d_fused.cu`` for
the others; :func:`conv2d_fused_cuda` routes between them by that rule of
the shape.  Two banded kernels, again with the same bits:
``csrc/conv2d_fused_banded_tiled.cu`` (register-tiled over a zero-padded
window) for the shapes :func:`banded_tiled_takes` accepts and
``csrc/conv2d_fused_banded.cu`` for the others; :func:`conv2d_fused_banded_cuda`
routes between them.

Each ``*_smem_bytes`` function is the shared memory its kernel's launch
requests, and what the dispatch registry's feasibility predicate compares
with a block's 227 KB.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels._build import (
    DTYPE_CODE,
    FLOAT_DTYPES,
    KROWS,
    SMEM_BYTES,
    CudaKernel,
    check_compressed,
    check_cuda_tensor,
    check_no_grad,
    check_same_device,
)
from repro_torch.kernels.colwise_nm.kernel import (H100_SMS, SM_BLOCKS,
                                                   SM_SMEM_BYTES, SM_THREADS)
from repro_torch.kernels.conv_gemm.plan import band_plan, tiled_band_plan
from repro_torch.kernels.im2col_pack.ref import out_size

CONV2D_FUSED = CudaKernel(
    "conv2d_fused", "repro_conv2d_fused",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 17,
    source="src/repro_torch/csrc/conv2d_fused.cu",
    replaces="src/repro/kernels/conv_gemm/kernel.py:99 conv2d_fused_pallas",
)

CONV2D_FUSED_TILED = CudaKernel(
    "conv2d_fused_tiled", "repro_conv2d_fused_tiled",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 19,
    source="src/repro_torch/csrc/conv2d_fused_tiled.cu",
    replaces="src/repro/kernels/conv_gemm/kernel.py:99 conv2d_fused_pallas",
    sized_smem=True,
)

CONV2D_FUSED_BANDED = CudaKernel(
    "conv2d_fused_banded", "repro_conv2d_fused_banded",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 20,
    source="src/repro_torch/csrc/conv2d_fused_banded.cu",
    replaces=("src/repro/kernels/conv_gemm/kernel.py:300 "
              "conv2d_fused_banded_pallas"),
    sized_smem=True,
)

CONV2D_FUSED_BANDED_TILED = CudaKernel(
    "conv2d_fused_banded_tiled", "repro_conv2d_fused_banded_tiled",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 24,
    source="src/repro_torch/csrc/conv2d_fused_banded_tiled.cu",
    replaces=("src/repro/kernels/conv_gemm/kernel.py:300 "
              "conv2d_fused_banded_pallas"),
    sized_smem=True,
)

# csrc/conv2d_fused_banded_tiled.cu's instances: positions a thread, each
# thread of a 256-thread block accumulating one 8-row group of a tile
BANDED_TILED_POSITIONS = (2, 4)
BANDED_TILED_ROWS = 8


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


def _check_fused(x, values, idx, kh, kw, stride, pad, v, block_k):
    """The checks of both whole-map fused-conv wrappers, in their order;
    returns ``(block_k, ho, wo, n_strips)`` with ``block_k`` clamped to
    k_kept."""
    check_no_grad("conv2d_fused", x, values)
    check_cuda_tensor("x", x, FLOAT_DTYPES, 4)
    n_tiles, k_kept, tile = values.shape
    block_k = min(block_k, k_kept)
    check_compressed(values, idx, x.dtype, block_k,
                     fused_smem_bytes(tile, block_k))
    check_same_device(x, values, idx)
    return (block_k, *_conv_out(x, kh, kw, stride, pad, v))


def _launch_scalar(x, values, idx, kh, kw, stride, pad, v, block_k, ho, wo,
                   n_strips) -> torch.Tensor:
    c, b, h, w = x.shape
    n_tiles, k_kept, tile = values.shape
    out = torch.empty((n_tiles * tile, n_strips * v), dtype=x.dtype,
                      device=x.device)
    CONV2D_FUSED.launch(
        x.device, x.data_ptr(), values.data_ptr(), idx.data_ptr(),
        out.data_ptr(), DTYPE_CODE[x.dtype], c, b, h, w, kh, kw, stride, pad,
        ho, wo, v, n_strips, n_tiles, k_kept, tile, block_k)
    return out


def conv2d_fused_scalar_cuda(x: torch.Tensor, values: torch.Tensor,
                             idx: torch.Tensor, *, kh: int, kw: int,
                             stride: int = 1, pad: int = 0, v: int = 128,
                             block_k: int = 128) -> torch.Tensor:
    """Launch ``csrc/conv2d_fused.cu``: CNHW ``x`` [C, B, H, W] with
    ``values`` [n_tiles, k_kept, T] / ``idx`` [n_tiles, k_kept] over the
    (kh, kw, c) rows -> [O, n_strips*V], zero past the last position, one
    block per (strip, tile), staging ``block_k`` kept rows at a time.
    :func:`conv2d_fused_cuda` routes to it the calls
    :func:`fused_tiled_takes` refuses; called directly, it is the bitwise
    yardstick of the tiled kernel."""
    geo = _check_fused(x, values, idx, kh, kw, stride, pad, v, block_k)
    return _launch_scalar(x, values, idx, kh, kw, stride, pad, v, *geo)


def conv2d_fused_cuda(x: torch.Tensor, values: torch.Tensor, idx: torch.Tensor,
                      *, kh: int, kw: int, stride: int = 1, pad: int = 0,
                      v: int = 128, block_k: int = 128) -> torch.Tensor:
    """Launch a whole-map fused conv: CNHW ``x`` [C, B, H, W] with
    ``values`` [n_tiles, k_kept, T] / ``idx`` [n_tiles, k_kept] over the
    (kh, kw, c) rows -> [O, n_strips*V], zero past the last position.
    After the checks of ``conv2d_fused.cu`` (``block_k`` chunks its staged
    values, and must be positive), takes the tiled kernel where
    :func:`fused_tiled_takes` says so and ``conv2d_fused.cu`` elsewhere;
    both give the same bits, and a failed launch raises."""
    block_k, ho, wo, n_strips = _check_fused(x, values, idx, kh, kw, stride,
                                             pad, v, block_k)
    geo = _fused_tiled_geometry_of(x, values, kh, kw, stride, pad, v)
    if geo is not None:
        return _launch_fused_tiled(x, values, idx, geo, kh, kw, stride, pad, v)
    return _launch_scalar(x, values, idx, kh, kw, stride, pad, v, block_k, ho,
                          wo, n_strips)


# csrc/conv2d_fused_tiled.cu's instances: cpt (a block runs 32 * cpt
# positions; a thread 4 rows x 2 * cpt of them), tiles a block (one warp a
# tile's 8-row group, at most 256 threads) and dense im2col rows a slice
FUSED_TILED_CPT = (1, 2, 4)
FUSED_TILED_GROUPS = tuple(range(1, 9))  # the tiles a block the sweep times
FUSED_TILED_BKS = (16, 32, 64, 128)
FUSED_TILED_THREADS = 256
FUSED_TILED_HELD = 16  # bf16: map elements a thread carries a slice
# the resident threads an SM should have (fused_tiled_config)
FUSED_TILED_SM_THREADS = 448


def fused_tiled_smem_bytes(k_rows: int, cpt: int, group: int, tile: int,
                           bk: int, itemsize: int) -> int:
    """Shared memory of one tiled fused-conv launch: a two-slot ring, each
    slot a ``bk``-row map slice of ``32 * cpt`` positions and the kept
    rows' values for each of the block's 8-row groups (``group * tile /
    8``) in the map's dtype, then the row table (8 bytes a dense row), and
    in 4 bytes each the ring's kept-row indices, each tile's slice bounds
    and its bad-index flag."""
    n_sl = -(-k_rows // bk)
    np_, rgb = 32 * cpt, group * (tile // KROWS)
    return (2 * bk * (np_ + rgb * KROWS) * itemsize + 8 * k_rows
            + 4 * (2 * group * bk + group * (n_sl + 1) + group))


def _fused_tiled_launch(c, b, h, w, kh, kw, stride, pad, v, n_tiles, k_kept,
                        tile, itemsize, cpt, group, bk) -> Optional[dict]:
    """The tiled fused conv's launch at one instance, or ``None`` where the
    kernel has no such launch (a fresh dict of :func:`_fused_tiled_plan`'s
    items)."""
    plan = _fused_tiled_plan(c, b, h, w, kh, kw, stride, pad, v, n_tiles,
                             k_kept, tile, itemsize, cpt, group, bk)
    return None if plan is None else dict(plan)


@functools.lru_cache(maxsize=4096)  # ints in, ints out; called per launch
def _fused_tiled_plan(c, b, h, w, kh, kw, stride, pad, v, n_tiles, k_kept,
                      tile, itemsize, cpt, group, bk) -> Optional[tuple]:
    ho, wo = out_size(h, kh, stride, pad), out_size(w, kw, stride, pad)
    threads = 32 * group * (tile // KROWS) if tile > 0 else 0
    np_ = 32 * cpt
    if (ho <= 0 or wo <= 0 or n_tiles <= 0 or k_kept <= 0 or tile <= 0
            or tile % KROWS or c * b * h * w >= 2 ** 31
            or cpt not in FUSED_TILED_CPT or v <= 0 or v % np_
            or not 1 <= group <= n_tiles or threads > FUSED_TILED_THREADS
            or (threads % np_ and np_ % threads) or bk not in FUSED_TILED_BKS
            or (itemsize == 2 and threads * FUSED_TILED_HELD < np_ * bk)):
        return None
    smem = fused_tiled_smem_bytes(kh * kw * c, cpt, group, tile, bk, itemsize)
    if smem > SMEM_BYTES:
        return None
    n_pos = b * ho * wo
    n_strips = -(-n_pos // v)
    n_groups = -(-n_tiles // group)
    return tuple(dict(ho=ho, wo=wo, n_strips=n_strips, cpt=cpt, group=group,
                      bk=bk, threads=threads, smem=smem,
                      blocks=n_strips * v // np_ * n_groups,
                      live_blocks=-(-n_pos // np_) * n_groups).items())


def fused_tiled_sm_threads(geo: dict) -> float:
    """Threads of a tiled fused-conv launch resident on each of the H100's
    SMs: its blocks that reach a live position spread over the SMs, as many
    as an SM's shared memory, threads and block slots hold."""
    per_sm = min(geo["live_blocks"] / H100_SMS,
                 SM_SMEM_BYTES // (geo["smem"] + 1024),
                 SM_THREADS // geo["threads"], SM_BLOCKS)
    return per_sm * geo["threads"]


@functools.lru_cache(maxsize=1024)  # ints in, ints out; called per launch
def fused_tiled_config(c: int, b: int, h: int, w: int, kh: int, kw: int,
                       stride: int, pad: int, v: int, n_tiles: int,
                       k_kept: int, tile: int,
                       itemsize: int) -> Optional[tuple]:
    """The tiled fused conv's default instance for a shape, ``(cpt, group,
    bk)``, or ``None`` where no instance fits: a rule of the shape alone,
    fitted to ``repro_torch.kernels.conv_gemm.tune``'s sweep on the H100
    (PERF.md).  A gathered slice feeds ``group`` tiles, so the rule takes
    the most tiles a block that 256 threads hold; a thread's ``cpt`` cuts
    the shared-memory loads a FMA and a taller slice the barriers and the
    tiles' imbalance between them, but an SM wants threads, so it then
    takes the most ``cpt``, then the tallest slice (no taller than the
    im2col's rows), that keep ``FUSED_TILED_SM_THREADS`` threads resident
    on each SM (:func:`fused_tiled_sm_threads`), else the first in that
    order that keeps the most."""
    k_rows = kh * kw * c
    group = min(n_tiles, FUSED_TILED_THREADS // 32 // max(1, tile // KROWS))
    pick, most = None, None
    for cpt in FUSED_TILED_CPT[::-1]:
        for bk in FUSED_TILED_BKS[::-1]:
            if bk > max(16, k_rows):
                continue
            geo = _fused_tiled_launch(c, b, h, w, kh, kw, stride, pad, v,
                                      n_tiles, k_kept, tile, itemsize, cpt,
                                      group, bk)
            if geo is None:
                continue
            resident = fused_tiled_sm_threads(geo)
            if resident >= FUSED_TILED_SM_THREADS:
                return cpt, group, bk
            if most is None or resident > most:
                pick, most = (cpt, group, bk), resident
    return pick


def fused_tiled_geometry(c: int, b: int, h: int, w: int, kh: int, kw: int,
                         stride: int, pad: int, v: int, n_tiles: int,
                         k_kept: int, tile: int, itemsize: int, *,
                         cpt: Optional[int] = None,
                         group: Optional[int] = None,
                         bk: Optional[int] = None) -> Optional[dict]:
    """The tiled fused conv's launch for this shape, or ``None`` where the
    kernel takes no such shape: tiles of a multiple of 8 rows whose 8-row
    groups fit one block's 256 threads (a warp each, so T <= 64), strips of
    a multiple of 32 positions, a map of fewer than 2**31 elements, and
    the row table and ring within a block's shared memory.  The instance is
    :func:`fused_tiled_config`'s where not given."""
    if cpt is None or group is None or bk is None:
        config = fused_tiled_config(c, b, h, w, kh, kw, stride, pad, v,
                                    n_tiles, k_kept, tile, itemsize)
        if config is None:
            return None
        cpt, group, bk = (given if given is not None else default
                          for given, default in zip((cpt, group, bk), config))
    return _fused_tiled_launch(c, b, h, w, kh, kw, stride, pad, v, n_tiles,
                               k_kept, tile, itemsize, cpt, group, bk)


def _fused_tiled_geometry_of(x: torch.Tensor, values: torch.Tensor, kh: int,
                             kw: int, stride: int, pad: int, v: int,
                             **instance) -> Optional[dict]:
    if (x.dim() != 4 or values.dim() != 3 or x.dtype not in FLOAT_DTYPES
            or values.data_ptr() % 16):
        return None
    c, b, h, w = x.shape
    n_tiles, k_kept, tile = values.shape
    return fused_tiled_geometry(c, b, h, w, kh, kw, stride, pad, v, n_tiles,
                                k_kept, tile, x.element_size(), **instance)


def fused_tiled_takes(x: torch.Tensor, values: torch.Tensor, *, kh: int,
                      kw: int, stride: int = 1, pad: int = 0,
                      v: int = 128) -> bool:
    """Whether the tiled fused conv takes this call: the shape rule of
    :func:`fused_tiled_geometry` and 16-byte aligned values (the kernel
    copies a kept row's 8 values by 16 bytes).  A rule of the shape and the
    pointer alone: the wrapper never reacts to a failed build or launch."""
    return _fused_tiled_geometry_of(x, values, kh, kw, stride, pad,
                                    v) is not None


def conv2d_fused_tiled_cuda(x: torch.Tensor, values: torch.Tensor,
                            idx: torch.Tensor, *, kh: int, kw: int,
                            stride: int = 1, pad: int = 0, v: int = 128,
                            cpt: Optional[int] = None,
                            group: Optional[int] = None,
                            bk: Optional[int] = None) -> torch.Tensor:
    """Launch ``csrc/conv2d_fused_tiled.cu``: the fused conv's function and
    bits for the calls :func:`fused_tiled_takes` accepts (raises on any
    other).  ``cpt`` (a block runs ``32 * cpt`` positions; one of
    ``FUSED_TILED_CPT``), ``group`` tiles a block and ``bk`` dense rows a
    slice (one of ``FUSED_TILED_BKS``) are the instance (each gives the
    same bits); by default :func:`fused_tiled_config`'s."""
    check_no_grad("conv2d_fused_tiled", x, values)
    check_cuda_tensor("x", x, FLOAT_DTYPES, 4)
    geo = _fused_tiled_geometry_of(x, values, kh, kw, stride, pad, v, cpt=cpt,
                                   group=group, bk=bk)
    if geo is None:
        raise ValueError(
            f"map {tuple(x.shape)} {x.dtype}, values {tuple(values.shape)}, "
            f"k{kh}x{kw} s{stride} p{pad} v{v}, cpt {cpt}, group {group}, "
            f"bk {bk}: the tiled fused conv takes tiles of a multiple of 8 "
            f"rows up to {FUSED_TILED_THREADS // 32 * KROWS}, strips of a "
            f"multiple of 32 * cpt positions, cpt in {FUSED_TILED_CPT}, at "
            f"most {FUSED_TILED_THREADS} threads, bk in {FUSED_TILED_BKS}, "
            "16-byte aligned values, and its row table and ring within "
            f"{SMEM_BYTES} bytes of shared memory")
    return _launch_fused_tiled(x, values, idx, geo, kh, kw, stride, pad, v)


def _launch_fused_tiled(x, values, idx, geo, kh, kw, stride, pad,
                        v) -> torch.Tensor:
    """The tiled fused-conv launch for a geometry
    :func:`fused_tiled_geometry` gave for ``x`` and ``values``."""
    c, b, h, w = x.shape
    n_tiles, k_kept, tile = values.shape
    smem = geo["smem"]
    check_compressed(values, idx, x.dtype, k_kept, smem)
    check_same_device(x, values, idx)
    out = torch.empty((n_tiles * tile, geo["n_strips"] * v), dtype=x.dtype,
                      device=x.device)
    CONV2D_FUSED_TILED.launch(
        x.device, x.data_ptr(), values.data_ptr(), idx.data_ptr(),
        out.data_ptr(), DTYPE_CODE[x.dtype], c, b, h, w, kh, kw, stride, pad,
        geo["ho"], geo["wo"], v, geo["n_strips"], n_tiles, k_kept, tile,
        geo["cpt"], geo["group"], geo["bk"], smem_bytes=smem)
    return out


def conv2d_fused_banded_scalar_cuda(x: torch.Tensor, values: torch.Tensor,
                                    idx: torch.Tensor, *, kh: int, kw: int,
                                    stride: int = 1, pad: int = 0,
                                    v: int = 128, block_k: int = 128,
                                    hb: int = 2) -> torch.Tensor:
    """Launch ``csrc/conv2d_fused_banded.cu``: the fused conv's function with
    only two ``[C, band_rows, W]`` windows of the map (bands of ``hb``
    strips) in shared memory.  Takes a map whose rows are a multiple of 4
    bytes.  :func:`conv2d_fused_banded_cuda` routes to it the calls
    :func:`banded_tiled_takes` refuses; called directly, it is the bitwise
    yardstick of the tiled kernel."""
    check_no_grad("conv2d_fused_banded", x, values)
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


def banded_tiled_smem_bytes(c: int, plane: int, n_tiles: int, k_kept: int,
                            tile: int, itemsize: int, group: int) -> int:
    """Shared memory of one tiled banded-conv launch: the padded window
    ``[C, plane]`` in the map's dtype, then ``group`` tiles' values in f32
    and their kept rows' window offsets, and each tile's bad-index flag (4
    bytes each)."""
    return (c * plane * itemsize
            + 4 * (group * k_kept * (tile + 1) + n_tiles))


def banded_tiled_geometry(c: int, b: int, h: int, w: int, kh: int, kw: int,
                          stride: int, pad: int, v: int, hb: int,
                          n_tiles: int, k_kept: int, tile: int,
                          itemsize: int) -> Optional[dict]:
    """The tiled banded kernel's launch geometry for this shape, or ``None``
    where the kernel takes no such shape: tiles of a multiple of 8 rows,
    map rows of whole 16-byte copies, and the window plus one tile's staged
    weights within a block's shared memory.  ``group`` is the tiles whose
    weights the block stages at once: all of them where they fit (staged
    once a block), else the fewest equal groups that fit (restaged each
    band)."""
    ho, wo = out_size(h, kh, stride, pad), out_size(w, kw, stride, pad)
    if (ho <= 0 or wo <= 0 or tile % BANDED_TILED_ROWS or k_kept <= 0
            or (w * itemsize) % 16):
        return None
    n_strips = -(-b * ho * wo // v)
    hb = max(min(hb, n_strips), 1)
    n_bands, rows, lead, pitch, plane = tiled_band_plan(
        b=b, h=h, w=w, kh=kh, stride=stride, pad=pad, ho=ho, wo=wo, v=v,
        hb=hb, itemsize=itemsize)
    window = banded_tiled_smem_bytes(c, plane, n_tiles, k_kept, tile,
                                     itemsize, 0)
    fit = (SMEM_BYTES - window) // (4 * k_kept * (tile + 1))  # tiles' weights
    if fit < 1:
        return None
    group = -(-n_tiles // -(-n_tiles // fit))
    return dict(ho=ho, wo=wo, n_strips=n_strips, hb=hb, n_bands=n_bands,
                band_rows=rows, lead=lead, pitch=pitch, plane=plane,
                group=group, smem=banded_tiled_smem_bytes(
                    c, plane, n_tiles, k_kept, tile, itemsize, group))


def banded_tiled_config(group: int, tile: int, hb: int, v: int) -> int:
    """Positions a thread of the tiled banded kernel, for a band of ``hb *
    v`` positions and ``group`` staged tiles of ``tile`` rows: a rule of the
    shape, fitted to ``repro_torch.kernels.conv_gemm.tune``'s sweep on the
    H100 (PERF.md).  A warp's unit of work is 32 * P positions of one 8-row
    group of a staged tile; at 2 positions a thread a band has ``units`` of
    them a group.  Up to 8 units, each of the block's 8 warps takes one;
    past that, 4 positions a thread.  Over resnet-tiny's five convs and
    ResNet-18's layer1 and layer2 convs, in f32 and bf16 under every band
    geometry, its pick was the faster instance or within 1.04x of it per
    conv, and within 1.015x on resnet-tiny's sums."""
    units = group * (tile // BANDED_TILED_ROWS) * -(-hb * v // 64)
    return 2 if units <= 8 else 4


def _tiled_geometry_of(x: torch.Tensor, values: torch.Tensor, kh: int,
                       kw: int, stride: int, pad: int, v: int,
                       hb: int) -> Optional[dict]:
    if (x.dim() != 4 or values.dim() != 3 or x.dtype not in FLOAT_DTYPES
            or x.data_ptr() % 16):
        return None
    c, b, h, w = x.shape
    n_tiles, k_kept, tile = values.shape
    return banded_tiled_geometry(c, b, h, w, kh, kw, stride, pad, v, hb,
                                 n_tiles, k_kept, tile, x.element_size())


def banded_tiled_takes(x: torch.Tensor, values: torch.Tensor, *, kh: int,
                       kw: int, stride: int = 1, pad: int = 0, v: int = 128,
                       hb: int = 2) -> bool:
    """Whether the tiled banded kernel takes this call: the shape rule of
    :func:`banded_tiled_geometry` and a 16-byte aligned map.  A rule of the
    shape and the pointer alone: the wrapper never reacts to a failed build
    or launch."""
    return _tiled_geometry_of(x, values, kh, kw, stride, pad, v,
                              hb) is not None


def conv2d_fused_banded_tiled_cuda(x: torch.Tensor, values: torch.Tensor,
                                   idx: torch.Tensor, *, kh: int, kw: int,
                                   stride: int = 1, pad: int = 0,
                                   v: int = 128, hb: int = 2,
                                   positions: Optional[int] = None
                                   ) -> torch.Tensor:
    """Launch ``csrc/conv2d_fused_banded_tiled.cu``: the banded conv's
    function and bits for the calls :func:`banded_tiled_takes` accepts
    (raises on any other).  ``positions`` a thread is the instance, one of
    ``BANDED_TILED_POSITIONS`` (each gives the same bits); by default
    :func:`banded_tiled_config`'s."""
    check_no_grad("conv2d_fused_banded_tiled", x, values)
    check_cuda_tensor("x", x, FLOAT_DTYPES, 4)
    geo = _tiled_geometry_of(x, values, kh, kw, stride, pad, v, hb)
    if geo is None:
        raise ValueError(
            f"map {tuple(x.shape)} {x.dtype}, values {tuple(values.shape)}, "
            f"k{kh}x{kw} s{stride} p{pad} v{v} hb{hb}: the tiled banded "
            "kernel takes tiles of a multiple of 8 rows, map rows of whole "
            "16-byte copies, a 16-byte aligned map, and the window plus one "
            f"tile's weights within {SMEM_BYTES} bytes of shared memory")
    return _launch_tiled(x, values, idx, geo, kh, kw, stride, pad, v,
                         positions)


def _launch_tiled(x, values, idx, geo, kh, kw, stride, pad, v,
                  positions=None) -> torch.Tensor:
    """The tiled banded launch for a geometry :func:`banded_tiled_geometry`
    gave for ``x`` and ``values``."""
    c, b, h, w = x.shape
    n_tiles, k_kept, tile = values.shape
    if positions is None:
        positions = banded_tiled_config(geo["group"], tile, geo["hb"], v)
    if positions not in BANDED_TILED_POSITIONS:
        raise ValueError(f"{positions} positions a thread is not an instance "
                         "of the tiled banded kernel: one of "
                         f"{BANDED_TILED_POSITIONS}")
    smem = geo["smem"]
    check_compressed(values, idx, x.dtype, k_kept, smem)
    check_same_device(x, values, idx)
    out = torch.empty((n_tiles * tile, geo["n_strips"] * v), dtype=x.dtype,
                      device=x.device)
    CONV2D_FUSED_BANDED_TILED.launch(
        x.device, x.data_ptr(), values.data_ptr(), idx.data_ptr(),
        out.data_ptr(), DTYPE_CODE[x.dtype], c, b, h, w, kh, kw, stride, pad,
        geo["ho"], geo["wo"], v, geo["n_strips"], n_tiles, k_kept, tile,
        geo["hb"], geo["n_bands"], geo["band_rows"], geo["lead"],
        geo["pitch"], geo["plane"], positions, geo["group"], smem_bytes=smem)
    return out


def conv2d_fused_banded_cuda(x: torch.Tensor, values: torch.Tensor,
                             idx: torch.Tensor, *, kh: int, kw: int,
                             stride: int = 1, pad: int = 0, v: int = 128,
                             block_k: int = 128, hb: int = 2) -> torch.Tensor:
    """Launch a banded conv: the fused conv's function, with only windows of
    bands of ``hb`` strips' input rows in shared memory.  Takes the tiled
    kernel where :func:`banded_tiled_takes` says so and
    ``conv2d_fused_banded.cu`` elsewhere (``block_k`` chunks its staged
    values); both give the same bits, and a failed launch raises."""
    check_no_grad("conv2d_fused_banded", x, values)
    check_cuda_tensor("x", x, FLOAT_DTYPES, 4)
    geo = _tiled_geometry_of(x, values, kh, kw, stride, pad, v, hb)
    if geo is not None:
        return _launch_tiled(x, values, idx, geo, kh, kw, stride, pad, v)
    return conv2d_fused_banded_scalar_cuda(x, values, idx, kh=kh, kw=kw,
                                           stride=stride, pad=pad, v=v,
                                           block_k=block_k, hb=hb)
