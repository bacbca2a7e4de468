"""Fused im2col + pack + sparse GEMM convs on Hopper: the whole-map kernel
(``csrc/conv2d_fused.cu``) and two banded ones with the same bits,
``csrc/conv2d_fused_banded_tiled.cu`` (register-tiled over a zero-padded
window) for the shapes :func:`banded_tiled_takes` accepts and
``csrc/conv2d_fused_banded.cu`` for the others; the packed strips never
reach device memory.  :func:`conv2d_fused_banded_cuda` routes between the
banded kernels by that rule of the shape.

Each ``*_smem_bytes`` function is the shared memory its kernel's launch
requests, and what the dispatch registry's feasibility predicate compares
with a block's 227 KB.
"""
from __future__ import annotations

import ctypes
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
    check_same_device,
)
from repro_torch.kernels.conv_gemm.plan import band_plan, tiled_band_plan
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
    check_cuda_tensor("x", x, FLOAT_DTYPES, 4)
    geo = _tiled_geometry_of(x, values, kh, kw, stride, pad, v, hb)
    if geo is not None:
        return _launch_tiled(x, values, idx, geo, kh, kw, stride, pad, v)
    return conv2d_fused_banded_scalar_cuda(x, values, idx, kh=kh, kw=kw,
                                           stride=stride, pad=pad, v=v,
                                           block_k=block_k, hb=hb)
