"""Fused im2col + pack on Hopper, and the im2col index arithmetic every conv
path shares.

Two kernels with the same bits: ``csrc/im2col_pack_tiled.cu`` (a block a
strip x group of taps x block of channels, 16-byte rows) for the strip widths
:func:`im2col_tiled_takes` accepts, and ``csrc/im2col_pack.cu`` (a block a
strip row) for the others; :func:`im2col_pack_cuda` routes between them by
that rule of the shape.

``tap_coords`` is the twin of ``repro/kernels/im2col_pack/kernel.py``'s: the
plain versions gather with it, and ``csrc/common.cuh::tap_coords`` computes
the same coordinates on the card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels._build import (CudaKernel, FLOAT_DTYPES,
                                        check_cuda_tensor, check_no_grad)
from repro_torch.kernels.im2col_pack.ref import out_size


def tap_coords(p, *, ikh, ikw, stride, pad, b, h, w, ho, wo,
               band_origin=None, band_rows=None):
    """Source coordinates of flat output positions ``p`` at kernel tap
    (ikh, ikw).

    ``p`` is an integer tensor of flattened ``(batch, oh, ow)`` positions;
    ``ikh``/``ikw`` broadcast against it.  Returns ``(valid, bc, ihc, iwc)``:
    the off-map / past-the-end mask and clamped (always in-bounds) batch, row
    and column coordinates.

    Band mode (``band_origin``/``band_rows`` set), for the banded conv that
    keeps only a row band of the ``[C, B*H, W]`` map: the row coordinate is
    band-local in the flattened ``(batch*h)`` row space,
    ``bb*h + ih - band_origin`` clamped to ``[0, band_rows)``, and the batch
    coordinate is dropped; returns ``(valid, rowc, iwc)``.  ``band_origin``
    may be a tensor that broadcasts against ``p``.
    """
    n_pos = b * ho * wo
    bb = p // (ho * wo)
    rem = p % (ho * wo)
    oh = rem // wo
    ow = rem % wo
    ih = oh * stride - pad + ikh
    iw = ow * stride - pad + ikw
    valid = (p < n_pos) & (ih >= 0) & (ih < h) & (iw >= 0) & (iw < w)
    if band_origin is not None:
        row = bb * h + ih - band_origin
        return (valid, row.clamp(0, band_rows - 1), iw.clamp(0, w - 1))
    return (valid, bb.clamp(0, b - 1), ih.clamp(0, h - 1), iw.clamp(0, w - 1))


def strip_tap_coords(s, *, v, ikh, ikw, stride, pad, b, h, w, ho, wo,
                     band_origin=None, band_rows=None, device=None):
    """:func:`tap_coords` over strip ``s``'s positions ``s*v + arange(v)``
    (band mode included)."""
    p = s * v + torch.arange(v, dtype=torch.int32, device=device)
    return tap_coords(p, ikh=ikh, ikw=ikw, stride=stride, pad=pad, b=b, h=h,
                      w=w, ho=ho, wo=wo, band_origin=band_origin,
                      band_rows=band_rows)


IM2COL_PACK = CudaKernel(
    "im2col_pack", "repro_im2col_pack",
    [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 13,
    source="src/repro_torch/csrc/im2col_pack.cu",
    replaces="src/repro/kernels/im2col_pack/kernel.py:124 im2col_pack_pallas",
)

IM2COL_PACK_TILED = CudaKernel(
    "im2col_pack_tiled", "repro_im2col_pack_tiled",
    [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 17,
    source="src/repro_torch/csrc/im2col_pack_tiled.cu",
    replaces="src/repro/kernels/im2col_pack/kernel.py:124 im2col_pack_pallas",
)

# csrc/im2col_pack_tiled.cu's instances: channels a block (cb), taps a block
# (tg) and channels a thread loads before it stores (unroll); a block's
# threads at most
IM2COL_TILED_CBS = (4, 8, 16, 32, 64, 128)
IM2COL_TILED_TGS = (1, 3, 9)
IM2COL_TILED_UNROLLS = (1, 2, 4)
IM2COL_TILED_THREADS = 256
# the instance rule: the blocks a launch should have at least (one an
# H100 SM), and the 16-byte rows a thread should write, by element size
IM2COL_TILED_BLOCKS = 132
IM2COL_TILED_ROWS = {4: 6, 2: 8}
MAX_GRID_YZ = 65535  # the grid's taps and channel chunks


def _pack_out(x: torch.Tensor, kh: int, kw: int, stride: int, pad: int,
              v: int) -> tuple:
    c, b, h, w = x.shape
    ho = out_size(h, kh, stride, pad)
    wo = out_size(w, kw, stride, pad)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"empty output {ho}x{wo} for map {h}x{w}")
    return ho, wo, -(-b * ho * wo // v)


def im2col_pack_scalar_cuda(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
                            pad: int = 0, v: int = 128) -> torch.Tensor:
    """Launch ``csrc/im2col_pack.cu``: CNHW ``x`` -> [n_strips, Kh*Kw*C, V],
    one block per strip row.  :func:`im2col_pack_cuda` routes to it the
    strip widths :func:`im2col_tiled_takes` refuses; called directly, it is
    the bitwise yardstick of the tiled kernel."""
    check_no_grad("im2col_pack", x)
    check_cuda_tensor("x", x, FLOAT_DTYPES, 4)
    return _launch_scalar(x, kh, kw, stride, pad, v,
                          *_pack_out(x, kh, kw, stride, pad, v))


def _launch_scalar(x, kh, kw, stride, pad, v, ho, wo, n_strips):
    c, b, h, w = x.shape
    out = torch.empty((n_strips, kh * kw * c, v), dtype=x.dtype, device=x.device)
    IM2COL_PACK.launch(x.device, x.data_ptr(), out.data_ptr(), x.element_size(),
                       c, b, h, w, kh, kw, stride, pad, ho, wo, v, n_strips)
    return out


def _needed(options, n, pick) -> bool:
    """Whether ``pick`` is one of ``options`` (ascending) that ``n`` items
    need: the first of them, or one whose predecessor is under ``n`` (a
    larger one would only add idle room)."""
    i = options.index(pick) if pick in options else -1
    return i == 0 or (i > 0 and options[i - 1] < n)


@functools.lru_cache(maxsize=4096)  # ints in, ints out; called per launch
def _im2col_tiled_plan(c, b, h, w, kh, kw, stride, pad, v, itemsize, cb, tg,
                       unroll) -> Optional[tuple]:
    ho, wo = out_size(h, kh, stride, pad), out_size(w, kw, stride, pad)
    ept = 16 // itemsize if itemsize in (2, 4) else 0
    if (ho <= 0 or wo <= 0 or c <= 0 or b <= 0 or not ept or v <= 0
            or v % ept or v // ept > IM2COL_TILED_THREADS
            or not _needed(IM2COL_TILED_CBS, c, cb)
            or not _needed(IM2COL_TILED_TGS, kh * kw, tg)
            or unroll not in IM2COL_TILED_UNROLLS):
        return None
    lanes = v // ept
    rp = min(IM2COL_TILED_THREADS // lanes, cb)
    rows = -(-min(cb, c) // rp)  # the channel rows a thread writes a tap
    n_strips = -(-b * ho * wo // v)
    chunks, tap_groups = -(-c // cb), -(-kh * kw // tg)
    if ((unroll > 1 and unroll // 2 >= rows) or chunks > MAX_GRID_YZ
            or tap_groups > MAX_GRID_YZ or n_strips * kh * kw * c >= 2 ** 31):
        return None
    return tuple(dict(ho=ho, wo=wo, n_strips=n_strips, cb=cb, tg=tg,
                      unroll=unroll, rp=rp, threads=lanes * rp,
                      rows=rows * min(tg, kh * kw),
                      blocks=n_strips * tap_groups * chunks).items())


def _im2col_tiled_launch(*args) -> Optional[dict]:
    """The tiled pack's launch at one instance, or ``None`` where the kernel
    has no such launch (a fresh dict of :func:`_im2col_tiled_plan`'s items)."""
    plan = _im2col_tiled_plan(*args)
    return None if plan is None else dict(plan)


@functools.lru_cache(maxsize=1024)  # ints in, ints out; called per launch
def im2col_tiled_config(c: int, b: int, h: int, w: int, kh: int, kw: int,
                        stride: int, pad: int, v: int,
                        itemsize: int) -> Optional[tuple]:
    """The tiled pack's default instance for a shape, ``(cb, tg, unroll)``,
    or ``None`` where the kernel takes no such shape: a rule of the shape
    alone, fitted to ``repro_torch.kernels.im2col_pack.tune``'s sweep on the
    H100 (PERF.md).  A block's time is mostly its start and its threads'
    load round trips, so a thread should write several rows, but the card
    needs blocks: among the instances that give ``IM2COL_TILED_BLOCKS``
    blocks (else those that give the most), the one whose threads write the
    nearest to ``IM2COL_TILED_ROWS`` 16-byte rows (channel rows times taps
    a block), more taps a block first, then more channels; at the deepest
    unroll the thread's rows a tap use."""
    want = IM2COL_TILED_ROWS.get(itemsize)
    pick, best = None, None
    for cb in IM2COL_TILED_CBS:
        for tg in IM2COL_TILED_TGS:
            for unroll in IM2COL_TILED_UNROLLS[::-1]:
                geo = _im2col_tiled_launch(c, b, h, w, kh, kw, stride, pad, v,
                                           itemsize, cb, tg, unroll)
                if geo is not None:
                    break
            if geo is None:
                continue
            few = geo["blocks"] < IM2COL_TILED_BLOCKS
            key = (few, -geo["blocks"] if few else 0,
                   abs(geo["rows"] - want), -tg, -cb)
            if best is None or key < best:
                pick, best = (cb, tg, unroll), key
    return pick


def im2col_tiled_geometry(c: int, b: int, h: int, w: int, kh: int, kw: int,
                          stride: int, pad: int, v: int, itemsize: int, *,
                          cb: Optional[int] = None, tg: Optional[int] = None,
                          unroll: Optional[int] = None) -> Optional[dict]:
    """The tiled pack's launch for this shape, or ``None`` where the kernel
    takes no such shape: strips of whole 16-byte rows (V a multiple of 4 in
    f32, 8 in bf16) that at most 256 threads cover, and a grid within the
    card's limits.  The instance is :func:`im2col_tiled_config`'s where not
    given; ``rp`` is the strip rows a block's threads take at once."""
    if cb is None or tg is None or unroll is None:
        config = im2col_tiled_config(c, b, h, w, kh, kw, stride, pad, v,
                                     itemsize)
        if config is None:
            return None
        cb, tg, unroll = (given if given is not None else default
                          for given, default in zip((cb, tg, unroll), config))
    return _im2col_tiled_launch(c, b, h, w, kh, kw, stride, pad, v, itemsize,
                                cb, tg, unroll)


def _im2col_tiled_geometry_of(x: torch.Tensor, kh: int, kw: int, stride: int,
                              pad: int, v: int, **instance) -> Optional[dict]:
    if x.dim() != 4 or x.dtype not in FLOAT_DTYPES:
        return None
    c, b, h, w = x.shape
    return im2col_tiled_geometry(c, b, h, w, kh, kw, stride, pad, v,
                                 x.element_size(), **instance)


def im2col_tiled_takes(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
                       pad: int = 0, v: int = 128) -> bool:
    """Whether the tiled pack takes this call: the shape rule of
    :func:`im2col_tiled_geometry`.  A rule of the shape alone: the wrapper
    never reacts to a failed build or launch."""
    return _im2col_tiled_geometry_of(x, kh, kw, stride, pad, v) is not None


def _launch_tiled(x, kh, kw, stride, pad, v, geo) -> torch.Tensor:
    c, b, h, w = x.shape
    out = torch.empty((geo["n_strips"], kh * kw * c, v), dtype=x.dtype,
                      device=x.device)
    IM2COL_PACK_TILED.launch(
        x.device, x.data_ptr(), out.data_ptr(), x.element_size(), c, b, h, w,
        kh, kw, stride, pad, geo["ho"], geo["wo"], v, geo["n_strips"],
        geo["cb"], geo["tg"], geo["rp"], geo["unroll"])
    return out


def im2col_pack_tiled_cuda(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
                           pad: int = 0, v: int = 128, *,
                           cb: Optional[int] = None, tg: Optional[int] = None,
                           unroll: Optional[int] = None) -> torch.Tensor:
    """Launch ``csrc/im2col_pack_tiled.cu``: CNHW ``x`` -> [n_strips,
    Kh*Kw*C, V], a block a strip x ``tg`` taps x ``cb`` channels.  The instance is
    :func:`im2col_tiled_config`'s where not given; a shape or instance the
    kernel does not take raises."""
    check_no_grad("im2col_pack", x)
    check_cuda_tensor("x", x, FLOAT_DTYPES, 4)
    _pack_out(x, kh, kw, stride, pad, v)
    geo = _im2col_tiled_geometry_of(x, kh, kw, stride, pad, v, cb=cb, tg=tg,
                                    unroll=unroll)
    if geo is None:
        raise ValueError(
            f"x {tuple(x.shape)} {x.dtype}, v {v}, cb {cb}, tg {tg}, unroll "
            f"{unroll}: the tiled pack takes strips of whole 16-byte rows that "
            f"at most {IM2COL_TILED_THREADS} threads cover, cb in "
            f"{IM2COL_TILED_CBS} and tg in {IM2COL_TILED_TGS} (no larger than "
            f"the channels and taps need), unroll in {IM2COL_TILED_UNROLLS} "
            "(no deeper than a thread's rows a tap)")
    return _launch_tiled(x, kh, kw, stride, pad, v, geo)


def im2col_pack_cuda(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
                     pad: int = 0, v: int = 128) -> torch.Tensor:
    """Launch a fused im2col+pack kernel: CNHW ``x`` -> [n_strips, Kh*Kw*C,
    V].  After the checks of ``im2col_pack.cu``, takes the tiled kernel
    where :func:`im2col_tiled_takes` says so and ``im2col_pack.cu``
    elsewhere; both give the same bits, and a failed launch raises."""
    check_no_grad("im2col_pack", x)
    check_cuda_tensor("x", x, FLOAT_DTYPES, 4)
    shape = _pack_out(x, kh, kw, stride, pad, v)
    geo = _im2col_tiled_geometry_of(x, kh, kw, stride, pad, v)
    if geo is not None:
        return _launch_tiled(x, kh, kw, stride, pad, v, geo)
    return _launch_scalar(x, kh, kw, stride, pad, v, *shape)
