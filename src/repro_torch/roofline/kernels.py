"""One count of each kernel family's work (``PERF.md``'s table, #1-#8).

A count is the :class:`Work` of the function a family's kernels compute, at
one call's operands: the FLOPs (a multiply-add is 2) and the bytes the call
must move, each input read once and each output written once, whatever a
kernel reads again.  It depends on the function and its operands only: the
old kernel, the tiled one and the plain version of a family count the same.

  #1 (1a, 1b)  sparse linear            :func:`linear_work`
  #2, #3       strip GEMM (pipelined)   :func:`strips_work`
  #4           im2col + pack            :func:`pack_work`
  #5, #6       fused conv (banded)      :func:`conv_work`
  #7           flash attention          :func:`flash_work`
  #8           paged attention          :func:`paged_work`

Where the work depends on the data (the rows a sparse weight keeps, the map
elements its taps read, a paged cache's valid rows), the count reads this
call's data.  A ``meta`` tensor holds none: there the count takes the most
the shapes allow (every row kept, the whole map read, every row the tables
reach valid), so a dry run on ``meta`` reads nothing data-dependent.

:func:`bound_ms` turns a count into the least time the card could take.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.roofline.analysis import HBM_BW, PEAK_FLOPS


class Work(NamedTuple):
    """What one call must do: its FLOPs and the bytes it must move."""

    flops: int
    bytes: int


def bound_ms(work: Work, dtype) -> tuple:
    """(ms, "bytes" | "operations"): the larger of the bytes over the card's
    memory rate and the FLOPs over its peak rate for ``dtype`` (a torch
    dtype or its name)."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    t_bytes = work.bytes / HBM_BW * 1e3
    t_ops = work.flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _on_meta(*tensors: torch.Tensor) -> bool:
    return any(t.device.type == "meta" for t in tensors)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _out_size(h: int, k: int, stride: int, pad: int) -> int:
    return (h + 2 * pad - k) // stride + 1


def kept_rows(idx: torch.Tensor, k_rows: int) -> int:
    """Distinct rows of the reduction dim (``k_rows`` long) that some tile
    keeps: ``idx``'s distinct values; on ``meta``, ``min(k_rows,
    idx.numel())``."""
    if _on_meta(idx):
        return min(k_rows, idx.numel())
    return int(torch.unique(idx).numel())


def linear_work(rows: int, values: torch.Tensor, idx: torch.Tensor,
                d_in: int) -> Work:
    """#1, ``y[r, t*T:(t+1)*T] = x[r, idx[t]] @ values[t]`` over ``rows``
    rows of x [rows, d_in]: the kept columns of x, values, idx and the
    output moved once; 2 FLOPs per kept row per output."""
    n_tiles, k_kept, tile = values.shape
    isz = values.element_size()
    nb = (rows * kept_rows(idx, d_in) * isz + values.numel() * isz
          + _nbytes(idx) + rows * n_tiles * tile * isz)
    return Work(2 * rows * k_kept * n_tiles * tile, nb)


def strips_work(strips: torch.Tensor, values: torch.Tensor,
                idx: torch.Tensor, n_pos: int = None) -> Work:
    """#2 and #3, the strip GEMM of packed strips [n_strips, K, V] -> [O,
    n_strips * V]: every strip's kept rows, values, idx and the output
    moved once; 2 FLOPs per kept row per output position, over ``n_pos``
    positions (the true ones of a conv; default every strip column)."""
    n_strips, k_rows, v = strips.shape
    n_tiles, k_kept, tile = values.shape
    o, isz = n_tiles * tile, strips.element_size()
    n_pos = n_strips * v if n_pos is None else n_pos
    nb = (n_strips * kept_rows(idx, k_rows) * v * isz + values.numel() * isz
          + _nbytes(idx) + o * n_strips * v * isz)
    return Work(2 * o * k_kept * n_pos, nb)


def pack_bytes(c, b, h, w, k, stride, pad, v, itemsize, kw=None) -> int:
    """Bytes one pack must move: each map element some tap reads, once, and
    every element of the strips (the ragged tail's zeros too), once.  ``k``
    is the kernel's height, ``kw`` its width (``k`` when ``None``)."""
    kw = k if kw is None else kw
    ho, wo = _out_size(h, k, stride, pad), _out_size(w, kw, stride, pad)
    hit = np.zeros((h, w), dtype=bool)
    for ikh in range(k):
        ih = np.arange(ho) * stride - pad + ikh
        for ikw in range(kw):
            iw = np.arange(wo) * stride - pad + ikw
            hit[np.ix_(ih[(ih >= 0) & (ih < h)], iw[(iw >= 0) & (iw < w)])] = True
    n_strips = -(-b * ho * wo // v)
    return (int(hit.sum()) * c * b + n_strips * k * kw * c * v) * itemsize


def pack_work(x: torch.Tensor, kh: int, kw: int, stride: int, pad: int,
              v: int) -> Work:
    """#4, im2col + pack of a CNHW map into [n_strips, kh*kw*C, V]: no
    FLOPs, :func:`pack_bytes`."""
    c, b, h, w = x.shape
    return Work(0, pack_bytes(c, b, h, w, kh, stride, pad, v,
                              x.element_size(), kw=kw))


def touched_elems(shape, kh, kw, stride, pad, rows, device) -> int:
    """Distinct map elements that output positions read through im2col
    rows ``rows`` ((kh, kw, c)-flattened): what the work needs from x."""
    from repro_torch.kernels.im2col_pack.kernel import tap_coords

    c, b, h, w = shape
    ho, wo = _out_size(h, kh, stride, pad), _out_size(w, kw, stride, pad)
    p = torch.arange(b * ho * wo, device=device)
    mark = torch.zeros(c * b * h * w, dtype=torch.bool, device=device)
    rows = rows.long()
    for tap in torch.unique(rows // c).tolist():
        chans = torch.unique(rows[rows // c == tap] % c)
        valid, bc, ihc, iwc = tap_coords(
            p, ikh=tap // kw, ikw=tap % kw, stride=stride, pad=pad, b=b, h=h,
            w=w, ho=ho, wo=wo)
        pos = ((bc * h + ihc) * w + iwc)[valid]
        mark[(chans[:, None] * (b * h * w) + pos[None, :]).reshape(-1)] = True
    return int(mark.sum())


def conv_work(x: torch.Tensor, values: torch.Tensor, idx: torch.Tensor, *,
              kh: int, kw: int, stride: int = 1, pad: int = 0) -> Work:
    """#5 and #6 (and any conv plan), the sparse conv of a CNHW map x: the
    map elements the kept rows read (:func:`touched_elems`; on ``meta``,
    the whole map), values, idx and the CNHW output moved once; 2 FLOPs per
    kept row per output position."""
    c, b, h, w = x.shape
    n_tiles, k_kept, tile = values.shape
    o = n_tiles * tile
    n_pos = b * _out_size(h, kh, stride, pad) * _out_size(w, kw, stride, pad)
    isz = x.element_size()
    if _on_meta(x, idx):
        touched = x.numel()
    else:
        touched = touched_elems(x.shape, kh, kw, stride, pad,
                                torch.unique(idx), x.device)
    nb = (touched * isz + values.numel() * values.element_size()
          + _nbytes(idx) + o * n_pos * isz)
    return Work(2 * o * k_kept * n_pos, nb)


def flash_work(b, sq, sk, h, kv, d, causal, itemsize) -> Work:
    """#7, attention of q [B, Sq, H, D] over k/v [B, Sk, KV, D]: QK and PV
    over the (top-left causal) pairs, 4 * B*H * D per pair; Q, K, V (at KV
    heads) and O read or written once."""
    pairs = (sum(min(i + 1, sk) for i in range(sq)) if causal else sq * sk)
    nb = (2 * b * sq * h * d + 2 * b * sk * kv * d) * itemsize
    return Work(4 * b * h * d * pairs, nb)


def paged_work(q, k_new, v_new, tables, lengths, page_size: int) -> Work:
    """#8, one paged-attention call: the valid cache rows of K and V (each
    sequence's ``lengths``, at most what its table reaches; on ``meta``,
    all of that), q, the new K/V and the output read or written once, the
    tables and lengths; QK and PV over the valid rows and the new ones."""
    b, sq, h, d = q.shape
    kv = k_new.shape[2]
    cap = tables.shape[1] * page_size
    if _on_meta(lengths):
        rows = [cap] * b
    else:
        rows = [min(int(n), cap) for n in lengths.tolist()]
    isz = q.element_size()
    nb = ((2 * sum(rows) * kv * d + 2 * q.numel() + k_new.numel()
           + v_new.numel()) * isz + 4 * (tables.numel() + lengths.numel()))
    return Work(sum(4 * h * d * (n + sq) * sq for n in rows), nb)


def banded_bytes_moved(c: int, b: int, h: int, w: int, kh: int, stride: int,
                       pad: int, ho: int, wo: int, v: int, hb: int,
                       o: int, itemsize: int) -> int:
    """Device-memory traffic of the banded conv (#6) at band depth ``hb``:
    every band copies its ``band_rows``-row window once (halo rows are read
    again by the next band), and the [O, P] output is written once.  This is
    the kernel's traffic, not :func:`conv_work`'s least bytes."""
    from repro_torch.kernels.conv_gemm.plan import band_plan

    n_bands, band_rows = band_plan(b=b, h=h, kh=kh, stride=stride, pad=pad,
                                   ho=ho, wo=wo, v=v, hb=hb)
    n_strips = -(-b * ho * wo // v)
    return (n_bands * c * band_rows * w + o * n_strips * v) * itemsize
