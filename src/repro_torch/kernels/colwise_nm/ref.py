"""Plain PyTorch column-wise N:M sparse matmuls (twin of
``repro/kernels/colwise_nm/ref.py``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.formats import ColwiseMeta, unpack_colwise
from repro_torch.kernels._build import KROWS
from repro_torch.kernels.colwise_nm.kernel import STRIPS_TILED_BK


def colwise_nm_matmul_ref(x: torch.Tensor, values: torch.Tensor,
                          idx: torch.Tensor, d_in=None) -> torch.Tensor:
    """``x @ W`` with W decompressed to the dense masked weight: shares no
    code with the gather-based kernels it checks."""
    n_tiles, k_kept, tile = values.shape
    if d_in is None:
        d_in = x.shape[-1]
    meta = ColwiseMeta(d_in=d_in, d_out=n_tiles * tile, tile=tile, m=d_in,
                       n=k_kept)
    return x @ unpack_colwise(values, idx, meta)


def colwise_nm_matmul_strips_ref(strips: torch.Tensor, values: torch.Tensor,
                                 idx: torch.Tensor) -> torch.Tensor:
    """Strip-major sparse GEMM, the strip kernel's plain version:
    ``out[t*T + f, s*V + j] = sum_k values[t, k, f] * strips[s, idx[t, k], j]``
    with float32 accumulation, returned in the strips' dtype as
    [n_tiles*T, n_strips*V]."""
    n_strips, _, v = strips.shape
    n_tiles, _, tile = values.shape
    sel = strips[:, idx.long(), :].float()  # [S, n_tiles, k, V]
    y = torch.einsum("tkf,stkj->tfsj", values.float(), sel)
    return y.reshape(n_tiles * tile, n_strips * v).to(strips.dtype)


def colwise_nm_matmul_strips_pipelined_ref(strips: torch.Tensor,
                                           values: torch.Tensor,
                                           idx: torch.Tensor, *,
                                           hb: int = 2) -> torch.Tensor:
    """The pipelined strip GEMM's plain version: the strips reference taken
    chunk by chunk over ``hb`` strips, each chunk at origin
    ``min(g*hb, S-hb)`` as in the TPU kernel, so the ragged last chunk
    re-covers the tail of the one before and writes those columns again
    with the same values."""
    n_strips, _, v = strips.shape
    n_tiles, _, tile = values.shape
    hb = max(min(hb, n_strips), 1)
    out = strips.new_empty((n_tiles * tile, n_strips * v))
    for g in range(-(-n_strips // hb)):
        o = min(g * hb, n_strips - hb)
        out[:, o * v:(o + hb) * v] = colwise_nm_matmul_strips_ref(
            strips[o:o + hb], values, idx)
    return out


def _strips_tiled_walk(strips: torch.Tensor, values: torch.Tensor,
                       idx: torch.Tensor, hb: int, lanes: int) -> torch.Tensor:
    """The strip GEMM walked as ``csrc/colwise_nm_strips_tiled.cu`` walks it,
    with every block of the grid at once: a tile's values staged once
    (here in f32; the kernel keeps their dtype and widens them exactly),
    rows padded with zeros to whole 8-row groups; then the ring's
    order, a block's ``hb`` strips taken ``lanes`` at a time side by side,
    one step after another, and each step's kept rows in slices of 16, each
    slice a gather of whole strip rows (NaN for an index outside [0, K))
    multiplied into f32 accumulators; a step's strips written when its last
    slice is done."""
    n_strips, k_rows, v = strips.shape
    n_tiles, k_kept, tile = values.shape
    hb = max(min(hb, n_strips), 1)
    lanes = max(min(lanes, hb), 1)
    rows_padded = -(-tile // KROWS) * KROWS
    w = values.new_zeros((n_tiles, k_kept, rows_padded), dtype=torch.float32)
    w[..., :tile] = values.float()
    bad = (idx < 0) | (idx >= k_rows)
    safe = torch.where(bad, torch.zeros_like(idx), idx).long()
    out = strips.new_empty((n_tiles * tile, n_strips, v))
    for s0 in range(0, hb, lanes):  # one step: lanes strips of every block
        lane_strips = [strips[sl::hb] for sl in range(s0, min(s0 + lanes, hb))]
        sel = torch.cat(lane_strips)
        acc = w.new_zeros((sel.shape[0], n_tiles, rows_padded, v))
        for k0 in range(0, k_kept, STRIPS_TILED_BK):  # one ring slice
            k1 = min(k0 + STRIPS_TILED_BK, k_kept)
            rows = sel[:, safe[:, k0:k1]].float()  # [strips, n_tiles, nk, V]
            rows = rows.masked_fill(bad[None, :, k0:k1, None], float("nan"))
            acc += torch.einsum("tkf,btkj->btfj", w[:, k0:k1], rows)
        y = acc[:, :, :tile].permute(1, 2, 0, 3).to(strips.dtype)
        y = y.reshape(n_tiles * tile, -1, v)
        first = 0
        for sl, part in zip(range(s0, hb), lane_strips):
            out[:, sl::hb] = y[:, first:first + part.shape[0]]
            first += part.shape[0]
    return out.reshape(n_tiles * tile, n_strips * v)


def colwise_nm_matmul_strips_tiled_ref(strips: torch.Tensor,
                                       values: torch.Tensor,
                                       idx: torch.Tensor) -> torch.Tensor:
    """The tiled strip GEMM's plain version, one strip a block: the strips
    reference's function, walked as the kernel walks it."""
    return _strips_tiled_walk(strips, values, idx, 1, 1)


def colwise_nm_matmul_strips_pipelined_tiled_ref(
        strips: torch.Tensor, values: torch.Tensor, idx: torch.Tensor, *,
        hb: int = 2, lanes: Optional[int] = None) -> torch.Tensor:
    """The tiled pipelined strip GEMM's plain version: ``hb`` strips a
    block, ``lanes`` of them side by side (all ``hb`` by default, as the
    kernel's default instance), the ring running from one step's last slice
    into the next step's first; each strip written once (no re-covered
    chunk)."""
    return _strips_tiled_walk(strips, values, idx, hb,
                              hb if lanes is None else lanes)
