"""Compressed storage for column-wise N:M pruned weights (twin of
``repro/core/formats.py``).

Per linear layer ``[d_in, d_out]`` with tile T and k_kept kept rows:

  values : [n_tiles, k_kept, T]   float, tile-major
  idx    : [n_tiles, k_kept]      int32, ascending absolute d_in index

and, for a layer whose reduction dim a tensor-parallel mesh shards, the
group-local REDUCE format: the prune unit spans the whole output dim (T =
d_out) and d_in splits into G groups, one a shard, of ``n`` kept rows each:

  values_r : [G, n, d_out]   float
  idx_r    : [G, n]          int32, ascending index *within* the group
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch._compat import resolve_device
from repro_torch.core.pruning import SparsityConfig, resolve_dims


class ColwiseMeta(NamedTuple):
    """Static metadata of a compressed layer."""

    d_in: int
    d_out: int
    tile: int
    m: int
    n: int

    @property
    def n_tiles(self) -> int:
        return self.d_out // self.tile

    @property
    def k_kept(self) -> int:
        return (self.d_in // self.m) * self.n

    @property
    def density(self) -> float:
        return self.k_kept / self.d_in


def meta_for(d_in: int, d_out: int, cfg: SparsityConfig) -> ColwiseMeta:
    tile, m, n, _, _, _ = resolve_dims(d_in, d_out, cfg)
    return ColwiseMeta(d_in=d_in, d_out=d_out, tile=tile, m=m, n=n)


def keep_matrix_from_mask(mask: torch.Tensor, tile: int) -> torch.Tensor:
    """[d_in, d_out] column-wise mask -> [n_tiles, d_in] per-tile keep flags."""
    d_in, d_out = mask.shape
    return mask.reshape(d_in, d_out // tile, tile)[:, :, 0].T


def indices_from_keep(keep: torch.Tensor, k_kept: int) -> torch.Tensor:
    """Per-tile ascending kept indices [n_tiles, k_kept] int32 from a
    [n_tiles, d_in] keep matrix with exactly k_kept True per row.

    Dropped positions are pushed past d_in so one ascending sort puts the
    kept ones first, as the JAX package does.
    """
    d_in = keep.shape[1]
    iota = torch.arange(d_in, dtype=torch.int32, device=keep.device)
    key = torch.where(keep, iota[None, :], d_in + iota[None, :])
    order = torch.sort(key, dim=-1).values[:, :k_kept]
    return order.to(torch.int32).contiguous()


def pack_colwise(w: torch.Tensor, mask: torch.Tensor,
                 meta: ColwiseMeta) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compress a dense [d_in, d_out] weight under a column-wise mask into
    (values [n_tiles, k_kept, tile], idx [n_tiles, k_kept] int32)."""
    idx = indices_from_keep(keep_matrix_from_mask(mask, meta.tile), meta.k_kept)
    wt = w.reshape(meta.d_in, meta.n_tiles, meta.tile)
    tiles = torch.arange(meta.n_tiles, device=w.device)[:, None]
    return wt[idx.long(), tiles], idx  # values[t, j] = wt[idx[t, j], t]


def unpack_colwise(values: torch.Tensor, idx: torch.Tensor,
                   meta: ColwiseMeta) -> torch.Tensor:
    """Decompress back to the dense (masked) [d_in, d_out] weight."""
    n_tiles, _, tile = values.shape
    if (n_tiles, tile) != (meta.n_tiles, meta.tile):
        raise ValueError(f"values {tuple(values.shape)} do not match {meta}")
    wt = values.new_zeros((n_tiles, meta.d_in, tile))
    tiles = torch.arange(n_tiles, device=values.device)[:, None]
    wt[tiles, idx.long()] = values
    return wt.transpose(0, 1).reshape(meta.d_in, meta.d_out)


def init_compressed(generator: torch.Generator, d_in: int, d_out: int,
                    cfg: SparsityConfig, dtype=torch.float32,
                    scale: Optional[float] = None, device=None):
    """Initialize a born-sparse compressed layer: random ``values`` from
    ``generator`` (a CPU generator, so the draw does not depend on the
    device) and kept indices evenly strided per group, as in JAX."""
    dev = resolve_device(device)
    meta = meta_for(d_in, d_out, cfg)
    if scale is None:
        scale = 1.0 / np.sqrt(max(meta.k_kept, 1))
    values = torch.randn((meta.n_tiles, meta.k_kept, meta.tile),
                         generator=generator, dtype=torch.float32)
    values = (values * scale).to(dtype)
    stride = max(meta.m // meta.n, 1)
    within = (torch.arange(meta.n, dtype=torch.int32) * stride) % meta.m
    base = torch.arange(d_in // meta.m, dtype=torch.int32) * meta.m
    idx1 = (base[:, None] + within[None, :]).reshape(-1)
    idx = idx1[None, :].expand(meta.n_tiles, meta.k_kept).contiguous()
    return values.to(dev), idx.to(dev)


def pack_reduce(w: torch.Tensor, mask: torch.Tensor,
                groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compress a dense [d_in, d_out] weight under a column-wise mask of
    tile d_out into the REDUCE format: (values [G, n, d_out], idx_within
    [G, n] int32, group-local in [0, d_in / G)).  Every group must keep the
    same count (N:M with M = d_in / G does)."""
    d_in, d_out = w.shape
    if d_in % groups:
        raise ValueError(f"d_in {d_in} does not split into {groups} groups")
    m = d_in // groups
    keep_g = mask[:, 0].reshape(groups, m)  # tile d_out: one row of flags
    counts = keep_g.sum(dim=1)
    if not bool((counts == counts[0]).all()):
        raise ValueError(f"groups keep unequal counts {counts.tolist()}")
    n_per = int(counts[0])
    iota = torch.arange(m, dtype=torch.int32, device=w.device)
    key = torch.where(keep_g, iota[None, :], m + iota[None, :])
    idx = torch.sort(key, dim=-1).values[:, :n_per].to(torch.int32)
    rows = torch.arange(groups, device=w.device)[:, None]
    return w.reshape(groups, m, d_out)[rows, idx.long()], idx.contiguous()


def unpack_reduce(values: torch.Tensor, idx: torch.Tensor,
                  d_in: int) -> torch.Tensor:
    """The REDUCE format back to the dense (masked) [d_in, d_out] weight."""
    g, _, d_out = values.shape
    w = values.new_zeros((g, d_in // g, d_out))
    w[torch.arange(g, device=values.device)[:, None], idx.long()] = values
    return w.reshape(d_in, d_out)


def init_compressed_reduce(generator: torch.Generator, d_in: int, d_out: int,
                           groups: int, n_per: int, dtype=torch.float32,
                           scale: Optional[float] = None, device=None):
    """Initialize a born-sparse REDUCE-format layer: random ``values`` [G,
    n_per, d_out] from ``generator`` (a CPU generator) and, in every group,
    the kept rows evenly strided, as in JAX."""
    dev = resolve_device(device)
    m = d_in // groups
    if scale is None:
        scale = 1.0 / np.sqrt(max(groups * n_per, 1))
    values = torch.randn((groups, n_per, d_out), generator=generator,
                         dtype=torch.float32)
    values = (values * scale).to(dtype)
    stride = max(m // n_per, 1)
    within = (torch.arange(n_per, dtype=torch.int32) * stride) % m
    idx = within[None, :].expand(groups, n_per).contiguous()
    return values.to(dev), idx.to(dev)
