"""Mask construction for column-wise N:M pruning (twin of
``repro/core/pruning.py``).

A linear layer computes ``y = x @ w`` with ``w`` of shape ``[d_in, d_out]``;
for every output tile of ``T`` features and every group of ``M`` consecutive
d_in positions, the ``N`` positions with the largest L1 norm over the tile are
kept for the whole tile.  Masks are bit-identical to the JAX package's on the
same weights: scores are the same float32 sums, and ties break by position
through a stable argsort.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    """Configuration of column-wise N:M pruning.

    Attributes:
      sparsity: fraction of weights removed, in [0, 1). 0 disables pruning.
      m: N:M group size along d_in; ``None`` means the whole reduction dim
        (the paper's adaptive-M mode).
      tile: output-feature tile size T sharing one set of kept indices.
      format: ``dense`` | ``masked`` | ``compressed_xla`` |
        ``compressed_pallas`` (both compressed names select the packed
        ``values``/``idx`` format).
      min_dim: layers with ``min(d_in, d_out) < min_dim`` stay dense.
      scheme: ``colwise`` (the paper's technique) or ``rowwise`` (tile 1).
    """

    sparsity: float = 0.0
    m: Optional[int] = None
    tile: Optional[int] = None
    format: str = "dense"
    min_dim: int = 128
    scheme: str = "colwise"

    @property
    def enabled(self) -> bool:
        return self.sparsity > 0.0 and self.format != "dense"

    @property
    def compressed(self) -> bool:
        return self.format in ("compressed_xla", "compressed_pallas")

    def applies_to(self, d_in: int, d_out: int) -> bool:
        return self.enabled and min(d_in, d_out) >= self.min_dim

    def with_(self, **kw) -> "SparsityConfig":
        return dataclasses.replace(self, **kw)


DENSE = SparsityConfig()


def choose_tile(d_out: int, requested: Optional[int]) -> int:
    """Largest divisor of d_out that is <= requested (defaults to d_out)."""
    if requested is None or requested >= d_out:
        return d_out
    t = requested
    while d_out % t != 0:
        t -= 1
    return max(t, 1)


def choose_group(d_in: int, requested: Optional[int]) -> int:
    """Largest divisor of d_in that is <= requested (defaults to d_in)."""
    if requested is None or requested >= d_in:
        return d_in
    m = requested
    while d_in % m != 0:
        m -= 1
    return max(m, 1)


def kept_per_group(m: int, sparsity: float) -> int:
    """N kept per group of M; Python's ``round`` (half to even), as in JAX."""
    n = int(round(m * (1.0 - sparsity)))
    return min(max(n, 1), m)


def resolve_dims(d_in: int, d_out: int, cfg: SparsityConfig):
    """Resolve (tile T, group M, kept-per-group N, n_tiles, n_groups, k_kept)."""
    tile = choose_tile(d_out, cfg.tile)
    m = choose_group(d_in, cfg.m)
    n = kept_per_group(m, cfg.sparsity)
    n_tiles = d_out // tile
    n_groups = d_in // m
    return tile, m, n, n_tiles, n_groups, n_groups * n


def colwise_importance(w: torch.Tensor, tile: int) -> torch.Tensor:
    """L1 norm of each (tile, d_in) column group: [n_tiles, d_in]."""
    d_in, d_out = w.shape
    return w.abs().reshape(d_in, d_out // tile, tile).sum(dim=-1).T


def _topn_mask_lastdim(scores: torch.Tensor, n: int) -> torch.Tensor:
    """Keep exactly the top-n entries of the last dim; ties go to the
    earlier position (stable argsort of the negated scores)."""
    order = torch.argsort(-scores, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    return ranks < n


def colwise_nm_mask(w: torch.Tensor, sparsity: float, m: Optional[int] = None,
                    tile: Optional[int] = None) -> torch.Tensor:
    """Column-wise N:M boolean mask of ``w`` [d_in, d_out]'s shape."""
    d_in, d_out = w.shape
    cfg = SparsityConfig(sparsity=sparsity, m=m, tile=tile, format="masked")
    tile, m, n, n_tiles, n_groups, _ = resolve_dims(d_in, d_out, cfg)
    scores = colwise_importance(w, tile).reshape(n_tiles, n_groups, m)
    keep = _topn_mask_lastdim(scores, n).reshape(n_tiles, d_in)
    return keep.T[:, :, None].expand(d_in, n_tiles, tile).reshape(d_in, d_out)


def conv_colwise_nm_mask(w_ohwi: torch.Tensor, sparsity: float,
                         m: Optional[int] = None,
                         tile: Optional[int] = None) -> torch.Tensor:
    """Column-wise N:M mask of an OHWI conv kernel over its GEMM view
    [Kh*Kw*C, O], returned in the kernel's own OHWI layout."""
    o, kh, kw, c = w_ohwi.shape
    mask = colwise_nm_mask(w_ohwi.reshape(o, kh * kw * c).T, sparsity, m=m,
                           tile=tile)
    return mask.T.reshape(o, kh, kw, c)


def rowwise_nm_mask(w: torch.Tensor, sparsity: float,
                    m: Optional[int] = None) -> torch.Tensor:
    """Row-based N:M baseline: the column-wise scheme with tile 1."""
    return colwise_nm_mask(w, sparsity, m=m, tile=1)
