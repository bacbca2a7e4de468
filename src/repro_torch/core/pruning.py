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

from repro_torch._tree import tree_map, tree_map_with_path


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


def mask_project_tree(params):
    """Re-apply every masked layer's stored ``mask`` to its ``w``: the
    per-step projection of masked finetuning (paper §4.1.2: the support
    stays fixed while the kept weights train), run after each optimizer
    update so momentum cannot bring pruned positions back.  Walks dicts,
    lists and tuples; linear ([d_in, d_out]) and conv (OHWI) layers alike,
    everything else passes through."""
    from repro_torch.core.sparse_conv import apply_conv_mask

    def walk(t):
        if isinstance(t, dict):
            # apply_conv_mask holds the one copy of the w * mask projection;
            # it does not read the layout, so linear layers go through it too
            return apply_conv_mask({k: walk(v) for k, v in t.items()})
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return t

    return walk(params)


def unstructured_mask(w: torch.Tensor, sparsity: float) -> torch.Tensor:
    """Global magnitude pruning (upper bound on flexibility): keep the
    ``round(numel * (1 - sparsity))`` largest |w|, ties to the earlier
    position."""
    k = max(int(round(w.numel() * (1.0 - sparsity))), 1)
    return _topn_mask_lastdim(w.abs().reshape(-1), k).reshape(w.shape)


# ---------------------------------------------------------------------------
# Mask invariants (used by tests)
# ---------------------------------------------------------------------------


def mask_is_colwise(mask: torch.Tensor, tile: int) -> bool:
    """Within each output tile, all columns share the keep pattern."""
    d_in, d_out = mask.shape
    m = torch.as_tensor(mask).reshape(d_in, d_out // tile, tile)
    return bool(torch.all(m.all(dim=2) == m.any(dim=2)))


def mask_nm_counts(mask: torch.Tensor, m_group: int) -> torch.Tensor:
    """Per-(group, column) kept counts along d_in, for N:M verification."""
    d_in, d_out = mask.shape
    return torch.as_tensor(mask).reshape(d_in // m_group, m_group,
                                         d_out).sum(dim=1)


# ---------------------------------------------------------------------------
# One-shot pruning over a parameter tree
# ---------------------------------------------------------------------------


def _mask_nd(w: torch.Tensor, mask_fn) -> torch.Tensor:
    """Apply a 2-D mask function over the trailing two dims of an N-D weight
    (stacked layers are [L, ..., d_in, d_out]), one layer at a time."""
    if w.ndim == 2:
        return mask_fn(w)
    flat = w.reshape((-1,) + tuple(w.shape[-2:]))
    return torch.stack([mask_fn(layer) for layer in flat]).reshape(w.shape)


def prune_tree(params, cfg: SparsityConfig, is_weight=None):
    """One-shot prune every >=2-D float weight in a tree (magnitude/L1, the
    paper's one-shot recipe); stacked layer weights ([L, d_in, d_out]) are
    masked per layer.  Returns (masked_params, masks), ``masks`` a matching
    tree holding ``None`` for untouched leaves.

    is_weight: optional predicate (path, leaf) -> bool to select leaves; a
    path is the tuple of dict keys and sequence indices from the root.
    """
    def one(path, leaf):
        take = (isinstance(leaf, torch.Tensor) and leaf.ndim >= 2
                and leaf.is_floating_point()
                and cfg.applies_to(leaf.shape[-2], leaf.shape[-1]))
        if take and is_weight is not None:
            take = is_weight(path, leaf)
        if not take:
            return leaf, None
        if cfg.scheme == "rowwise":
            fn = lambda w: rowwise_nm_mask(w, cfg.sparsity, m=cfg.m)  # noqa: E731
        else:
            fn = lambda w: colwise_nm_mask(w, cfg.sparsity, m=cfg.m,  # noqa: E731
                                           tile=cfg.tile)
        mask = _mask_nd(leaf, fn)
        return leaf * mask.to(leaf.dtype), mask

    out = tree_map_with_path(one, params)
    return (tree_map(lambda _p, t: t[0], params, out),
            tree_map(lambda _p, t: t[1], params, out))
