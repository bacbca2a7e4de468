"""Shared LM components (twin of ``repro/models/common.py``): RMSNorm and
LayerNorm, RoPE and Qwen2-VL's M-RoPE, Whisper's sinusoidal positions and
the token embedding."""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch._compat import resolve_device
from repro_torch.core.sparse_linear import box
from repro_torch.sharding.api import (all_reduce_sum, gather_leaf,
                                      is_laid_out, rank_chunk, split_dim)


def norm_init(d: int, kind: str = "rmsnorm", dtype=torch.float32,
              device=None):
    """``{"scale"}`` of ones, and for ``kind="layernorm"`` a ``"bias"`` of
    zeros, on ``device`` (``None``: the CUDA card)."""
    dev = resolve_device(device)
    p = {"scale": box(torch.ones((d,), dtype=dtype, device=dev), (None,))}
    if kind == "layernorm":
        p["bias"] = box(torch.zeros((d,), dtype=dtype, device=dev), (None,))
    return p


def norm_apply(params, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm, or LayerNorm for ``kind="layernorm"``, in float32, returned
    in ``x``'s dtype."""
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * params["scale"].float() + params["bias"].float()
    else:
        var = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * params["scale"].float()
    return y.to(x.dtype)


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


@functools.lru_cache(maxsize=None)
def _freqs_on(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    # copied to the device once, so a serving step copies nothing from the
    # host (and can be captured in a CUDA graph)
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions [..., S] -> cos/sin [..., S, head_dim//2] (float32)."""
    ang = positions.float()[..., None] * _freqs_on(head_dim, theta,
                                                   positions.device)
    return torch.cos(ang), torch.sin(ang)


@functools.lru_cache(maxsize=None)
def _section_ids(sections: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The position component [D/2] each frequency slot reads, on
    ``device``."""
    return torch.from_numpy(np.repeat(np.arange(len(sections)), sections)).to(
        device)


def mrope_cos_sin(positions_3: torch.Tensor, head_dim: int, theta: float,
                  sections: Tuple[int, ...]):
    """Qwen2-VL multimodal RoPE.  positions_3 [B, 3, S] (temporal, h, w) ->
    cos/sin [B, S, head_dim//2] (float32).

    The head_dim/2 frequency slots are split into ``sections`` (summing to
    head_dim/2), and each slot takes its angle from its section's position
    component.  The JAX package picks the component by a one-hot einsum; a
    gather by section id gives the same bits for finite angles.  Text
    tokens carry three equal components, which is 1-D RoPE exactly.
    """
    if sum(sections) != head_dim // 2:
        raise ValueError(f"mrope sections {sections} must sum to head_dim/2 "
                         f"= {head_dim // 2}")
    pos = positions_3[:, _section_ids(tuple(sections), positions_3.device)]
    pos = pos.transpose(1, 2)  # [B, S, D/2]
    ang = pos.float() * _freqs_on(head_dim, theta, positions_3.device)
    return torch.cos(ang), torch.sin(ang)


def sinusoidal_positions(n: int, d: int) -> np.ndarray:
    """Whisper-style fixed sinusoidal embeddings [n, d] (numpy float32,
    computed in float64 as the JAX package computes them)."""
    pos = np.arange(n)[:, None]
    dim = np.arange(d // 2)[None, :]
    inv = np.exp(-math.log(10000.0) * dim / max(d // 2 - 1, 1))
    ang = pos * inv
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=8)
def sinusoidal_on(n: int, d: int, device: torch.device) -> torch.Tensor:
    """:func:`sinusoidal_positions` copied to ``device`` once per (n, d), so
    a decode step copies nothing from the host."""
    return torch.from_numpy(sinusoidal_positions(n, d)).to(device)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D]; cos/sin [B, S, D/2], broadcast over heads.  Rotates
    the pairs (x[..., :D/2], x[..., D/2:]), the NeoX convention of the
    Llama family."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2].float(), x[..., d2:].float()
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """[vocab, d] N(0, 0.02^2) table; ``generator`` is a CPU generator."""
    e = torch.randn((vocab, d), generator=generator, dtype=torch.float32) * 0.02
    return box(e.to(resolve_device(device), dtype), ("vocab", "embed"))


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The rows of ``table`` at ``ids``.  A laid-out table (``("vocab",
    "embed")``, the model and data axes) is gathered over the data axis; a
    rank looks up the ids among its vocab rows, 0 for the rest, and the
    ranks' rows are summed over the model axis: each sum has one nonzero
    term, so it is exact."""
    if not is_laid_out(table):
        return table[ids.long()]
    rows = gather_leaf(table, keep=("model",))
    if split_dim(table) != 0:
        return rows[ids.long()]
    mesh = table.device_mesh
    lo, hi = rank_chunk(table.shape[0], ("model",), mesh)
    ids = ids.long()
    inside = ((ids >= lo) & (ids < hi))[..., None]
    out = torch.where(inside, rows[(ids - lo).clamp(0, hi - lo - 1)], 0.0)
    return all_reduce_sum(out, "model", mesh)
