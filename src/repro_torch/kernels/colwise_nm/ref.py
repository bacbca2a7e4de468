"""Plain PyTorch column-wise N:M sparse matmuls (twin of
``repro/kernels/colwise_nm/ref.py``)."""
from __future__ import annotations

import torch

from repro_torch.core.formats import ColwiseMeta, unpack_colwise


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
