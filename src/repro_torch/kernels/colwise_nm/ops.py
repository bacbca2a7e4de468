"""Public wrappers of the column-wise N:M sparse GEMMs.  A CUDA tensor runs
the kernel (or raises); a CPU tensor runs the plain version.

The sparse linear (:func:`colwise_nm_matmul`, :func:`colwise_nm_matmul_tiled`)
differentiates, as the JAX package's custom VJP does
(``repro/kernels/colwise_nm/ops.py``): its forward is the kernel (or, on the
CPU, the plain version) with autograd off, and its backward the same
gather/scatter formulas in plain PyTorch, every contraction and the scatter
accumulated in float32.  The strip GEMMs stay forward only.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels.colwise_nm.kernel import (
    colwise_nm_matmul_cuda,
    colwise_nm_matmul_strips_cuda,
    colwise_nm_matmul_strips_pipelined_cuda,
    colwise_nm_matmul_tiled_cuda,
)
from repro_torch.kernels.colwise_nm.ref import (
    colwise_nm_matmul_ref,
    colwise_nm_matmul_strips_pipelined_ref,
    colwise_nm_matmul_strips_ref,
)
from repro_torch.roofline import kernels as work
from repro_torch.roofline.counter import counted

# the op counter's count of a call (roofline/kernels.py)
_LINEAR = counted("linear", lambda x, values, idx, **_: work.linear_work(
    x.numel() // x.shape[-1], values, idx, x.shape[-1]))
_STRIPS = counted("strips", lambda strips, values, idx, **_: work.strips_work(
    strips, values, idx))


# ---------------------------------------------------------------------------
# Shared backward contractions, twins of the JAX package's: the linear's
# backward below and the conv's (``conv_gemm/ops.py``) see the same
# [..., n_tiles, k] / [..., n_tiles, tile] layouts, the conv with its
# flattened output positions leading.  Both run on float32 copies, so bf16
# params are reduced in float32 (JAX: ``preferred_element_type=f32``).
# ---------------------------------------------------------------------------


def sparse_grad_dxg(dy_t: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """dL/d(gathered activations) of ``y_t = xg @ values[t]``.

    dy_t: [..., n_tiles, tile]; values: [n_tiles, k, tile].  Returns
    [..., n_tiles, k] in float32 (the caller scatters, then casts)."""
    return torch.einsum("...tf,tkf->...tk", dy_t.float(), values.float())


DVALUES_ROWS = 256  # rows of one partial sum of sparse_grad_dvalues


def sparse_grad_dvalues(xg: torch.Tensor, dy_t: torch.Tensor,
                        dtype: torch.dtype) -> torch.Tensor:
    """dL/dvalues of ``y_t = xg @ values[t]``: the gathered activations by
    dy, contracted over the leading (row or position) dims in float32.

    The rows are contracted ``DVALUES_ROWS`` at a time, one batched GEMM
    for all blocks, and the partial sums then added: as one contraction
    over a conv's 65536 positions and a [k, T] output of a few hundred
    values, the GEMM runs on a handful of blocks (2.1 ms on the H100).

    xg: [..., n_tiles, k]; dy_t: [..., n_tiles, tile].  Returns
    [n_tiles, k, tile] cast to the param ``dtype``."""
    n_tiles, k = xg.shape[-2:]
    xg = xg.reshape(-1, n_tiles, k).float()
    dy = dy_t.reshape(-1, n_tiles, dy_t.shape[-1]).float()
    full = xg.shape[0] // DVALUES_ROWS * DVALUES_ROWS
    out = torch.einsum("ptk,ptf->tkf", xg[full:], dy[full:])
    if full:
        blocks = torch.einsum(
            "sptk,sptf->stkf", xg[:full].reshape(-1, DVALUES_ROWS, n_tiles, k),
            dy[:full].reshape(-1, DVALUES_ROWS, *dy.shape[1:]))
        out = blocks.sum(0) + out
    return out.to(dtype)


def scatter_add_f32(n: int, index: torch.Tensor,
                    src: torch.Tensor) -> torch.Tensor:
    """A float32 vector of ``n`` zeros with ``src`` added at ``index`` (both
    flattened); duplicate indices add up.  Repeatable bit for bit: on CUDA
    an accumulating ``index_put_`` sorts the indices and sums each run of
    duplicates in a fixed order, where ``index_add_`` adds by atomics in an
    order that changes from run to run."""
    out = torch.zeros(n, dtype=torch.float32, device=src.device)
    return out.index_put_((index.reshape(-1),), src.reshape(-1).float(),
                          accumulate=True)


class _SparseLinear(torch.autograd.Function):
    """``fwd(x, values, idx)`` with the backward of the JAX package's
    ``colwise_nm/ops.py::_bwd``; ``x`` is 2-D [rows, d_in]."""

    @staticmethod
    def forward(ctx, x, values, idx, fwd):
        ctx.save_for_backward(x, values, idx)
        return fwd(x, values, idx)

    @staticmethod
    def backward(ctx, dy):
        x, values, idx = ctx.saved_tensors
        n_tiles, _, tile = values.shape
        rows, d_in = x.shape
        dy_t = dy.reshape(rows, n_tiles, tile)
        # dL/d(gathered x), scatter-added back to the d_in positions in
        # float32: tiles that share a kept row add up there, and only the
        # sum is cast to x's dtype
        dxg = sparse_grad_dxg(dy_t, values)  # [rows, t, k] f32
        flat = (torch.arange(rows, device=x.device)[:, None] * d_in
                + idx.long().reshape(1, -1))
        dx = scatter_add_f32(rows * d_in, flat, dxg).reshape(x.shape)
        dvalues = sparse_grad_dvalues(x[:, idx.long()], dy_t, values.dtype)
        return dx.to(x.dtype), dvalues, None, None


def _sparse_linear(x: torch.Tensor, values: torch.Tensor, idx: torch.Tensor,
                   fwd: Callable) -> torch.Tensor:
    """Flatten ``x``'s leading dims, run ``fwd`` under :class:`_SparseLinear`
    and restore them."""
    n_tiles, _, tile = values.shape
    lead = x.shape[:-1]
    y = _SparseLinear.apply(x.reshape(-1, x.shape[-1]), values, idx, fwd)
    return y.reshape(*lead, n_tiles * tile)


@_LINEAR
def colwise_nm_matmul(x: torch.Tensor, values: torch.Tensor, idx: torch.Tensor,
                      *, block_b: int = 128, block_k: int = 128) -> torch.Tensor:
    """Sparse linear ``y[..., t*T:(t+1)*T] = x[..., idx[t]] @ values[t]``,
    any leading dims on ``x``; differentiable in ``x`` and ``values``."""

    def fwd(x2, values, idx):
        if x2.device.type == "cpu":
            return colwise_nm_matmul_ref(x2, values, idx)
        return colwise_nm_matmul_cuda(x2.contiguous(), values, idx,
                                      block_b=block_b, block_k=block_k)

    return _sparse_linear(x, values, idx, fwd)


@_LINEAR
def colwise_nm_matmul_tiled(x: torch.Tensor, values: torch.Tensor,
                            idx: torch.Tensor) -> torch.Tensor:
    """The sparse linear of :func:`colwise_nm_matmul` through the tiled
    kernel, which takes tile widths that are a multiple of 64; any leading
    dims on ``x``; differentiable in ``x`` and ``values``."""

    def fwd(x2, values, idx):
        if x2.device.type == "cpu":
            return colwise_nm_matmul_ref(x2, values, idx)
        return colwise_nm_matmul_tiled_cuda(x2.contiguous(), values, idx)

    return _sparse_linear(x, values, idx, fwd)


@_STRIPS
def colwise_nm_matmul_strips(strips: torch.Tensor, values: torch.Tensor,
                             idx: torch.Tensor, *,
                             block_k: int = 128) -> torch.Tensor:
    """Strip-major sparse GEMM: packed [n_strips, K, V] strips -> [O, S*V].

    Consumes ``im2col_pack`` output directly; columns past the true position
    count are strip padding, sliced off by the conv wrapper.
    """
    if strips.device.type == "cpu":
        return colwise_nm_matmul_strips_ref(strips, values, idx)
    return colwise_nm_matmul_strips_cuda(strips, values, idx, block_k=block_k)


@_STRIPS
def colwise_nm_matmul_strips_pipelined(strips: torch.Tensor,
                                       values: torch.Tensor, idx: torch.Tensor,
                                       *, block_k: int = 128,
                                       hb: int = 2) -> torch.Tensor:
    """The strip GEMM's function, pipelined: ``hb`` strips per block, the
    gathered rows of slice i+1 copied while slice i is multiplied."""
    if strips.device.type == "cpu":
        return colwise_nm_matmul_strips_pipelined_ref(strips, values, idx, hb=hb)
    return colwise_nm_matmul_strips_pipelined_cuda(strips, values, idx,
                                                   block_k=block_k, hb=hb)
