"""Public wrappers of the column-wise N:M sparse GEMMs.  A CUDA tensor runs
the kernel (or raises); a CPU tensor runs the plain version."""
from __future__ import annotations

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


def colwise_nm_matmul(x: torch.Tensor, values: torch.Tensor, idx: torch.Tensor,
                      *, block_b: int = 128, block_k: int = 128) -> torch.Tensor:
    """Sparse linear ``y[..., t*T:(t+1)*T] = x[..., idx[t]] @ values[t]``,
    any leading dims on ``x``."""
    n_tiles, _, tile = values.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu":
        y = colwise_nm_matmul_ref(x2, values, idx)
    else:
        y = colwise_nm_matmul_cuda(x2.contiguous(), values, idx,
                                   block_b=block_b, block_k=block_k)
    return y.reshape(*lead, n_tiles * tile)


def colwise_nm_matmul_tiled(x: torch.Tensor, values: torch.Tensor,
                            idx: torch.Tensor) -> torch.Tensor:
    """The sparse linear of :func:`colwise_nm_matmul` through the tiled
    kernel, which takes tile widths that are a multiple of 64; any leading
    dims on ``x``."""
    n_tiles, _, tile = values.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu":
        y = colwise_nm_matmul_ref(x2, values, idx)
    else:
        y = colwise_nm_matmul_tiled_cuda(x2.contiguous(), values, idx)
    return y.reshape(*lead, n_tiles * tile)


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
