"""Public wrapper of the strip-major column-wise N:M sparse GEMM."""
from __future__ import annotations

import torch

from repro_torch.kernels.colwise_nm.kernel import colwise_nm_matmul_strips_cuda
from repro_torch.kernels.colwise_nm.ref import colwise_nm_matmul_strips_ref


def colwise_nm_matmul_strips(strips: torch.Tensor, values: torch.Tensor,
                             idx: torch.Tensor, *,
                             block_k: int = 128) -> torch.Tensor:
    """Strip-major sparse GEMM: packed [n_strips, K, V] strips -> [O, S*V].

    Consumes ``im2col_pack`` output directly; columns past the true position
    count are strip padding, sliced off by the conv wrapper.  A CUDA tensor
    runs the kernel (or raises); a CPU tensor runs the plain version.
    """
    if strips.device.type == "cpu":
        return colwise_nm_matmul_strips_ref(strips, values, idx)
    return colwise_nm_matmul_strips_cuda(strips, values, idx, block_k=block_k)
