"""Public wrapper of fused im2col + packing."""
from __future__ import annotations

import torch

from repro_torch.kernels.im2col_pack.kernel import im2col_pack_cuda
from repro_torch.kernels.im2col_pack.ref import im2col_pack_ref
from repro_torch.roofline.counter import counted
from repro_torch.roofline.kernels import pack_work


@counted("pack", lambda x, *, kh, kw, stride=1, pad=0, v=128:
         pack_work(x, kh, kw, stride, pad, v))
def im2col_pack(x: torch.Tensor, *, kh: int, kw: int, stride: int = 1,
                pad: int = 0, v: int = 128) -> torch.Tensor:
    """Fused single-pass im2col + packing: CNHW -> [n_strips, Kh*Kw*C, V].

    A CUDA tensor runs the kernel (or raises); a CPU tensor runs the plain
    two-pass version.
    """
    if x.device.type == "cpu":
        return im2col_pack_ref(x, kh, kw, stride, pad, v)
    return im2col_pack_cuda(x, kh, kw, stride, pad, v)
