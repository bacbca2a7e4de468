"""GEMM-based sparse convolution in the paper's layouts: the two plans this
port runs, and the plan choice behind ``core.sparse_conv.conv_apply``.

  fused      : im2col + pack + sparse GEMM in one kernel (``conv2d_fused``);
               the packed strips never reach device memory
  two-kernel : the im2col+pack kernel, then the strip-major sparse GEMM
               on its [n_strips, K, V] output (``conv2d_two_kernel``)

Forward only: the conv backward and the other plans of the JAX package's
ladder (banded, pipelined, XLA reference, the profiled dispatch) are later
slices of the port (ROADMAP).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.formats import meta_for, pack_colwise
from repro_torch.core.pruning import SparsityConfig, colwise_nm_mask
from repro_torch.kernels.colwise_nm.ops import colwise_nm_matmul_strips
from repro_torch.kernels.conv_gemm.kernel import conv2d_fused_cuda
from repro_torch.kernels.conv_gemm.ref import conv2d_fused_ref
from repro_torch.kernels.im2col_pack.ops import im2col_pack
from repro_torch.kernels.im2col_pack.ref import out_size

FUSED = "fused_sparse_pallas"
TWO_KERNEL = "im2col_sparse_pallas"


def compress_conv_weights(w_ohwi: torch.Tensor, cfg: SparsityConfig):
    """Prune and compress an OHWI kernel column-wise over (kh, kw, c): the
    GEMM weight [Kh*Kw*C, O] -> (values, idx, meta)."""
    o, kh, kw, c = w_ohwi.shape
    wmat = w_ohwi.reshape(o, kh * kw * c).T
    meta = meta_for(kh * kw * c, o, cfg)
    mask = colwise_nm_mask(wmat, cfg.sparsity, m=cfg.m, tile=meta.tile)
    values, idx = pack_colwise(wmat, mask, meta)
    return values, idx, meta


def _to_cnhw(y: torch.Tensor, b: int, ho: int, wo: int) -> torch.Tensor:
    """[O, n_strips*V] -> contiguous CNHW [O, B, Ho, Wo] (drops strip padding)."""
    return y[:, : b * ho * wo].reshape(y.shape[0], b, ho, wo).contiguous()


def conv2d_fused(x_cnhw: torch.Tensor, values: torch.Tensor, idx: torch.Tensor,
                 *, kh: int, kw: int, stride: int = 1, pad: int = 0,
                 v: int = 128, block_k: int = 128) -> torch.Tensor:
    """Single-kernel sparse conv; returns CNHW [O, B, Ho, Wo].  A CUDA
    tensor runs the kernel (or raises); a CPU tensor its plain version."""
    c, b, h, w = x_cnhw.shape
    if x_cnhw.device.type == "cpu":
        y = conv2d_fused_ref(x_cnhw, values, idx, kh=kh, kw=kw, stride=stride,
                             pad=pad, v=v)
    else:
        y = conv2d_fused_cuda(x_cnhw, values, idx, kh=kh, kw=kw,
                              stride=stride, pad=pad, v=v, block_k=block_k)
    return _to_cnhw(y, b, out_size(h, kh, stride, pad),
                    out_size(w, kw, stride, pad))


def conv2d_two_kernel(x_cnhw: torch.Tensor, values: torch.Tensor,
                      idx: torch.Tensor, *, kh: int, kw: int, stride: int = 1,
                      pad: int = 0, v: int = 128,
                      block_k: int = 128) -> torch.Tensor:
    """Two-kernel plan: im2col+pack, then the strip-major sparse GEMM on the
    strips as they are.  Returns CNHW [O, B, Ho, Wo]."""
    c, b, h, w = x_cnhw.shape
    strips = im2col_pack(x_cnhw, kh=kh, kw=kw, stride=stride, pad=pad, v=v)
    y = colwise_nm_matmul_strips(strips, values, idx, block_k=block_k)
    return _to_cnhw(y, b, out_size(h, kh, stride, pad),
                    out_size(w, kw, stride, pad))


def conv2d_sparse(x_cnhw: torch.Tensor, values: torch.Tensor,
                  idx: torch.Tensor, *, kh: int, kw: int, stride: int = 1,
                  pad: int = 0, v: int = 128,
                  impl: Optional[str] = None) -> torch.Tensor:
    """Sparse conv forward under the plan ``impl`` names, with the JAX
    registry's names: ``None`` or ``"fused_sparse_pallas"`` runs the fused
    kernel at its default geometry (V = 128, block_k = 128, whatever the
    caller's ``v``, as in the JAX registry); ``"im2col_sparse_pallas"`` runs
    the two-kernel plan at strip width ``v``.  Returns CNHW [O, B, Ho, Wo].
    """
    if impl is None or impl == FUSED:
        return conv2d_fused(x_cnhw, values, idx, kh=kh, kw=kw, stride=stride,
                            pad=pad, v=128, block_k=128)
    if impl == TWO_KERNEL:
        return conv2d_two_kernel(x_cnhw, values, idx, kh=kh, kw=kw,
                                 stride=stride, pad=pad, v=v)
    raise ValueError(
        f"conv plan {impl!r} is not ported yet; this slice runs "
        f"{FUSED!r} and {TWO_KERNEL!r}, the other plans and the profiled "
        "dispatch come with ROADMAP queue-1 item 7")
