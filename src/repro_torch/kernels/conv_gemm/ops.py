"""GEMM-based sparse convolution in the paper's layouts: the conv plan
ladder (twin of ``repro/kernels/conv_gemm/ops.py``'s forward half).

  fused      : im2col + pack + sparse GEMM in one kernel (``conv2d_fused``);
               the packed strips never reach device memory.  On the card
               ``conv2d_fused_tiled`` (dense im2col slices gathered once for
               a group of tiles) where ``fused_tiled_takes`` says so, else
               ``conv2d_fused.cu``; the two give the same bits
  banded     : the same fused conv with only a double-buffered row band of
               the map in shared memory (``conv2d_fused_banded``)
  two-kernel : the im2col+pack kernel, then the strip-major sparse GEMM on
               its [n_strips, K, V] output (``conv2d_two_kernel``), or its
               pipelined twin (``conv2d_two_kernel_pipelined``)
  reference  : the pack kernel, then a gather-einsum GEMM in PyTorch
               (``conv2d_xla_ref``, the twin of the JAX package's XLA plan)

``conv2d_sparse`` runs the plan that ``repro_torch.dispatch`` resolves for
the conv's shape (profile DB, else the heuristic), or the one ``impl``
names.  Forward only: the conv backward is a later slice of the port.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.formats import meta_for, pack_colwise
from repro_torch.core.pruning import SparsityConfig, colwise_nm_mask
from repro_torch.core.sparse_linear import forward_compressed_xla
from repro_torch.kernels.colwise_nm.ops import (
    colwise_nm_matmul_strips,
    colwise_nm_matmul_strips_pipelined,
)
from repro_torch.kernels.conv_gemm.kernel import (
    conv2d_fused_banded_cuda,
    conv2d_fused_cuda,
)
from repro_torch.kernels.conv_gemm.plan import band_plan
from repro_torch.kernels.conv_gemm.ref import (
    conv2d_fused_banded_ref,
    conv2d_fused_ref,
)
from repro_torch.kernels.im2col_pack.ops import im2col_pack
from repro_torch.kernels.im2col_pack.ref import out_size


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


def _out_hw(x: torch.Tensor, kh: int, kw: int, stride: int, pad: int):
    _c, b, h, w = x.shape
    return b, out_size(h, kh, stride, pad), out_size(w, kw, stride, pad)


def conv2d_fused(x_cnhw: torch.Tensor, values: torch.Tensor, idx: torch.Tensor,
                 *, kh: int, kw: int, stride: int = 1, pad: int = 0,
                 v: int = 128, block_k: int = 128) -> torch.Tensor:
    """Single-kernel sparse conv; returns CNHW [O, B, Ho, Wo].  A CUDA
    tensor runs the kernel (or raises); a CPU tensor its plain version."""
    if x_cnhw.device.type == "cpu":
        y = conv2d_fused_ref(x_cnhw, values, idx, kh=kh, kw=kw, stride=stride,
                             pad=pad, v=v)
    else:
        y = conv2d_fused_cuda(x_cnhw, values, idx, kh=kh, kw=kw,
                              stride=stride, pad=pad, v=v, block_k=block_k)
    return _to_cnhw(y, *_out_hw(x_cnhw, kh, kw, stride, pad))


def conv2d_fused_banded(x_cnhw: torch.Tensor, values: torch.Tensor,
                        idx: torch.Tensor, *, kh: int, kw: int,
                        stride: int = 1, pad: int = 0, v: int = 128,
                        block_k: int = 128, hb: int = 2) -> torch.Tensor:
    """Banded fused conv: only two windows of ``hb`` strips' input rows (plus
    the kh-1 halo) are in shared memory.  Same function as
    :func:`conv2d_fused`; returns CNHW [O, B, Ho, Wo]."""
    if x_cnhw.device.type == "cpu":
        y = conv2d_fused_banded_ref(x_cnhw, values, idx, kh=kh, kw=kw,
                                    stride=stride, pad=pad, v=v, hb=hb)
    else:
        y = conv2d_fused_banded_cuda(x_cnhw, values, idx, kh=kh, kw=kw,
                                     stride=stride, pad=pad, v=v,
                                     block_k=block_k, hb=hb)
    return _to_cnhw(y, *_out_hw(x_cnhw, kh, kw, stride, pad))


def conv2d_two_kernel(x_cnhw: torch.Tensor, values: torch.Tensor,
                      idx: torch.Tensor, *, kh: int, kw: int, stride: int = 1,
                      pad: int = 0, v: int = 128,
                      block_k: int = 128) -> torch.Tensor:
    """Two-kernel plan: im2col+pack, then the strip-major sparse GEMM on the
    strips as they are.  Returns CNHW [O, B, Ho, Wo]."""
    strips = im2col_pack(x_cnhw, kh=kh, kw=kw, stride=stride, pad=pad, v=v)
    y = colwise_nm_matmul_strips(strips, values, idx, block_k=block_k)
    return _to_cnhw(y, *_out_hw(x_cnhw, kh, kw, stride, pad))


def conv2d_two_kernel_pipelined(x_cnhw: torch.Tensor, values: torch.Tensor,
                                idx: torch.Tensor, *, kh: int, kw: int,
                                stride: int = 1, pad: int = 0, v: int = 128,
                                block_k: int = 128,
                                hb: int = 2) -> torch.Tensor:
    """Two-kernel plan with the pipelined strip GEMM (``hb`` strips per
    block, gathered rows copied ahead of the multiply).  Returns CNHW
    [O, B, Ho, Wo]."""
    strips = im2col_pack(x_cnhw, kh=kh, kw=kw, stride=stride, pad=pad, v=v)
    y = colwise_nm_matmul_strips_pipelined(strips, values, idx,
                                           block_k=block_k, hb=hb)
    return _to_cnhw(y, *_out_hw(x_cnhw, kh, kw, stride, pad))


def banded_bytes_moved(c: int, b: int, h: int, w: int, kh: int, stride: int,
                       pad: int, ho: int, wo: int, v: int, hb: int,
                       o: int, itemsize: int) -> int:
    """Device-memory traffic of the banded conv at band depth ``hb``: every
    band copies its ``band_rows``-row window once (halo rows are read again
    by the next band), and the [O, P] output is written once."""
    n_bands, band_rows = band_plan(b=b, h=h, kh=kh, stride=stride, pad=pad,
                                   ho=ho, wo=wo, v=v, hb=hb)
    n_strips = -(-b * ho * wo // v)
    return (n_bands * c * band_rows * w + o * n_strips * v) * itemsize


def conv2d_xla_ref(x_cnhw: torch.Tensor, values: torch.Tensor,
                   idx: torch.Tensor, *, kh: int, kw: int, stride: int = 1,
                   pad: int = 0, v: int = 128) -> torch.Tensor:
    """Reference plan: the pack kernel, then the gather-einsum GEMM in
    PyTorch over per-position rows.  Returns CNHW [O, B, Ho, Wo]."""
    c = x_cnhw.shape[0]
    b, ho, wo = _out_hw(x_cnhw, kh, kw, stride, pad)
    o = values.shape[0] * values.shape[2]
    strips = im2col_pack(x_cnhw, kh=kh, kw=kw, stride=stride, pad=pad, v=v)
    xt = strips.transpose(1, 2).reshape(-1, kh * kw * c)  # [S*V, K]
    y = forward_compressed_xla(xt, values, idx)[: b * ho * wo]
    return y.T.reshape(o, b, ho, wo).contiguous()


def conv2d_sparse(x_cnhw: torch.Tensor, values: torch.Tensor,
                  idx: torch.Tensor, *, kh: int, kw: int, stride: int = 1,
                  pad: int = 0, v: int = 128,
                  impl: Optional[str] = None) -> torch.Tensor:
    """Sparse conv forward under the plan ``repro_torch.dispatch`` resolves
    for this shape and device, or under the candidate ``impl`` names (the
    JAX registry's names, geometry suffixes included).  A candidate that
    cannot run raises.  Returns CNHW [O, B, Ho, Wo]."""
    from repro_torch import dispatch

    phase = dispatch.current_phase()

    def make_key():
        c, b, h, w = x_cnhw.shape
        n_tiles, k_kept, tile = (int(s) for s in values.shape)
        return dispatch.conv_key(c, h, w, n_tiles * tile, kh, kw, stride, pad,
                                 k_kept, tile, v=v, dtype=x_cnhw.dtype, batch=b,
                                 phase=phase)

    site = ("conv", x_cnhw.shape, values.shape, x_cnhw.dtype, x_cnhw.device,
            kh, kw, stride, pad, v, phase)
    spec = dispatch.site_impl(site, make_key, param_keys=("values", "idx"),
                              force=dispatch.forced_impl("conv", impl),
                              device=x_cnhw.device)
    return spec.apply({"values": values, "idx": idx}, x_cnhw, kh=kh, kw=kw,
                      stride=stride, pad=pad, v=v)
