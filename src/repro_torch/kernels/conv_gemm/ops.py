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
names, and differentiates in ``x`` and ``values`` whatever plan ran: its
backward is the JAX package's ``_conv_bwd`` in plain PyTorch, the im2col
gather and the transposed-conv scatter through the kept taps, accumulated
in float32.  The single-plan functions below stay forward only on the card.
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
    scatter_add_f32,
    sparse_grad_dvalues,
    sparse_grad_dxg,
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
from repro_torch.kernels.im2col_pack.kernel import tap_coords
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


def conv2d_sparse_bwd(x_cnhw: torch.Tensor, values: torch.Tensor,
                      idx: torch.Tensor, dy: torch.Tensor, *, kh: int, kw: int,
                      stride: int, pad: int):
    """``(dx, dvalues)`` of ``y[t*T+f, p] = sum_j values[t, j, f] *
    X_im2col[idx[t, j], p]`` under the cotangent ``dy`` [O, B, Ho, Wo], the
    twin of the JAX package's ``conv_gemm/ops.py::_conv_bwd``, without the
    im2col matrix.  The forward kernels' :func:`tap_coords` arithmetic, in
    int32 as in the JAX package (int64 for a map of 2^31 elements or more),
    gives ``fidx`` [P, n_tiles, k_kept], where output position p reads kept
    row ``idx[t, j]`` in the flat CNHW map; the kept rows are gathered there
    for ``dvalues`` (an einsum in float32, cast to the values' dtype), and
    ``dx`` is the transposed conv's scatter-add through the kept taps in
    float32 (output positions whose receptive fields overlap, and tiles that
    share a kept row, collide there), cast to the map's dtype."""
    c, b, h, w = x_cnhw.shape
    o, _, ho, wo = dy.shape
    n_pos = b * ho * wo
    n_tiles, _, tile = values.shape
    itype = torch.int32 if x_cnhw.numel() < 2 ** 31 else torch.int64
    idx = idx.to(itype)
    k_of = idx // c  # [n_tiles, k_kept] kernel tap ikh*kw + ikw
    c_of = idx % c   # [n_tiles, k_kept] input channel
    p = torch.arange(n_pos, dtype=itype, device=idx.device)[:, None, None]
    valid, bc, ihc, iwc = tap_coords(
        p, ikh=(k_of // kw)[None], ikw=(k_of % kw)[None], stride=stride,
        pad=pad, b=b, h=h, w=w, ho=ho, wo=wo)
    fidx = ((c_of[None] * b + bc) * h + ihc) * w + iwc  # [P, t, k]
    dy_t = dy.reshape(o, n_pos).T.reshape(n_pos, n_tiles, tile)  # [P, t, f]

    xg = torch.where(valid, x_cnhw.reshape(-1)[fidx], 0)  # [P, t, k]
    dvalues = sparse_grad_dvalues(xg, dy_t, values.dtype)
    dxg = sparse_grad_dxg(dy_t, values)  # [P, t, k] f32
    dx = scatter_add_f32(c * b * h * w, fidx, torch.where(valid, dxg, 0))
    return dx.reshape(c, b, h, w).to(x_cnhw.dtype), dvalues


class _ConvSparse(torch.autograd.Function):
    """``run(x, values, idx)``, the dispatched forward, with the backward of
    :func:`conv2d_sparse_bwd`.  Autograd is off inside ``forward``, so the
    kernel wrappers' no-grad check passes and the card runs the same kernels
    as an inference forward."""

    @staticmethod
    def forward(ctx, x_cnhw, values, idx, run, geom):
        ctx.geom = geom
        ctx.save_for_backward(x_cnhw, values, idx)
        return run(x_cnhw, values, idx)

    @staticmethod
    def backward(ctx, dy):
        x_cnhw, values, idx = ctx.saved_tensors
        dx, dvalues = conv2d_sparse_bwd(x_cnhw, values, idx, dy.contiguous(),
                                        **ctx.geom)
        return dx, dvalues, None, None, None


def conv2d_sparse(x_cnhw: torch.Tensor, values: torch.Tensor,
                  idx: torch.Tensor, *, kh: int, kw: int, stride: int = 1,
                  pad: int = 0, v: int = 128,
                  impl: Optional[str] = None) -> torch.Tensor:
    """Differentiable sparse conv under the plan ``repro_torch.dispatch``
    resolves for this shape and device, or under the candidate ``impl``
    names (the JAX registry's names, geometry suffixes included), through
    ``dispatch.run_guarded``: a candidate that refuses to run is quarantined
    and the next one runs; raises when none is left.  The backward
    (:func:`conv2d_sparse_bwd`) is the same for every plan; ``idx`` gets no
    gradient.  Returns CNHW [O, B, Ho, Wo]."""
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

    def run(x, values, idx):
        # execution guard, inside the autograd twin's forward so it holds
        # when training too: a rung that refuses to run is quarantined and
        # the plan re-resolves down the ladder
        return dispatch.run_guarded(
            make_key, spec,
            lambda s: s.apply({"values": values, "idx": idx}, x, kh=kh, kw=kw,
                              stride=stride, pad=pad, v=v),
            param_keys=("values", "idx"), device=x.device)

    return _ConvSparse.apply(x_cnhw, values, idx, run,
                             dict(kh=kh, kw=kw, stride=stride, pad=pad))


def conv2d_colwise_sparse(x_cnhw: torch.Tensor, values: torch.Tensor,
                          idx: torch.Tensor, kh: int, kw: int, stride: int = 1,
                          pad: int = 0, v: int = 128,
                          use_pallas: Optional[bool] = None) -> torch.Tensor:
    """Sparse conv with a selected plan, the twin of the JAX package's
    entry: ``use_pallas=None`` the dispatched, differentiable
    :func:`conv2d_sparse`; ``True`` the two-kernel plan; ``False`` the
    reference plan.  Returns CNHW [O, B, Ho, Wo]."""
    if use_pallas is None:
        return conv2d_sparse(x_cnhw, values, idx, kh=kh, kw=kw, stride=stride,
                             pad=pad, v=v)
    if use_pallas:
        return conv2d_two_kernel(x_cnhw, values, idx, kh=kh, kw=kw,
                                 stride=stride, pad=pad, v=v)
    return conv2d_xla_ref(x_cnhw, values, idx, kh=kh, kw=kw, stride=stride,
                          pad=pad, v=v)
