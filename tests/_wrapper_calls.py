"""One small call of every kernel wrapper (``*_cuda``) of the port, shared
by the CPU tests and the card tests of the no-grad check: each wrapper
refuses a call autograd would record, before any other check, so the same
calls raise on CPU tensors as on the card."""
import numpy as np
import torch

from _paged_cases import problem
from repro_torch.kernels.colwise_nm import kernel as colwise
from repro_torch.kernels.conv_gemm import kernel as conv
from repro_torch.kernels.flash_attn import kernel as flash
from repro_torch.kernels.flash_attn import paged
from repro_torch.kernels.im2col_pack import kernel as im2col

# the modules whose ``*_cuda`` functions launch the port's kernels
MODULES = (colwise, conv, flash, paged, im2col)


def _f(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))


def _compressed(rng, n_tiles, k_rows, k_kept, tile):
    idx = np.stack([np.sort(rng.choice(k_rows, k_kept, replace=False))
                    for _ in range(n_tiles)]).astype(np.int32)
    return _f(rng, n_tiles, k_kept, tile), torch.from_numpy(idx)


def calls(dev):
    """{wrapper name: (function, float operands, int operands, keywords)},
    on ``dev``.  The float operands are the ones a caller might mark to
    require grad; every call is one the kernel takes."""
    rng = np.random.default_rng(0)
    x = _f(rng, 8, 2, 8, 8).to(dev)  # CNHW map, C 8
    values, idx = (t.to(dev) for t in _compressed(rng, 2, 72, 36, 8))
    v64, i64 = (t.to(dev) for t in _compressed(rng, 1, 72, 36, 64))
    strips = _f(rng, 1, 72, 128).to(dev)
    rows = _f(rng, 4, 72).to(dev)
    qkv = tuple(_f(rng, 1, 8, 2, 16).to(dev) for _ in range(3))
    pg = [torch.from_numpy(a).to(dev) for a in problem()]
    conv_kw = dict(kh=3, kw=3, pad=1)
    paged_kw = dict(page_size=8)
    return {
        "im2col_pack_cuda": (im2col.im2col_pack_cuda, (x,), (),
                             dict(kh=3, kw=3, stride=1, pad=1)),
        "im2col_pack_scalar_cuda": (im2col.im2col_pack_scalar_cuda, (x,), (),
                                    dict(kh=3, kw=3, stride=1, pad=1)),
        "im2col_pack_tiled_cuda": (im2col.im2col_pack_tiled_cuda, (x,), (),
                                   dict(kh=3, kw=3, stride=1, pad=1)),
        "colwise_nm_matmul_strips_cuda": (
            colwise.colwise_nm_matmul_strips_cuda, (strips, values), (idx,), {}),
        "colwise_nm_matmul_strips_pipelined_cuda": (
            colwise.colwise_nm_matmul_strips_pipelined_cuda, (strips, values),
            (idx,), {}),
        "colwise_nm_matmul_strips_scalar_cuda": (
            colwise.colwise_nm_matmul_strips_scalar_cuda, (strips, values),
            (idx,), {}),
        "colwise_nm_matmul_strips_pipelined_scalar_cuda": (
            colwise.colwise_nm_matmul_strips_pipelined_scalar_cuda,
            (strips, values), (idx,), {}),
        "colwise_nm_matmul_strips_tiled_cuda": (
            colwise.colwise_nm_matmul_strips_tiled_cuda, (strips, values),
            (idx,), {}),
        "colwise_nm_matmul_strips_pipelined_tiled_cuda": (
            colwise.colwise_nm_matmul_strips_pipelined_tiled_cuda,
            (strips, values), (idx,), {}),
        "colwise_nm_matmul_cuda": (colwise.colwise_nm_matmul_cuda,
                                   (rows, values), (idx,), {}),
        "colwise_nm_matmul_tiled_cuda": (colwise.colwise_nm_matmul_tiled_cuda,
                                         (rows, v64), (i64,), {}),
        "conv2d_fused_cuda": (conv.conv2d_fused_cuda, (x, values), (idx,),
                              conv_kw),
        "conv2d_fused_scalar_cuda": (conv.conv2d_fused_scalar_cuda,
                                     (x, values), (idx,), conv_kw),
        "conv2d_fused_tiled_cuda": (conv.conv2d_fused_tiled_cuda, (x, values),
                                    (idx,), conv_kw),
        "conv2d_fused_banded_cuda": (conv.conv2d_fused_banded_cuda,
                                     (x, values), (idx,), conv_kw),
        "conv2d_fused_banded_scalar_cuda": (
            conv.conv2d_fused_banded_scalar_cuda, (x, values), (idx,), conv_kw),
        "conv2d_fused_banded_tiled_cuda": (
            conv.conv2d_fused_banded_tiled_cuda, (x, values), (idx,), conv_kw),
        "flash_attention_cuda": (flash.flash_attention_cuda, qkv, (), {}),
        "flash_attention_scalar_cuda": (flash.flash_attention_scalar_cuda, qkv,
                                        (), {}),
        "flash_attention_tiled_cuda": (flash.flash_attention_tiled_cuda, qkv,
                                       (), {}),
        "paged_attention_cuda": (paged.paged_attention_cuda, tuple(pg[:5]),
                                 tuple(pg[5:]), paged_kw),
        "paged_attention_scalar_cuda": (paged.paged_attention_scalar_cuda,
                                        tuple(pg[:5]), tuple(pg[5:]), paged_kw),
        "paged_attention_split_cuda": (paged.paged_attention_split_cuda,
                                       tuple(pg[:5]), tuple(pg[5:]), paged_kw),
    }


NAMES = sorted(calls("cpu"))


def call_with_grad(name, dev, which):
    """Call wrapper ``name`` on ``dev`` with float operand ``which``
    requiring grad."""
    fn, floats, ints, kw = calls(dev)[name]
    floats = [t.clone().requires_grad_(i == which) for i, t in enumerate(floats)]
    return fn(*floats, *ints, **kw)


def n_floats(name):
    return len(calls("cpu")[name][1])
