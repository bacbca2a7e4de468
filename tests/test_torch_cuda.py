"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: where there is no CUDA card every test here skips.  On a
machine with one, from the repository root:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The shapes go past the main path's: tiles that are not a multiple of the
kernels' 8-row register block, ``block_k`` chunking, strips wider than a
block's 128 threads, ragged last strips, and bf16.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import KERNELS, reset_launch_counts
from repro_torch.kernels.colwise_nm import (
    colwise_nm_matmul_strips_cuda,
    colwise_nm_matmul_strips_ref,
)
from repro_torch.kernels.conv_gemm import conv2d_fused_cuda, conv2d_fused_ref
from repro_torch.kernels.im2col_pack import im2col_pack_cuda, im2col_pack_ref

pytestmark = pytest.mark.cuda

# (C, B, H, W, k, stride, pad, v)
CASES = [
    (8, 2, 16, 16, 3, 1, 1, 128),
    (16, 3, 9, 9, 3, 2, 1, 128),    # ragged last strip, stride 2
    (16, 2, 12, 12, 1, 2, 0, 64),   # 1x1 strided projection
    (5, 2, 11, 7, 3, 1, 0, 256),    # strips wider than one block
    (4, 1, 6, 6, 2, 1, 1, 32),      # even kernel, narrow strips
]
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # of max|y|


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _x(c, b, h, w, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((c, b, h, w), dtype=np.float32)
                            ).to(dev, dtype)


def _compressed(n_tiles, k_rows, k_kept, tile, dtype, dev, seed=1):
    rng = np.random.default_rng(seed)
    values = rng.standard_normal((n_tiles, k_kept, tile), dtype=np.float32)
    idx = np.stack([np.sort(rng.choice(k_rows, k_kept, replace=False))
                    for _ in range(n_tiles)]).astype(np.int32)
    return (torch.from_numpy(values).to(dev, dtype),
            torch.from_numpy(idx).to(dev))


def _close(got, want, dtype):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert bool(torch.isfinite(got).all())
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL[dtype] * max(float(want.float().abs().max()), 1.0), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,b,h,w,k,stride,pad,v", CASES)
def test_im2col_pack_kernel_bit_exact(dev, c, b, h, w, k, stride, pad, v, dtype):
    x = _x(c, b, h, w, dtype, dev)
    got = im2col_pack_cuda(x, k, k, stride, pad, v)
    torch.cuda.synchronize()
    assert torch.equal(got, im2col_pack_ref(x, k, k, stride, pad, v))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile,n_tiles,keep,block_k", [
    (8, 2, 0.5, 128), (12, 3, 0.5, 128), (3, 4, 0.25, 7), (16, 1, 1.0, 32)])
@pytest.mark.parametrize("c,b,h,w,k,stride,pad,v", CASES[:4])
def test_sparse_kernels_match_plain(dev, c, b, h, w, k, stride, pad, v,
                                    tile, n_tiles, keep, block_k, dtype):
    x = _x(c, b, h, w, dtype, dev)
    k_rows = k * k * c
    values, idx = _compressed(n_tiles, k_rows, max(1, int(k_rows * keep)),
                              tile, dtype, dev)
    geo = dict(kh=k, kw=k, stride=stride, pad=pad, v=v)
    _close(conv2d_fused_cuda(x, values, idx, block_k=block_k, **geo),
           conv2d_fused_ref(x, values, idx, **geo), dtype)
    strips = im2col_pack_ref(x, k, k, stride, pad, v)
    _close(colwise_nm_matmul_strips_cuda(strips, values, idx, block_k=block_k),
           colwise_nm_matmul_strips_ref(strips, values, idx), dtype)


def test_out_of_range_index_gives_nan_not_a_bad_read(dev):
    x = _x(8, 1, 8, 8, torch.float32, dev)
    values, idx = _compressed(2, 72, 36, 8, torch.float32, dev)
    idx[1, 3] = 72  # one past the last im2col row
    y = conv2d_fused_cuda(x, values, idx, kh=3, kw=3, pad=1)
    g = colwise_nm_matmul_strips_cuda(im2col_pack_ref(x, 3, 3, 1, 1, 128),
                                      values, idx)
    torch.cuda.synchronize()
    for out in (y, g):
        assert bool(torch.isnan(out[8:, :64]).all())  # tile 1, every position
        assert bool(torch.isfinite(out[:8]).all())    # tile 0 is untouched


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = _x(8, 2, 8, 8, torch.float32, dev)
    values, idx = _compressed(2, 72, 36, 8, torch.float32, dev)
    with pytest.raises(ValueError, match="contiguous"):
        im2col_pack_cuda(x.transpose(2, 3), 3, 3, 1, 1)
    with pytest.raises(TypeError, match="dtype"):
        conv2d_fused_cuda(x, values.to(torch.bfloat16), idx, kh=3, kw=3, pad=1)
    with pytest.raises(TypeError, match="dtype"):
        conv2d_fused_cuda(x, values, idx.long(), kh=3, kw=3, pad=1)
    with pytest.raises(ValueError, match="does not match"):
        colwise_nm_matmul_strips_cuda(im2col_pack_ref(x, 3, 3, 1, 1, 128),
                                      values, idx[:, :10].contiguous())
    with pytest.raises(ValueError, match="shared memory"):
        conv2d_fused_cuda(x, values, idx, kh=3, kw=3, pad=1, block_k=0)


def test_each_launch_counts_once(dev):
    x = _x(8, 2, 8, 8, torch.float32, dev)
    values, idx = _compressed(2, 72, 36, 8, torch.float32, dev)
    reset_launch_counts()
    strips = im2col_pack_cuda(x, 3, 3, 1, 1)
    colwise_nm_matmul_strips_cuda(strips, values, idx)
    conv2d_fused_cuda(x, values, idx, kh=3, kw=3, pad=1)
    conv2d_fused_cuda(x, values, idx, kh=3, kw=3, pad=1)
    torch.cuda.synchronize()
    assert {k.name: k.launches for k in KERNELS} == {
        "conv2d_fused": 2, "im2col_pack": 1, "colwise_nm_matmul_strips": 1}


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def test_vision_forward_on_card_matches_cpu(dev):
    from repro_torch.configs import get_vision_config
    from repro_torch.models.vision import synth_batch, vision_apply, vision_init

    cfg = get_vision_config("resnet-tiny")
    params = vision_init(cfg, 0, device="cpu")
    x, _ = synth_batch(cfg, 1, 8, device="cpu")
    want = vision_apply(params, cfg, x)  # plain versions on the CPU
    on_card = _to(params, dev)
    for impl in (None, "im2col_sparse_pallas"):
        got = vision_apply(on_card, cfg, x.to(dev), impl=impl).cpu()
        err = float((got - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), (impl, err)
