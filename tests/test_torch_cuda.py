"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: where there is no CUDA card every test here skips.  On a
machine with one, from the repository root:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The shapes go past the main path's: tiles that are not a multiple of the
kernels' 8-row register block, ``block_k`` chunking, strips wider than a
block's 128 threads, ragged last strips and bands, and bf16; the sparse
linear kernel also runs at smollm-360m's MLP widths.  The banded convs and
the pipelined strip GEMM must give the same bits as the fused conv and the
plain strip GEMM (the tiled banded conv under every instance and stage
count, routed by its shape rule, with a bad index, an inf weight on a
padding tap and a window too short), and the tiled linear the same bits as the linear kernel
(rows under, at and over each block size, ragged kept rows, several
tiles).  Both paged-attention kernels run the CPU parity tests'
cases and smollm-360m's serving shapes, the trash-page, empty-cache and
bad-page-id cases, their rejections, dispatch on the card, and a served
request of the smoke model; the split kernel agrees with the plain version
and with ``paged_attention.cu`` under every warp count, with more pages
than warps and new keys past one page, and the wrapper routes by its shape
rule.  Every kernel wrapper raises where autograd would record the call.  The flash-attention kernels run the JAX flash
tests' sweep (f32 and bf16, JAX's tolerances), the GQA head map for
H % KV != 0, the top-left causal mask when Sq != Sk, large logits,
smollm-360m's scoring shape, their rejections, and one launch per layer
through ``attn_apply`` and the smoke model's forward; the tiled kernel gives
the other's bits (``torch.equal``) under every instance over the sweep and
the GQA cases, keys past Sk stay out even where NaN follows them in memory,
and the wrapper routes by the shape rule (a misaligned view and heads that
are not whole 16-byte rows go to ``flash_attention.cu``).  A resnet-tiny
train step under each conv family launches the family's kernels in its
forward and agrees with the same step on the CPU, two runs of the same
steps give the same bits, the sparse linear's backward agrees with the CPU
through both linear entries, and the raw wrappers still refuse autograd.  The tiled
fused conv gives the bits of ``conv2d_fused.cu`` under every instance over
the CPU tests' cases and resnet-tiny's convs, with a tile whose ``idx`` is
not ascending and with a bad index, and ``conv2d_fused_cuda`` routes by its
shape rule.  The tiled pack gives the bits of ``im2col_pack.cu`` and of the
plain version under every instance, with NaN payloads and -0.0 in the map,
and ``im2col_pack_cuda`` routes by its shape rule.  The training tier: the
``SparseTrainer`` killed at step 3 and restarted ends with the bits of the
uninterrupted run, card tensors (bf16 among them) round-trip through a
checkpoint, AdamW agrees with the CPU, and the smoke LM ``Trainer``
launches the tiled linear and no flash kernel.
"""
import numpy as np
import pytest
import torch

from _paged_cases import CASES as PAGED_CASES, case_id, case_kwargs, problem
from _wrapper_calls import NAMES as WRAPPERS, call_with_grad, n_floats

from repro_torch import dispatch
from repro_torch.kernels import KERNELS, reset_launch_counts
from repro_torch.kernels._build import SMEM_BYTES
from repro_torch.kernels.colwise_nm import (
    COLWISE_NM_LINEAR,
    COLWISE_NM_LINEAR_TILED,
    COLWISE_NM_STRIPS,
    COLWISE_NM_STRIPS_PIPELINED,
    COLWISE_NM_STRIPS_PIPELINED_TILED,
    COLWISE_NM_STRIPS_TILED,
    STRIPS_TILED_CPT,
    colwise_nm_matmul_cuda,
    colwise_nm_matmul_tiled_cuda,
    colwise_nm_matmul_ref,
    colwise_nm_matmul_strips_cuda,
    colwise_nm_matmul_strips_pipelined_cuda,
    colwise_nm_matmul_strips_pipelined_ref,
    colwise_nm_matmul_strips_pipelined_scalar_cuda,
    colwise_nm_matmul_strips_pipelined_tiled_cuda,
    colwise_nm_matmul_strips_pipelined_tiled_ref,
    colwise_nm_matmul_strips_ref,
    colwise_nm_matmul_strips_scalar_cuda,
    colwise_nm_matmul_strips_tiled_cuda,
    colwise_nm_matmul_strips_tiled_ref,
    strips_tiled_geometry,
    strips_tiled_takes,
)
from repro_torch.kernels.conv_gemm import (
    BANDED_TILED_POSITIONS,
    CONV2D_FUSED,
    CONV2D_FUSED_BANDED,
    CONV2D_FUSED_BANDED_TILED,
    CONV2D_FUSED_TILED,
    FUSED_TILED_CPT,
    FUSED_TILED_GROUPS,
    FUSED_TILED_BKS,
    banded_tiled_geometry,
    banded_tiled_takes,
    conv2d_fused_banded_cuda,
    conv2d_fused_banded_ref,
    conv2d_fused_banded_scalar_cuda,
    conv2d_fused_banded_tiled_cuda,
    conv2d_fused_banded_tiled_ref,
    conv2d_fused_cuda,
    conv2d_fused_ref,
    conv2d_fused_scalar_cuda,
    conv2d_fused_tiled_cuda,
    conv2d_fused_tiled_ref,
    fused_tiled_geometry,
    fused_tiled_takes,
)
from repro_torch.kernels.flash_attn import (
    FLASH_ATTENTION,
    FLASH_ATTENTION_TILED,
    FLASH_TILED_SHAPES,
    PAGED_ATTENTION,
    PAGED_ATTENTION_SPLIT,
    PAGED_SPLIT_WARPS,
    flash_attention,
    flash_attention_cuda,
    flash_attention_gqa_ref,
    flash_attention_ref,
    flash_attention_scalar_cuda,
    flash_attention_tiled_cuda,
    flash_smem_bytes,
    flash_tiled_config,
    flash_tiled_smem_bytes,
    flash_tiled_takes,
    paged_attention,
    paged_attention_cuda,
    paged_attention_ref,
    paged_attention_scalar_cuda,
    paged_attention_split_cuda,
    paged_attention_split_ref,
    paged_launch_smem_bytes,
    paged_split_config,
    paged_split_smem_bytes,
    paged_split_takes,
    paged_split_tile_bound,
)
from repro_torch.kernels.im2col_pack import (
    IM2COL_PACK,
    IM2COL_PACK_TILED,
    IM2COL_TILED_CBS,
    IM2COL_TILED_TGS,
    IM2COL_TILED_UNROLLS,
    im2col_pack_cuda,
    im2col_pack_ref,
    im2col_pack_scalar_cuda,
    im2col_pack_tiled_cuda,
    im2col_tiled_geometry,
    im2col_tiled_takes,
)

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


def _with_specials(x):
    """``x`` with NaNs of several payloads (quiet and signalling, both
    signs) and -0.0 spread over it, as element bits."""
    ints = x.view(torch.int32 if x.element_size() == 4 else torch.int16)
    specials = ([0x7FC01234, 0x7F800001, -0x3FE0000, -0x80000000]
                if x.element_size() == 4 else [0x7FC3, 0x7F81, -0x7E, -0x8000])
    flat = ints.clone().reshape(-1)
    for i, bits in enumerate(specials):
        flat[i::7] = bits
    return flat.view(x.dtype).reshape(x.shape)


def _im2col_instances(x, k, stride, pad, v):
    c, b, h, w = x.shape
    return [dict(cb=cb, tg=tg, unroll=u) for cb in IM2COL_TILED_CBS
            for tg in IM2COL_TILED_TGS for u in IM2COL_TILED_UNROLLS
            if im2col_tiled_geometry(c, b, h, w, k, k, stride, pad, v,
                                     x.element_size(), cb=cb, tg=tg, unroll=u)]


# the pack's cases: CASES, then channels no block divides (C 12, 24), the
# 3x1 outputs whose rows and batches wrap inside a thread's positions, and
# strip widths the tiled kernel refuses (6) or takes in f32 only (36)
IM2COL_CASES = CASES + [
    (12, 3, 6, 6, 3, 1, 1, 128),
    (24, 2, 7, 7, 3, 2, 1, 256),
    (4, 3, 5, 3, 3, 1, 0, 32),
    (8, 2, 8, 8, 3, 1, 1, 6),
    (8, 2, 8, 8, 3, 1, 1, 36),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,b,h,w,k,stride,pad,v", IM2COL_CASES)
def test_im2col_pack_kernel_bit_exact(dev, c, b, h, w, k, stride, pad, v, dtype):
    """The routed pack, ``im2col_pack.cu`` and the tiled kernel under every
    instance give the plain version's bits, also for a map of NaN payloads
    and -0.0 (compared as integers: the bits, not the values)."""
    ints = torch.int32 if dtype == torch.float32 else torch.int16
    plain = _x(c, b, h, w, dtype, dev)
    for x in (plain, _with_specials(plain)):
        want = im2col_pack_ref(x, k, k, stride, pad, v).view(ints)
        got = im2col_pack_cuda(x, k, k, stride, pad, v)
        scalar = im2col_pack_scalar_cuda(x, k, k, stride, pad, v)
        torch.cuda.synchronize()
        assert torch.equal(got.view(ints), want)
        assert torch.equal(scalar.view(ints), want)
        instances = _im2col_instances(x, k, stride, pad, v)
        assert bool(instances) is im2col_tiled_takes(x, k, k, stride, pad, v)
        for inst in instances:
            tiled = im2col_pack_tiled_cuda(x, k, k, stride, pad, v, **inst)
            torch.cuda.synchronize()
            assert torch.equal(tiled.view(ints), want), inst


def test_im2col_pack_routes_by_the_shape_rule(dev):
    """Strips of whole 16-byte rows go to the tiled kernel, a width of 6 to
    ``im2col_pack.cu``; the launch counters show which ran."""
    x = _x(8, 2, 8, 8, torch.float32, dev)
    for v, kernel in ((128, "im2col_pack_tiled"), (6, "im2col_pack"),
                      (256, "im2col_pack_tiled")):
        reset_launch_counts()
        got = im2col_pack_cuda(x, 3, 3, 1, 1, v)
        torch.cuda.synchronize()
        assert {k.name: k.launches for k in (IM2COL_PACK, IM2COL_PACK_TILED)
                } == {"im2col_pack": kernel == "im2col_pack",
                      "im2col_pack_tiled": kernel == "im2col_pack_tiled"}
        assert torch.equal(got, im2col_pack_ref(x, 3, 3, 1, 1, v))
    with pytest.raises(ValueError, match="16-byte rows"):
        im2col_pack_tiled_cuda(x, 3, 3, 1, 1, 6)
    with pytest.raises(ValueError, match="16-byte rows"):
        im2col_pack_tiled_cuda(x, 3, 3, 1, 1, 128, cb=12)


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


# (C, B, H, W, O, k, stride, pad, v, hb): the CPU tests' banded sweep
BANDED_CASES = [
    (8, 2, 10, 10, 16, 3, 1, 1, 16, 1),
    (8, 2, 10, 10, 16, 3, 1, 1, 16, 2),
    (8, 1, 12, 12, 16, 3, 2, 1, 16, 2),
    (6, 2, 9, 8, 8, 3, 1, 0, 8, 2),       # W even: 4-byte rows in bf16
    (3, 1, 7, 8, 8, 3, 2, 1, 128, 2),
    (6, 2, 11, 12, 8, 3, 1, 1, 32, 4),
    (4, 3, 8, 8, 16, 1, 2, 0, 32, 2),
    (16, 256, 16, 16, 16, 3, 2, 1, 128, 2),  # resnet-tiny blocks[1]/conv1
    (16, 256, 8, 8, 16, 3, 1, 1, 256, 2),    # blocks[1]/conv2, wide strips
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,b,h,w,o,k,stride,pad,v,hb", BANDED_CASES)
def test_banded_kernel_matches_plain_and_fused_bits(dev, c, b, h, w, o, k,
                                                    stride, pad, v, hb, dtype):
    x = _x(c, b, h, w, dtype, dev)
    k_rows = k * k * c
    values, idx = _compressed(o // 8, k_rows, (k_rows + 1) // 2, 8, dtype, dev)
    geo = dict(kh=k, kw=k, stride=stride, pad=pad, v=v)
    for block_k in (128, 8):
        got = conv2d_fused_banded_cuda(x, values, idx, block_k=block_k, hb=hb,
                                       **geo)
        _close(got, conv2d_fused_banded_ref(x, values, idx, hb=hb, **geo), dtype)
        fused = conv2d_fused_cuda(x, values, idx, block_k=block_k, **geo)
        torch.cuda.synchronize()
        assert torch.equal(got, fused)


# (C, B, H, W, O, k, stride, pad, v, hb): shapes the tiled kernel takes in
# both dtypes (W a multiple of 8), past BANDED_CASES: several 8-row groups a
# tile, one 8-row tile, a 5x5 kernel with pad 2, a ragged last band
TILED_CASES = [
    (8, 2, 16, 16, 32, 3, 1, 1, 128, 2),
    (4, 3, 8, 16, 8, 3, 2, 1, 64, 3),
    (5, 2, 9, 8, 16, 5, 1, 2, 16, 3),
    (16, 4, 16, 16, 16, 1, 2, 0, 128, 1),
]


def _nan_equal(a, b):
    """Equal bits, NaN where the other is NaN."""
    torch.cuda.synchronize()
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,b,h,w,o,k,stride,pad,v,hb",
                         BANDED_CASES + TILED_CASES)
def test_banded_tiled_equals_the_other_kernels_bits(dev, c, b, h, w, o, k,
                                                    stride, pad, v, hb, dtype):
    """Where the rule takes the shape, the tiled kernel gives the bits of
    conv2d_fused_banded.cu and of conv2d_fused.cu at block_k 128 and 8,
    and is within tolerance of its plain version; elsewhere it refuses."""
    x = _x(c, b, h, w, dtype, dev)
    k_rows = k * k * c
    tile = 16 if o == 32 else 8
    values, idx = _compressed(o // tile, k_rows, (k_rows + 1) // 2, tile,
                              dtype, dev)
    geo = dict(kh=k, kw=k, stride=stride, pad=pad, v=v)
    takes = banded_tiled_takes(x, values, hb=hb, **geo)
    assert takes == ((w * x.element_size()) % 16 == 0)
    if not takes:
        with pytest.raises(ValueError, match="16-byte"):
            conv2d_fused_banded_tiled_cuda(x, values, idx, hb=hb, **geo)
        return
    got = conv2d_fused_banded_tiled_cuda(x, values, idx, hb=hb, **geo)
    _close(got, conv2d_fused_banded_tiled_ref(x, values, idx, hb=hb, **geo),
           dtype)
    for block_k in (128, 8):
        old = conv2d_fused_banded_scalar_cuda(x, values, idx, block_k=block_k,
                                              hb=hb, **geo)
        fused = conv2d_fused_cuda(x, values, idx, block_k=block_k, **geo)
        torch.cuda.synchronize()
        assert torch.equal(got, old) and torch.equal(got, fused)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [BANDED_CASES[7], TILED_CASES[1],
                                  TILED_CASES[2]])
def test_banded_tiled_instances_give_the_same_bits(dev, case, dtype):
    c, b, h, w, o, k, stride, pad, v, hb = case
    x = _x(c, b, h, w, dtype, dev)
    values, idx = _compressed(o // 8, k * k * c, (k * k * c + 1) // 2, 8,
                              dtype, dev)
    geo = dict(kh=k, kw=k, stride=stride, pad=pad, v=v)
    want = conv2d_fused_cuda(x, values, idx, **geo)
    for p in BANDED_TILED_POSITIONS:
        got = conv2d_fused_banded_tiled_cuda(x, values, idx, hb=hb,
                                             positions=p, **geo)
        torch.cuda.synchronize()
        assert torch.equal(got, want), p


# (C, B, H, W, O, k, stride, pad, v, hb, group): weights too wide to stage
# at once beside the window, so a block stages them group tiles at a time
TILE_GROUP_CASES = [
    (64, 2, 8, 8, 256, 3, 1, 1, 64, 1, 16),       # 2 groups of 16 tiles
    # ResNet-18 layer2's map: 5 groups of 3 tiles, then one of 1
    (128, 1, 28, 28, 128, 3, 1, 1, 128, 1, 3),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,b,h,w,o,k,stride,pad,v,hb,group",
                         TILE_GROUP_CASES)
def test_banded_tiled_tile_groups_give_the_same_bits(dev, c, b, h, w, o, k,
                                                     stride, pad, v, hb,
                                                     group, dtype):
    """Weights staged a group of tiles at a time give the bits of
    conv2d_fused.cu (those of conv2d_fused_banded.cu, which does not take
    the second shape) under every instance, and a bad index in the last
    group's tile makes that tile, and only it, NaN."""
    x = _x(c, b, h, w, dtype, dev)
    k_rows = k * k * c
    values, idx = _compressed(o // 8, k_rows, k_rows // 2, 8, dtype, dev)
    geo = dict(kh=k, kw=k, stride=stride, pad=pad, v=v)
    tg = banded_tiled_geometry(c, b, h, w, k, k, stride, pad, v, hb, o // 8,
                               k_rows // 2, 8, x.element_size())
    if dtype == torch.bfloat16 and w % 8:  # 56-byte bf16 rows
        assert tg is None
        return
    assert tg["group"] == group < o // 8
    want = conv2d_fused_cuda(x, values, idx, **geo)
    for p in BANDED_TILED_POSITIONS:
        got = conv2d_fused_banded_tiled_cuda(x, values, idx, hb=hb,
                                             positions=p, **geo)
        torch.cuda.synchronize()
        assert torch.equal(got, want), p
    idx[-1, 3] = k_rows
    got = conv2d_fused_banded_tiled_cuda(x, values, idx, hb=hb, **geo)
    n_pos = b * tg["ho"] * tg["wo"]
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[-8:, :n_pos]).all())
    assert torch.equal(got[:-8], want[:-8])


def test_banded_routing_rule(dev):
    """conv2d_fused_banded_cuda takes the tiled kernel exactly where
    banded_tiled_takes says so: tiles of a multiple of 8 rows, map rows of
    whole 16-byte copies and a 16-byte aligned map; the others, a
    misaligned view among them, go to conv2d_fused_banded.cu, with the same
    bits.  A shape neither kernel takes raises."""
    geo = dict(kh=3, kw=3, stride=1, pad=1, v=64, hb=2)
    cases = [((8, 2, 8, 16), torch.float32, 8, True),
             ((8, 2, 8, 10), torch.float32, 8, False),   # 40-byte rows
             ((8, 2, 8, 8), torch.bfloat16, 8, True),
             ((8, 2, 8, 12), torch.bfloat16, 8, False),  # 24-byte rows
             ((8, 2, 8, 16), torch.float32, 12, False),  # tile 12
             ((8, 2, 8, 16), torch.float32, 16, True)]
    for (c, b, h, w), dtype, tile, tiled in cases:
        x = _x(c, b, h, w, dtype, dev)
        values, idx = _compressed(2, 72, 36, tile, dtype, dev)
        assert banded_tiled_takes(x, values, **geo) == tiled, (w, dtype, tile)
        reset_launch_counts()
        got = conv2d_fused_banded_cuda(x, values, idx, **geo)
        torch.cuda.synchronize()
        assert CONV2D_FUSED_BANDED_TILED.launches == int(tiled)
        assert CONV2D_FUSED_BANDED.launches == int(not tiled)
        assert torch.equal(got, conv2d_fused_banded_scalar_cuda(
            x, values, idx, **geo))
    x = _x(8, 2, 8, 16, torch.float32, dev)
    values, idx = _compressed(2, 72, 36, 8, torch.float32, dev)
    base = torch.empty(x.numel() + 1, device=dev)
    x_mis = base[1:].view(x.shape)
    x_mis.copy_(x)
    assert x_mis.is_contiguous() and x_mis.data_ptr() % 16
    assert not banded_tiled_takes(x_mis, values, **geo)
    reset_launch_counts()
    got = conv2d_fused_banded_cuda(x_mis, values, idx, **geo)
    torch.cuda.synchronize()
    assert CONV2D_FUSED_BANDED.launches == 1
    assert CONV2D_FUSED_BANDED_TILED.launches == 0
    assert torch.equal(got, conv2d_fused_banded_tiled_cuda(x, values, idx,
                                                           **geo))
    with pytest.raises(ValueError, match="16-byte"):
        conv2d_fused_banded_tiled_cuda(x_mis, values, idx, **geo)
    # 64 f32 channels of a stride-2 map in bands of 4 strips: neither the
    # tiled kernel's one window nor the other kernel's two fit
    big = _x(64, 256, 16, 16, torch.float32, dev)
    v64, i64 = _compressed(2, 576, 288, 8, torch.float32, dev)
    assert not banded_tiled_takes(big, v64, kh=3, kw=3, stride=2, pad=1,
                                  v=128, hb=4)
    with pytest.raises(ValueError, match="shared memory"):
        conv2d_fused_banded_cuda(big, v64, i64, kh=3, kw=3, stride=2, pad=1,
                                 hb=4)


def test_banded_tiled_bad_index_makes_the_tile_nan(dev):
    """An index outside [0, K) makes every position of its tile NaN, as in
    conv2d_fused_banded.cu; the ragged last strip's tail stays 0, and the
    other tile keeps its bits."""
    x = _x(8, 1, 9, 8, torch.float32, dev)  # 81 positions in 2 strips of 64
    values, idx = _compressed(2, 72, 36, 8, torch.float32, dev)
    geo = dict(kh=3, kw=3, pad=1, v=64)
    idx[0, 5] = -1
    got = conv2d_fused_banded_tiled_cuda(x, values, idx, **geo)
    old = conv2d_fused_banded_scalar_cuda(x, values, idx, **geo)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[:8, :72]).all())
    assert bool((got[:, 72:] == 0).all())
    assert _nan_equal(got, old)
    assert torch.equal(got[8:], old[8:])


def test_banded_tiled_padding_taps_are_not_skipped(dev):
    """A tap in the padding adds fmaf(w, 0, acc): with an inf weight it is
    NaN in both banded kernels, at the same positions."""
    x = _x(8, 2, 8, 8, torch.float32, dev)
    values, idx = _compressed(2, 72, 36, 8, torch.float32, dev)
    values[0, 0, 3] = float("inf")  # row idx[0, 0]: a tap of the top-left
    geo = dict(kh=3, kw=3, pad=1, v=64)
    got = conv2d_fused_banded_tiled_cuda(x, values, idx, **geo)
    old = conv2d_fused_banded_scalar_cuda(x, values, idx, **geo)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[3]).any()) and _nan_equal(got, old)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hb", [1, 2, 3, 100])
@pytest.mark.parametrize("c,b,h,w,k,stride,pad,v", CASES[:4] + [
    (16, 256, 16, 16, 3, 1, 1, 128), (16, 256, 8, 8, 3, 1, 1, 256)])
def test_pipelined_kernel_matches_plain_and_strip_bits(dev, c, b, h, w, k,
                                                       stride, pad, v, hb,
                                                       dtype):
    x = _x(c, b, h, w, dtype, dev)
    k_rows = k * k * c
    strips = im2col_pack_ref(x, k, k, stride, pad, v)
    for n_tiles, tile, keep, block_k in ((2, 8, 0.5, 128), (3, 12, 0.25, 7)):
        values, idx = _compressed(n_tiles, k_rows, max(1, int(k_rows * keep)),
                                  tile, dtype, dev)
        got = colwise_nm_matmul_strips_pipelined_cuda(strips, values, idx,
                                                      block_k=block_k, hb=hb)
        _close(got, colwise_nm_matmul_strips_pipelined_ref(strips, values, idx,
                                                           hb=hb), dtype)
        plain = colwise_nm_matmul_strips_cuda(strips, values, idx,
                                              block_k=block_k)
        torch.cuda.synchronize()
        assert torch.equal(got, plain)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,b,h,w,k,stride,pad,v", CASES[:4] + [
    (16, 256, 16, 16, 3, 1, 1, 128), (16, 256, 8, 8, 3, 1, 1, 256)])
def test_strips_tiled_equals_the_scalar_kernel(dev, c, b, h, w, k, stride,
                                               pad, v, dtype):
    """Both entry points of the tiled strip GEMM give colwise_nm_strips.cu's
    bits over the strip and pipelined cases (tiles of 8 and 12 rows, ragged
    kept rows, hb past the strip count) and agree with their plain
    versions."""
    x = _x(c, b, h, w, dtype, dev)
    k_rows = k * k * c
    strips = im2col_pack_ref(x, k, k, stride, pad, v)
    for n_tiles, tile, keep in ((2, 8, 0.5), (3, 12, 0.25), (1, 16, 1.0)):
        values, idx = _compressed(n_tiles, k_rows, max(1, int(k_rows * keep)),
                                  tile, dtype, dev)
        want = colwise_nm_matmul_strips_scalar_cuda(strips, values, idx)
        assert strips_tiled_takes(strips, values)
        got = colwise_nm_matmul_strips_tiled_cuda(strips, values, idx)
        _close(got, colwise_nm_matmul_strips_tiled_ref(strips, values, idx),
               dtype)
        assert torch.equal(got, want)
        for hb in (1, 2, 3, 100):
            got = colwise_nm_matmul_strips_pipelined_tiled_cuda(
                strips, values, idx, hb=hb)
            _close(got, colwise_nm_matmul_strips_pipelined_tiled_ref(
                strips, values, idx, hb=hb), dtype)
            torch.cuda.synchronize()
            assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [(16, 2, 12, 12, 3, 1, 1, 128, 3, 12, 0.5),
                                  (8, 2, 16, 16, 3, 1, 1, 128, 2, 40, 0.5),
                                  (5, 2, 11, 7, 3, 1, 0, 256, 2, 8, 0.25)])
def test_strips_tiled_instances_give_the_same_bits(dev, case, dtype):
    """Every instance (columns a thread) under both entry points and every
    number of strip lanes, with T 40 walked in passes of 8-row groups where
    the threads run out."""
    c, b, h, w, k, stride, pad, v, n_tiles, tile, keep = case
    x = _x(c, b, h, w, dtype, dev)
    k_rows = k * k * c
    strips = im2col_pack_ref(x, k, k, stride, pad, v)
    values, idx = _compressed(n_tiles, k_rows, int(k_rows * keep), tile,
                              dtype, dev)
    want = colwise_nm_matmul_strips_scalar_cuda(strips, values, idx)
    n_strips = strips.shape[0]
    for cpt in STRIPS_TILED_CPT:
        if strips_tiled_geometry(n_strips, v, n_tiles, idx.shape[1], tile,
                                 x.element_size(), 1, cpt=cpt) is None:
            continue
        outs = [colwise_nm_matmul_strips_tiled_cuda(strips, values, idx,
                                                    cpt=cpt)]
        for hb, lanes in ((2, 1), (2, 2), (3, 1), (3, 2), (3, 3)):
            if strips_tiled_geometry(n_strips, v, n_tiles, idx.shape[1], tile,
                                     x.element_size(), hb, cpt=cpt,
                                     lanes=lanes) is not None:
                outs.append(colwise_nm_matmul_strips_pipelined_tiled_cuda(
                    strips, values, idx, hb=hb, cpt=cpt, lanes=lanes))
        torch.cuda.synchronize()
        assert len(outs) >= 3 and all(torch.equal(o, want) for o in outs), cpt


def test_strips_routing_rule(dev):
    """The strip GEMM wrappers launch the tiled kernel where the shape rule
    holds, and the old kernels where it refuses: (for the strip GEMM) a
    misaligned view and rows of 6 f32 columns, not whole 16-byte copies;
    (for both) a tile's values past a block's shared memory."""
    x = _x(8, 2, 8, 8, torch.float32, dev)
    values, idx = _compressed(2, 72, 36, 8, torch.float32, dev)
    strips = im2col_pack_ref(x, 3, 3, 1, 1, 128)
    flat = torch.empty(strips.numel() + 1, device=dev)
    mis = flat[1:].view(strips.shape)
    mis.copy_(strips)
    narrow = im2col_pack_ref(x, 3, 3, 1, 1, 6)
    assert strips_tiled_takes(strips, values)
    assert not strips_tiled_takes(mis, values)
    assert not strips_tiled_takes(narrow, values)
    # 1000 kept rows of a 64-row tile: 256 KB of f32 values
    wide = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 1200, 128), dtype=np.float32)).to(dev)
    v_big, i_big = _compressed(1, 1200, 1000, 64, torch.float32, dev)
    assert not strips_tiled_takes(wide, v_big)
    want = colwise_nm_matmul_strips_scalar_cuda(strips, values, idx)
    want_big = colwise_nm_matmul_strips_scalar_cuda(wide, v_big, i_big)
    reset_launch_counts()
    outs = [colwise_nm_matmul_strips_cuda(strips, values, idx),
            colwise_nm_matmul_strips_pipelined_cuda(strips, values, idx),
            colwise_nm_matmul_strips_cuda(mis, values, idx)]
    big = [colwise_nm_matmul_strips_cuda(wide, v_big, i_big),
           colwise_nm_matmul_strips_pipelined_cuda(wide, v_big, i_big)]
    narrow_out = colwise_nm_matmul_strips_cuda(narrow, values, idx)
    torch.cuda.synchronize()
    assert {k.name: k.launches for k in KERNELS if k.launches} == {
        "colwise_nm_matmul_strips_tiled": 1,
        "colwise_nm_matmul_strips_pipelined_tiled": 1,
        "colwise_nm_matmul_strips": 3, "colwise_nm_matmul_strips_pipelined": 1}
    assert all(torch.equal(o, want) for o in outs)
    assert all(torch.equal(o, want_big) for o in big)
    _close(narrow_out, colwise_nm_matmul_strips_ref(narrow, values, idx),
           torch.float32)
    # the tiled wrappers refuse what the rule refuses, unlaunched
    for fn in (colwise_nm_matmul_strips_tiled_cuda,
               colwise_nm_matmul_strips_pipelined_tiled_cuda):
        with pytest.raises(ValueError, match="16-byte"):
            fn(mis, values, idx)
        with pytest.raises(ValueError, match="16-byte"):
            fn(narrow, values, idx)
    with pytest.raises(ValueError, match="16-byte"):
        colwise_nm_matmul_strips_tiled_cuda(strips, values, idx, cpt=3)
    assert COLWISE_NM_STRIPS_TILED.launches == 1
    assert COLWISE_NM_STRIPS.launches == 3


def test_strips_tiled_launch_smem_equals_the_rule(dev):
    for dtype in (torch.float32, torch.bfloat16):
        x = _x(16, 4, 12, 12, dtype, dev)
        strips = im2col_pack_ref(x, 3, 3, 1, 1, 128)
        values, idx = _compressed(3, 144, 72, 12, dtype, dev)
        for hb, kernel, fn in (
                (1, COLWISE_NM_STRIPS_TILED, colwise_nm_matmul_strips_cuda),
                (2, COLWISE_NM_STRIPS_PIPELINED_TILED,
                 colwise_nm_matmul_strips_pipelined_cuda)):
            fn(strips, values, idx)
            torch.cuda.synchronize()
            assert kernel.last_smem_bytes == strips_tiled_geometry(
                strips.shape[0], 128, 3, 72, 12, x.element_size(), hb)["smem"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,d_in,d_out,keep,tile,bb,bk", [
    (16, 64, 32, 0.5, 8, 8, 8),
    (8, 128, 128, 0.5, 32, 8, 16),
    (33, 96, 48, 0.25, 16, 16, 8),
    (4, 256, 64, 0.75, 64, 128, 128),
    (64, 64, 64, 0.5, 64, 32, 24),
    (5, 48, 96, 0.5, 96, 8, 8),         # tile == d_out
    (7, 40, 12, 0.5, 3, 128, 128),      # tile under 8: 16 row lanes
    (256, 960, 2560, 0.5, 2560, 128, 128),  # smollm-360m up-proj, T = d_out
    (256, 2560, 960, 0.5, 960, 256, 128),   # down-proj, ragged column chunk
    (256, 960, 2560, 0.5, 8, 128, 64),      # tile 8
])
def test_linear_kernel_matches_plain(dev, b, d_in, d_out, keep, tile, bb, bk,
                                     dtype):
    rng = np.random.default_rng(b + d_in)
    x = torch.from_numpy(rng.standard_normal((b, d_in), dtype=np.float32)
                         ).to(dev, dtype)
    values, idx = _compressed(d_out // tile, d_in, int(d_in * keep), tile,
                              dtype, dev)
    got = colwise_nm_matmul_cuda(x, values, idx, block_b=bb, block_k=bk)
    _close(got, colwise_nm_matmul_ref(x, values, idx), dtype)


# (d_in, d_out, T, k_kept) of the tiled linear: smollm-360m's k/v, q/o, up
# and down widths with T = d_out; several tiles of 64 and 128 with a ragged
# last step of kept rows
TILED_SHAPES = [(960, 320, 320, 480), (960, 960, 960, 480),
                (960, 2560, 2560, 480), (2560, 960, 960, 1280),
                (128, 64, 64, 64), (96, 256, 64, 37), (200, 384, 128, 100)]
TILED_ROWS = [1, 4, 15, 16, 17, 63, 64, 255, 256, 1000]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d_in,d_out,tile,k_kept", TILED_SHAPES)
@pytest.mark.parametrize("rows", TILED_ROWS)
def test_tiled_linear_equals_the_linear_kernel(dev, rows, d_in, d_out, tile,
                                               k_kept, dtype):
    """Bit for bit: both kernels take each output as one fmaf chain over the
    kept rows in ascending order."""
    rng = np.random.default_rng(rows * 7 + d_out)
    x = torch.from_numpy(rng.standard_normal((rows, d_in), dtype=np.float32)
                         ).to(dev, dtype)
    values, idx = _compressed(d_out // tile, d_in, k_kept, tile, dtype, dev,
                              seed=rows)
    got = colwise_nm_matmul_tiled_cuda(x, values, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, colwise_nm_matmul_cuda(x, values, idx))
    _close(got, colwise_nm_matmul_ref(x, values, idx), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [3, 100, 300])
def test_tiled_linear_block_rows_give_the_same_bits(dev, rows, dtype):
    rng = np.random.default_rng(rows)
    x = torch.from_numpy(rng.standard_normal((rows, 200), dtype=np.float32)
                         ).to(dev, dtype)
    values, idx = _compressed(3, 200, 77, 128, dtype, dev)
    want = colwise_nm_matmul_cuda(x, values, idx)
    for bm in (16, 64, 128):
        got = colwise_nm_matmul_tiled_cuda(x, values, idx, block_rows=bm)
        torch.cuda.synchronize()
        assert torch.equal(got, want), bm
    with pytest.raises(ValueError, match="block_rows"):
        colwise_nm_matmul_tiled_cuda(x, values, idx, block_rows=32)


def test_tiled_linear_nan_reaches_exactly_its_tile(dev):
    x = _x(1, 1, 20, 96, torch.float32, dev)[0, 0]
    values, idx = _compressed(3, 96, 40, 64, torch.float32, dev)
    idx[1, 39] = 96   # one past the end, in the ragged last step
    idx[2, 0] = -1
    y = colwise_nm_matmul_tiled_cuda(x, values, idx)
    torch.cuda.synchronize()
    assert bool(torch.isnan(y[:, 64:]).all())
    assert bool(torch.isfinite(y[:, :64]).all())
    assert torch.equal(y[:, :64], colwise_nm_matmul_cuda(x, values, idx)[:, :64])


def test_tiled_linear_inf_in_an_unkept_column_stays_out(dev):
    """The ragged last step is zero in both operands, never a padded index:
    an inf in x[:, 0], which no tile keeps, does not reach the output."""
    x = _x(1, 1, 8, 96, torch.float32, dev)[0, 0]
    x[:, 0] = float("inf")
    values, idx = _compressed(2, 95, 37, 64, torch.float32, dev)
    y = colwise_nm_matmul_tiled_cuda(x, values, idx + 1)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all())


def test_tiled_linear_zero_rows_launch_nothing(dev):
    values, idx = _compressed(2, 72, 36, 64, torch.float32, dev)
    reset_launch_counts()
    y = colwise_nm_matmul_tiled_cuda(torch.zeros((0, 72), device=dev), values,
                                     idx)
    assert tuple(y.shape) == (0, 128) and COLWISE_NM_LINEAR_TILED.launches == 0


def test_tiled_linear_rejects_what_the_kernel_does_not_take(dev):
    x = _x(1, 1, 4, 72, torch.float32, dev)[0, 0]
    values, idx = _compressed(2, 72, 36, 64, torch.float32, dev)
    with pytest.raises(ValueError, match="multiple of 64"):
        colwise_nm_matmul_tiled_cuda(x, *_compressed(2, 72, 36, 96,
                                                     torch.float32, dev))
    flat = torch.zeros(values.numel() + 1, device=dev)
    shifted = flat[1:].view(values.shape)  # contiguous, 4 bytes off
    shifted.copy_(values)
    with pytest.raises(ValueError, match="16-byte aligned"):
        colwise_nm_matmul_tiled_cuda(x, shifted, idx)
    with pytest.raises(ValueError, match="16-byte aligned"):
        colwise_nm_matmul_tiled_cuda(
            torch.zeros(4 * 72 + 1, device=dev)[1:].view(4, 72), values, idx)
    with pytest.raises(TypeError, match="dtype"):
        colwise_nm_matmul_tiled_cuda(x.to(torch.int32), values, idx)
    with pytest.raises(TypeError, match="dtype"):
        colwise_nm_matmul_tiled_cuda(x, values.to(torch.bfloat16), idx)
    with pytest.raises(ValueError, match="contiguous"):
        colwise_nm_matmul_tiled_cuda(_x(1, 1, 72, 4, torch.float32, dev)[0, 0].T,
                                     values, idx)


@pytest.mark.parametrize("d_out,tile,kernel", [
    (2560, None, "colwise_nm_matmul_tiled"), (960, 64, "colwise_nm_matmul_tiled"),
    (2400, 12, "colwise_nm_matmul")])
def test_linear_apply_launches_the_tiled_kernel_once(dev, tmp_path, d_out,
                                                      tile, kernel):
    from repro_torch.core.pruning import SparsityConfig
    from repro_torch.core.sparse_linear import linear_apply, linear_init

    dispatch.set_db(dispatch.ProfileDB(path=tmp_path / "profile.json"))
    try:
        sp = SparsityConfig(sparsity=0.5, m=None, tile=tile, min_dim=64,
                            format="compressed_pallas")
        layer = linear_init(torch.Generator().manual_seed(1), 960, d_out, sp,
                            device=dev)
        x = _x(1, 3, 5, 960, torch.float32, dev)[0]  # [3, 5, 960]
        reset_launch_counts()
        y = linear_apply(layer, x)
        torch.cuda.synchronize()
        assert {k.name: k.launches for k in KERNELS if k.launches} == {
            kernel: 1}
        want = colwise_nm_matmul_ref(x.reshape(-1, 960), layer["values"],
                                     layer["idx"]).reshape(3, 5, d_out)
        _close(y, want, torch.float32)
    finally:
        dispatch.set_db(None)


def test_out_of_range_index_gives_nan_not_a_bad_read(dev):
    x = _x(8, 1, 8, 8, torch.float32, dev)
    values, idx = _compressed(2, 72, 36, 8, torch.float32, dev)
    idx[1, 3] = 72  # one past the last im2col row
    strips = im2col_pack_ref(x, 3, 3, 1, 1, 128)
    outs = [conv2d_fused_cuda(x, values, idx, kh=3, kw=3, pad=1),
            conv2d_fused_banded_scalar_cuda(x, values, idx, kh=3, kw=3, pad=1),
            conv2d_fused_banded_tiled_cuda(x, values, idx, kh=3, kw=3, pad=1),
            colwise_nm_matmul_strips_scalar_cuda(strips, values, idx),
            colwise_nm_matmul_strips_pipelined_scalar_cuda(strips, values, idx),
            colwise_nm_matmul_strips_tiled_cuda(strips, values, idx),
            colwise_nm_matmul_strips_pipelined_tiled_cuda(strips, values, idx),
            colwise_nm_matmul_strips_tiled_cuda(strips, values, idx, cpt=1),
            colwise_nm_matmul_strips_pipelined_tiled_cuda(strips, values, idx,
                                                          lanes=1)]
    torch.cuda.synchronize()
    for out in outs:
        assert bool(torch.isnan(out[8:, :64]).all())  # tile 1, every position
        assert bool(torch.isfinite(out[:8]).all())    # tile 0 is untouched
    y = colwise_nm_matmul_cuda(_x(1, 1, 4, 72, torch.float32, dev)[0, 0],
                               values, idx)
    torch.cuda.synchronize()
    assert bool(torch.isnan(y[:, 8:]).all()) and bool(torch.isfinite(y[:, :8]).all())


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = _x(8, 2, 8, 8, torch.float32, dev)
    values, idx = _compressed(2, 72, 36, 8, torch.float32, dev)
    strips = im2col_pack_ref(x, 3, 3, 1, 1, 128)
    with pytest.raises(ValueError, match="contiguous"):
        im2col_pack_cuda(x.transpose(2, 3), 3, 3, 1, 1)
    with pytest.raises(TypeError, match="dtype"):
        conv2d_fused_cuda(x, values.to(torch.bfloat16), idx, kh=3, kw=3, pad=1)
    with pytest.raises(TypeError, match="dtype"):
        conv2d_fused_cuda(x, values, idx.long(), kh=3, kw=3, pad=1)
    with pytest.raises(ValueError, match="does not match"):
        colwise_nm_matmul_strips_cuda(strips, values, idx[:, :10].contiguous())
    with pytest.raises(ValueError, match="shared memory"):
        conv2d_fused_cuda(x, values, idx, kh=3, kw=3, pad=1, block_k=0)
    # pipelined: strips wider than 256 (colwise_nm_strips_pipelined.cu; the
    # routing wrapper gives them to the tiled kernel) or not a 16-byte
    # multiple
    with pytest.raises(ValueError, match="strip width"):
        colwise_nm_matmul_strips_pipelined_scalar_cuda(
            im2col_pack_ref(x, 3, 3, 1, 1, 384), values, idx)
    with pytest.raises(ValueError, match="strip width"):
        colwise_nm_matmul_strips_pipelined_cuda(
            im2col_pack_ref(x, 3, 3, 1, 1, 6), values, idx)
    # banded: odd bf16 rows; two f32 windows of conv2d_fused_banded.cu past
    # 227 KB (the routing wrapper gives that shape to the tiled kernel)
    xb = _x(8, 1, 8, 7, torch.bfloat16, dev)
    with pytest.raises(ValueError, match="4 bytes"):
        conv2d_fused_banded_cuda(xb, values.to(torch.bfloat16), idx, kh=3,
                                 kw=3, pad=1)
    big = _x(16, 256, 16, 16, torch.float32, dev)
    v16, i16 = _compressed(2, 144, 72, 8, torch.float32, dev)
    with pytest.raises(ValueError, match="shared memory"):
        conv2d_fused_banded_scalar_cuda(big, v16, i16, kh=3, kw=3, stride=2,
                                        pad=1, hb=4)
    # tiled banded: instances it does not have; a window past 227 KB
    for p in (8, 3):
        with pytest.raises(ValueError, match="instance"):
            conv2d_fused_banded_tiled_cuda(big, v16, i16, kh=3, kw=3,
                                           stride=2, pad=1, positions=p)
    v64, i64 = _compressed(2, 576, 288, 8, torch.float32, dev)
    with pytest.raises(ValueError, match="shared memory"):
        conv2d_fused_banded_tiled_cuda(_x(64, 256, 16, 16, torch.float32, dev),
                                       v64, i64, kh=3, kw=3, stride=2, pad=1,
                                       hb=4)
    # linear: 2-D x of the values' dtype
    with pytest.raises(ValueError, match="2-D"):
        colwise_nm_matmul_cuda(_x(1, 2, 4, 72, torch.float32, dev)[0], values, idx)
    with pytest.raises(TypeError, match="dtype"):
        colwise_nm_matmul_cuda(_x(1, 1, 4, 72, torch.bfloat16, dev)[0, 0],
                               values, idx)


def test_each_launch_counts_once(dev):
    x = _x(8, 2, 8, 8, torch.float32, dev)
    values, idx = _compressed(2, 72, 36, 8, torch.float32, dev)
    reset_launch_counts()
    strips = im2col_pack_cuda(x, 3, 3, 1, 1)
    colwise_nm_matmul_strips_scalar_cuda(strips, values, idx)
    colwise_nm_matmul_strips_cuda(strips, values, idx)  # tiled
    conv2d_fused_cuda(x, values, idx, kh=3, kw=3, pad=1)
    conv2d_fused_cuda(x, values, idx, kh=3, kw=3, pad=1)
    colwise_nm_matmul_strips_pipelined_scalar_cuda(strips, values, idx)
    colwise_nm_matmul_strips_pipelined_cuda(strips, values, idx)  # tiled
    conv2d_fused_banded_scalar_cuda(x, values, idx, kh=3, kw=3, pad=1)
    conv2d_fused_banded_cuda(x, values, idx, kh=3, kw=3, pad=1)  # tiled
    colwise_nm_matmul_cuda(_x(1, 1, 4, 72, torch.float32, dev)[0, 0], values, idx)
    colwise_nm_matmul_tiled_cuda(_x(1, 1, 4, 72, torch.float32, dev)[0, 0],
                                 *_compressed(2, 72, 36, 64, torch.float32, dev))
    paged_attention_cuda(*_paged(dev, torch.float32), page_size=8)  # split
    paged_attention_scalar_cuda(*_paged(dev, torch.float32), page_size=8)
    flash_attention_cuda(*_flash_qkv(1, 8, 8, 2, 2, 16, torch.float32, dev))
    flash_attention_cuda(*_flash_qkv(1, 8, 8, 2, 2, 18, torch.float32, dev))
    torch.cuda.synchronize()
    assert {k.name: k.launches for k in KERNELS} == {
        "conv2d_fused_tiled": 2, "conv2d_fused": 0, "im2col_pack": 0,
        "im2col_pack_tiled": 1,
        "colwise_nm_matmul_strips": 1,
        "colwise_nm_matmul": 1, "colwise_nm_matmul_strips_pipelined": 1,
        "conv2d_fused_banded": 1, "flash_attention": 1, "paged_attention": 1,
        "colwise_nm_matmul_tiled": 1, "flash_attention_tiled": 1,
        "conv2d_fused_banded_tiled": 1, "paged_attention_split": 1,
        "colwise_nm_matmul_strips_tiled": 1,
        "colwise_nm_matmul_strips_pipelined_tiled": 1}


@pytest.mark.parametrize("kernel,op,name,args", [
    (CONV2D_FUSED_TILED, "conv", "fused_sparse_pallas", (16, 8, 8, 8, 3, 1, 1)),
    (CONV2D_FUSED_TILED, "conv", "fused_sparse_pallas@v256_bk128",
     (16, 64, 8, 8, 3, 2, 1)),
    (CONV2D_FUSED_TILED, "conv", "fused_sparse_pallas@v128_bk64",
     (16, 8, 16, 16, 1, 2, 0)),
    (CONV2D_FUSED_BANDED_TILED, "conv", "fused_banded_pallas@v128_bk128_hb4",
     (16, 64, 8, 8, 3, 1, 1)),
    (CONV2D_FUSED_BANDED, "conv", "fused_banded_pallas@v128_bk64_hb1",
     (8, 4, 10, 10, 3, 1, 1)),
    (COLWISE_NM_STRIPS_PIPELINED_TILED, "conv",
     "two_kernel_pipelined@v256_bk128_hb2", (16, 8, 8, 8, 3, 1, 1)),
    (COLWISE_NM_STRIPS_TILED, "conv", "im2col_sparse_pallas",
     (16, 8, 8, 8, 3, 1, 1)),
    (COLWISE_NM_LINEAR, "linear", "compressed_pallas@bb256_bk128", (96, 200)),
    (COLWISE_NM_LINEAR, "linear", "compressed_pallas@bb128_bk64", (2560, 960)),
    (COLWISE_NM_LINEAR_TILED, "linear", "compressed_tiled", (96, 256)),
    (COLWISE_NM_LINEAR_TILED, "linear", "compressed_tiled", (2560, 960)),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_smem_equals_the_feasibility_footprint(dev, kernel, op, name,
                                                      args, dtype):
    spec = dispatch.REGISTRY.get(op, name)
    if op == "conv":
        c, b, h, w, k, stride, pad = args
        x = _x(c, b, h, w, dtype, dev)
        values, idx = _compressed(2, k * k * c, k * k * c // 2, 8, dtype, dev)
        key = dispatch.conv_key(c, h, w, 16, k, k, stride, pad, idx.shape[1], 8,
                                dtype=dtype, batch=b)
        spec.apply({"values": values, "idx": idx}, x, kh=k, kw=k,
                   stride=stride, pad=pad)
    else:
        d_in, d_out = args
        x = _x(1, 1, 64, d_in, dtype, dev)[0, 0]
        values, idx = _compressed(1, d_in, d_in // 2, d_out, dtype, dev)
        key = dispatch.linear_key_from(x.shape, values.shape, dtype)
        spec.apply({"values": values, "idx": idx}, x)
    torch.cuda.synchronize()
    assert spec.feasible(key)[0]
    assert kernel.last_smem_bytes == spec.smem_bytes(key)


# (C, B, H, W, k, stride, pad, V, n_tiles, k_kept, T): the CPU tests' cases
# of the tiled fused conv (tests/test_torch_fused_tiled.py), then
# resnet-tiny's convs at batch 16 and a deep ragged k_kept over 8 tiles
FUSED_TILED_CASES = [
    (4, 1, 7, 7, 3, 1, 1, 128, 2, 10, 8),
    (4, 3, 10, 10, 3, 1, 1, 128, 2, 16, 8),
    (4, 2, 9, 9, 3, 1, 1, 128, 1, 20, 16),
    (3, 4, 12, 12, 3, 1, 1, 256, 2, 13, 16),
    (4, 1, 12, 12, 3, 2, 1, 128, 3, 9, 8),
    (5, 2, 9, 7, 3, 1, 0, 128, 2, 30, 8),
    (16, 2, 8, 8, 1, 2, 0, 128, 2, 8, 8),
    (8, 16, 16, 16, 3, 1, 1, 128, 2, 36, 8),
    (16, 16, 16, 16, 3, 2, 1, 256, 2, 72, 8),
    (32, 2, 9, 9, 3, 1, 1, 128, 8, 141, 8),
]


def _fused_tiled_problem(case, dtype, dev):
    c, b, h, w, k, stride, pad, v, n_tiles, k_kept, tile = case
    x = _x(c, b, h, w, dtype, dev)
    values, idx = _compressed(n_tiles, k * k * c, k_kept, tile, dtype, dev)
    return x, values, idx, dict(kh=k, kw=k, stride=stride, pad=pad, v=v)


def _fused_tiled_instances(x, values, geo):
    c, b, h, w = x.shape
    n_tiles, k_kept, tile = values.shape
    return [dict(cpt=cpt, group=group, bk=bk)
            for cpt in FUSED_TILED_CPT for group in FUSED_TILED_GROUPS
            for bk in FUSED_TILED_BKS
            if fused_tiled_geometry(c, b, h, w, geo["kh"], geo["kw"],
                                    geo["stride"], geo["pad"], geo["v"],
                                    n_tiles, k_kept, tile, x.element_size(),
                                    cpt=cpt, group=group,
                                    bk=bk) is not None]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FUSED_TILED_CASES)
def test_fused_tiled_gives_conv2d_fused_bits_under_every_instance(dev, case,
                                                                  dtype):
    x, values, idx, geo = _fused_tiled_problem(case, dtype, dev)
    assert fused_tiled_takes(x, values, **geo)
    want = conv2d_fused_scalar_cuda(x, values, idx, **geo)
    _close(want, conv2d_fused_ref(x, values, idx, **geo), dtype)
    _close(conv2d_fused_tiled_cuda(x, values, idx, **geo),
           conv2d_fused_tiled_ref(x, values, idx, **geo), dtype)
    insts = _fused_tiled_instances(x, values, geo)
    assert dict(cpt=1, group=1, bk=16) in insts
    for inst in insts:
        got = conv2d_fused_tiled_cuda(x, values, idx, **inst, **geo)
        torch.cuda.synchronize()
        assert torch.equal(got, want), inst


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [FUSED_TILED_CASES[1], FUSED_TILED_CASES[5],
                                  FUSED_TILED_CASES[9]])
def test_fused_tiled_walks_a_tile_that_is_not_ascending_in_k_order(dev, case,
                                                                   dtype):
    """A tile whose idx is permuted takes the kernel's one-by-one walk and
    still gives conv2d_fused.cu's bits; a bad index makes that tile, and
    only it, NaN before the last position and 0 after it."""
    x, values, idx, geo = _fused_tiled_problem(case, dtype, dev)
    n_tiles, k_kept, tile = values.shape
    idx[-1] = idx[-1].flip(0)
    want = conv2d_fused_scalar_cuda(x, values, idx, **geo)
    for inst in _fused_tiled_instances(x, values, geo):
        got = conv2d_fused_tiled_cuda(x, values, idx, **inst, **geo)
        torch.cuda.synchronize()
        assert torch.equal(got, want), inst
    idx[-1, k_kept // 2] = case[4] ** 2 * case[0]  # one past the last row
    want = conv2d_fused_scalar_cuda(x, values, idx, **geo)
    fg = fused_tiled_geometry(*x.shape, geo["kh"], geo["kw"], geo["stride"],
                              geo["pad"], geo["v"], n_tiles, k_kept, tile,
                              x.element_size())
    n_pos = x.shape[1] * fg["ho"] * fg["wo"]
    for inst in _fused_tiled_instances(x, values, geo):
        got = conv2d_fused_tiled_cuda(x, values, idx, **inst, **geo)
        torch.cuda.synchronize()
        assert bool(torch.isnan(got[-tile:, :n_pos]).all()), inst
        assert bool((got[-tile:, n_pos:] == 0).all()), inst
        assert torch.equal(got[:-tile], want[:-tile]), inst
        assert _nan_equal(got, want), inst


def test_fused_routing_rule(dev):
    """conv2d_fused_cuda takes the tiled kernel exactly where
    fused_tiled_takes says so; a tile of 12 rows and a misaligned view of
    the values go to conv2d_fused.cu, with the same bits; the checks of
    conv2d_fused.cu come first."""
    geo = dict(kh=3, kw=3, stride=1, pad=1)
    x = _x(8, 2, 8, 8, torch.float32, dev)
    values, idx = _compressed(2, 72, 36, 8, torch.float32, dev)
    v12, i12 = _compressed(2, 72, 36, 12, torch.float32, dev)
    flat = torch.empty(values.numel() + 1, dtype=values.dtype, device=dev)
    v_mis = flat[1:].view(values.shape)
    v_mis.copy_(values)
    calls = [(values, idx, True), (v12, i12, False), (v_mis, idx, False)]
    for vv, ii, takes in calls:
        assert fused_tiled_takes(x, vv, **geo) == takes
    want = [conv2d_fused_scalar_cuda(x, vv, ii, **geo) for vv, ii, _ in calls]
    torch.cuda.synchronize()
    reset_launch_counts()
    got = [conv2d_fused_cuda(x, vv, ii, **geo) for vv, ii, _ in calls]
    torch.cuda.synchronize()
    assert (CONV2D_FUSED_TILED.launches, CONV2D_FUSED.launches) == (1, 2)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="shared memory"):
        conv2d_fused_cuda(x, values, idx, block_k=0, **geo)
    with pytest.raises(ValueError, match="tiled fused conv takes"):
        conv2d_fused_tiled_cuda(x, v12, i12, **geo)
    with pytest.raises(ValueError, match="tiled fused conv takes"):
        conv2d_fused_tiled_cuda(x, values, idx, cpt=3, **geo)
    with pytest.raises(RuntimeError, match="forward only"):
        conv2d_fused_tiled_cuda(x, values.clone().requires_grad_(), idx,
                                **geo)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def test_vision_forward_on_card_matches_cpu(dev, tmp_path):
    from repro_torch.configs import get_vision_config
    from repro_torch.models.vision import (conv_hints, synth_batch,
                                           vision_apply, vision_init)

    dispatch.set_db(dispatch.ProfileDB(path=tmp_path / "profile.json"))
    try:
        cfg = get_vision_config("resnet-tiny")
        params = vision_init(cfg, 0, device="cpu")
        x, _ = synth_batch(cfg, 1, 8, device="cpu")
        want = vision_apply(params, cfg, x)  # plain versions on the CPU
        on_card = _to(params, dev)
        hints = conv_hints(cfg, batch=8)
        keys = []
        for path, _op, info in dispatch.iter_op_layers(on_card):
            hint = next(h for p, h in hints.items() if p and p in path)
            n_tiles, k_kept, tile = info["values"].shape
            keys.append(dispatch.conv_key(
                info["c_in"], hint["h"], hint["w"], n_tiles * tile, info["kh"],
                info["kw"], hint["stride"], hint["pad"], k_kept, tile, batch=8))
        impls = [None] + [s.name for s in dispatch.REGISTRY.candidates(
            "conv", param_keys=("values", "idx"))]
        for impl in impls:
            reset_launch_counts()
            spec = impl and dispatch.REGISTRY.get("conv", impl)
            if spec and not all(spec.feasible(k)[0] for k in keys):
                # forced past its shared memory, a candidate raises
                with pytest.raises(ValueError, match="shared memory"):
                    vision_apply(on_card, cfg, x.to(dev), impl=impl)
                continue
            got = vision_apply(on_card, cfg, x.to(dev), impl=impl).cpu()
            err = float((got - want).abs().max())
            assert err <= 1e-4 * float(want.abs().max()), (impl, err)
            if impl is None:  # an empty DB: the fused kernel, as before
                assert {k.name: k.launches for k in KERNELS if k.launches} == {
                    "conv2d_fused_tiled": 5}
        plan = dispatch.plan_params(on_card, profile=True,
                                    conv_hints=conv_hints(cfg, batch=8))
        assert len(plan) == 5 and len(dispatch.get_db()) == 5
        # the card races and picks hand-written kernels only
        for token, impl in plan.items():
            assert dispatch.REGISTRY.get("conv", impl).backend == "cuda"
            assert all(dispatch.REGISTRY.get("conv", n).backend == "cuda"
                       for n in dispatch.get_db().get(token)["all"])
        reset_launch_counts()
        got = vision_apply(on_card, cfg, x.to(dev)).cpu()
        assert sum(k.launches for k in KERNELS) >= 5
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    finally:
        dispatch.set_db(None)


@pytest.mark.parametrize("profiled", [False, True])
@pytest.mark.parametrize("d_out,tile", [(2560, None), (2560, 8), (2400, 12)])
def test_compressed_linear_through_dispatch(dev, tmp_path, d_out, tile,
                                            profiled):
    """Resolved by the heuristic or by a profile on the card, a compressed
    layer runs a sparse linear kernel, whatever its tile width: the tiled
    one by the heuristic where T is a multiple of 64, the other one for
    tiles 8 and 12; a profile runs its winner."""
    from repro_torch.core.pruning import SparsityConfig
    from repro_torch.core.sparse_linear import linear_apply, linear_init

    db = dispatch.ProfileDB(path=tmp_path / "profile.json")
    dispatch.set_db(db)
    try:
        gen = torch.Generator().manual_seed(0)
        sp = SparsityConfig(sparsity=0.5, m=None, tile=tile, min_dim=64,
                            format="compressed_pallas")
        layer = linear_init(gen, 960, d_out, sp, device=dev)
        x = _x(1, 2, 128, 960, torch.float32, dev)[0]  # [2, 128, 960]
        key = dispatch.linear_key_from(x.shape, layer["values"].shape)
        if profiled:
            plan = dispatch.plan_params({"mlp": layer}, batch_hint=256,
                                        profile=True)
            assert list(plan) == [key.token]
            assert set(db.get(key.token)["all"]) == {
                s.name for s in dispatch.REGISTRY.feasible(
                    key, param_keys=("values", "idx"), device_type="cuda")}
        spec, source = dispatch.resolve(key, param_keys=("values", "idx"),
                                        device=dev)
        assert spec.backend == "cuda"
        assert source == ("db" if profiled else "heuristic")
        if not profiled:
            assert spec.name == ("compressed_tiled" if tile is None
                                 else "compressed_pallas")
        kernel = ("colwise_nm_matmul_tiled" if spec.name == "compressed_tiled"
                  else "colwise_nm_matmul")
        reset_launch_counts()
        y = linear_apply(layer, x)
        torch.cuda.synchronize()
        assert {k.name: k.launches for k in KERNELS if k.launches} == {
            kernel: 1}
        want = colwise_nm_matmul_ref(x.reshape(-1, 960), layer["values"],
                                     layer["idx"]).reshape(2, 128, d_out)
        _close(y, want, torch.float32)
    finally:
        dispatch.set_db(None)


def test_banded_window_too_short_gives_nan_not_a_neighbouring_row(
        dev, monkeypatch):
    """The band gather never clamps: where ``band_rows`` is short of what
    the geometry needs, the rows past the window contribute NaN (the tiled
    kernel: the positions whose taps would leave its padded window)."""
    from repro_torch.kernels.conv_gemm import kernel as conv_kernel

    x = _x(8, 2, 16, 16, torch.float32, dev)
    values, idx = _compressed(2, 72, 36, 8, torch.float32, dev)
    geo = dict(kh=3, kw=3, pad=1)
    good = conv2d_fused_banded_scalar_cuda(x, values, idx, **geo)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(good).all())
    assert torch.equal(good, conv2d_fused_banded_tiled_cuda(x, values, idx,
                                                            **geo))
    plan = conv_kernel.band_plan
    monkeypatch.setattr(conv_kernel, "band_plan", lambda **kw: (
        plan(**kw)[0], plan(**kw)[1] - 2))
    tiled_plan = conv_kernel.tiled_band_plan

    def short_tiled(**kw):
        n_bands, rows, lead, pitch, _ = tiled_plan(**kw)
        return n_bands, rows - 2, lead, pitch, lead + (rows - 2) * pitch

    monkeypatch.setattr(conv_kernel, "tiled_band_plan", short_tiled)
    for launch in (conv2d_fused_banded_scalar_cuda,
                   conv2d_fused_banded_tiled_cuda):
        short = launch(x, values, idx, **geo)
        torch.cuda.synchronize()
        assert bool(torch.isnan(short).any()), launch.__name__
        # every output is either NaN or exactly the full window's
        same = short == good
        assert bool((same | torch.isnan(short)).all()), launch.__name__


def test_device_timer_times_a_kernel_launch(dev):
    x = _x(8, 2, 16, 16, torch.float32, dev)
    values, idx = _compressed(2, 72, 36, 8, torch.float32, dev)
    us = dispatch.device_time_us(
        lambda: conv2d_fused_cuda(x, values, idx, kh=3, kw=3, pad=1),
        device=dev)
    assert 0.0 < us < 1e4


# ---------------------------------------------------------------------------
# Paged attention
# ---------------------------------------------------------------------------


def _paged(dev, dtype, **kw):
    """A paged problem on the card: float operands in ``dtype``."""
    arrays = problem(**kw)
    return tuple(torch.from_numpy(a).to(dev, dtype if a.dtype == np.float32
                                        else torch.int32) for a in arrays)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", PAGED_CASES, ids=case_id)
def test_paged_kernel_matches_plain(dev, case, dtype):
    args = _paged(dev, dtype, **case_kwargs(case))
    ps = case[6]
    for block_q in (8, 16, 1):
        got = paged_attention_scalar_cuda(*args, page_size=ps, block_q=block_q)
        _close(got, paged_attention_ref(*args), dtype)
    _close(paged_attention_cuda(*args, page_size=ps),
           paged_attention_ref(*args), dtype)


def test_paged_trash_page_and_empty_cache(dev):
    """Padded table entries name the trash page: whatever it holds, NaN
    included, the output does not change.  An empty cache attends to the
    new keys alone."""
    kw = dict(b=3, sq=4, h=4, kv=2, d=16, n_pages=4, page_size=8,
              lengths=[0, 9, 17])
    finite = _paged(dev, torch.float32, trash_value=1e4, **kw)
    poisoned = _paged(dev, torch.float32, trash_value=float("nan"), **kw)
    want = paged_attention_ref(*finite)
    q, kn, vn, kp, vp, tables, lengths = finite
    none = torch.zeros_like(lengths)
    own = paged_attention_ref(q, kn, vn, kp[:1] * 0, vp[:1] * 0,
                              torch.zeros_like(tables[:, :1]), none)
    assert paged_split_takes(*finite[:6])
    for launch in (paged_attention_cuda, paged_attention_scalar_cuda):
        got = launch(*poisoned, page_size=8)
        _close(got, want, torch.float32)
        empty = launch(q, kn, vn, kp, vp, tables, none, page_size=8)
        _close(empty, own, torch.float32)


def test_paged_bad_page_id_gives_nan_not_a_bad_read(dev):
    q, kn, vn, kp, vp, tables, lengths = _paged(
        dev, torch.float32, b=2, lengths=[20, 20])
    tables[1, 1] = kp.shape[0]  # one past the last physical page
    for launch in (paged_attention_cuda, paged_attention_scalar_cuda):
        out = launch(q, kn, vn, kp, vp, tables, lengths, page_size=8)
        torch.cuda.synchronize()
        assert bool(torch.isnan(out[1]).all())
        assert bool(torch.isfinite(out[0]).all())


def test_paged_wrapper_rejects_what_the_kernel_does_not_take(dev):
    args = _paged(dev, torch.float32, h=3, kv=2)
    with pytest.raises(ValueError, match="H % KV"):
        paged_attention_cuda(*args, page_size=8)
    args = _paged(dev, torch.float32)
    with pytest.raises(ValueError, match="page_size"):
        paged_attention_cuda(*args, page_size=16)
    q, kn, vn, kp, vp, tables, lengths = args
    with pytest.raises(TypeError, match="dtype"):
        paged_attention_cuda(q, kn, vn, kp, vp, tables.long(), lengths,
                             page_size=8)
    with pytest.raises(TypeError, match="dtype"):
        paged_attention_cuda(q, kn.bfloat16(), vn, kp, vp, tables, lengths,
                             page_size=8)
    strided = torch.cat([q, q], dim=2)[:, :, ::2]  # q's shape, not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        paged_attention_cuda(strided, kn, vn, kp, vp, tables, lengths,
                             page_size=8)


def test_paged_dispatch_on_the_card(dev, tmp_path):
    """On the card the paged family resolves among the kernel geometries
    only: a page size with none raises; the plain version runs when
    forced, and launches nothing."""
    from repro_torch.dispatch import TuningError

    dispatch.set_db(dispatch.ProfileDB(path=tmp_path / "profile.json"))
    try:
        args = _paged(dev, torch.float32, b=4, sq=1, h=15, kv=5, d=64,
                      n_pages=10, page_size=16, lengths=[0, 16, 37, 150])
        for ps, n_launch in ((16, 1), (8, 1), (32, 1)):
            a = _paged(dev, torch.float32, b=2, h=15, kv=5, d=64,
                       page_size=ps, lengths=[3, 20]) if ps != 16 else args
            reset_launch_counts()
            got = paged_attention(*a, page_size=ps)
            torch.cuda.synchronize()
            assert PAGED_ATTENTION_SPLIT.launches == n_launch
            assert PAGED_ATTENTION.launches == 0
            _close(got, paged_attention_ref(*a), torch.float32)
        reset_launch_counts()
        forced = paged_attention(*args, page_size=16, impl="paged_attn_ref")
        with dispatch.force_scope(paged_attn="paged_attn_ref"):
            scoped = paged_attention(*args, page_size=16)
        torch.cuda.synchronize()
        assert PAGED_ATTENTION.launches == PAGED_ATTENTION_SPLIT.launches == 0
        assert torch.equal(forced, scoped)
        with pytest.raises(TuningError):
            paged_attention(*_paged(dev, torch.float32, page_size=4),
                            page_size=4)
        assert dispatch.choose_page_size(15, 5, 64, 160, q_rows=4,
                                         device=dev) == 16
        ps = dispatch.choose_page_size(15, 5, 64, 160, q_rows=4, device=dev,
                                       profile=True)
        assert ps in {dict(g)["ps"] for g in dispatch.PAGED_ATTN_GEOMETRY}
    finally:
        dispatch.set_db(None)


@pytest.mark.parametrize("name,sq", [("paged_attn_pallas", 1),
                                     ("paged_attn_pallas@ps16_bq16", 16),
                                     ("paged_attn_pallas@ps8_bq8", 8)])
def test_paged_launch_smem_equals_the_feasibility_footprint(dev, name, sq):
    spec = dispatch.REGISTRY.get("paged_attn", name)
    ps, bq = spec.geom("ps"), spec.geom("bq")
    args = _paged(dev, torch.float32, b=2, sq=sq, h=15, kv=5, d=64,
                  page_size=ps, lengths=[5, 30])
    key = dispatch.paged_attn_key(2 * sq, 15, 5, 64, 4 * ps, page_size=ps)
    reset_launch_counts()
    paged_attention_cuda(*args, page_size=ps, block_q=bq)
    torch.cuda.synchronize()
    assert spec.feasible(key)[0]
    # the launch sizes the kernel the rule picks for the call's Sq; the
    # registry sizes it at bq query rows a sequence
    kernel = PAGED_ATTENTION_SPLIT if sq * 3 <= 16 else PAGED_ATTENTION
    assert kernel.launches == 1
    assert kernel.last_smem_bytes == paged_launch_smem_bytes(
        ps, 64, 15, 5, sq, args[5].shape[1], torch.float32, bq)
    assert spec.smem_bytes(key) == paged_launch_smem_bytes(
        ps, 64, 15, 5, bq, -(-key.get("kvcap") // ps), torch.float32, bq)
    if sq >= bq:
        assert kernel.last_smem_bytes == spec.smem_bytes(key)


def test_served_requests_launch_the_kernels(dev, tmp_path):
    """The smoke model served on the card through the paged scheduler: each
    decode step launches the split paged kernel once per layer and every linear
    layer its kernel, and the tokens are the plain CPU run's."""
    from repro_torch.configs import smoke_config
    from repro_torch.core.pruning import SparsityConfig
    from repro_torch.models.lm import lm_init
    from repro_torch.serve import Engine, Scheduler, synthetic_trace

    dispatch.set_db(dispatch.ProfileDB(path=tmp_path / "profile.json"))
    try:
        cfg = smoke_config("smollm-360m").with_(sparsity=SparsityConfig(
            sparsity=0.5, m=None, tile=None, min_dim=16,
            format="compressed_pallas"))
        params = lm_init(cfg, 0, device="cpu")
        trace = lambda: synthetic_trace(5, seed=1, vocab=cfg.vocab_size,  # noqa: E731
                                        prompt_lens=(3, 20), new_tokens=(2, 9))
        runs = {}
        for where in ("cpu", "cuda"):
            reset_launch_counts()
            sched = Scheduler(Engine(cfg, _to(params, torch.device(where))),
                              n_slots=3, paged=True, page_size=8)
            runs[where] = {c.uid: c.tokens for c in sched.run(trace())}
            torch.cuda.synchronize()
            counts = {k.name: k.launches for k in KERNELS if k.launches}
        st = sched.stats
        # T = d_out: q, o and down (64 wide) take the tiled kernel, k, v
        # (32), gate and up (96) the other one
        layer = params["layers"]
        tiled = sum(layer[a][n]["values"].shape[-1] % 64 == 0
                    for a, n in (("attn", "q"), ("attn", "k"), ("attn", "v"),
                                 ("attn", "o"), ("mlp", "gate"), ("mlp", "up"),
                                 ("mlp", "down")))
        assert tiled == 3
        calls = cfg.n_layers * (st["decode_steps"] + st["prefill_calls"])
        assert counts == {
            "paged_attention_split": cfg.n_layers * st["decode_steps"],
            "colwise_nm_matmul_tiled": tiled * calls,
            "colwise_nm_matmul": (7 - tiled) * calls}
        assert runs["cpu"].keys() == runs["cuda"].keys()
        for uid, toks in runs["cpu"].items():
            assert np.array_equal(toks, runs["cuda"][uid]), uid
    finally:
        dispatch.set_db(None)


def _paged_kernels(args, ps):
    """(split kernel under each warp count that fits, paged_attention.cu)."""
    q = args[0]
    rows = (q.shape[2] // args[3].shape[2]) * q.shape[1]
    tiles = paged_split_tile_bound(ps, args[5].shape[1], q.shape[1])
    split = {w: paged_attention_split_cuda(*args, page_size=ps, warps=w)
             for w in PAGED_SPLIT_WARPS
             if paged_split_smem_bytes(ps, q.shape[3], rows, q.element_size(),
                                       w, tiles) <= SMEM_BYTES}
    return split, paged_attention_scalar_cuda(*args, page_size=ps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", PAGED_CASES, ids=case_id)
def test_paged_split_matches_plain_and_the_other_kernel(dev, case, dtype):
    """Where the rule takes the case, every warp count agrees with the
    plain version, with its own plain version (the same page assignment
    and combine) and with paged_attention.cu; not bit for bit (the sums
    run in another order)."""
    args = _paged(dev, dtype, **case_kwargs(case))
    ps = case[6]
    if not paged_split_takes(*args[:6]):
        assert case[1] * case[2] // case[3] > 16  # only Sq 12: 24 rows
        return
    split, old = _paged_kernels(args, ps)
    assert len(split) >= 2
    want = paged_attention_ref(*args)
    for warps, got in split.items():
        _close(got, want, dtype)
        _close(got, old, dtype)
        _close(got, paged_attention_split_ref(*args, warps=warps), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_split_more_pages_than_warps_and_new_keys_past_a_page(dev,
                                                                    dtype):
    # 150 rows: 10 pages and a tile of new keys over 4 warps
    args = _paged(dev, dtype, b=4, sq=1, h=15, kv=5, d=64, n_pages=10,
                  page_size=16, lengths=[0, 16, 37, 150], shuffle=True)
    got = paged_attention_split_cuda(*args, page_size=16, warps=4)
    _close(got, paged_attention_ref(*args), dtype)
    # Sq 12 at page size 8, one q head a KV head: two tiles of new keys
    args = _paged(dev, dtype, b=2, sq=12, h=2, kv=2, d=16, n_pages=3,
                  page_size=8, lengths=[0, 19], shuffle=True)
    assert paged_split_takes(*args[:6])
    for warps in PAGED_SPLIT_WARPS:
        got = paged_attention_split_cuda(*args, page_size=8, warps=warps)
        _close(got, paged_attention_ref(*args), dtype)


def test_paged_split_routing_rule(dev):
    """paged_attention_cuda launches the split kernel where
    paged_split_takes holds and paged_attention.cu elsewhere: 24 query rows
    a KV head, a head of 72-byte rows, pages of 64 rows, a misaligned q."""
    taken = _paged(dev, torch.float32, b=4, sq=1, h=15, kv=5, d=64,
                   n_pages=10, page_size=16, lengths=[0, 16, 37, 150])
    rows24 = _paged(dev, torch.float32, b=2, sq=8, h=15, kv=5, d=64,
                    page_size=16, lengths=[5, 30])
    d18 = _paged(dev, torch.float32, b=2, h=4, kv=2, d=18, page_size=8,
                 lengths=[5, 30])
    ps64 = _paged(dev, torch.float32, b=2, h=4, kv=2, d=16, n_pages=2,
                  page_size=64, lengths=[5, 100])
    q = taken[0]
    buf = torch.empty(q.numel() + 1, device=dev)
    view = buf[1:].view(q.shape)
    view.copy_(q)
    shifted = (view, *taken[1:])
    for args, ps, split in ((taken, 16, True), (rows24, 16, False),
                            (d18, 8, False), (ps64, 64, False),
                            (shifted, 16, False)):
        assert paged_split_takes(*args[:6]) is split
        reset_launch_counts()
        got = paged_attention_cuda(*args, page_size=ps)
        torch.cuda.synchronize()
        assert (PAGED_ATTENTION_SPLIT.launches, PAGED_ATTENTION.launches) == \
            ((1, 0) if split else (0, 1))
        _close(got, paged_attention_ref(*args), torch.float32)
    with pytest.raises(ValueError, match="split paged kernel takes"):
        paged_attention_split_cuda(*rows24, page_size=16)
    with pytest.raises(ValueError, match="instance"):
        paged_attention_split_cuda(*taken, page_size=16, warps=3)
    # f32 at 16 warps: 11 tiles at most, one slot a warp; a 20-page table
    # needs two, and 16 warps of two 16-row slots pass 227 KB
    assert paged_split_config(16, 64, 3, 11, torch.float32) == (16, 4)
    assert paged_split_config(16, 64, 3, 21, torch.float32) == (8, 4)
    wide = _paged(dev, torch.float32, b=2, sq=1, h=15, kv=5, d=64,
                  n_pages=20, page_size=16, lengths=[300, 17], shuffle=True)
    with pytest.raises(ValueError, match="shared memory"):
        paged_attention_split_cuda(*wide, page_size=16, warps=16)
    for warps in (None, 4, 8):
        got = paged_attention_split_cuda(*wide, page_size=16, warps=warps)
        _close(got, paged_attention_ref(*wide), torch.float32)


@pytest.mark.parametrize("name", WRAPPERS)
def test_every_wrapper_raises_under_grad(dev, name):
    """On the card every kernel wrapper refuses a call autograd would
    record (its output would have no grad_fn), and runs the same call
    without grad or under torch.no_grad()."""
    for which in range(n_floats(name)):
        with pytest.raises(RuntimeError, match="forward only"):
            call_with_grad(name, dev, which)
    reset_launch_counts()
    call_with_grad(name, dev, -1)
    with torch.no_grad():
        call_with_grad(name, dev, 0)
    torch.cuda.synchronize()
    assert sum(k.launches for k in KERNELS) >= 2


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------

# tests/test_flash_attn.py's sweep: (bh, sq, sk, d, causal)
FLASH_SWEEP = [
    (2, 32, 32, 16, True),
    (1, 16, 48, 16, False),   # cross-attn-like
    (2, 24, 24, 32, True),    # ragged q tiles
    (1, 8, 8, 16, True),      # tiles > dims
    (3, 33, 17, 16, True),    # ragged both, Sq > Sk: the top-left mask
]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}  # JAX's TOL, atol = rtol


def _flash_qkv(b, sq, sk, h, kv, d, dtype, dev, seed=0):
    """q [b, sq, h, d], k/v [b, sk, kv, d] on the card from a numpy seed."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(dev, dtype)

    return f(b, sq, h, d), f(b, sk, kv, d), f(b, sk, kv, d)


def _flash_close(got, want, dtype):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,sq,sk,d,causal", FLASH_SWEEP)
def test_flash_kernel_matches_plain_over_the_sweep(dev, bh, sq, sk, d, causal,
                                                   dtype):
    """The Pallas kernel's layout: q [BH, Sq, D], k/v [BH, Sk, D]."""
    q, k, v = (t[:, :, 0] for t in _flash_qkv(bh, sq, sk, 1, 1, d, dtype, dev,
                                               seed=bh * sq + sk))
    _flash_close(flash_attention_cuda(q, k, v, causal=causal),
                 flash_attention_ref(q, k, v, causal=causal), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", [
    (2, 16, 16, 4, 4, 16, True),
    (2, 16, 16, 4, 2, 16, True),
    (2, 16, 16, 5, 2, 16, True),     # H % KV != 0: heads map to [0,0,0,1,1]
    (2, 33, 17, 5, 2, 16, True),     # and the top-left mask with Sq > Sk
    (1, 17, 70, 6, 3, 32, False),    # two K tiles, ragged
    (1, 130, 130, 3, 1, 48, True),   # three q tiles, D not a power of two
    (1, 70, 70, 2, 1, 128, True),    # the widest head the kernel takes
    (2, 33, 17, 5, 2, 18, True),     # not whole 16-byte rows: the other kernel
])
def test_flash_gqa_layout_and_head_map(dev, b, sq, sk, h, kv, d, causal,
                                       dtype):
    """The public entry point launches the kernel the shape rule picks,
    once, with the shared memory its footprint function gives."""
    q, k, v = _flash_qkv(b, sq, sk, h, kv, d, dtype, dev, seed=h * 7 + kv)
    reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal)
    _flash_close(got, flash_attention_gqa_ref(q, k, v, causal=causal), dtype)
    if d == 18:
        assert FLASH_ATTENTION.launches == 1
        assert FLASH_ATTENTION_TILED.launches == 0
        assert FLASH_ATTENTION.last_smem_bytes == flash_smem_bytes(d)
    else:
        assert FLASH_ATTENTION_TILED.launches == 1
        assert FLASH_ATTENTION.launches == 0
        rows, _ = flash_tiled_config(d, dtype)
        assert FLASH_ATTENTION_TILED.last_smem_bytes == flash_tiled_smem_bytes(
            d, dtype, rows)


def test_flash_head_map_is_not_h_over_g(dev):
    """At H 5, KV 2 the map (h * KV) // H gives [0, 0, 0, 1, 1]; the
    kernel's output for head 2 is KV head 0's, which h // (H // KV) = 1
    would not give."""
    q, k, v = _flash_qkv(1, 8, 8, 5, 2, 16, torch.float32, dev, seed=3)
    got = flash_attention_cuda(q, k, v, causal=True)
    head2 = flash_attention_ref(q[:, :, 2], k[:, :, 0], v[:, :, 0])
    _flash_close(got[:, :, 2], head2, torch.float32)
    wrong = flash_attention_ref(q[:, :, 2], k[:, :, 1], v[:, :, 1])
    assert float((got[:, :, 2] - wrong).abs().max()) > 1e-2


def test_flash_large_logits_stay_finite(dev):
    q = torch.full((1, 8, 16), 30.0, device=dev)
    k = torch.full((1, 8, 16), 30.0, device=dev)
    v = _flash_qkv(1, 8, 1, 1, 1, 16, torch.float32, dev)[0][:, :, 0]
    for causal in (False, True):
        got = flash_attention_cuda(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        _flash_close(got, flash_attention_ref(q, k, v, causal=causal),
                     torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_the_scoring_shape(dev, dtype):
    """smollm-360m's scoring forward: B 4, S 2048, H 15, KV 5, D 64."""
    q, k, v = _flash_qkv(4, 2048, 2048, 15, 5, 64, dtype, dev, seed=5)
    _flash_close(flash_attention_cuda(q, k, v, causal=True),
                 flash_attention_gqa_ref(q, k, v, causal=True), dtype)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(dev):
    q, k, v = _flash_qkv(1, 8, 8, 2, 2, 256, torch.float32, dev)
    assert flash_smem_bytes(256) is None
    with pytest.raises(ValueError, match="head_dim 256"):
        flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="head_dim 256"):
        flash_attention(q, k, v)
    q, k, v = _flash_qkv(1, 8, 8, 2, 2, 16, torch.float32, dev)
    with pytest.raises(TypeError, match="dtype"):
        flash_attention_cuda(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="shapes"):
        flash_attention_cuda(q, k[:, :, :, :8].contiguous(), v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_cuda(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_cuda(q.cpu(), k.cpu(), v.cpu())
    reset_launch_counts()
    for call in (flash_attention, flash_attention_cuda):
        with pytest.raises(RuntimeError, match="forward only"):
            call(q.requires_grad_(), k, v)
    with torch.no_grad():
        flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert FLASH_ATTENTION_TILED.launches == 1  # D 16 f32: the tiled kernel
    assert FLASH_ATTENTION.launches == 0


def test_attn_apply_and_forward_launch_flash_once_per_layer(dev):
    """Under attn_impl="pallas" each attn_apply launches the flash kernel
    once and nothing else (dense smoke linears are plain matmuls); the
    model's logits equal the naive branch's; under "naive" and "chunked"
    the kernel is not launched."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import attention as tattn
    from repro_torch.models import registry as treg
    from repro_torch.models.blocks import layer_params
    from repro_torch.models.lm import lm_init

    cfg = smoke_config("smollm-360m").with_(attn_impl="pallas")
    params = lm_init(cfg, 0, device=dev)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 40, cfg.d_model),
                                             dtype=np.float32)).to(dev)
    pos = torch.arange(40, device=dev)[None].expand(2, 40)
    attn0 = layer_params(params["layers"], 0)["attn"]
    reset_launch_counts()
    with torch.no_grad():
        y = tattn.attn_apply(attn0, cfg, x, positions=pos)
    torch.cuda.synchronize()
    assert {k.name: k.launches for k in KERNELS if k.launches} == {
        "flash_attention_tiled": 1}  # head_dim 16 in f32: the tiled kernel
    y_naive = tattn.attn_apply(attn0, cfg.with_(attn_impl="naive"), x,
                               positions=pos)
    _flash_close(y, y_naive, torch.float32)

    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)).to(dev)}
    want = treg.forward_fn(cfg.with_(attn_impl="naive"))(params, batch)
    chunked = treg.forward_fn(cfg.with_(attn_impl="chunked", attn_chunk=8))(
        params, batch)
    torch.cuda.synchronize()
    assert FLASH_ATTENTION_TILED.launches == 1
    reset_launch_counts()
    with torch.no_grad():
        got = treg.forward_fn(cfg)(params, batch)
    torch.cuda.synchronize()
    assert {k.name: k.launches for k in KERNELS if k.launches} == {
        "flash_attention_tiled": cfg.n_layers}
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale
    assert float((chunked - want).abs().max()) <= 1e-4 * scale


# ---------------------------------------------------------------------------
# The tiled flash kernel: the other kernel's bits, and the routing rule
# ---------------------------------------------------------------------------

FLASH_GQA_CASES = [  # (b, sq, sk, h, kv, d, causal)
    (2, 16, 16, 5, 2, 16, True),
    (2, 33, 17, 5, 2, 16, True),
    (1, 17, 70, 6, 3, 32, False),
    (1, 130, 130, 3, 1, 48, True),
    (2, 130, 130, 15, 5, 64, True),   # ragged last query block and key tile
    (1, 300, 200, 4, 2, 96, True),
    (1, 70, 70, 2, 1, 128, True),
]


def _tiled_shapes(d, dtype):
    """Every instance of the tiled kernel that takes a head of ``d``."""
    from repro_torch.kernels.flash_attn.tune import instances
    return instances(d, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,sq,sk,d,causal", FLASH_SWEEP)
def test_flash_tiled_equals_the_scalar_kernel_over_the_sweep(
        dev, bh, sq, sk, d, causal, dtype):
    q, k, v = (t[:, :, 0] for t in _flash_qkv(bh, sq, sk, 1, 1, d, dtype, dev,
                                               seed=bh * sq + sk))
    want = flash_attention_scalar_cuda(q, k, v, causal=causal)
    for shape in _tiled_shapes(d, dtype):
        got = flash_attention_tiled_cuda(q, k, v, causal=causal, shape=shape)
        torch.cuda.synchronize()
        assert torch.equal(got, want), shape
    _flash_close(want, flash_attention_ref(q, k, v, causal=causal), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", FLASH_GQA_CASES)
def test_flash_tiled_equals_the_scalar_kernel_gqa(dev, b, sq, sk, h, kv, d,
                                                  causal, dtype):
    q, k, v = _flash_qkv(b, sq, sk, h, kv, d, dtype, dev, seed=sq + d)
    want = flash_attention_scalar_cuda(q, k, v, causal=causal)
    _flash_close(want, flash_attention_gqa_ref(q, k, v, causal=causal), dtype)
    for shape in _tiled_shapes(d, dtype):
        got = flash_attention_tiled_cuda(q, k, v, causal=causal, shape=shape)
        torch.cuda.synchronize()
        assert torch.equal(got, want), shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_tiled_at_the_scoring_shape(dev, dtype):
    """smollm-360m's scoring forward (B 4, S 2048, H 15, KV 5, D 64): the
    rule's instance against the plain version and, bit for bit, the other
    kernel."""
    q, k, v = _flash_qkv(4, 2048, 2048, 15, 5, 64, dtype, dev, seed=5)
    got = flash_attention_tiled_cuda(q, k, v, causal=True)
    _flash_close(got, flash_attention_gqa_ref(q, k, v, causal=True), dtype)
    assert torch.equal(got, flash_attention_scalar_cuda(q, k, v, causal=True))


@pytest.mark.parametrize("kernel", ["tiled", "scalar"])
def test_flash_keys_past_sk_stay_out_of_the_sum(dev, kernel):
    """K and V are views whose memory runs on into NaN rows past Sk (B 1,
    so the view is contiguous): the staged tile holds zeros there, never
    those rows, so the output stays finite and equals the clean inputs'."""
    fn = (flash_attention_tiled_cuda if kernel == "tiled"
          else flash_attention_scalar_cuda)
    q, k_full, v_full = _flash_qkv(1, 70, 128, 4, 2, 64, torch.float32, dev,
                                   seed=11)
    k_full[:, 70:] = float("nan")
    v_full[:, 70:] = float("nan")
    k, v = k_full[:, :70], v_full[:, :70]
    assert k.is_contiguous() and v.is_contiguous()
    for causal in (True, False):
        got = fn(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        want = flash_attention_gqa_ref(q, k.clone(), v.clone(), causal=causal)
        _flash_close(got, want, torch.float32)


def test_flash_routing_rule(dev):
    """flash_attention_cuda takes the tiled kernel exactly where
    flash_tiled_takes says so: whole 16-byte rows (f32 D % 4, bf16 D % 8)
    and 16-byte aligned operands; a misaligned view and f32 D 18 go to the
    other kernel, with the same bits."""
    cases = [(16, torch.float32, True), (20, torch.float32, True),
             (18, torch.float32, False), (20, torch.bfloat16, False),
             (24, torch.bfloat16, True), (128, torch.float32, True)]
    for d, dtype, tiled in cases:
        q, k, v = _flash_qkv(1, 40, 40, 5, 2, d, dtype, dev, seed=d)
        assert flash_tiled_takes(q, k, v) == tiled, (d, dtype)
        reset_launch_counts()
        flash_attention_cuda(q, k, v)
        torch.cuda.synchronize()
        assert FLASH_ATTENTION_TILED.launches == int(tiled), (d, dtype)
        assert FLASH_ATTENTION.launches == int(not tiled), (d, dtype)
    q, k, v = _flash_qkv(1, 40, 40, 5, 2, 64, torch.float32, dev, seed=3)
    base = torch.empty(q.numel() + 1, device=dev)
    q_mis = base[1:].view(q.shape)
    q_mis.copy_(q)
    assert q_mis.is_contiguous() and q_mis.data_ptr() % 16
    assert not flash_tiled_takes(q_mis, k, v)
    reset_launch_counts()
    got = flash_attention_cuda(q_mis, k, v)
    torch.cuda.synchronize()
    assert FLASH_ATTENTION.launches == 1 and FLASH_ATTENTION_TILED.launches == 0
    assert torch.equal(got, flash_attention_tiled_cuda(q, k, v))
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_tiled_cuda(q_mis, k, v)


def test_flash_tiled_rejects_what_the_kernel_does_not_take(dev):
    q, k, v = _flash_qkv(1, 8, 8, 2, 2, 18, torch.float32, dev)
    with pytest.raises(ValueError, match="head_dim 18"):
        flash_attention_tiled_cuda(q, k, v)
    q, k, v = _flash_qkv(1, 8, 8, 2, 2, 128, torch.float32, dev)
    for shape in ((64, 8), (32, 4), (128, 4)):  # 8 rows at D 128; no 32;
        with pytest.raises(ValueError, match="shape|shared memory"):  # smem
            flash_attention_tiled_cuda(q, k, v, shape=shape)
    q, k, v = _flash_qkv(1, 8, 8, 2, 2, 16, torch.float32, dev)
    with pytest.raises(TypeError, match="dtype"):
        flash_attention_tiled_cuda(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_tiled_cuda(q.cpu(), k.cpu(), v.cpu())
    reset_launch_counts()
    with pytest.raises(RuntimeError, match="forward only"):
        flash_attention_tiled_cuda(q.requires_grad_(), k, v)
    assert FLASH_ATTENTION_TILED.launches == 0
    assert set(FLASH_TILED_SHAPES) == {(64, 4), (64, 8), (128, 4), (128, 8)}


# ---------------------------------------------------------------------------
# Training: the autograd twins of the sparse conv and linear on the card
# ---------------------------------------------------------------------------

# the conv families a train step runs under force_scope, and the kernel
# roles each launches once per pruned conv: {role: (old kernel, tiled)}
TRAIN_FAMILIES = {
    "fused_sparse_pallas": {"conv": ("conv2d_fused", "conv2d_fused_tiled")},
    "fused_banded_pallas": {"conv": ("conv2d_fused_banded",
                                     "conv2d_fused_banded_tiled")},
    "two_kernel_pipelined": {
        "pack": ("im2col_pack", "im2col_pack_tiled"),
        "gemm": ("colwise_nm_matmul_strips_pipelined",
                 "colwise_nm_matmul_strips_pipelined_tiled")},
    "im2col_sparse_pallas": {
        "pack": ("im2col_pack", "im2col_pack_tiled"),
        "gemm": ("colwise_nm_matmul_strips", "colwise_nm_matmul_strips_tiled")},
    "im2col_sparse_xla": {"pack": ("im2col_pack", "im2col_pack_tiled")},
}


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def _train_problem(batch, seed=0):
    from repro_torch.configs import get_vision_config
    from repro_torch.models.vision import sgd_init, synth_batch, vision_init

    cfg = get_vision_config("resnet-tiny")
    params = vision_init(cfg, seed, device="cpu")
    x, labels = synth_batch(cfg, seed + 1, batch, device="cpu")
    return cfg, params, sgd_init(params), x, labels


@pytest.mark.parametrize("family", list(TRAIN_FAMILIES))
def test_train_step_runs_the_family_kernels_forward(dev, tmp_path, family):
    """One resnet-tiny SGD step with the conv family forced: the forward
    launches the family's kernels once per pruned conv and nothing else,
    every trainable leaf gets a finite, non-zero gradient (the first step's
    momentum), and the step agrees with the same step on the CPU."""
    from repro_torch.models.vision import train_step

    dispatch.set_db(dispatch.ProfileDB(path=tmp_path / "profile.json"))
    try:
        cfg, params, mom, x, labels = _train_problem(8)
        want = train_step(params, mom, cfg, x, labels)
        with dispatch.force_scope(conv=family):
            reset_launch_counts()
            got = train_step(_to(params, dev), _to(mom, dev), cfg, x.to(dev),
                             labels.to(dev))
            torch.cuda.synchronize()
        counts = {k.name: k.launches for k in KERNELS if k.launches}
        roles = TRAIN_FAMILIES[family]
        for names in roles.values():
            assert sum(counts.get(n, 0) for n in names) == 5, counts
        assert sum(counts.values()) == 5 * len(roles), counts
        assert abs(float(got[2]) - float(want[2])) <= 1e-5 * float(want[2])
        for g_dev, g_cpu in zip(_leaves(got[1]), _leaves(want[1]),
                                strict=True):
            if not g_cpu.is_floating_point():
                assert torch.equal(g_dev.cpu(), g_cpu)
                continue
            assert bool(torch.isfinite(g_dev).all())
            assert float(g_dev.abs().max()) > 0
            _close(g_dev.cpu(), g_cpu, torch.float32)
        for p_dev, p_cpu in zip(_leaves(got[0]), _leaves(want[0]), strict=True):
            _close(p_dev.cpu().float(), p_cpu.float(), torch.float32)
    finally:
        dispatch.set_db(None)


def test_train_step_is_repeatable_bit_for_bit(dev, tmp_path):
    """Two runs of the same steps give the same bits: the scatters of both
    backwards add in a fixed order on the card."""
    from repro_torch.models.vision import train_step

    dispatch.set_db(dispatch.ProfileDB(path=tmp_path / "profile.json"))
    try:
        cfg, params, mom, x, labels = _train_problem(64)
        runs = []
        for _ in range(2):
            p, m = _to(params, dev), _to(mom, dev)
            losses = []
            for _step in range(2):
                p, m, loss = train_step(p, m, cfg, x.to(dev), labels.to(dev))
                losses.append(loss)
            runs.append((_leaves((p, m)), losses))
        for a, b in zip(*(r[0] + r[1] for r in runs), strict=True):
            assert torch.equal(a, b)
    finally:
        dispatch.set_db(None)


@pytest.mark.parametrize("entry", ["colwise_nm_matmul",
                                   "colwise_nm_matmul_tiled"])
def test_linear_twin_on_card_matches_cpu(dev, entry):
    """The sparse linear's backward on the card (the kernel forward) against
    the same call on the CPU (the plain forward), tiles that share kept
    rows included; the kernel launches once, for the forward."""
    from repro_torch.kernels.colwise_nm import ops

    fn = getattr(ops, entry)
    x = _x(2, 3, 5, 128, torch.float32, "cpu").reshape(2, 3, 5, 128)
    values, idx = _compressed(2, 128, 64, 64, torch.float32, "cpu")
    cot = _x(2, 3, 5, 128, torch.float32, "cpu", seed=3)
    grads = []
    for d in ("cpu", dev):
        xt = x.to(d).requires_grad_()
        vt = values.to(d).requires_grad_()
        reset_launch_counts()
        y = fn(xt, vt, idx.to(d))
        grads.append(torch.autograd.grad((y * cot.to(d)).sum(), (xt, vt)))
    assert sum(k.launches for k in KERNELS) == 1
    for g_dev, g_cpu in zip(grads[1], grads[0]):
        _close(g_dev.cpu(), g_cpu, torch.float32)


def test_conv_backward_is_repeatable_at_the_main_path_shape(dev):
    """resnet-tiny's widest pruned conv at batch 256 (fidx [65536, 2, 72]):
    the same backward twice gives the same bits."""
    from repro_torch.kernels.conv_gemm import conv2d_sparse_bwd

    x = _x(16, 256, 16, 16, torch.float32, dev)
    values, idx = _compressed(2, 144, 72, 8, torch.float32, dev)
    dy = _x(16, 256, 16, 16, torch.float32, dev, seed=5)
    kw = dict(kh=3, kw=3, stride=1, pad=1)
    a = conv2d_sparse_bwd(x, values, idx, dy, **kw)
    b = conv2d_sparse_bwd(x, values, idx, dy, **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert bool(torch.isfinite(a[0]).all()) and bool(torch.isfinite(a[1]).all())


def test_raw_kernel_calls_still_raise_under_autograd(dev):
    """conv2d_sparse differentiates on the card, while a raw kernel wrapper
    and a single-plan function called on the same tensors under autograd
    still refuse."""
    from repro_torch.kernels.conv_gemm import conv2d_fused, conv2d_sparse

    x = _x(8, 2, 8, 8, torch.float32, dev).requires_grad_()
    values, idx = _compressed(2, 72, 36, 8, torch.float32, dev)
    values.requires_grad_()
    y = conv2d_sparse(x, values, idx, kh=3, kw=3, pad=1)
    dx, dv = torch.autograd.grad(y.sum(), (x, values))
    assert bool(torch.isfinite(dx).all()) and bool(torch.isfinite(dv).all())
    for call in (lambda: conv2d_fused_cuda(x, values, idx, kh=3, kw=3, pad=1),
                 lambda: conv2d_fused(x, values, idx, kh=3, kw=3, pad=1),
                 lambda: colwise_nm_matmul_cuda(
                     torch.ones(4, 72, device=dev), values, idx)):
        with pytest.raises(RuntimeError, match="forward only"):
            call()


# ---------------------------------------------------------------------------
# The training tier on the card: the SparseTrainer's kill -> resume, card
# tensors through checkpoints, AdamW, the LM Trainer's kernels
# ---------------------------------------------------------------------------


def _tensor_bits(t):
    t = t.detach().cpu().contiguous()
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else t.dtype)


def test_sparse_trainer_kill_and_resume_bitwise_on_card(dev, tmp_path):
    """resnet-tiny's SparseTrainer at batch 8 on the card: killed at the
    top of step 3 and restarted, it ends with the params and momentum of
    the uninterrupted run, bit for bit."""
    from repro_torch.train import SparseTrainConfig, SparseTrainer

    class Dies(SparseTrainer):
        def batch_at(self, step):
            if step == 3:
                raise KeyboardInterrupt("killed at step 3")
            return super().batch_at(step)

    dispatch.set_db(dispatch.ProfileDB(path=tmp_path / "profile.json"))
    try:
        def cfg(d):
            return SparseTrainConfig(steps=5, batch=8, ckpt_dir=str(d),
                                     ckpt_every=1)

        ta = SparseTrainer(cfg(tmp_path / "a"), device=dev)
        ta.run()
        tb = Dies(cfg(tmp_path / "b"), device=dev)
        with pytest.raises(KeyboardInterrupt):
            tb.run()
        tb.ckpt.wait()
        assert tb.ckpt.latest_step() == 3
        tc = SparseTrainer(cfg(tmp_path / "b"), device=dev)
        out = tc.run()
        assert out["start_step"] == 3 and out["final_step"] == 5
        assert tc.device.type == dev.type
        for a, c in zip(_leaves((ta.params, ta.mom)), _leaves((tc.params, tc.mom)),
                        strict=True):
            assert a.device.type == dev.type and c.device.type == dev.type
            assert torch.equal(_tensor_bits(a), _tensor_bits(c))
    finally:
        dispatch.set_db(None)


def test_checkpoint_of_card_tensors_round_trips(dev, tmp_path):
    """Card tensors of every dtype a checkpoint holds (bf16 among them)
    are written from their host copies and restored onto the card, bit
    for bit, also from an async save whose tensors change after it."""
    from repro_torch.train import CheckpointManager

    rng = np.random.default_rng(0)
    tree = {"w": torch.from_numpy(rng.standard_normal((64, 32), dtype=np.float32)),
            "h": torch.from_numpy(rng.standard_normal((8, 16), dtype=np.float32)
                                  ).to(torch.bfloat16),
            "idx": torch.arange(24, dtype=torch.int32).reshape(4, 6),
            "m": torch.zeros((4, 6), dtype=torch.int8),
            "mask": torch.from_numpy(rng.random(9) > 0.5),
            "step": torch.tensor(7, dtype=torch.int32)}
    want = {k: v.clone() for k, v in tree.items()}
    on_card = _to(tree, dev)
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"params": on_card}, blocking=False)
    on_card["w"].add_(1.0)
    on_card["h"].mul_(2)
    mgr.wait()
    protos = {"params": _to({k: torch.zeros_like(v) for k, v in tree.items()},
                            dev)}
    out, _ = mgr.restore(1, protos)
    for k, v in want.items():
        got = out["params"][k]
        assert got.device.type == dev.type and got.dtype == v.dtype, k
        assert torch.equal(_tensor_bits(got), _tensor_bits(v)), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_update_on_card_matches_cpu(dev, dtype):
    """Three AdamW steps on the card against the CPU on the same
    gradients: every float leaf of params and state within 1e-6 of its
    max (bf16 params within one bf16 step), integer leaves equal."""
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

    rng = np.random.default_rng(1)
    params = {"w": torch.from_numpy(rng.standard_normal((64, 48), dtype=np.float32)
                                    ).to(dtype),
              "b": [torch.from_numpy(rng.standard_normal(48, dtype=np.float32)
                                     ).to(dtype)],
              "idx": torch.arange(12, dtype=torch.int32)}
    cfg = AdamWConfig(lr=1e-2)
    runs = []
    for d in ("cpu", dev):
        p = _to(params, d)
        s = adamw_init(p)
        grng = np.random.default_rng(2)
        for _ in range(3):
            g = {"w": torch.from_numpy(grng.standard_normal((64, 48),
                                                            dtype=np.float32)),
                 "b": [torch.from_numpy(grng.standard_normal(48, dtype=np.float32))],
                 "idx": None}
            g["w"], g["b"][0] = g["w"].to(d, dtype), g["b"][0].to(d, dtype)
            p, s, norm = adamw_update(p, g, s, cfg)
        runs.append((_leaves((p, s)), float(norm)))
    (cpu_leaves, cpu_norm), (dev_leaves, dev_norm) = runs
    assert abs(dev_norm - cpu_norm) <= 1e-6 * cpu_norm
    for a, b in zip(dev_leaves, cpu_leaves, strict=True):
        a = a.cpu()
        if not b.is_floating_point():
            assert torch.equal(a, b)
        elif b.dtype == torch.bfloat16:
            assert bool(((a.float() - b.float()).abs()
                         <= 2.0 ** -7 * b.float().abs()).all())
        else:
            err = float((a - b).abs().max())
            assert err <= 1e-6 * max(float(b.abs().max()), 1e-30), err


def test_lm_trainer_runs_the_tiled_linear_and_no_flash(dev, tmp_path):
    """The smoke LM (widths multiples of 64, so every compressed linear
    takes the tiled kernel) trained 3 steps on the card: 7 tiled-linear
    launches a layer a step, no other kernel (flash has no gradient, so
    the trainer runs naive attention), losses within 1e-4 of the same
    steps on the CPU."""
    from repro_torch.configs import smoke_config
    from repro_torch.core.pruning import SparsityConfig
    from repro_torch.data import DataConfig
    from repro_torch.models.registry import init_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer

    cfg = smoke_config("smollm-360m").with_(
        n_kv_heads=4, d_ff=128, attn_impl="naive",
        sparsity=SparsityConfig(sparsity=0.5, min_dim=64,
                                format="compressed_xla"))
    params = init_params(cfg, 0, device="cpu")
    data = DataConfig(vocab_size=cfg.vocab_size, batch=4, seq_len=32, seed=0)
    tcfg = TrainConfig(steps=3, log_every=1)
    dispatch.set_db(dispatch.ProfileDB(path=tmp_path / "profile.json"))
    try:
        want = Trainer(cfg, data, AdamWConfig(), tcfg, params=params).run()
        reset_launch_counts()
        got = Trainer(cfg, data, AdamWConfig(), tcfg,
                      params=_to(params, dev)).run()
        torch.cuda.synchronize()
    finally:
        dispatch.set_db(None)
    counts = {k.name: k.launches for k in KERNELS if k.launches}
    assert counts == {"colwise_nm_matmul_tiled": 7 * cfg.n_layers * 3}, counts
    for g, w in zip(got["history"], want["history"], strict=True):
        assert abs(g["loss"] - w["loss"]) <= 1e-4 * abs(w["loss"])
        assert abs(g["grad_norm"] - w["grad_norm"]) <= 1e-4 * w["grad_norm"]
