"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: where there is no CUDA card every test here skips.  On a
machine with one, from the repository root:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The shapes go past the main path's: tiles that are not a multiple of the
kernels' 8-row register block, ``block_k`` chunking, strips wider than a
block's 128 threads, ragged last strips and bands, and bf16; the sparse
linear kernel also runs at smollm-360m's MLP widths.  The banded conv and
the pipelined strip GEMM must give the same bits as the fused conv and the
plain strip GEMM.
"""
import numpy as np
import pytest
import torch

from repro_torch import dispatch
from repro_torch.kernels import KERNELS, reset_launch_counts
from repro_torch.kernels.colwise_nm import (
    COLWISE_NM_LINEAR,
    COLWISE_NM_STRIPS_PIPELINED,
    colwise_nm_matmul_cuda,
    colwise_nm_matmul_ref,
    colwise_nm_matmul_strips_cuda,
    colwise_nm_matmul_strips_pipelined_cuda,
    colwise_nm_matmul_strips_pipelined_ref,
    colwise_nm_matmul_strips_ref,
)
from repro_torch.kernels.conv_gemm import (
    CONV2D_FUSED_BANDED,
    conv2d_fused_banded_cuda,
    conv2d_fused_banded_ref,
    conv2d_fused_cuda,
    conv2d_fused_ref,
)
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


def test_out_of_range_index_gives_nan_not_a_bad_read(dev):
    x = _x(8, 1, 8, 8, torch.float32, dev)
    values, idx = _compressed(2, 72, 36, 8, torch.float32, dev)
    idx[1, 3] = 72  # one past the last im2col row
    strips = im2col_pack_ref(x, 3, 3, 1, 1, 128)
    outs = [conv2d_fused_cuda(x, values, idx, kh=3, kw=3, pad=1),
            conv2d_fused_banded_cuda(x, values, idx, kh=3, kw=3, pad=1),
            colwise_nm_matmul_strips_cuda(strips, values, idx),
            colwise_nm_matmul_strips_pipelined_cuda(strips, values, idx)]
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
    # pipelined: strips wider than 256 or not a 16-byte multiple
    with pytest.raises(ValueError, match="strip width"):
        colwise_nm_matmul_strips_pipelined_cuda(
            im2col_pack_ref(x, 3, 3, 1, 1, 384), values, idx)
    with pytest.raises(ValueError, match="strip width"):
        colwise_nm_matmul_strips_pipelined_cuda(
            im2col_pack_ref(x, 3, 3, 1, 1, 6), values, idx)
    # banded: odd bf16 rows; two f32 windows past 227 KB
    xb = _x(8, 1, 8, 7, torch.bfloat16, dev)
    with pytest.raises(ValueError, match="4 bytes"):
        conv2d_fused_banded_cuda(xb, values.to(torch.bfloat16), idx, kh=3,
                                 kw=3, pad=1)
    big = _x(16, 256, 16, 16, torch.float32, dev)
    v16, i16 = _compressed(2, 144, 72, 8, torch.float32, dev)
    with pytest.raises(ValueError, match="shared memory"):
        conv2d_fused_banded_cuda(big, v16, i16, kh=3, kw=3, stride=2, pad=1,
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
    colwise_nm_matmul_strips_cuda(strips, values, idx)
    conv2d_fused_cuda(x, values, idx, kh=3, kw=3, pad=1)
    conv2d_fused_cuda(x, values, idx, kh=3, kw=3, pad=1)
    colwise_nm_matmul_strips_pipelined_cuda(strips, values, idx)
    conv2d_fused_banded_cuda(x, values, idx, kh=3, kw=3, pad=1)
    colwise_nm_matmul_cuda(_x(1, 1, 4, 72, torch.float32, dev)[0, 0], values, idx)
    torch.cuda.synchronize()
    assert {k.name: k.launches for k in KERNELS} == {
        "conv2d_fused": 2, "im2col_pack": 1, "colwise_nm_matmul_strips": 1,
        "colwise_nm_matmul": 1, "colwise_nm_matmul_strips_pipelined": 1,
        "conv2d_fused_banded": 1}


@pytest.mark.parametrize("kernel,op,name,args", [
    (CONV2D_FUSED_BANDED, "conv", "fused_banded_pallas@v128_bk128_hb4",
     (16, 64, 8, 8, 3, 1, 1)),
    (CONV2D_FUSED_BANDED, "conv", "fused_banded_pallas@v128_bk64_hb1",
     (8, 4, 10, 10, 3, 1, 1)),
    (COLWISE_NM_STRIPS_PIPELINED, "conv", "two_kernel_pipelined@v256_bk128_hb2",
     (16, 8, 8, 8, 3, 1, 1)),
    (COLWISE_NM_LINEAR, "linear", "compressed_pallas@bb256_bk128", (96, 200)),
    (COLWISE_NM_LINEAR, "linear", "compressed_pallas@bb128_bk64", (2560, 960)),
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
                    "conv2d_fused": 5}
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
    layer runs the sparse linear kernel, whatever its tile width."""
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
                s.name for s in dispatch.REGISTRY.candidates(
                    "linear", param_keys=("values", "idx"),
                    device_type="cuda")}
        spec, source = dispatch.resolve(key, param_keys=("values", "idx"),
                                        device=dev)
        assert spec.backend == "cuda"
        assert source == ("db" if profiled else "heuristic")
        reset_launch_counts()
        y = linear_apply(layer, x)
        torch.cuda.synchronize()
        assert {k.name: k.launches for k in KERNELS if k.launches} == {
            "colwise_nm_matmul": 1}
        want = colwise_nm_matmul_ref(x.reshape(-1, 960), layer["values"],
                                     layer["idx"]).reshape(2, 128, d_out)
        _close(y, want, torch.float32)
    finally:
        dispatch.set_db(None)


def test_banded_window_too_short_gives_nan_not_a_neighbouring_row(
        dev, monkeypatch):
    """The band gather never clamps: where ``band_rows`` is short of what
    the geometry needs, the rows past the window contribute NaN."""
    from repro_torch.kernels.conv_gemm import kernel as conv_kernel

    x = _x(8, 2, 16, 16, torch.float32, dev)
    values, idx = _compressed(2, 72, 36, 8, torch.float32, dev)
    good = conv2d_fused_banded_cuda(x, values, idx, kh=3, kw=3, pad=1)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(good).all())
    plan = conv_kernel.band_plan
    monkeypatch.setattr(conv_kernel, "band_plan", lambda **kw: (
        plan(**kw)[0], plan(**kw)[1] - 2))
    short = conv2d_fused_banded_cuda(x, values, idx, kh=3, kw=3, pad=1)
    torch.cuda.synchronize()
    assert bool(torch.isnan(short).any())
    # every output is either NaN or exactly the full window's
    same = short == good
    assert bool((same | torch.isnan(short)).all())


def test_device_timer_times_a_kernel_launch(dev):
    x = _x(8, 2, 16, 16, torch.float32, dev)
    values, idx = _compressed(2, 72, 36, 8, torch.float32, dev)
    us = dispatch.device_time_us(
        lambda: conv2d_fused_cuda(x, values, idx, kh=3, kw=3, pad=1),
        device=dev)
    assert 0.0 < us < 1e4
