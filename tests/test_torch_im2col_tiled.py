"""The tiled pack's plain version (``im2col_pack_tiled_ref``, the walk of
``csrc/im2col_pack_tiled.cu``) against the JAX package's im2col + pack in
interpret mode, on the same numpy inputs, bit for bit (an exact copy) under
every channel block the instance rule can pick.  Also the kernel's index
walk (one decode a thread, then a step a position, then the block's tap),
replayed in Python against ``tap_coords``; its shape rule
(``im2col_tiled_takes``), launch geometry and instance rule
(``im2col_tiled_config``) at resnet-tiny's five pruned convs and ResNet-18's
layer1-4 3x3 convs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.im2col_pack.kernel import im2col_pack_pallas
from repro_torch.kernels.colwise_nm.kernel import H100_SMS
from repro_torch.kernels.im2col_pack import (
    IM2COL_TILED_CBS,
    IM2COL_TILED_TGS,
    IM2COL_TILED_THREADS,
    IM2COL_TILED_UNROLLS,
    im2col_pack_ref,
    im2col_pack_tiled_ref,
    im2col_tiled_config,
    im2col_tiled_geometry,
    im2col_tiled_takes,
    out_size,
    tap_coords,
)

# (C, B, H, W, k, stride, pad, v): tests/test_torch_kernels.py's CONV_CASES,
# then channels that no channel block divides, strips of 256, a pad-0
# non-square map whose positions wrap rows and batches inside one thread's
# eight (bf16) positions, and an even kernel
CASES = [
    (8, 2, 8, 8, 3, 1, 1, 128),
    (16, 1, 10, 10, 3, 1, 1, 128),
    (16, 2, 9, 9, 3, 2, 1, 64),
    (16, 2, 12, 12, 1, 2, 0, 64),
    (8, 1, 11, 9, 3, 1, 0, 32),
    (5, 2, 11, 7, 3, 1, 0, 256),    # C 5: a ragged channel block at any cb
    (12, 3, 6, 6, 3, 1, 1, 128),    # C 12: 8 + 4 at cb 8
    (24, 2, 7, 7, 3, 2, 1, 256),    # C 24: 16 + 8 at cb 16, v 256, stride 2
    (4, 3, 5, 3, 3, 1, 0, 32),      # 3x1 outputs: rows and batches wrap
    (4, 1, 6, 6, 2, 1, 1, 32),      # even kernel
]
DTYPES = {"float32": (jnp.float32, torch.float32, np.int32, torch.int32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, np.int16, torch.int16)}
# resnet-tiny's pruned convs at batch 256 (configs/resnet_tiny.py), then
# ResNet-18's layer1-4 3x3 convs at batch 8: (name, C, B, H, W, k, stride, pad)
MAIN_CONVS = [
    ("blocks[0]/conv1", 8, 256, 16, 16, 3, 1, 1),
    ("blocks[0]/conv2", 16, 256, 16, 16, 3, 1, 1),
    ("blocks[1]/conv1", 16, 256, 16, 16, 3, 2, 1),
    ("blocks[1]/conv2", 16, 256, 8, 8, 3, 1, 1),
    ("blocks[1]/proj", 16, 256, 16, 16, 1, 2, 0),
    ("resnet18/layer1", 64, 8, 56, 56, 3, 1, 1),
    ("resnet18/layer2", 128, 8, 28, 28, 3, 1, 1),
    ("resnet18/layer3", 256, 8, 14, 14, 3, 1, 1),
    ("resnet18/layer4", 512, 8, 7, 7, 3, 1, 1),
]


def _case_id(case):
    c, b, h, w, k, s, p, v = case
    return f"C{c}B{b}-{h}x{w}-k{k}s{s}p{p}-v{v}"


def _bits(dtype, seed=0, *, shape):
    """A map's element bits for both packages: standard normal values, in
    bf16 rounded by torch."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    _, td, npi, ti = DTYPES[dtype]
    return x.to(td).view(ti).numpy().astype(npi)


def _pallas(bits, dtype, k, stride, pad, v):
    jd, _, npi, _ = DTYPES[dtype]
    out = im2col_pack_pallas(jnp.asarray(bits).view(jd), k, k, stride=stride,
                             pad=pad, v=v, interpret=True)
    return np.asarray(out).view(npi)


def _tiled(bits, dtype, k, stride, pad, v, cb, tg):
    _, td, _, ti = DTYPES[dtype]
    x = torch.from_numpy(bits.copy()).view(td)
    got = im2col_pack_tiled_ref(x, k, k, stride, pad, v, cb, tg)
    assert got.dtype == td and got.is_contiguous()
    return got.view(ti).numpy()


def _pickable(c, k):
    """The (channel block, taps a block) pairs the shape rule has an
    instance for: every pair the instance rule can pick."""
    return [(cb, tg) for cb in IM2COL_TILED_CBS for tg in IM2COL_TILED_TGS
            if im2col_tiled_geometry(c, 1, 9, 9, k, k, 1, 1, 128, 4, cb=cb,
                                     tg=tg, unroll=1) is not None]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_tiled_plain_version_is_the_pallas_bits(case, dtype):
    c, b, h, w, k, stride, pad, v = case
    bits = _bits(dtype, shape=(c, b, h, w))
    want = _pallas(bits, dtype, k, stride, pad, v)
    n_pos = b * out_size(h, k, stride, pad) * out_size(w, k, stride, pad)
    for cb, tg in _pickable(c, k):
        got = _tiled(bits, dtype, k, stride, pad, v, cb, tg)
        np.testing.assert_array_equal(got, want)
        tail = got.transpose(1, 0, 2).reshape(got.shape[1], -1)[:, n_pos:]
        assert not tail.any()  # past the last position: +0 bits


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", [CASES[0], CASES[2], CASES[3], CASES[5]],
                         ids=_case_id)
def test_nan_payloads_and_negative_zero_move_as_bits(case, dtype):
    """A map of NaNs with payloads (quiet and signalling, both signs) and
    -0.0: the tiled walk moves each element's bits, as the two-pass plain
    version does.  JAX's f32 copy keeps them too; its bf16 copy widens to
    f32 on the CPU and gives back the canonical NaN, so there the NaNs are
    held by position against JAX and by bits against the plain version."""
    c, b, h, w, k, stride, pad, v = case
    bits = _bits(dtype, seed=3, shape=(c, b, h, w))
    flat = bits.reshape(-1)
    specials = ([0x7FC01234, 0x7F800001, -0x3FE0000, -0x80000000]
                if dtype == "float32" else [0x7FC3, 0x7F81, -0x7E, -0x8000])
    for i, s in enumerate(specials):  # -0x7E: 0xFF82, -0x8000: -0.0
        flat[i::7] = s
    want = _pallas(bits, dtype, k, stride, pad, v)
    _, td, _, ti = DTYPES[dtype]
    plain = im2col_pack_ref(torch.from_numpy(bits.copy()).view(td), k, k,
                            stride, pad, v).view(ti).numpy()
    nan = torch.from_numpy(plain.copy()).view(td).isnan().numpy()
    assert nan.any() and (plain == specials[-1]).any()
    for cb, tg in _pickable(c, k):
        got = _tiled(bits, dtype, k, stride, pad, v, cb, tg)
        np.testing.assert_array_equal(got, plain)
        if dtype == "float32":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_array_equal(got[~nan], want[~nan])
            assert torch.from_numpy(want.copy()).view(td).isnan().numpy()[
                nan].all()


def _kernel_offsets(s, tap, v, ept, *, c, b, h, w, kh, kw, stride, pad):
    """The plane offsets (-1 off the map or past the end) each thread of
    block (s, tap, *) keeps, walked as ``csrc/im2col_pack_tiled.cu`` walks
    them: ``decode_position`` of the thread's first position, then
    ``next_position`` for the others, each shifted by ``tap_shift``."""
    ho, wo = out_size(h, kh, stride, pad), out_size(w, kw, stride, pad)
    ikh, ikw = divmod(tap, kw)
    out = []
    for lane in range(v // ept):
        p = s * v + lane * ept
        bb, rem = divmod(p, ho * wo)
        oh, ow = divmod(rem, wo)
        ih0, iw0 = oh * stride - pad, ow * stride - pad
        for _ in range(ept):
            ih, iw = ih0 + ikh, iw0 + ikw
            ok = 0 <= ih < h and 0 <= iw < w and bb < b
            out.append((bb * h + ih) * w + iw if ok else -1)
            iw0 += stride  # next_position
            if iw0 > (wo - 1) * stride - pad:
                iw0 = -pad
                ih0 += stride
                if ih0 > (ho - 1) * stride - pad:
                    ih0 = -pad
                    bb += 1
    return out


@pytest.mark.parametrize("ept", [4, 8])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_the_kernels_position_walk_is_tap_coords(case, ept):
    """One decode a thread, then one step a position: the same coordinates
    and validity as ``tap_coords`` at every position of every strip and
    tap, the ragged last strip included."""
    c, b, h, w, k, stride, pad, v = case
    ho, wo = out_size(h, k, stride, pad), out_size(w, k, stride, pad)
    n_strips = -(-b * ho * wo // v)
    geo = dict(c=c, b=b, h=h, w=w, kh=k, kw=k, stride=stride, pad=pad)
    for s in range(n_strips):
        p = s * v + torch.arange(v)
        for tap in range(k * k):
            valid, bc, ihc, iwc = tap_coords(
                p, ikh=tap // k, ikw=tap % k, stride=stride, pad=pad, b=b,
                h=h, w=w, ho=ho, wo=wo)
            want = torch.where(valid, (bc * h + ihc) * w + iwc, -1)
            assert _kernel_offsets(s, tap, v, ept, **geo) == want.tolist()


def _meta(c, b, h, w, dtype=torch.float32):
    return torch.empty((c, b, h, w), dtype=dtype, device="meta")


@pytest.mark.parametrize("v", [128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("conv", MAIN_CONVS, ids=lambda conv: conv[0])
def test_the_rule_takes_every_main_path_strip(conv, dtype, v):
    """The tiled pack takes resnet-tiny's and ResNet-18's strips at the
    conv families' widths; the rule's instance fills the H100's SMs, each
    of a block's threads one 16-byte segment of a strip row."""
    _, c, b, h, w, k, stride, pad = conv
    x = _meta(c, b, h, w, dtype)
    assert im2col_tiled_takes(x, k, k, stride, pad, v)
    isz = x.element_size()
    cb, tg, unroll = im2col_tiled_config(c, b, h, w, k, k, stride, pad, v, isz)
    assert cb in IM2COL_TILED_CBS and tg in IM2COL_TILED_TGS
    assert unroll in IM2COL_TILED_UNROLLS
    geo = im2col_tiled_geometry(c, b, h, w, k, k, stride, pad, v, isz)
    lanes = v * isz // 16
    assert geo["threads"] == lanes * geo["rp"] <= IM2COL_TILED_THREADS
    assert geo["rp"] == min(IM2COL_TILED_THREADS // lanes, cb)
    n_strips = -(-b * out_size(h, k, stride, pad) * out_size(w, k, stride, pad)
                 // v)
    assert geo["n_strips"] == n_strips
    assert (geo["blocks"] == n_strips * -(-k * k // tg) * -(-c // cb)
            >= H100_SMS)
    assert (geo["cb"], geo["tg"], geo["unroll"]) == (cb, tg, unroll)


@pytest.mark.parametrize("c,v,dtype,takes", [
    (16, 6, torch.float32, False),     # not whole 16-byte rows
    (16, 36, torch.bfloat16, False),   # 72 bytes a row
    (16, 36, torch.float32, True),     # 144 bytes a row
    (16, 1024, torch.float32, True),   # 256 threads a row
    (16, 1028, torch.float32, False),  # 257
    (16, 2048, torch.bfloat16, True),
    (1, 128, torch.float32, True),     # one channel: the smallest block
])
def test_the_shape_rule(c, v, dtype, takes):
    x = _meta(c, 2, 9, 9, dtype)
    assert im2col_tiled_takes(x, 3, 3, 1, 1, v) is takes
    assert (im2col_tiled_config(c, 2, 9, 9, 3, 3, 1, 1, v, x.element_size())
            is not None) is takes
    assert not im2col_tiled_takes(x[0], 3, 3, 1, 1, v)  # 3-D
    assert not im2col_tiled_takes(x.to(torch.float16), 3, 3, 1, 1, v)


def test_instances_outside_the_rule_are_refused():
    kw = dict(c=16, b=2, h=9, w=9, kh=3, kw=3, stride=1, pad=1, v=128,
              itemsize=4)
    assert im2col_tiled_geometry(**kw, cb=16, tg=1, unroll=1) is not None
    assert im2col_tiled_geometry(**kw, cb=32, tg=1, unroll=1) is None  # > C
    assert im2col_tiled_geometry(**kw, cb=12, tg=1, unroll=1) is None
    assert im2col_tiled_geometry(**kw, cb=16, tg=2, unroll=1) is None
    assert im2col_tiled_geometry(**kw, cb=16, tg=1, unroll=3) is None
    geo = im2col_tiled_geometry(**kw, cb=16, tg=9, unroll=1)
    assert geo["blocks"] == 2  # one a strip: 162 positions
    # 32 lanes x 8 rows at once: 16 channels are 2 rows a thread a tap
    assert im2col_tiled_geometry(**kw, cb=16, tg=3, unroll=2)["rp"] == 8
    assert im2col_tiled_geometry(**kw, cb=16, tg=1, unroll=4) is None
    assert im2col_tiled_geometry(**kw, cb=4, tg=1, unroll=2) is None  # 1 row
    geo = im2col_tiled_geometry(**{**kw, "itemsize": 2}, cb=16, tg=1,
                                unroll=1)
    assert (geo["rp"], geo["threads"]) == (16, 256)  # 16 lanes a row
    one = dict(kw, kh=1, kw=1, pad=0)  # a 1x1 conv: one tap a block only
    assert im2col_tiled_geometry(**one, cb=16, tg=1, unroll=1) is not None
    assert im2col_tiled_geometry(**one, cb=16, tg=3, unroll=1) is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("conv", MAIN_CONVS, ids=lambda conv: conv[0])
def test_the_rule_picks_the_nearest_rows_a_thread_that_fill_the_card(conv,
                                                                    dtype):
    """Among the instances that give a block to each of the H100's SMs, no
    other has its threads write nearer to the rule's rows a thread; the
    unroll is the deepest the thread's rows a tap use."""
    from repro_torch.kernels.im2col_pack import (IM2COL_TILED_BLOCKS,
                                                 IM2COL_TILED_ROWS)

    _, c, b, h, w, k, stride, pad = conv
    isz = torch.empty((), dtype=dtype).element_size()
    args = (c, b, h, w, k, k, stride, pad, 128, isz)
    geo = im2col_tiled_geometry(*args)
    assert geo["blocks"] >= IM2COL_TILED_BLOCKS
    want = IM2COL_TILED_ROWS[isz]
    for cb in IM2COL_TILED_CBS:
        for tg in IM2COL_TILED_TGS:
            other = im2col_tiled_geometry(*args, cb=cb, tg=tg, unroll=1)
            if other is not None and other["blocks"] >= IM2COL_TILED_BLOCKS:
                assert abs(other["rows"] - want) >= abs(geo["rows"] - want)
    deeper = [u for u in IM2COL_TILED_UNROLLS if u > geo["unroll"]
              and im2col_tiled_geometry(*args, cb=geo["cb"], tg=geo["tg"],
                                        unroll=u) is not None]
    assert not deeper
