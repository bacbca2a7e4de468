"""The tiled fused conv's plain version (``conv2d_fused_tiled_ref``, the walk
of ``csrc/conv2d_fused_tiled.cu``) against the JAX package's fused conv in
interpret mode, on the same numpy inputs: 1e-5 of max|y| in f32 and 2e-2 in
bf16 (one bf16 rounding of the output, sums in another order).  It gives
the bits of the fused conv's plain version (``conv2d_fused_ref``), with a
tile whose ``idx`` is not ascending too, and a bad index makes exactly its
tile NaN.  Also the kernel's shape rule (``fused_tiled_takes``, what it
takes and refuses), its launch geometry and shared memory, its instance
rule, and the dispatch registry's shared-memory predicate, which sizes the
fused kernel the rule picks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv_gemm.kernel import conv2d_fused_pallas
from repro_torch import dispatch
from repro_torch.kernels._build import SMEM_BYTES
from repro_torch.kernels.conv_gemm import (
    FUSED_TILED_CPT,
    FUSED_TILED_BKS,
    conv2d_fused_ref,
    conv2d_fused_tiled_ref,
    fused_smem_bytes,
    fused_tiled_config,
    fused_tiled_geometry,
    fused_tiled_sm_threads,
    fused_tiled_smem_bytes,
    fused_tiled_takes,
)
from repro_torch.kernels.im2col_pack import out_size

# (C, B, H, W, k, stride, pad, V, n_tiles, k_kept, T): every case ends on a
# ragged strip; k_kept below, at and above one slice's 16 dense rows
CASES = [
    (4, 1, 7, 7, 3, 1, 1, 128, 2, 10, 8),    # 49 positions, k_kept 10
    (4, 3, 10, 10, 3, 1, 1, 128, 2, 16, 8),  # 300 over 3 strips, k_kept 16
    (4, 2, 9, 9, 3, 1, 1, 128, 1, 20, 16),   # 162 over 2 strips, T 16
    (3, 4, 12, 12, 3, 1, 1, 256, 2, 13, 16),  # 576 over 3 strips of 256
    (4, 1, 12, 12, 3, 2, 1, 128, 3, 9, 8),   # stride 2: 36 positions
    (5, 2, 9, 7, 3, 1, 0, 128, 2, 30, 8),    # pad 0, non-square, 3 slices
    (16, 2, 8, 8, 1, 2, 0, 128, 2, 8, 8),    # the 1x1 strided projection
]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _case_id(case):
    c, b, h, w, k, s, p, v, n_tiles, k_kept, t = case
    return f"k{k}s{s}p{p}-v{v}-kk{k_kept}-T{t}"


def _assert_close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _problem(case, dtype, seed=0):
    """The same map, values and ascending kept rows for both packages."""
    c, b, h, w, k, stride, pad, v, n_tiles, k_kept, tile = case
    jd, td, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((c, b, h, w), dtype=np.float32)
    values = rng.standard_normal((n_tiles, k_kept, tile)).astype(np.float32)
    idx = np.stack([np.sort(rng.choice(k * k * c, k_kept, replace=False))
                    for _ in range(n_tiles)]).astype(np.int32)
    jax_args = (jnp.asarray(x, jd), jnp.asarray(values, jd), jnp.asarray(idx))
    torch_args = (torch.from_numpy(x).to(td), torch.from_numpy(values).to(td),
                  torch.from_numpy(idx))
    return jax_args, torch_args, dict(kh=k, kw=k, stride=stride, pad=pad, v=v)


def _n_pos(case):
    c, b, h, w, k, stride, pad = case[:7]
    return b * out_size(h, k, stride, pad) * out_size(w, k, stride, pad)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_tiled_plain_version_matches_pallas(case, dtype):
    (xj, vj, ij), (xt, vt, it), geo = _problem(case, dtype)
    want = conv2d_fused_pallas(xj, vj, ij, interpret=True, **geo)
    got = conv2d_fused_tiled_ref(xt, vt, it, **geo)
    assert got.dtype == xt.dtype
    _assert_close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_tiled_plain_version_gives_the_fused_plain_versions_bits(case, dtype):
    """Each kept row taken from its dense slice is the row the fused plain
    version gathers from the map, so the same einsum gives the same bits;
    past the last position both hold 0."""
    _, (xt, vt, it), geo = _problem(case, dtype)
    want = conv2d_fused_ref(xt, vt, it, **geo)
    for bk in FUSED_TILED_BKS:
        got = conv2d_fused_tiled_ref(xt, vt, it, bk=bk, **geo)
        assert torch.equal(got, want)
        assert bool((got[:, _n_pos(case):] == 0).all())


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_a_tile_that_is_not_ascending_takes_its_rows_in_k_order(case):
    """A tile whose kept rows are permuted (the kernel's one-by-one walk)
    still gives the fused plain version's bits: the walk is in k order."""
    _, (xt, vt, it), geo = _problem(case, "float32")
    it = it.clone()
    it[-1] = it[-1].flip(0)  # descending: every tile but the last ascends
    got = conv2d_fused_tiled_ref(xt, vt, it, **geo)
    assert torch.equal(got, conv2d_fused_ref(xt, vt, it, **geo))


@pytest.mark.parametrize("bad", [-1, "K"])
def test_a_bad_index_makes_exactly_its_tile_nan(bad):
    case = CASES[1]
    _, (xt, vt, it), geo = _problem(case, "float32")
    k_rows = case[4] ** 2 * case[0]
    it = it.clone()
    it[1, 3] = k_rows if bad == "K" else bad
    got = conv2d_fused_tiled_ref(xt, vt, it, **geo)
    n_pos, tile = _n_pos(case), case[-1]
    assert bool(torch.isnan(got[tile:, :n_pos]).all())
    assert bool((got[tile:, n_pos:] == 0).all())  # past the end: 0, not NaN
    assert torch.equal(got[:tile], conv2d_fused_ref(xt, vt, it, **geo)[:tile])


# ---------------------------------------------------------------------------
# The shape rule, the launch geometry and the instance rule
# ---------------------------------------------------------------------------

# (name, C, B, H, W, k, stride, pad, O): resnet-tiny's five pruned convs at
# batch 256, then ResNet-18's layer1-4 3x3 convs at batch 8
CONVS = [("blocks[0]/conv1", 8, 256, 16, 16, 3, 1, 1, 16),
         ("blocks[0]/conv2", 16, 256, 16, 16, 3, 1, 1, 16),
         ("blocks[1]/conv1", 16, 256, 16, 16, 3, 2, 1, 16),
         ("blocks[1]/conv2", 16, 256, 8, 8, 3, 1, 1, 16),
         ("blocks[1]/proj", 16, 256, 16, 16, 1, 2, 0, 16),
         ("resnet18/layer1", 64, 8, 56, 56, 3, 1, 1, 64),
         ("resnet18/layer2", 128, 8, 28, 28, 3, 1, 1, 128),
         ("resnet18/layer3", 256, 8, 14, 14, 3, 1, 1, 256),
         ("resnet18/layer4", 512, 8, 7, 7, 3, 1, 1, 512)]


def _x(c, b, h, w, dtype=torch.float32):
    # zero strides: the rule reads only the shape, never the map's elements
    return torch.zeros((1,), dtype=dtype).expand(c, b, h, w)


def _values(n_tiles, k_kept, tile, dtype=torch.float32, offset=0):
    flat = torch.zeros(n_tiles * k_kept * tile + offset, dtype=dtype)
    return flat[offset:].view(n_tiles, k_kept, tile)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("conv", CONVS, ids=[c[0] for c in CONVS])
def test_rule_takes_the_main_path_and_resnet18(conv, dtype):
    _, c, b, h, w, k, stride, pad, o = conv
    k_kept = k * k * c // 2
    values = _values(o // 8, k_kept, 8, dtype)
    assert values.data_ptr() % 16 == 0
    for v in (128, 256):
        assert fused_tiled_takes(_x(c, b, h, w, dtype), values, kh=k, kw=k,
                                 stride=stride, pad=pad, v=v)


def test_rule_refuses_what_the_kernel_does_not_take():
    x = _x(8, 2, 8, 8)
    geo = dict(kh=3, kw=3, stride=1, pad=1)
    assert fused_tiled_takes(x, _values(2, 36, 8), **geo)
    # tiles that are not a multiple of 8 rows
    for tile in (3, 12):
        assert not fused_tiled_takes(x, _values(2, 36, tile), **geo)
    # a misaligned view of aligned values (a kept row's values are copied
    # by 16 bytes)
    assert not fused_tiled_takes(x, _values(2, 36, 8, offset=1), **geo)
    # a tile whose 8-row groups pass one block's 256 threads: 2560 rows is
    # also past conv2d_fused.cu's shared memory
    assert fused_tiled_takes(x, _values(1, 36, 64), **geo)
    assert not fused_tiled_takes(x, _values(1, 36, 72), **geo)
    assert not fused_tiled_takes(x, _values(1, 36, 2560), **geo)
    assert fused_smem_bytes(2560, 36) > SMEM_BYTES
    # strips that are not a multiple of 32 positions
    assert not fused_tiled_takes(x, _values(2, 36, 8), v=48, **geo)
    assert fused_tiled_takes(x, _values(2, 36, 8), v=32, **geo)
    # not the layout: a 3-D map, an integer map, an empty output
    assert not fused_tiled_takes(x[0], _values(2, 36, 8), **geo)
    assert not fused_tiled_takes(x.int(), _values(2, 36, 8), **geo)
    assert not fused_tiled_takes(_x(8, 2, 2, 2), _values(2, 36, 8), kh=3,
                                 kw=3)
    # the row table past a block's shared memory: 8 bytes a dense row
    assert fused_tiled_geometry(3500, 1, 4, 4, 3, 3, 1, 1, 128, 1, 10, 8,
                                4) is None
    # a map of 2**31 elements
    assert fused_tiled_geometry(2 ** 11, 2 ** 10, 2 ** 5, 2 ** 5, 1, 1, 1, 0,
                                128, 1, 8, 8, 4) is None


def test_geometry_threads_blocks_and_shared_memory():
    # resnet-tiny's blocks[0]/conv2 in f32 at cpt 4, both tiles a block and
    # 32-row slices: 2 warps over 128 positions, 512 runs
    geo = fused_tiled_geometry(16, 256, 16, 16, 3, 3, 1, 1, 128, 2, 72, 8, 4,
                               cpt=4, group=2, bk=32)
    assert (geo["cpt"], geo["group"], geo["bk"]) == (4, 2, 32)
    assert geo["threads"] == 64
    assert geo["blocks"] == geo["live_blocks"] == 65536 // 128
    assert geo["n_strips"] == 512 and (geo["ho"], geo["wo"]) == (16, 16)
    # ring (map slices, 2 warps' values), 144 rows, indices, bounds of 5
    # slices, flags
    assert geo["smem"] == (2 * 32 * (128 + 2 * 8) * 4 + 8 * 144
                           + 4 * (2 * 2 * 32 + 2 * 6 + 2))
    assert geo["smem"] == fused_tiled_smem_bytes(144, 4, 2, 8, 32, 4)
    # ResNet-18 layer4 at batch 8: 392 positions in 4 strips of 128; the
    # runs wholly past the end only write zeros
    geo = fused_tiled_geometry(512, 8, 7, 7, 3, 3, 1, 1, 128, 64, 2304, 8, 4,
                               cpt=2, group=8, bk=16)
    assert geo["threads"] == 256 and geo["blocks"] == 8 * 8
    assert geo["live_blocks"] == 7 * 8
    # T 16: two warps a tile
    geo = fused_tiled_geometry(8, 2, 8, 8, 3, 3, 1, 1, 128, 4, 36, 16, 2,
                               cpt=1, group=4, bk=16)
    assert geo["threads"] == 256 and geo["blocks"] == 4 * 1
    assert fused_tiled_geometry(8, 2, 8, 8, 3, 3, 1, 1, 128, 4, 36, 16, 2,
                                cpt=1, group=8, bk=16) is None  # 512 threads
    # instances it does not have: cpt, group (3 > 2 tiles), slice height
    for cpt, group, bk in ((3, 1, 16), (8, 1, 16), (1, 0, 16), (1, 3, 16),
                           (1, 1, 8), (1, 1, 256)):
        assert fused_tiled_geometry(8, 2, 8, 8, 3, 3, 1, 1, 128, 2, 36, 8, 4,
                                    cpt=cpt, group=group, bk=bk) is None
    # threads neither a multiple nor a divisor of the block's positions
    assert fused_tiled_geometry(8, 2, 8, 8, 3, 3, 1, 1, 128, 3, 36, 8, 4,
                                cpt=2, group=3, bk=16) is None
    assert fused_tiled_geometry(8, 2, 8, 8, 3, 3, 1, 1, 128, 3, 36, 8, 4,
                                cpt=1, group=3, bk=16) is not None
    # bf16 carries the next slice in registers, at most 16 map elements a
    # thread: threads * 16 >= positions * bk
    for cpt, group, bk, takes in ((4, 2, 16, False), (2, 2, 16, True),
                                  (2, 2, 32, False), (1, 2, 32, True)):
        geo = fused_tiled_geometry(8, 2, 8, 8, 3, 3, 1, 1, 128, 2, 36, 8, 2,
                                   cpt=cpt, group=group, bk=bk)
        assert (geo is not None) == takes, (cpt, group, bk)
    assert fused_tiled_geometry(8, 2, 8, 8, 3, 3, 1, 1, 128, 2, 36, 8, 4,
                                cpt=4, group=2, bk=32) is not None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("conv", CONVS, ids=[c[0] for c in CONVS])
def test_config_is_a_rule_of_the_shape(conv, dtype):
    """The most tiles a block, then the most cpt, then the tallest slice
    (no taller than K) that keep FUSED_TILED_SM_THREADS threads resident on
    each SM, else the first in that order that keeps the most; the geometry
    takes it by default."""
    from repro_torch.kernels.conv_gemm.kernel import FUSED_TILED_SM_THREADS

    _, c, b, h, w, k, stride, pad, o = conv
    isz = 4 if dtype == torch.float32 else 2
    args = (c, b, h, w, k, k, stride, pad, 128, o // 8, k * k * c // 2, 8,
            isz)
    pick = fused_tiled_config(*args)
    assert pick == fused_tiled_config(*args)
    geo = fused_tiled_geometry(*args)
    assert (geo["cpt"], geo["group"], geo["bk"]) == pick
    group = min(o // 8, 8)
    order = [(cp, group, bk) for cp in FUSED_TILED_CPT[::-1]
             for bk in FUSED_TILED_BKS[::-1] if bk <= max(16, k * k * c)]
    resident = {}
    for cp, g, bk in order:
        inst = fused_tiled_geometry(*args, cpt=cp, group=g, bk=bk)
        if inst is not None:
            resident[(cp, g, bk)] = fused_tiled_sm_threads(inst)
    enough = [i for i in order if resident.get(i, 0) >= FUSED_TILED_SM_THREADS]
    most = max(resident.values())
    want = enough[0] if enough else next(i for i in order
                                         if resident.get(i) == most)
    assert pick == want


# the rule's picks at the swept convs, (cpt, group, bk) in f32 and bf16:
# the sweep's best instance or within 1.05x of it, but for layer2 in f32
# (1.16x) and layer1 in bf16 (1.06x), where the rule, which counts no
# registers, expects more blocks an SM than fit (PERF.md)
RULE_PICKS = {"blocks[0]/conv1": ((2, 2, 32), (2, 2, 16)),
              "blocks[0]/conv2": ((2, 2, 32), (2, 2, 16)),
              "blocks[1]/conv1": ((1, 2, 128), (1, 2, 32)),
              "blocks[1]/conv2": ((1, 2, 128), (1, 2, 32)),
              "blocks[1]/proj": ((1, 2, 16), (1, 2, 16)),
              "resnet18/layer1": ((2, 8, 64), (2, 8, 64)),
              "resnet18/layer2": ((1, 8, 64), (1, 8, 128)),
              "resnet18/layer3": ((1, 8, 64), (1, 8, 128)),
              "resnet18/layer4": ((1, 8, 128), (1, 8, 128))}


@pytest.mark.parametrize("conv", CONVS, ids=[c[0] for c in CONVS])
def test_config_picks_at_the_swept_convs(conv):
    name, c, b, h, w, k, stride, pad, o = conv
    picks = tuple(fused_tiled_config(c, b, h, w, k, k, stride, pad, 128,
                                     o // 8, k * k * c // 2, 8, isz)
                  for isz in (4, 2))
    assert picks == RULE_PICKS[name]


def test_resident_threads_count_live_blocks_and_shared_memory():
    # ResNet-18 layer4, f32, 8 tiles a block: 56 live blocks of 256 threads
    geo = fused_tiled_geometry(512, 8, 7, 7, 3, 3, 1, 1, 128, 64, 2304, 8, 4,
                               cpt=2, group=8, bk=16)
    assert fused_tiled_sm_threads(geo) == pytest.approx(56 / 132 * 256)
    # resnet-tiny blocks[0]/conv2: 1024 blocks of 64 threads over 132 SMs,
    # fewer than an SM's shared memory, threads and block slots hold
    geo = fused_tiled_geometry(16, 256, 16, 16, 3, 3, 1, 1, 128, 2, 72, 8, 4,
                               cpt=2, group=2, bk=16)
    assert fused_tiled_sm_threads(geo) == pytest.approx(1024 / 132 * 64)
    # ResNet-18 layer4 at cpt 4 and 32-row slices: 90.6 KB a block (a 36.9
    # KB row table, a 49 KB ring), so 2 blocks fit an SM
    geo = fused_tiled_geometry(512, 8, 7, 7, 3, 3, 1, 1, 128, 64, 2304, 8, 4,
                               cpt=4, group=8, bk=32)
    assert geo["smem"] == 2 * 32 * (128 + 64) * 4 + 8 * 4608 + 4 * (
        2 * 8 * 32 + 8 * 145 + 8)
    assert 228 * 1024 // (geo["smem"] + 1024) == 2


# ---------------------------------------------------------------------------
# The registry sizes the fused kernel the shape rule picks
# ---------------------------------------------------------------------------

# (C, B, H, W, k, stride, pad, tile, dtype)
KEY_CASES = [
    (16, 256, 16, 16, 3, 1, 1, 8, torch.float32),   # resnet-tiny blocks[0]/conv2
    (16, 256, 8, 8, 3, 1, 1, 8, torch.bfloat16),    # blocks[1]/conv2, bf16
    (16, 256, 16, 16, 1, 2, 0, 8, torch.float32),   # the projection
    (256, 8, 14, 14, 3, 1, 1, 8, torch.float32),    # ResNet-18 layer3
    (512, 8, 7, 7, 3, 1, 1, 8, torch.bfloat16),     # ResNet-18 layer4
]


@pytest.mark.parametrize("case", KEY_CASES)
def test_registry_sizes_the_fused_kernel_the_rule_picks(case):
    c, b, h, w, k, stride, pad, tile, dtype = case
    k_kept = k * k * c // 2
    isz = 4 if dtype == torch.float32 else 2
    key = dispatch.conv_key(c, h, w, 16, k, k, stride, pad, k_kept, tile,
                            v=128, dtype=dtype, batch=b)
    values = _values(2, k_kept, tile, dtype)
    for geom in dispatch.registry.FUSED_CONV_GEOMETRY:
        g = dict(geom)
        spec = dispatch.REGISTRY.get("conv", dispatch.registry.geometry_name(
            "fused_sparse_pallas", geom,
            dispatch.registry.FUSED_CONV_GEOMETRY[0]))
        assert fused_tiled_takes(_x(c, b, h, w, dtype), values, kh=k, kw=k,
                                 stride=stride, pad=pad, v=g["v"])
        assert spec.smem_bytes(key) == fused_tiled_geometry(
            c, b, h, w, k, k, stride, pad, g["v"], 2, k_kept, tile,
            isz)["smem"]
        assert spec.feasible(key)[0]


@pytest.mark.parametrize("tile", [12, 3])
def test_registry_sizes_the_old_kernel_where_the_rule_refuses(tile):
    key = dispatch.conv_key(8, 10, 10, 2 * tile, 3, 3, 1, 1, 36, tile,
                            dtype=torch.float32, batch=2)
    assert fused_tiled_geometry(8, 2, 10, 10, 3, 3, 1, 1, 128, 2, 36, tile,
                                4) is None
    for geom in dispatch.registry.FUSED_CONV_GEOMETRY:
        spec = dispatch.REGISTRY.get("conv", dispatch.registry.geometry_name(
            "fused_sparse_pallas", geom,
            dispatch.registry.FUSED_CONV_GEOMETRY[0]))
        assert spec.smem_bytes(key) == fused_smem_bytes(
            tile, min(dict(geom)["bk"], 36))
        assert spec.feasible(key)[0]
