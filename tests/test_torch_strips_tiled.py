"""The tiled strip GEMM's plain versions (``colwise_nm_matmul_strips_tiled_ref``
and ``colwise_nm_matmul_strips_pipelined_tiled_ref``, the walk of
``csrc/colwise_nm_strips_tiled.cu``) against the JAX package's strip GEMMs
in interpret mode, on the same numpy inputs: 1e-5 of max|y| in f32 and
2e-2 in bf16 (one bf16 rounding of the output, sums in another order).
Also the kernel's shape rule (``strips_tiled_takes``, what it takes and
refuses), its launch geometry and shared memory, and the dispatch
registry's shared-memory predicates, which size the kernel the rule picks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.colwise_nm.kernel import (
    colwise_nm_matmul_strips_pallas,
    colwise_nm_matmul_strips_pipelined_pallas,
)
from repro_torch import dispatch
from repro_torch.kernels._build import SMEM_BYTES
from repro_torch.kernels.colwise_nm import (
    STRIPS_TILED_CPT,
    colwise_nm_matmul_strips_pipelined_ref,
    colwise_nm_matmul_strips_pipelined_tiled_ref,
    colwise_nm_matmul_strips_ref,
    colwise_nm_matmul_strips_tiled_ref,
    pipelined_smem_bytes,
    strips_smem_bytes,
    strips_tiled_config,
    strips_tiled_geometry,
    strips_tiled_sm_threads,
    strips_tiled_smem_bytes,
    strips_tiled_takes,
)
from repro_torch.kernels.im2col_pack import im2col_pack_ref

# (C, B, H, W, k, stride, pad, V, n_tiles, k_kept, T): every case ends on a
# ragged strip; k_kept below, at and above one ring slice of 16 kept rows
CASES = [
    (4, 1, 7, 7, 3, 1, 1, 32, 2, 4, 8),      # 49 positions over 2 strips, k_kept 4
    (4, 3, 10, 10, 3, 1, 1, 128, 2, 16, 8),  # 300 over 3 strips, one whole slice
    (4, 2, 9, 9, 3, 1, 1, 128, 1, 20, 16),   # 162 over 2, ragged last slice, T 16
    (3, 4, 12, 12, 3, 1, 1, 256, 2, 13, 16),  # 576 over 3 strips of 256
    (4, 1, 12, 12, 3, 2, 1, 32, 3, 9, 8),    # stride 2: 36 over 2 strips
]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _case_id(case):
    c, b, h, w, k, s, p, v, n_tiles, k_kept, t = case
    return f"v{v}-kk{k_kept}-T{t}-s{s}"


def _assert_close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _problem(case, dtype, seed=0):
    """The same strips (im2col+pack of a numpy map), values and ascending
    kept rows for both packages."""
    c, b, h, w, k, stride, pad, v, n_tiles, k_kept, tile = case
    jd, td, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((c, b, h, w), dtype=np.float32))
    strips = im2col_pack_ref(x.to(td), k, k, stride, pad, v)
    values = rng.standard_normal((n_tiles, k_kept, tile)).astype(np.float32)
    idx = np.stack([np.sort(rng.choice(k * k * c, k_kept, replace=False))
                    for _ in range(n_tiles)]).astype(np.int32)
    jax_args = (jnp.asarray(strips.float().numpy(), jd), jnp.asarray(values, jd),
                jnp.asarray(idx))
    torch_args = (strips, torch.from_numpy(values).to(td), torch.from_numpy(idx))
    return jax_args, torch_args


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_tiled_plain_version_matches_pallas(case, dtype):
    (sj, vj, ij), (st, vt, it) = _problem(case, dtype)
    want = colwise_nm_matmul_strips_pallas(sj, vj, ij, interpret=True)
    got = colwise_nm_matmul_strips_tiled_ref(st, vt, it)
    assert got.dtype == st.dtype
    _assert_close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hb", [1, 2, 3, 100])  # 100 > n_strips: clamped
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_pipelined_tiled_plain_version_matches_pallas(case, hb, dtype):
    (sj, vj, ij), (st, vt, it) = _problem(case, dtype)
    want = colwise_nm_matmul_strips_pipelined_pallas(sj, vj, ij, hb=hb,
                                                     interpret=True)
    got = colwise_nm_matmul_strips_pipelined_tiled_ref(st, vt, it, hb=hb)
    assert got.dtype == st.dtype
    _assert_close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("hb,lanes", [(1, 1), (2, 1), (2, 2), (3, 1),
                                      (3, 2), (3, 3)])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_tiled_plain_versions_agree_with_the_other_plain_versions(case, hb,
                                                                  lanes):
    """Every block's walk, in any strip grouping and any number of strips
    side by side, is the strip GEMM's function: the tiled plain versions
    agree with the plain strip GEMM and the pipelined one (which re-covers
    a ragged last chunk)."""
    _, (st, vt, it) = _problem(case, "float32")
    want = colwise_nm_matmul_strips_ref(st, vt, it)
    _assert_close(colwise_nm_matmul_strips_pipelined_tiled_ref(
        st, vt, it, hb=hb, lanes=lanes), want.numpy(), 1e-5)
    _assert_close(colwise_nm_matmul_strips_pipelined_ref(st, vt, it, hb=hb),
                  want.numpy(), 1e-5)


def test_tiled_plain_version_bad_index_makes_exactly_its_tile_nan():
    _, (st, vt, it) = _problem(CASES[1], "float32")
    it = it.clone()
    it[1, 3] = st.shape[1]  # one past the last im2col row
    for got in (colwise_nm_matmul_strips_tiled_ref(st, vt, it),
                colwise_nm_matmul_strips_pipelined_tiled_ref(st, vt, it, hb=2)):
        assert bool(torch.isnan(got[8:]).all())
        assert bool(torch.isfinite(got[:8]).all())


# ---------------------------------------------------------------------------
# The shape rule and the launch geometry
# ---------------------------------------------------------------------------


def _strips(n_strips, k_rows, v, dtype=torch.float32, offset=0):
    flat = torch.zeros(n_strips * k_rows * v + offset, dtype=dtype)
    return flat[offset:].view(n_strips, k_rows, v)


def _values(n_tiles, k_kept, tile, dtype=torch.float32):
    return torch.zeros((n_tiles, k_kept, tile), dtype=dtype)


@pytest.mark.parametrize("hb", [1, 2])
def test_rule_takes_resnet_tiny_convs(hb):
    for n_strips, k_rows, k_kept in ((512, 72, 36), (512, 144, 72),
                                     (128, 144, 72), (128, 16, 8)):
        for dtype in (torch.float32, torch.bfloat16):
            st = _strips(n_strips, k_rows, 128, dtype)
            assert st.data_ptr() % 16 == 0
            assert strips_tiled_takes(st, _values(2, k_kept, 8, dtype), hb=hb)


def test_rule_refuses_what_the_kernel_does_not_take():
    vals = _values(2, 36, 8)
    # a misaligned view of aligned storage
    assert strips_tiled_takes(_strips(2, 72, 128), vals)
    assert not strips_tiled_takes(_strips(2, 72, 128, offset=1), vals)
    # rows that are not whole 16-byte copies: 6 f32, 4 bf16
    assert not strips_tiled_takes(_strips(2, 72, 6), vals)
    assert not strips_tiled_takes(_strips(2, 72, 4, torch.bfloat16),
                                  _values(2, 36, 8, torch.bfloat16))
    assert strips_tiled_takes(_strips(2, 72, 8, torch.bfloat16),
                              _values(2, 36, 8, torch.bfloat16))
    # the staged values past a block's shared memory
    big = _values(1, 4000, 16)
    assert strips_tiled_smem_bytes(4000, 16, 2, 128, 4) > SMEM_BYTES
    assert not strips_tiled_takes(_strips(1, 8000, 128), big)
    # not the layout: 2-D strips, an integer dtype
    assert not strips_tiled_takes(_strips(2, 72, 128)[0], vals)
    assert not strips_tiled_takes(_strips(2, 72, 128).int(), vals)


def test_geometry_threads_passes_and_shared_memory():
    # resnet-tiny's blocks[0]/conv2: 512 strips of 128, T 8, f32
    geo = strips_tiled_geometry(512, 128, 2, 72, 8, 4, 1)
    cpt, lanes = strips_tiled_config(512, 128, 2, 72, 8, 4, 1)
    assert (geo["cpt"], geo["lanes"], lanes) == (cpt, 1, 1)
    assert geo["rg"] == 1 and geo["threads"] == 128 // cpt
    assert geo["blocks"] == 512 * 2
    assert geo["smem"] == (72 * 8 + 2 * 16 * 128) * 4 + 4 * 72
    # hb strips a block: side by side as far as 256 threads go, each lane
    # its own ring rows
    geo = strips_tiled_geometry(128, 128, 2, 72, 8, 4, 2, cpt=2)
    assert geo["lanes"] == 2 and geo["threads"] == 128
    assert geo["blocks"] == 64 * 2
    assert geo["smem"] == (72 * 8 + 2 * 2 * 16 * 128) * 4 + 4 * 72
    assert strips_tiled_geometry(128, 128, 2, 72, 8, 4, 4, cpt=1)["lanes"] == 2
    assert strips_tiled_geometry(128, 128, 2, 72, 8, 4, 4, cpt=1,
                                 lanes=4) is None  # 512 threads
    assert strips_tiled_geometry(128, 128, 2, 72, 8, 4, 2, lanes=3) is None
    assert strips_tiled_geometry(1, 128, 2, 72, 8, 4, 2)["lanes"] == 1
    # T 40: five 8-row groups, all at once where threads allow ...
    geo = strips_tiled_geometry(4, 128, 1, 20, 40, 4, 1, cpt=4)
    assert geo["rg"] == 5 and geo["threads"] == 160
    # ... else in passes, the values padded to whole passes
    geo = strips_tiled_geometry(4, 256, 1, 20, 40, 4, 1, cpt=2)
    assert geo["threads"] == 256 and geo["rg"] == 2
    assert geo["smem"] == (20 * 48 + 2 * 16 * 256) * 4 + 4 * 20
    # every instance the kernel has, and none it has not
    for cpt in STRIPS_TILED_CPT:
        assert strips_tiled_geometry(8, 128, 2, 36, 8, 4, 2,
                                     cpt=cpt)["cpt"] == cpt
    for bad in (3, 8):
        assert strips_tiled_geometry(8, 128, 2, 36, 8, 4, 1, cpt=bad) is None
    # more than 256 threads for one 8-row group
    assert strips_tiled_geometry(8, 512, 2, 36, 8, 4, 1, cpt=1) is None
    assert strips_tiled_geometry(8, 1024, 2, 36, 8, 4, 1, cpt=2) is None
    assert strips_tiled_geometry(8, 1024, 2, 36, 8, 4, 1, cpt=4) is not None


@pytest.mark.parametrize("n_strips,n_tiles,k_kept,hb", [
    (512, 2, 72, 1), (128, 2, 72, 1), (128, 2, 72, 2), (128, 2, 8, 1),
    (196, 8, 288, 1), (13, 32, 1152, 1), (13, 32, 1152, 2), (4, 64, 2304, 1)])
def test_config_is_a_rule_of_the_shape(n_strips, n_tiles, k_kept, hb):
    """The most columns a thread that keep 224 threads resident on each
    SM, else 1; every strip of a block side by side."""
    for isz in (4, 2):
        args = (n_strips, 128, n_tiles, k_kept, 8, isz)
        cpt, lanes = strips_tiled_config(*args, hb)
        assert (cpt, lanes) == strips_tiled_config(*args, hb)
        assert lanes == min(hb, 256 // (128 // cpt))
        order = (4, 2, 1) if isz == 2 else (2, 1)
        resident = [strips_tiled_sm_threads(strips_tiled_geometry(
            *args, hb, cpt=c)) for c in order]
        first = next((c for c, r in zip(order, resident) if r >= 224), 1)
        assert cpt == first


def test_resident_threads_count_shared_memory_and_the_grid():
    # resnet-tiny's blocks[0]/conv2, f32: 1024 blocks of 64 threads, 7.76 a
    # SM of the 11 its shared memory holds
    geo = strips_tiled_geometry(512, 128, 2, 72, 8, 4, 1, cpt=2)
    assert strips_tiled_sm_threads(geo) == pytest.approx(1024 / 132 * 64)
    # ResNet-18 layer3, f32: 416 blocks, but 57.5 KB each leave room for 3
    geo = strips_tiled_geometry(13, 128, 32, 1152, 8, 4, 1, cpt=2)
    assert geo["smem"] + 1024 > 228 * 1024 // 4
    assert strips_tiled_sm_threads(geo) == 3 * 64
    assert strips_tiled_geometry(13, 128, 32, 1152, 8, 4, 1)["cpt"] == 1


# ---------------------------------------------------------------------------
# The registry sizes the strip GEMM the shape rule picks
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
def test_registry_sizes_the_strip_gemm_the_rule_picks(case):
    c, b, h, w, k, stride, pad, tile, dtype = case
    k_rows = k * k * c
    k_kept = k_rows // 2
    key = dispatch.conv_key(c, h, w, 16, k, k, stride, pad, k_kept, tile,
                            v=128, dtype=dtype, batch=b)
    x = torch.zeros((c, b, h, w), dtype=dtype)
    strips = im2col_pack_ref(x, k, k, stride, pad, 128)
    values = _values(2, k_kept, tile, dtype)
    assert strips_tiled_takes(strips, values)
    n_strips = strips.shape[0]
    isz = strips.element_size()
    spec = dispatch.REGISTRY.get("conv", "im2col_sparse_pallas")
    assert spec.smem_bytes(key) == strips_tiled_geometry(
        n_strips, 128, 2, k_kept, tile, isz, 1)["smem"]
    for geom in dispatch.registry.BANDED_CONV_GEOMETRY:
        g = dict(geom)
        spec = dispatch.REGISTRY.get(
            "conv", dispatch.registry.geometry_name(
                "two_kernel_pipelined", geom,
                dispatch.registry.BANDED_CONV_GEOMETRY[0]))
        strips = im2col_pack_ref(x, k, k, stride, pad, g["v"])
        assert strips_tiled_takes(strips, values, hb=g["hb"])
        assert spec.smem_bytes(key) == strips_tiled_geometry(
            strips.shape[0], g["v"], 2, k_kept, tile, isz, g["hb"])["smem"]
        assert spec.feasible(key)[0]


def test_registry_sizes_the_old_kernels_where_the_rule_refuses():
    # values of 4000 kept rows of a 64-row tile (1 MB in f32) fit no block
    key = dispatch.conv_key(500, 8, 8, 64, 3, 3, 1, 1, 4000, 64, v=128,
                            dtype=torch.float32, batch=2)
    assert strips_tiled_geometry(1, 128, 1, 4000, 64, 4, 1) is None
    spec = dispatch.REGISTRY.get("conv", "im2col_sparse_pallas")
    assert spec.smem_bytes(key) == strips_smem_bytes(64, 128)
    name = dispatch.registry.geometry_name(
        "two_kernel_pipelined", dispatch.registry.BANDED_CONV_GEOMETRY[3],
        dispatch.registry.BANDED_CONV_GEOMETRY[0])
    assert dispatch.REGISTRY.get("conv", name).smem_bytes(key) == \
        pipelined_smem_bytes(128, 64, 4)
