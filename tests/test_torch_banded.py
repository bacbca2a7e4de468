"""Parity of the port's band geometry and of the plain versions of its
banded-conv, pipelined strip-GEMM and sparse-linear kernels (what the
wrappers run on the CPU) with the JAX package's Pallas kernels in interpret
mode, on the same numpy inputs.  Band geometry and band-mode coordinates are
exact integers; the GEMMs match to 1e-5 of max|y| in f32 and 2e-2 in bf16
(one bf16 rounding of the output, sums in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparse_linear import forward_compressed_xla as j_forward_xla
from repro.kernels.colwise_nm.kernel import (
    colwise_nm_matmul_pallas,
    colwise_nm_matmul_strips_pipelined_pallas,
)
from repro.kernels.conv_gemm.kernel import _band_origin as j_band_origin
from repro.kernels.conv_gemm.kernel import band_plan as j_band_plan
from repro.kernels.conv_gemm.kernel import conv2d_fused_banded_pallas
from repro.kernels.conv_gemm.ops import banded_bytes_moved as j_banded_bytes_moved
from repro.kernels.im2col_pack.kernel import strip_tap_coords as j_strip_tap_coords
from repro_torch.core.sparse_linear import forward_compressed_xla
from repro_torch.kernels import colwise_nm as tcw
from repro_torch.kernels import conv_gemm as tcv
from repro_torch.kernels.conv_gemm.plan import _band_origin
from repro_torch.kernels.im2col_pack import im2col_pack_ref, out_size, strip_tap_coords

# (C, B, H, W, O, k, stride, pad, v, hb): the banded sweep of the JAX tests
BANDED_CASES = [
    (8, 2, 10, 10, 16, 3, 1, 1, 16, 1),   # halo crosses every band
    (8, 2, 10, 10, 16, 3, 1, 1, 16, 2),
    (8, 1, 12, 12, 16, 3, 2, 1, 16, 2),   # stride>1 band origins
    (5, 2, 9, 7, 8, 3, 1, 0, 8, 2),       # no pad, non-square
    (3, 1, 7, 7, 8, 3, 2, 1, 128, 2),     # single ragged strip
    (6, 2, 11, 11, 8, 3, 1, 1, 32, 4),    # ragged final band, deep
    (4, 3, 8, 8, 16, 1, 2, 0, 32, 2),     # 1x1 strided, batch 3
]
# (b, h, w, k, stride, pad, v, hb): the band-coverage sweep of the JAX tests
PLAN_CASES = [(2, 10, 10, 3, 1, 1, 16, 1), (1, 12, 12, 3, 2, 1, 16, 3),
              (3, 8, 8, 1, 2, 0, 32, 2), (2, 11, 11, 3, 1, 1, 32, 4)]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def _assert_close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _compressed(n_tiles, k_rows, k_kept, tile, dtype, seed=1):
    """The same (values, idx) for both packages: ascending kept rows per
    tile, as the packed format has them."""
    jd, td, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    values = rng.standard_normal((n_tiles, k_kept, tile)).astype(np.float32)
    idx = np.stack([np.sort(rng.choice(k_rows, k_kept, replace=False))
                    for _ in range(n_tiles)]).astype(np.int32)
    return ((jnp.asarray(values, jd), jnp.asarray(idx)),
            (torch.from_numpy(values).to(td), torch.from_numpy(idx)))


def _map(c, b, h, w, dtype, seed=0):
    jd, td, _ = DTYPES[dtype]
    x = np.random.default_rng(seed).standard_normal((c, b, h, w)).astype(np.float32)
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _geo(b, h, w, k, stride, pad):
    return dict(b=b, h=h, kh=k, stride=stride, pad=pad,
                ho=out_size(h, k, stride, pad), wo=out_size(w, k, stride, pad))


@pytest.mark.parametrize("b,h,w,k,stride,pad,v,hb", PLAN_CASES + [
    (bb, hh, ww, kk, ss, pp, vv, hh_b)
    for (_c, bb, hh, ww, _o, kk, ss, pp, vv, hh_b) in BANDED_CASES])
def test_band_plan_and_origin_exact(b, h, w, k, stride, pad, v, hb):
    geo = _geo(b, h, w, k, stride, pad)
    n_bands, rows = tcv.band_plan(v=v, hb=hb, **geo)
    assert (n_bands, rows) == j_band_plan(v=v, hb=hb, **geo)
    n_strips = -(-b * geo["ho"] * geo["wo"] // v)
    hb_eff = max(min(hb, n_strips), 1)
    og = dict(hb=hb_eff, v=v, h=h, ho=geo["ho"], wo=geo["wo"], pad=pad,
              stride=stride, bh=b * h, band_rows=rows)
    want = [int(j_band_origin(jnp.int32(g), **og)) for g in range(n_bands)]
    assert [_band_origin(g, **og) for g in range(n_bands)] == want
    as_tensor = _band_origin(torch.arange(n_bands), **og)
    assert as_tensor.tolist() == want
    moved = dict(c=5, b=b, h=h, w=w, kh=k, stride=stride, pad=pad,
                 ho=geo["ho"], wo=geo["wo"], v=v, hb=hb, o=16, itemsize=4)
    assert tcv.banded_bytes_moved(**moved) == j_banded_bytes_moved(**moved)


@pytest.mark.parametrize("c,b,h,w,o,k,stride,pad,v,hb", BANDED_CASES[:4])
def test_band_mode_strip_tap_coords_exact(c, b, h, w, o, k, stride, pad, v, hb):
    geo = _geo(b, h, w, k, stride, pad)
    n_bands, rows = tcv.band_plan(v=v, hb=hb, **geo)
    ikh = np.repeat(np.arange(k), k)[:, None].astype(np.int32)
    ikw = np.tile(np.arange(k), k)[:, None].astype(np.int32)
    cg = dict(stride=stride, pad=pad, b=b, h=h, w=w, ho=geo["ho"],
              wo=geo["wo"], band_rows=rows)
    for s in range(n_bands * hb):
        org = _band_origin(s // hb, hb=hb, v=v, h=h, ho=geo["ho"],
                           wo=geo["wo"], pad=pad, stride=stride, bh=b * h,
                           band_rows=rows)
        got = strip_tap_coords(s, v=v, ikh=torch.from_numpy(ikh),
                               ikw=torch.from_numpy(ikw), band_origin=org, **cg)
        want = j_strip_tap_coords(s, v=v, ikh=jnp.asarray(ikh),
                                  ikw=jnp.asarray(ikw), band_origin=org, **cg)
        assert len(got) == len(want) == 3
        for a, e in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(e))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,b,h,w,o,k,stride,pad,v,hb", BANDED_CASES)
def test_banded_conv_matches_pallas(c, b, h, w, o, k, stride, pad, v, hb,
                                    dtype):
    xj, xt = _map(c, b, h, w, dtype)
    (vj, ij), (vt, it) = _compressed(o // 8, k * k * c, (k * k * c + 1) // 2,
                                     8, dtype)
    geo = dict(kh=k, kw=k, stride=stride, pad=pad, v=v)
    want = conv2d_fused_banded_pallas(xj, vj, ij, hb=hb, interpret=True, **geo)
    got = tcv.conv2d_fused_banded_ref(xt, vt, it, hb=hb, **geo)
    assert got.dtype == xt.dtype
    _assert_close(got, want, DTYPES[dtype][2])
    # the band windows change nothing: the whole-map fused plain version
    # computes the same function
    _assert_close(got, tcv.conv2d_fused_ref(xt, vt, it, **geo),
                  DTYPES[dtype][2])


def test_banded_block_k_chunking_matches_pallas():
    xj, xt = _map(8, 1, 9, 9, "float32")
    (vj, ij), (vt, it) = _compressed(2, 72, 36, 8, "float32")
    geo = dict(kh=3, kw=3, stride=1, pad=1, v=16)
    want = conv2d_fused_banded_pallas(xj, vj, ij, block_k=8, hb=2,
                                      interpret=True, **geo)
    got = tcv.conv2d_fused_banded(xt, vt, it, block_k=8, hb=2, **geo)
    ho = out_size(9, 3, 1, 1)
    _assert_close(got.reshape(16, -1), np.asarray(want)[:, : ho * ho], 1e-5)


@pytest.mark.parametrize("hb", [1, 2, 3, 100])  # 100 > n_strips: clamped
def test_pipelined_strips_matches_pallas(hb):
    xj, xt = _map(4, 2, 8, 8, "float32")
    (vj, ij), (vt, it) = _compressed(2, 36, 18, 8, "float32")
    strips = im2col_pack_ref(xt, 3, 3, 1, 1, 16)  # [S, K, V]
    want = colwise_nm_matmul_strips_pipelined_pallas(
        jnp.asarray(strips.numpy()), vj, ij, hb=hb, interpret=True)
    got = tcw.colwise_nm_matmul_strips_pipelined(strips, vt, it, hb=hb)
    _assert_close(got, want, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pipelined_ragged_final_chunk_recover_changes_nothing(dtype):
    """n_strips odd with hb=2: the last chunk re-covers the tail of the one
    before; the result equals the plain strip GEMM's exactly, and the JAX
    kernel's within the tolerance."""
    _, xt = _map(5, 1, 10, 10, dtype)
    (vj, ij), (vt, it) = _compressed(1, 45, 23, 8, dtype)
    strips = im2col_pack_ref(xt, 3, 3, 1, 1, 16)
    assert strips.shape[0] % 2 == 1
    got = tcw.colwise_nm_matmul_strips_pipelined_ref(strips, vt, it, hb=2)
    assert torch.equal(got, tcw.colwise_nm_matmul_strips_ref(strips, vt, it))
    sj = jnp.asarray(strips.float().numpy(), DTYPES[dtype][0])
    want = colwise_nm_matmul_strips_pipelined_pallas(sj, vj, ij, hb=2,
                                                     interpret=True)
    _assert_close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,d_in,d_out,keep,tile,bb,bk", [
    (16, 64, 32, 0.5, 8, 8, 8),
    (8, 128, 128, 0.5, 32, 8, 16),
    (33, 96, 48, 0.25, 16, 16, 8),    # ragged batch
    (4, 256, 64, 0.75, 64, 128, 128),  # blocks > dims
    (64, 64, 64, 0.5, 64, 32, 24),    # k not a multiple of bk
    (5, 48, 96, 0.5, 96, 8, 8),       # tile == d_out
])
def test_linear_matches_pallas(b, d_in, d_out, keep, tile, bb, bk, dtype):
    jd, td, tol = DTYPES[dtype]
    x = np.random.default_rng(7).standard_normal((b, d_in)).astype(np.float32)
    (vj, ij), (vt, it) = _compressed(d_out // tile, d_in, int(d_in * keep),
                                     tile, dtype, seed=b + d_in)
    want = colwise_nm_matmul_pallas(jnp.asarray(x, jd), vj, ij, block_b=bb,
                                    block_k=bk, interpret=True)
    xt = torch.from_numpy(x).to(td)
    got = tcw.colwise_nm_matmul(xt, vt, it, block_b=bb, block_k=bk)
    assert got.dtype == td and tuple(got.shape) == (b, d_out)
    _assert_close(got, want, tol)
    _assert_close(forward_compressed_xla(xt, vt, it),
                  j_forward_xla(jnp.asarray(x, jd), vj, ij), tol)


def test_linear_leading_dims():
    x = np.random.default_rng(1).standard_normal((2, 3, 64)).astype(np.float32)
    (_, _), (vt, it) = _compressed(4, 64, 32, 8, "float32")
    got = tcw.colwise_nm_matmul(torch.from_numpy(x), vt, it)
    want = tcw.colwise_nm_matmul_ref(torch.from_numpy(x).reshape(6, 64), vt, it)
    _assert_close(got.reshape(6, 32), want, 1e-6)
