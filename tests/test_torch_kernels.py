"""Parity of the PyTorch port's kernel plain versions (what the wrappers run
on the CPU) with the JAX package's Pallas kernels in interpret mode, on the
same numpy inputs.  Index math and im2col+pack are exact; the sparse GEMMs
match to 1e-5 in f32 and 2e-2 in bf16 (relative to max|y|: one bf16
rounding of the output, sums in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pruning as jp
from repro.kernels.colwise_nm.kernel import (colwise_nm_matmul_pallas,
                                           colwise_nm_matmul_strips_pallas)
from repro.kernels.conv_gemm import ops as jconv
from repro.kernels.conv_gemm.kernel import conv2d_fused_pallas
from repro.kernels.conv_gemm.ref import conv2d_cnhw_ref as j_conv_ref
from repro.kernels.im2col_pack.kernel import im2col_pack_pallas
from repro.kernels.im2col_pack.kernel import tap_coords as j_tap_coords
from repro_torch.core import pruning as tp
from repro_torch.kernels import colwise_nm as tcw
from repro_torch.kernels import conv_gemm as tcv
from repro_torch.kernels import im2col_pack as tip

# (C, B, H, W, k, stride, pad, v): 1x1 and 3x3, stride 1 and 2, pad 0 and 1;
# k_kept at 50% is 36 (C=8, 3x3), 72 (C=16, 3x3) or 8 (C=16, 1x1); every
# case but the first ends on a ragged strip
CONV_CASES = [
    (8, 2, 8, 8, 3, 1, 1, 128),    # 128 positions: one whole strip
    (16, 1, 10, 10, 3, 1, 1, 128),  # 100 positions: ragged single strip
    (16, 2, 9, 9, 3, 2, 1, 64),    # 50 positions, stride 2
    (16, 2, 12, 12, 1, 2, 0, 64),  # 1x1 strided projection, 72 positions
    (8, 1, 11, 9, 3, 1, 0, 32),    # pad 0, ragged 63 positions over 2 strips
]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def _problem(c, b, h, w, k, dtype, seed=0):
    """CNHW map and the compressed OHWI weight of a 16-channel conv."""
    jd, td, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((c, b, h, w)).astype(np.float32)
    wt = rng.standard_normal((16, k, k, c)).astype(np.float32)
    cfg = dict(sparsity=0.5, m=None, tile=8, format="compressed_pallas")
    vt, it, meta = tcv.compress_conv_weights(torch.from_numpy(wt),
                                             tp.SparsityConfig(**cfg))
    vj, ij, _ = jconv.compress_conv_weights(jnp.asarray(wt),
                                            jp.SparsityConfig(**cfg))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    return ((jnp.asarray(x, jd), vj.astype(jd), ij),
            (torch.from_numpy(x).to(td), vt.to(td), it), meta)


def _assert_close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("b,h,w,kh,kw,stride,pad", [
    (2, 8, 8, 3, 3, 1, 1), (1, 10, 7, 3, 3, 2, 1), (2, 6, 6, 1, 1, 2, 0),
    (1, 5, 9, 3, 2, 1, 0),
])
def test_tap_coords_exact(b, h, w, kh, kw, stride, pad):
    ho, wo = tip.out_size(h, kh, stride, pad), tip.out_size(w, kw, stride, pad)
    n = -(-b * ho * wo // 16) * 16 + 16  # past the end too
    p = np.arange(n, dtype=np.int32)[None, :]
    ikh = np.repeat(np.arange(kh), kw)[:, None].astype(np.int32)
    ikw = np.tile(np.arange(kw), kh)[:, None].astype(np.int32)
    geo = dict(stride=stride, pad=pad, b=b, h=h, w=w, ho=ho, wo=wo)
    jout = j_tap_coords(jnp.asarray(p), ikh=jnp.asarray(ikh),
                        ikw=jnp.asarray(ikw), **geo)
    tout = tip.tap_coords(torch.from_numpy(p), ikh=torch.from_numpy(ikh),
                          ikw=torch.from_numpy(ikw), **geo)
    for a, e in zip(tout, jout):
        np.testing.assert_array_equal(a.numpy(), np.asarray(e))
    for s in range(n // 16):
        sv = tip.strip_tap_coords(s, v=16, ikh=1 % kh, ikw=0, **geo)
        np.testing.assert_array_equal(sv[0].numpy(),
                                      tout[0][kw * (1 % kh)][s * 16:(s + 1) * 16].numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,b,h,w,k,stride,pad,v", CONV_CASES)
def test_im2col_pack_exact(c, b, h, w, k, stride, pad, v, dtype):
    (xj, _, _), (xt, _, _), _ = _problem(c, b, h, w, k, dtype)
    want = im2col_pack_pallas(xj, k, k, stride=stride, pad=pad, v=v,
                              interpret=True)
    got = tip.im2col_pack(xt, kh=k, kw=k, stride=stride, pad=pad, v=v)
    assert got.dtype == xt.dtype and got.is_contiguous()
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,b,h,w,k,stride,pad,v", CONV_CASES)
def test_strips_gemm_matches_pallas(c, b, h, w, k, stride, pad, v, dtype):
    (xj, vj, ij), (xt, vt, it), meta = _problem(c, b, h, w, k, dtype, seed=1)
    strips = tip.im2col_pack_ref(xt, k, k, stride, pad, v)
    sj = jnp.asarray(strips.float().numpy(), DTYPES[dtype][0])
    want = colwise_nm_matmul_strips_pallas(sj, vj, ij, interpret=True)
    got = tcw.colwise_nm_matmul_strips(strips, vt, it)
    assert got.dtype == xt.dtype and tuple(got.shape) == (16, strips.shape[0] * v)
    _assert_close(got, want, DTYPES[dtype][2])
    # the decompress-then-matmul oracle agrees too
    xmat = strips.float().permute(0, 2, 1).reshape(-1, strips.shape[1])
    oracle = tcw.colwise_nm_matmul_ref(xmat, vt.float(), it).T
    _assert_close(got, oracle, DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,b,h,w,k,stride,pad,v", CONV_CASES)
def test_conv2d_fused_matches_pallas(c, b, h, w, k, stride, pad, v, dtype):
    (xj, vj, ij), (xt, vt, it), meta = _problem(c, b, h, w, k, dtype, seed=2)
    want = conv2d_fused_pallas(xj, vj, ij, kh=k, kw=k, stride=stride, pad=pad,
                               v=v, interpret=True)
    got = tcv.conv2d_fused_ref(xt, vt, it, kh=k, kw=k, stride=stride, pad=pad,
                               v=v)
    assert got.dtype == xt.dtype
    _assert_close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("c,b,h,w,k,stride,pad,v", CONV_CASES)
def test_conv_plans_match_library_conv(c, b, h, w, k, stride, pad, v):
    """Both plans' CNHW output equals the library conv on the masked dense
    weight, in the port and in the JAX package's lax reference."""
    (xj, _, _), (xt, vt, it), meta = _problem(c, b, h, w, k, "float32", seed=3)
    from repro_torch.core.formats import unpack_colwise

    w_ohwi = unpack_colwise(vt, it, meta).T.reshape(16, k, k, c).contiguous()
    want_t = tcv.conv2d_cnhw_ref(xt, w_ohwi, stride=stride, pad=pad)
    want_j = j_conv_ref(xj, jnp.asarray(w_ohwi.numpy()), stride=stride, pad=pad)
    _assert_close(want_t, want_j, 1e-5)
    geo = dict(kh=k, kw=k, stride=stride, pad=pad, v=v)
    for impl in (None, "fused_sparse_pallas", "im2col_sparse_pallas"):
        got = tcv.conv2d_sparse(xt, vt, it, impl=impl, **geo)
        assert got.is_contiguous()
        _assert_close(got, want_t, 1e-5)
    _assert_close(tcv.conv2d_two_kernel(xt, vt, it, **geo), want_t, 1e-5)


# (rows, d_in, n_tiles, k_kept, T): the tiled linear's tile widths, more than
# one tile, a ragged last step of kept rows (37, 70), rows under and over
# one block
TILED_CASES = [(5, 96, 1, 48, 64), (17, 96, 4, 37, 64), (3, 200, 2, 70, 128),
               (40, 64, 3, 32, 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d_in,n_tiles,k_kept,tile", TILED_CASES)
def test_tiled_linear_matches_pallas(rows, d_in, n_tiles, k_kept, tile, dtype):
    """The tiled linear's wrapper on the CPU (its plain version) against the
    JAX package's linear kernel in interpret mode, with leading dims."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(rows + d_in + tile)
    x = rng.standard_normal((rows, d_in)).astype(np.float32)
    values = rng.standard_normal((n_tiles, k_kept, tile)).astype(np.float32)
    idx = np.stack([np.sort(rng.choice(d_in, k_kept, replace=False))
                    for _ in range(n_tiles)]).astype(np.int32)
    want = colwise_nm_matmul_pallas(jnp.asarray(x, jdt), jnp.asarray(values, jdt),
                                    jnp.asarray(idx), interpret=True)
    xt = torch.from_numpy(x).to(tdt)
    got = tcw.colwise_nm_matmul_tiled(xt.reshape(1, rows, d_in),
                                      torch.from_numpy(values).to(tdt),
                                      torch.from_numpy(idx))
    assert got.dtype == tdt and tuple(got.shape) == (1, rows, n_tiles * tile)
    _assert_close(got[0], want, tol)
