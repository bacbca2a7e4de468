"""Parity of the PyTorch port's pruning and compressed formats with the JAX
package: the same numpy inputs through both, masks / idx / values
bit-exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jf
from repro.core import pruning as jp
from repro.kernels.conv_gemm import ops as jconv
from repro_torch.core import formats as tf
from repro_torch.core import pruning as tp
from repro_torch.kernels.conv_gemm import ops as tconv


# jitted once per shape: one XLA program instead of one per primitive
_j_mask = jax.jit(jp.colwise_nm_mask, static_argnums=(1, 2, 3))
_j_conv_mask = jax.jit(jp.conv_colwise_nm_mask, static_argnums=(1, 2, 3))
_j_pack = jax.jit(jf.pack_colwise, static_argnums=(2,))
_j_unpack = jax.jit(jf.unpack_colwise, static_argnums=(2,))
_j_init_compressed = jax.jit(jf.init_compressed, static_argnums=(1, 2, 3))
_j_compress_conv = jax.jit(
    lambda w, cfg: jconv.compress_conv_weights(w, cfg)[:2], static_argnums=1)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _weights(shape, seed, integer=False):
    rng = np.random.default_rng(seed)
    if integer:  # integer-valued weights: exact L1 sums, so real ties
        return rng.integers(-3, 4, size=shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


MASK_CASES = [
    # (d_in, d_out, sparsity, m, tile, integer-valued)
    (64, 32, 0.5, 16, 8, False),
    (128, 64, 0.75, None, 16, False),
    (72, 16, 0.5, None, 8, False),
    (96, 24, 0.25, 6, 8, False),   # m=6 at 0.25: N = round(4.5) = 4
    (60, 12, 0.3, 10, 5, False),   # tile and group chosen as divisors
    (64, 32, 0.5, 4, 1, False),    # row-wise (tile 1)
    (64, 32, 0.5, 8, 8, True),
    (48, 16, 0.75, None, 4, True),
    (36, 10, 0.5, 6, 7, True),     # requested tile 7 -> divisor 5
]


@pytest.mark.parametrize("integer", [False, True])
def test_conv_mask_bit_exact(integer):
    w = _weights((16, 3, 3, 8), 7, integer)  # OHWI
    mj = _j_conv_mask(jnp.asarray(w), 0.5, None, 8)
    mt = tp.conv_colwise_nm_mask(torch.from_numpy(w), 0.5, tile=8)
    np.testing.assert_array_equal(_np(mt), np.asarray(mj))


def test_rowwise_mask_bit_exact():
    w = _weights((64, 32), 3, integer=True)
    np.testing.assert_array_equal(
        _np(tp.rowwise_nm_mask(torch.from_numpy(w), 0.5, m=4)),
        np.asarray(jp.rowwise_nm_mask(jnp.asarray(w), 0.5, m=4)))


def test_shape_helpers_match():
    for d in (1, 6, 12, 16, 72, 96, 100, 144):
        for req in (None, 1, 5, 7, 8, 16, 200):
            assert tp.choose_tile(d, req) == jp.choose_tile(d, req)
            assert tp.choose_group(d, req) == jp.choose_group(d, req)
    for m in range(1, 20):
        for s in (0.0, 0.1, 0.25, 0.3, 0.5, 0.75, 0.9, 0.99):
            assert tp.kept_per_group(m, s) == jp.kept_per_group(m, s), (m, s)
    # Python's round is half-to-even: 6 * 0.75 = 4.5 -> 4, 10 * 0.25 = 2.5 -> 2
    assert tp.kept_per_group(6, 0.25) == 4
    assert tp.kept_per_group(10, 0.75) == 2
    for d_in, d_out in ((72, 16), (144, 16), (16, 16), (27, 8)):
        for cfg in (jp.SparsityConfig(sparsity=0.5, tile=8),
                    jp.SparsityConfig(sparsity=0.25, m=6, tile=5)):
            tcfg = tp.SparsityConfig(sparsity=cfg.sparsity, m=cfg.m,
                                     tile=cfg.tile)
            assert tp.resolve_dims(d_in, d_out, tcfg) == \
                jp.resolve_dims(d_in, d_out, cfg)
            assert tuple(tf.meta_for(d_in, d_out, tcfg)) == \
                tuple(jf.meta_for(d_in, d_out, cfg))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_indices_from_keep_bit_exact(seed):
    rng = np.random.default_rng(seed)
    n_tiles, d_in, k = 4, 40, 13
    keep = np.zeros((n_tiles, d_in), bool)
    for t in range(n_tiles):
        keep[t, rng.choice(d_in, k, replace=False)] = True
    it = tf.indices_from_keep(torch.from_numpy(keep), k)
    ij = jf.indices_from_keep(jnp.asarray(keep), k)
    assert it.dtype == torch.int32 and it.is_contiguous()
    np.testing.assert_array_equal(_np(it), np.asarray(ij))


@pytest.mark.parametrize("d_in,d_out,sparsity,m,tile,integer", MASK_CASES)
def test_mask_pack_unpack_bit_exact(d_in, d_out, sparsity, m, tile, integer):
    w = _weights((d_in, d_out), d_in * d_out, integer)
    jcfg = jp.SparsityConfig(sparsity=sparsity, m=m, tile=tile)
    tcfg = tp.SparsityConfig(sparsity=sparsity, m=m, tile=tile)
    jmeta, tmeta = jf.meta_for(d_in, d_out, jcfg), tf.meta_for(d_in, d_out, tcfg)
    assert tuple(tmeta) == tuple(jmeta)
    mj = _j_mask(jnp.asarray(w), sparsity, m, tile)
    mt = tp.colwise_nm_mask(torch.from_numpy(w), sparsity, m=m, tile=tile)
    assert mt.dtype == torch.bool
    np.testing.assert_array_equal(_np(mt), np.asarray(mj))
    vj, ij = _j_pack(jnp.asarray(w), mj, jmeta)
    vt, it = tf.pack_colwise(torch.from_numpy(w), mt, tmeta)
    assert it.dtype == torch.int32 and it.is_contiguous()
    np.testing.assert_array_equal(_np(it), np.asarray(ij))
    np.testing.assert_array_equal(_np(vt), np.asarray(vj))
    np.testing.assert_array_equal(_np(tf.unpack_colwise(vt, it, tmeta)),
                                  np.asarray(_j_unpack(vj, ij, jmeta)))


@pytest.mark.parametrize("d_in,d_out,sparsity,m,tile", [
    (72, 16, 0.5, None, 8), (144, 16, 0.5, None, 8), (16, 16, 0.5, None, 8),
    (60, 12, 0.3, 7, 5),
])
def test_init_compressed_strided_support(d_in, d_out, sparsity, m, tile):
    jcfg = jp.SparsityConfig(sparsity=sparsity, m=m, tile=tile,
                             format="compressed_pallas")
    tcfg = tp.SparsityConfig(sparsity=sparsity, m=m, tile=tile,
                             format="compressed_pallas")
    vj, ij = _j_init_compressed(jax.random.PRNGKey(0), d_in, d_out, jcfg)
    vt, it = tf.init_compressed(torch.Generator().manual_seed(0), d_in, d_out,
                                tcfg, device="cpu")
    assert it.dtype == torch.int32 and it.is_contiguous()
    np.testing.assert_array_equal(_np(it), np.asarray(ij))
    assert tuple(vt.shape) == tuple(vj.shape) and vt.dtype == torch.float32


@pytest.mark.parametrize("o,kh,c,integer", [(16, 3, 8, False), (16, 1, 16, False),
                                            (24, 3, 4, True)])
def test_compress_conv_weights_bit_exact(o, kh, c, integer):
    w = _weights((o, kh, kh, c), o * kh * c, integer)
    cfg = dict(sparsity=0.5, m=None, tile=8, format="compressed_pallas")
    vj, ij = _j_compress_conv(jnp.asarray(w), jp.SparsityConfig(**cfg))
    vt, it, mt = tconv.compress_conv_weights(torch.from_numpy(w),
                                             tp.SparsityConfig(**cfg))
    assert tuple(mt) == (kh * kh * c, o, 8, kh * kh * c, kh * kh * c // 2)
    np.testing.assert_array_equal(_np(it), np.asarray(ij))
    np.testing.assert_array_equal(_np(vt), np.asarray(vj))
