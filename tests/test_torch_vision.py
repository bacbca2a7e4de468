"""The port's slice as a whole against the JAX package: resnet-tiny logits
from the same (converted) params and images, under both conv plans, and
the masked -> compressed tree conversion."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro import dispatch
from repro.configs import get_vision_config as j_get_config
from repro.core.sparse_conv import compress_conv_tree as j_compress_conv_tree
from repro.core.sparse_linear import unbox_tree
from repro.dispatch import ProfileDB
from repro.models import vision as jv
from repro_torch.configs import get_vision_config
from repro_torch.convert import params_from_jax
from repro_torch.core.sparse_conv import compress_conv_tree, prune_conv_tree
from repro_torch.models import vision as tv

PLANS = ["fused_sparse_pallas", "im2col_sparse_pallas"]


@pytest.fixture
def db(tmp_path):
    d = ProfileDB(path=str(tmp_path / "profile.json"))
    dispatch.set_db(d)
    yield d
    dispatch.set_db(None)


def _images(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((cfg.c_in, batch, *cfg.image_hw)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_params(cfg, seed):
    """The JAX package's unboxed resnet-tiny params as numpy leaves (jitted
    once per config: one XLA program instead of one per primitive)."""
    init = jax.jit(lambda key: unbox_tree(jv.vision_init(cfg, key))[0])
    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(seed)))


def _assert_logits(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_configs_match():
    j, t = j_get_config("resnet-tiny"), get_vision_config("resnet-tiny")
    for f in ("c_in", "stem_channels", "stage_channels", "stage_blocks",
              "stage_strides", "image_hw", "num_classes", "strip_v", "dtype"):
        assert getattr(t, f) == getattr(j, f), f
    for f in ("sparsity", "m", "tile", "min_dim", "format", "scheme"):
        assert getattr(t.sparsity, f) == getattr(j.sparsity, f), f


def test_params_from_jax_keeps_structure_and_types():
    jp = _jax_params(j_get_config("resnet-tiny"), 0)
    tp = params_from_jax(jp, device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = jax.tree_util.tree_leaves_with_path(tp)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        assert tuple(b.shape) == a.shape
        np.testing.assert_array_equal(b.numpy(), a)
    assert tp["blocks"][0]["conv1"]["idx"].dtype == torch.int32
    assert tp["blocks"][0]["conv1"]["conv_geom"].tolist() == [3, 3, 8]
    # the port's own init yields the same tree layout
    own = tv.vision_init(get_vision_config("resnet-tiny"), 0, device="cpu")
    assert [p for p, _ in jax.tree_util.tree_leaves_with_path(own)] == \
        [p for p, _ in tl]


@pytest.mark.parametrize("impl", PLANS)
def test_resnet_tiny_logits_match_jax(db, impl):
    jcfg, tcfg = j_get_config("resnet-tiny"), get_vision_config("resnet-tiny")
    jp = _jax_params(jcfg, 3)
    x = _images(jcfg, 2, 4)
    want = jv.vision_apply(jp, jcfg, jax.numpy.asarray(x), impl=impl)
    got = tv.vision_apply(params_from_jax(jp, device="cpu"), tcfg,
                          torch.from_numpy(x), impl=impl)
    assert tuple(got.shape) == (2, tcfg.num_classes)
    _assert_logits(got, want)
    if impl == PLANS[0]:  # the default plan is the fused one
        _assert_logits(tv.vision_apply(params_from_jax(jp, device="cpu"), tcfg,
                                       torch.from_numpy(x)), want)


def test_compress_conv_tree_matches_jax(db):
    """A masked tree compressed by both packages: the same values/idx, and
    the compressed forward equals the masked one."""
    jcfg = j_get_config("resnet-tiny")
    jcfg_m = jcfg.with_(sparsity=jcfg.sparsity.with_(format="masked"))
    tcfg = get_vision_config("resnet-tiny")
    tcfg_m = tcfg.with_(sparsity=tcfg.sparsity.with_(format="masked"))
    jmasked = _jax_params(jcfg_m, 5)
    jpacked = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda t: j_compress_conv_tree(t, jcfg.sparsity))(jmasked))
    tmasked = params_from_jax(jmasked, device="cpu")
    tpacked = compress_conv_tree(tmasked, tcfg.sparsity)
    jl = jax.tree_util.tree_leaves_with_path(jpacked)
    tl = jax.tree_util.tree_leaves_with_path(tpacked)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert str(b.dtype) == f"torch.{a.dtype.name}", path
        np.testing.assert_array_equal(b.numpy(), a)
    x = torch.from_numpy(_images(jcfg, 2, 6))
    _assert_logits(tv.vision_apply(tpacked, tcfg, x),
                   tv.vision_apply(tmasked, tcfg_m, x).numpy())


def test_prune_conv_tree_matches_jax():
    """One-shot pruning of a dense tree: the same masks and masked weights."""
    from repro.core.pruning import SparsityConfig as JCfg
    from repro.core.sparse_conv import prune_conv_tree as j_prune_conv_tree
    from repro_torch.core.pruning import SparsityConfig as TCfg

    jcfg = j_get_config("resnet-tiny")
    jdense = _jax_params(jcfg.with_(sparsity=JCfg()), 8)
    cfg = dict(sparsity=0.5, m=None, tile=8, min_dim=16, format="masked")
    jpruned = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda t: j_prune_conv_tree(t, JCfg(**cfg)))(jdense))
    tpruned = prune_conv_tree(params_from_jax(jdense, device="cpu"), TCfg(**cfg))
    jl = jax.tree_util.tree_leaves_with_path(jpruned)
    tl = jax.tree_util.tree_leaves_with_path(tpruned)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        np.testing.assert_array_equal(b.numpy(), a)


def test_synth_batch_and_accuracy_on_cpu():
    cfg = get_vision_config("resnet-tiny")
    x, labels = tv.synth_batch(cfg, 1, 4, device="cpu")
    x2, labels2 = tv.synth_batch(cfg, 1, 4, device="cpu")
    assert tuple(x.shape) == (3, 4, 16, 16) and x.dtype == torch.float32
    assert torch.equal(x, x2) and torch.equal(labels, labels2)
    params = tv.vision_init(cfg, 0, device="cpu")
    acc = tv.vision_accuracy(params, cfg, x, labels)
    assert 0.0 <= acc <= 1.0
