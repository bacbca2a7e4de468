"""The port's training half against the JAX package (twin of
``tests/test_conv_grad.py``): the sparse conv's backward on every plan rung
against ``jax.grad`` through JAX's custom VJP and against autograd of the
dense masked conv, the sparse linear's backward (leading dims, tiles that
share a kept row, bf16 against the f32 oracle), the masked-finetune hooks
bit for bit, and one resnet-tiny SGD step against JAX's.  Inputs are drawn
with numpy from a seed and converted for both packages."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import dispatch as jdispatch
from repro.configs import get_vision_config as j_get_config
from repro.core import SparsityConfig as JCfg
from repro.core import apply_conv_mask as j_apply_conv_mask
from repro.core import conv_init as j_conv_init
from repro.core import mask_project_tree as j_mask_project_tree
from repro.core import prune_conv_tree as j_prune_conv_tree
from repro.core import refresh_conv_mask as j_refresh_conv_mask
from repro.core.sparse_linear import unbox_tree
from repro.dispatch import ProfileDB
from repro.kernels.colwise_nm import colwise_nm_matmul as j_colwise_nm_matmul
from repro.kernels.conv_gemm import conv2d_sparse as j_conv2d_sparse
from repro.models import vision as jv
from repro_torch import dispatch
from repro_torch.configs import get_vision_config
from repro_torch.convert import params_from_jax
from repro_torch.core import apply_conv_mask, mask_project_tree, refresh_conv_mask
from repro_torch.core.formats import meta_for, pack_colwise
from repro_torch.core.pruning import SparsityConfig, colwise_nm_mask
from repro_torch.core.sparse_conv import conv_apply, conv_init
from repro_torch.kernels.colwise_nm import (
    colwise_nm_matmul,
    colwise_nm_matmul_tiled,
    scatter_add_f32,
    sparse_grad_dvalues,
    sparse_grad_dxg,
)
from repro_torch.kernels.conv_gemm import (
    compress_conv_weights,
    conv2d_cnhw_ref,
    conv2d_colwise_sparse,
    conv2d_sparse,
)
from repro_torch.models import vision as tv

# every rung of the conv plan ladder, each forced by name (on the CPU each
# runs its plain version; the backward is the same for all)
RUNGS = ["fused_sparse_pallas", "fused_banded_pallas", "two_kernel_pipelined",
         "im2col_sparse_pallas", "im2col_sparse_xla"]
# tests/test_conv_grad.py's shapes: (c, b, h, w, o, k, stride, pad)
SHAPES = [
    (8, 2, 10, 10, 16, 3, 1, 1),   # multi-batch, padded
    (8, 1, 10, 10, 16, 3, 2, 1),   # stride 2
    (5, 2, 9, 7, 8, 3, 1, 0),      # no pad, non-square
    (6, 2, 11, 11, 8, 3, 1, 1),    # ragged: P % V != 0
]
TOL = 1e-4  # rtol and atol of the f32 gradients, as the JAX tests
BF16_TOL = 3e-2  # bf16 gradients against the f32 oracle, as the JAX tests
CFG = SparsityConfig(sparsity=0.5, m=None, tile=8, format="compressed_pallas")
MCFG = SparsityConfig(sparsity=0.5, m=None, tile=8, min_dim=8, format="masked")


@pytest.fixture
def db(tmp_path):
    """Empty profile DBs for both packages' dispatch; yields the port's."""
    jdispatch.set_db(ProfileDB(path=str(tmp_path / "profile.json")))
    tdb = dispatch.ProfileDB(path=tmp_path / "torch_profile.json")
    dispatch.set_db(tdb)
    yield tdb
    jdispatch.set_db(None)
    dispatch.set_db(None)


def _t(a, requires_grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(requires_grad)


@functools.lru_cache(maxsize=None)
def _conv_problem(c, b, h, w, o, k, stride, pad, seed=0):
    """(x, values, idx, masked dense OHWI weight, cotangent) as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((c, b, h, w)).astype(np.float32)
    wt = rng.standard_normal((o, k, k, c)).astype(np.float32)
    values, idx, meta = compress_conv_weights(torch.from_numpy(wt), CFG)
    wmat = torch.from_numpy(wt).reshape(o, -1).T
    mask = colwise_nm_mask(wmat, 0.5, tile=meta.tile)
    wm = (wmat * mask).T.reshape(o, k, k, c).numpy()
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    cot = rng.standard_normal((o, b, ho, wo)).astype(np.float32)
    return x, values.numpy(), idx.numpy(), wm, cot


@functools.lru_cache(maxsize=None)
def _jax_conv_grads(shape):
    """(dx, dvalues) of JAX's custom VJP, through its XLA rung (the backward
    is the same for every rung)."""
    c, b, h, w, o, k, stride, pad = shape
    x, values, idx, _wm, cot = _conv_problem(*shape)

    def loss(x, values):
        y = j_conv2d_sparse(x, values, jnp.asarray(idx), kh=k, kw=k,
                            stride=stride, pad=pad, v=16,
                            impl="im2col_sparse_xla")
        return jnp.sum(y * cot)

    return tuple(np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(values)))


def _dense_grads(x, wm, stride, pad, cot):
    """(dx, dW_ohwi) by autograd of the port's dense masked conv."""
    xt, wt = _t(x, True), _t(wm, True)
    y = conv2d_cnhw_ref(xt, wt, stride=stride, pad=pad)
    return torch.autograd.grad((y * _t(cot)).sum(), (xt, wt))


def _kept(dw_ohwi, idx, tile):
    """The dense weight gradient at the packed positions: [n_tiles, k, T]."""
    o = dw_ohwi.shape[0]
    dwmat = np.asarray(dw_ohwi, np.float32).reshape(o, -1).T  # [K, O]
    return np.stack([dwmat[idx[t], t * tile:(t + 1) * tile]
                     for t in range(idx.shape[0])])


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def _close(got, want, tol=TOL, scale=None):
    atol = tol if scale is None else tol * scale
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=atol)


# ---------------------------------------------------------------------------
# The conv's backward on every rung
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", RUNGS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_conv_grad_matches_jax_and_dense_autograd(db, impl, shape):
    c, b, h, w, o, k, stride, pad = shape
    x, values, idx, wm, cot = _conv_problem(*shape)
    xt, vt = _t(x, True), _t(values, True)
    y = conv2d_sparse(xt, vt, _t(idx), kh=k, kw=k, stride=stride, pad=pad,
                      v=16, impl=impl)
    dx, dv = torch.autograd.grad((y * _t(cot)).sum(), (xt, vt))
    assert dx.dtype == torch.float32 and dv.dtype == torch.float32
    jdx, jdv = _jax_conv_grads(shape)
    _close(dx, jdx)
    _close(dv, jdv)
    ddx, ddw = _dense_grads(x, wm, stride, pad, cot)
    _close(dx, ddx)
    _close(dv, _kept(ddw.numpy(), idx, values.shape[2]))


def test_conv_grad_under_force_scope_and_conv2d_colwise_sparse(db):
    """An ambient force_scope pins the forward's rung; the backward is the
    shared one, and conv2d_colwise_sparse's dispatched entry is the same
    differentiable function."""
    shape = SHAPES[0]
    c, b, h, w, o, k, stride, pad = shape
    x, values, idx, _wm, cot = _conv_problem(*shape)
    jdx, jdv = _jax_conv_grads(shape)
    for run in (
            lambda xt, vt: conv2d_sparse(xt, vt, _t(idx), kh=k, kw=k,
                                         stride=stride, pad=pad, v=16),
            lambda xt, vt: conv2d_colwise_sparse(xt, vt, _t(idx), k, k,
                                                 stride=stride, pad=pad, v=16)):
        xt, vt = _t(x, True), _t(values, True)
        with dispatch.force_scope(conv="fused_banded_pallas"):
            y = run(xt, vt)
        dx, dv = torch.autograd.grad((y * _t(cot)).sum(), (xt, vt))
        _close(dx, jdx)
        _close(dv, jdv)
    with torch.no_grad():
        for use_pallas in (True, False):
            got = conv2d_colwise_sparse(_t(x), _t(values), _t(idx), k, k,
                                        stride=stride, pad=pad, v=16,
                                        use_pallas=use_pallas)
            _close(got, conv2d_cnhw_ref(_t(x), _t(_wm), stride=stride,
                                        pad=pad))


def test_conv_grad_of_values_alone_and_of_x_alone(db):
    """Where only one operand requires grad, autograd hands back that one,
    with the values of the full backward."""
    shape = SHAPES[1]
    c, b, h, w, o, k, stride, pad = shape
    x, values, idx, _wm, cot = _conv_problem(*shape)
    jdx, jdv = _jax_conv_grads(shape)
    for which, want in ((0, jdx), (1, jdv)):
        xt, vt = _t(x, which == 0), _t(values, which == 1)
        y = conv2d_sparse(xt, vt, _t(idx), kh=k, kw=k, stride=stride,
                          pad=pad, v=16)
        (g,) = torch.autograd.grad((y * _t(cot)).sum(), (xt, vt)[which])
        _close(g, want)


def test_conv_apply_grads_land_on_values_and_bias(db):
    cfg = CFG.with_(min_dim=8)
    params = conv_init(torch.Generator().manual_seed(0), 8, 16, 3, 3, cfg,
                       use_bias=True, device="cpu")
    x = _t(np.random.default_rng(1).standard_normal((8, 2, 9, 9))
           .astype(np.float32))
    live = {k: v.requires_grad_() if v.is_floating_point() else v
            for k, v in params.items()}
    y = conv_apply(live, x, kh=3, kw=3, pad=1)
    g_values, g_b = torch.autograd.grad((y ** 2).sum(), (live["values"],
                                                         live["b"]))
    for g in (g_values, g_b):
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    # idx and conv_geom are integers: autograd gives them nothing
    assert not live["idx"].requires_grad and y.grad_fn is not None


# ---------------------------------------------------------------------------
# The linear's backward
# ---------------------------------------------------------------------------


def _linear_problem(lead, d_in, d_out, tile, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((d_in, d_out)).astype(np.float32)
    wt = torch.from_numpy(w)
    mask = colwise_nm_mask(wt, 0.5, tile=tile)
    values, idx = pack_colwise(wt, mask, meta_for(d_in, d_out, CFG.with_(
        tile=tile)))
    x = rng.standard_normal((*lead, d_in)).astype(np.float32)
    cot = rng.standard_normal((*lead, d_out)).astype(np.float32)
    return x, values.numpy(), idx.numpy(), (wt * mask).numpy(), cot


@pytest.mark.parametrize("entry", [colwise_nm_matmul, colwise_nm_matmul_tiled],
                         ids=["colwise_nm_matmul", "colwise_nm_matmul_tiled"])
@pytest.mark.parametrize("lead", [(6,), (2, 3), (2, 2, 3)], ids=str)
def test_linear_grad_matches_jax_and_dense_autograd(entry, lead):
    x, values, idx, wm, cot = _linear_problem(lead, 64, 32, 8)
    assert len(np.unique(idx)) < idx.size  # tiles share kept rows

    def jloss(x, values):
        return jnp.sum(j_colwise_nm_matmul(x, values, jnp.asarray(idx)) * cot)

    jdx, jdv = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                               jnp.asarray(values))
    xt, vt = _t(x, True), _t(values, True)
    y = entry(xt, vt, _t(idx))
    assert tuple(y.shape) == (*lead, 32)
    dx, dv = torch.autograd.grad((y * _t(cot)).sum(), (xt, vt))
    _close(dx, jdx)
    _close(dv, jdv)
    xd, wd = _t(x, True), _t(wm, True)
    ddx, ddw = torch.autograd.grad(((xd @ wd) * _t(cot)).sum(), (xd, wd))
    _close(dx, ddx)
    _close(dv, _kept(ddw.numpy().T.reshape(32, 1, 1, 64), idx, 8))


@pytest.mark.parametrize("entry", [colwise_nm_matmul, colwise_nm_matmul_tiled],
                         ids=["colwise_nm_matmul", "colwise_nm_matmul_tiled"])
def test_linear_bf16_grads_match_f32_oracle(entry):
    """bf16 params: both contractions and the scatter run in float32, so
    the grads track the f32 oracle to input rounding over 256 terms."""
    x, values, idx, wm, cot = _linear_problem((64,), 512, 64, 8)
    xt = _t(x).to(torch.bfloat16).requires_grad_()
    vt = _t(values).to(torch.bfloat16).requires_grad_()
    y = entry(xt, vt, _t(idx))
    dx, dv = torch.autograd.grad((y.float() * _t(cot)).sum(), (xt, vt))
    assert dx.dtype == torch.bfloat16 and dv.dtype == torch.bfloat16
    xd, wd = _t(x, True), _t(wm, True)
    dx32, dw32 = torch.autograd.grad(((xd @ wd) * _t(cot)).sum(), (xd, wd))
    dv32 = _kept(dw32.numpy().T.reshape(64, 1, 1, 512), idx, 8)
    _close(dx.float(), dx32, BF16_TOL, float(dx32.abs().max()))
    _close(dv.float(), dv32, BF16_TOL, float(np.abs(dv32).max()))


def test_linear_backward_gives_idx_nothing():
    x, values, idx, _wm, _cot = _linear_problem((6,), 64, 32, 8)
    y = colwise_nm_matmul(_t(x, True), _t(values, True), _t(idx))
    node = y.grad_fn.next_functions[0][0]  # past the leading-dims view
    grads = node.apply(torch.ones(6, 32))
    assert grads[2] is None and grads[0].shape == (6, 64)
    assert grads[1].shape == values.shape


@pytest.mark.parametrize("rows", [1, 256, 600])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dvalues_blocks_sum_to_the_whole_contraction(rows, dtype):
    """sparse_grad_dvalues contracts its rows a block at a time: the sum
    equals one float64 contraction to f32 rounding (then one cast)."""
    rng = np.random.default_rng(rows)
    xg = _t(rng.standard_normal((rows, 3, 5)).astype(np.float32)).to(dtype)
    dy = _t(rng.standard_normal((rows, 3, 4)).astype(np.float32)).to(dtype)
    got = sparse_grad_dvalues(xg, dy, torch.float32)
    want = torch.einsum("ptk,ptf->tkf", xg.double(), dy.double())
    _close(got, want, 1e-5, float(want.abs().max()))
    lead = sparse_grad_dvalues(xg.reshape(2, -1, 3, 5) if rows % 2 == 0
                               else xg, dy.reshape(2, -1, 3, 4) if rows % 2 == 0
                               else dy, dtype)
    assert lead.dtype == dtype and tuple(lead.shape) == (3, 5, 4)


def test_backward_helpers_accumulate_f32():
    # 4 rows of ones sum exactly; the f32 einsum casts at the end only
    xg = torch.ones((4, 2, 8), dtype=torch.bfloat16)
    out = sparse_grad_dvalues(xg, xg, torch.bfloat16)
    assert out.dtype == torch.bfloat16 and bool((out.float() == 4.0).all())
    # 1 + 2^-9 is not a bf16: 512 such terms must not round one by one
    small = torch.full((512, 1, 1), 1 + 2 ** -9, dtype=torch.bfloat16)
    one = torch.ones((512, 1, 1), dtype=torch.bfloat16)
    assert float(sparse_grad_dvalues(small, one, torch.float32)) == float(
        small.float().sum())
    # dL/d(gathered x) comes back in float32, summed in float32
    rng = np.random.default_rng(4)
    dy = _t(rng.standard_normal((7, 3, 4)).astype(np.float32)).bfloat16()
    values = _t(rng.standard_normal((3, 5, 4)).astype(np.float32)).bfloat16()
    dxg = sparse_grad_dxg(dy, values)
    want = torch.einsum("ptf,tkf->ptk", dy.double(), values.double())
    assert dxg.dtype == torch.float32 and tuple(dxg.shape) == (7, 3, 5)
    _close(dxg, want, 1e-6, float(want.abs().max()))
    got = scatter_add_f32(3, torch.tensor([2, 0, 2, 2]),
                          torch.tensor([1.0, 2.0, 3.0, 4.0],
                                       dtype=torch.bfloat16))
    assert got.dtype == torch.float32 and got.tolist() == [2.0, 0.0, 8.0]


# ---------------------------------------------------------------------------
# Masked-finetune hooks, bit for bit against JAX
# ---------------------------------------------------------------------------


def _jax_masked_conv(seed=0):
    jp, _ = unbox_tree(j_conv_init(jax.random.PRNGKey(seed), 8, 16, 3, 3,
                                   JCfg(**_MCFG)))
    return jax.tree_util.tree_map(np.asarray, jp)


_MCFG = dict(sparsity=0.5, m=None, tile=8, min_dim=8, format="masked")


def _assert_same_tree(got, want):
    jl = jax.tree_util.tree_leaves_with_path(want)
    tl = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        a = np.asarray(a)
        assert str(b.dtype) == f"torch.{a.dtype.name}", path
        np.testing.assert_array_equal(b.numpy(), a, err_msg=str(path))


def test_apply_conv_mask_matches_jax():
    jp = _jax_masked_conv()
    drifted = {**jp, "w": jp["w"] + np.float32(1.0)}  # pruned taps back
    want = jax.tree_util.tree_map(np.asarray, j_apply_conv_mask(drifted))
    got = apply_conv_mask(params_from_jax(drifted, device="cpu"))
    _assert_same_tree(got, want)
    assert bool((got["w"][~got["mask"]] == 0).all())
    no_mask = {"w": torch.ones(2, 3)}
    assert apply_conv_mask(no_mask) is no_mask


def test_refresh_conv_mask_matches_jax():
    jp = _jax_masked_conv()
    new_w = np.random.default_rng(7).standard_normal(
        jp["w"].shape).astype(np.float32)
    want = jax.tree_util.tree_map(np.asarray, j_refresh_conv_mask(
        {**jp, "w": new_w}, JCfg(**_MCFG)))
    got = refresh_conv_mask(params_from_jax({**jp, "w": new_w}, device="cpu"),
                            MCFG)
    _assert_same_tree(got, want)
    assert not np.array_equal(want["mask"], jp["mask"])  # the support moved


def test_mask_project_tree_matches_jax():
    """A pruned resnet-tiny tree, every leaf moved by 0.5: the projection
    zeroes exactly the pruned positions, as JAX's does."""
    jcfg = j_get_config("resnet-tiny")
    jdense, _ = unbox_tree(jv.vision_init(jcfg.with_(sparsity=JCfg()),
                                          jax.random.PRNGKey(0)))
    pruned = j_prune_conv_tree(jdense, JCfg(**{**_MCFG, "min_dim": 16}))
    drift = jax.tree_util.tree_map(
        lambda p: np.asarray(p + 0.5) if p.dtype != jnp.bool_ else
        np.asarray(p), pruned)
    want = jax.tree_util.tree_map(np.asarray, j_mask_project_tree(drift))
    got = mask_project_tree(params_from_jax(drift, device="cpu"))
    _assert_same_tree(got, want)
    n_masked = sum("mask" in layer for block in got["blocks"]
                   for layer in block.values())
    assert n_masked == 5
    as_tuple = mask_project_tree((params_from_jax(drift, device="cpu"),))
    assert isinstance(as_tuple, tuple)
    _assert_same_tree(as_tuple[0], want)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_train_step(seed, batch):
    """(params, batch, new params, new momentum, loss) of one resnet-tiny
    step in JAX, numpy leaves, through JAX's XLA conv rung."""
    cfg = j_get_config("resnet-tiny")
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda key: unbox_tree(jv.vision_init(cfg, key))[0])(
            jax.random.PRNGKey(seed)))
    x, labels = jv.synth_batch(cfg, jax.random.PRNGKey(seed + 1), batch)
    step = jax.jit(lambda p, m, x, y: jv.train_step(p, m, cfg, x, y))
    new_p, new_m, loss = step(params, jv.sgd_init(params), x, labels)
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return (params, (np.asarray(x), np.asarray(labels)), to_np(new_p),
            to_np(new_m), float(loss))


def test_train_step_matches_jax(db, monkeypatch):
    monkeypatch.setenv("REPRO_DISPATCH_FORCE", "im2col_sparse_xla")
    jparams, (x, labels), jnew_p, jnew_m, jloss = _jax_train_step(0, 4)
    cfg = get_vision_config("resnet-tiny")
    params = params_from_jax(jparams, device="cpu")
    before = {id(t): t.clone() for t in _leaves(params)}
    new_p, new_m, loss = tv.train_step(params, tv.sgd_init(params), cfg,
                                       _t(x), _t(labels))
    assert abs(float(loss) - jloss) <= 1e-5 * abs(jloss)
    for want, got in ((jnew_p, new_p), (jnew_m, new_m)):
        jl = jax.tree_util.tree_leaves_with_path(want)
        tl = jax.tree_util.tree_leaves_with_path(got)
        assert [p for p, _ in jl] == [p for p, _ in tl]
        for (path, a), (_, b) in zip(jl, tl):
            assert str(b.dtype) == f"torch.{a.dtype.name}", path
            scale = max(float(np.abs(a).max()), 1e-30) if a.size else 1.0
            _close(b, a, TOL, scale)
    # functional: the input tree is as it was
    for t in _leaves(params):
        assert torch.equal(t, before[id(t)])
    # the first step's momentum is the gradient: every float leaf moved
    for layer in (new_m["stem"], new_m["blocks"][1]["conv1"], new_m["head"]):
        g = layer["values" if "values" in layer else "w"]
        assert float(g.abs().max()) > 0


def test_train_step_under_every_rung_gives_the_same_step(db):
    cfg = get_vision_config("resnet-tiny")
    params = tv.vision_init(cfg, 0, device="cpu")
    x, labels = tv.batch_for_step(cfg, 3, 0, 4, device="cpu")
    mom = tv.sgd_init(params)
    want = tv.train_step(params, mom, cfg, x, labels)
    for rung in RUNGS:
        with dispatch.force_scope(conv=rung):
            got = tv.train_step(params, mom, cfg, x, labels)
        assert abs(float(got[2]) - float(want[2])) <= 1e-5 * float(want[2])
        for a, b in zip(_leaves(got[:2]), _leaves(want[:2])):
            if a.is_floating_point():
                _close(a, b, TOL, max(float(b.abs().max()), 1e-30))
            else:
                assert torch.equal(a, b)


@pytest.mark.parametrize("flag", [False, True])
def test_train_step_leaves_the_cudnn_setting_as_it_was(db, monkeypatch, flag):
    """The step takes its gradients with cuDNN's deterministic algorithms
    (the dense convs' backward is then repeatable on the card) and restores
    the setting after it."""
    seen = []
    loss_fn = tv.vision_loss

    def spy(*args):
        seen.append(torch.backends.cudnn.deterministic)
        return loss_fn(*args)

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", flag)
    monkeypatch.setattr(tv, "vision_loss", spy)
    cfg = get_vision_config("resnet-tiny")
    params = tv.vision_init(cfg, 0, device="cpu")
    x, labels = tv.synth_batch(cfg, 1, 2, device="cpu")
    tv.train_step(params, tv.sgd_init(params), cfg, x, labels)
    assert seen == [True] and torch.backends.cudnn.deterministic is flag


def test_train_smoke_reduces_the_loss_on_the_cpu(db):
    losses = tv.train_smoke(steps=3, verbose=False, device="cpu")
    assert losses[-1] < losses[0] and all(np.isfinite(losses))


def test_masked_finetune_keeps_its_support(db):
    cfg = get_vision_config("resnet-tiny")
    mcfg = cfg.with_(sparsity=cfg.sparsity.with_(format="masked"))
    params = tv.vision_init(mcfg, 0, device="cpu")
    x, labels = tv.synth_batch(cfg, 1, 4, device="cpu")
    masks = [layer["mask"] for block in params["blocks"]
             for layer in block.values() if "mask" in layer]
    assert len(masks) == 5
    mom = tv.sgd_init(params)
    for _ in range(2):
        params, mom, loss = tv.train_step(params, mom, mcfg, x, labels)
        assert np.isfinite(float(loss))
    after = [layer for block in params["blocks"] for layer in block.values()
             if "mask" in layer]
    for mask, layer in zip(masks, after, strict=True):
        assert torch.equal(layer["mask"], mask)
        assert bool((layer["w"][~mask] == 0).all())
        assert bool((layer["w"][mask] != 0).all())


def test_train_step_adds_nothing_to_the_profile_db(db):
    cfg = get_vision_config("resnet-tiny")
    params = tv.vision_init(cfg, 0, device="cpu")
    x, labels = tv.synth_batch(cfg, 1, 2, device="cpu")
    tv.train_step(params, tv.sgd_init(params), cfg, x, labels)
    assert len(db) == 0 and not db.path.exists()
    assert not [t for t in db.tokens() if t.startswith("conv|")]


def test_batch_for_step_is_a_function_of_seed_and_step():
    cfg = get_vision_config("resnet-tiny")
    a = tv.batch_for_step(cfg, 5, 2, 4, device="cpu")
    b = tv.batch_for_step(cfg, 5, 2, 4, device="cpu")
    c = tv.batch_for_step(cfg, 5, 3, 4, device="cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    assert tuple(a[0].shape) == (3, 4, 16, 16) and a[1].dtype == torch.int64
