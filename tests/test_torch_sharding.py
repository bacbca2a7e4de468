"""The port's logical-axis sharding layer and its REDUCE format against the
JAX package's, on the CPU.

* ``resolve_spec`` entry for entry against JAX's on drawn dims and names,
  over ``tests/test_sharding_rules.py``'s three meshes and a (2, 2) one,
  and the twins of that file's four named cases.
* The spec trees: ``param_specs`` (every LM config of the registry at smoke
  size, dense, masked, compressed, and compressed with
  ``shard_local_reduce``), ``batch_specs``, ``cache_specs`` and
  ``opt_state_specs`` leaf for leaf against JAX's; ``abstract_params`` at
  published size against ``jax.eval_shape``, allocating nothing.
* ``train_shardings``/``serve_shardings``: ``Replicate()`` everywhere on a
  (1, 1) CPU mesh, and the entries they resolve on fake (16, 16) and (2, 16,
  16) meshes equal to JAX's ``resolve_spec`` over JAX's spec trees.
* The production and host meshes.
* The REDUCE format: ``pack_reduce``, ``unpack_reduce``,
  ``init_compressed_reduce``, ``forward_compressed_reduce``, a reduce-mode
  ``linear_apply`` and smollm-360m's smoke scoring loss, against JAX's on
  converted params.

The JAX package's sharded steps are not references here (ROADMAP queue 3);
its rule resolution, spec trees and REDUCE format are.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.configs import smoke_config as j_smoke_config
from repro.core import formats as jformats
from repro.core import sparse_linear as jsl
from repro.core.pruning import SparsityConfig as JSparsityConfig
from repro.models import registry as jreg
from repro.optim import opt_state_specs as j_opt_state_specs
from repro.sharding import RULES as J_RULES
from repro.sharding import resolve_spec as j_resolve_spec
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import formats
from repro_torch.core import sparse_linear as tsl
from repro_torch.core.pruning import SparsityConfig, colwise_nm_mask
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import registry as treg
from repro_torch.optim import adamw_init, opt_state_specs
from repro_torch.sharding import (RULES, ShardingCtx, get_ctx, placements,
                                  resolve_spec, shd, use_ctx)


def fake_mesh(shape_dict):
    class M:
        shape = shape_dict
    return M()


MESHES = [
    {"data": 16, "model": 16},
    {"pod": 2, "data": 16, "model": 16},
    {"data": 1, "model": 1},
    {"data": 2, "model": 2},
]
FORMATS = {
    "dense": None,
    "masked": dict(sparsity=0.5, min_dim=16, format="masked"),
    "compressed": dict(sparsity=0.5, min_dim=16, format="compressed_xla"),
    "reduce": dict(sparsity=0.5, min_dim=16, format="compressed_xla",
                   shard_local_reduce=True),
}
ARCHS = tuple(j_list_archs())
REL = 1e-5


def _flat(tree, prefix=()):
    """{path: leaf} of a dict tree; a tuple (a spec) is a leaf."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _jflat(tree, prefix=()):
    """{path: leaf} of a JAX tree whose leaves are specs or arrays."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_jflat(v, prefix + (k,)))
        return out
    return {prefix: tuple(tree) if isinstance(tree, tuple) else tree}


def _cfgs(arch, fmt):
    kw = FORMATS[fmt]
    jc, tc = j_smoke_config(arch), smoke_config(arch)
    if kw is None:
        return jc, tc
    return jc.with_(sparsity=JSparsityConfig(**kw)), tc.with_(
        sparsity=SparsityConfig(**kw))


# ---------------------------------------------------------------------------
# resolve_spec
# ---------------------------------------------------------------------------


def test_rules_are_jax_rules():
    assert RULES == J_RULES


@given(
    st.sampled_from(MESHES),
    st.lists(st.sampled_from([1, 2, 5, 15, 16, 64, 960, 2048, 151936]),
             min_size=1, max_size=4),
    st.lists(st.sampled_from(list(RULES) + [None]), min_size=4, max_size=4),
)
@settings(max_examples=100, deadline=None)
def test_resolve_spec_matches_jax(mesh_shape, dims, names):
    mesh = fake_mesh(mesh_shape)
    names = names[:len(dims)]
    assert resolve_spec(dims, names, RULES, mesh) == tuple(
        j_resolve_spec(dims, names, J_RULES, mesh))


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda m: "x".join(
    map(str, m.values())))
def test_resolve_spec_matches_jax_on_every_name(mesh_shape):
    """Every rule name (and None) at each dim size of the drawn test, one
    name a dim, and all names together on one 4-dim shape."""
    mesh = fake_mesh(mesh_shape)
    names = list(RULES) + [None]
    for dim in (1, 2, 5, 15, 16, 64, 960, 2048, 151936):
        for name in names:
            assert resolve_spec((dim,), (name,), RULES, mesh) == tuple(
                j_resolve_spec((dim,), (name,), J_RULES, mesh)), (dim, name)
    for i in range(len(names) - 3):
        dims, ns = (64, 2048, 960, 16), names[i:i + 4]
        assert resolve_spec(dims, ns, RULES, mesh) == tuple(
            j_resolve_spec(dims, ns, J_RULES, mesh)), ns


def test_indivisible_dim_left_unsharded():
    mesh = fake_mesh({"data": 16, "model": 16})
    spec = resolve_spec((15, 64), ("heads", "head_dim"), RULES, mesh)
    assert spec[0] is None  # 15 heads cannot shard over 16


def test_pod_axis_dropped_on_single_pod():
    mesh = fake_mesh({"data": 16, "model": 16})
    spec = resolve_spec((256, 128), ("act_batch", None), RULES, mesh)
    assert spec[0] == "data"


def test_multi_axis_batch():
    mesh = fake_mesh({"pod": 2, "data": 16, "model": 16})
    spec = resolve_spec((256, 128), ("act_batch", None), RULES, mesh)
    assert spec[0] == ("pod", "data")
    from torch.distributed.tensor import Replicate, Shard

    assert placements(spec, mesh) == (Shard(0), Shard(0), Replicate())


def test_used_axis_not_reused_across_dims():
    mesh = fake_mesh({"data": 16, "model": 16})
    spec = resolve_spec((64, 2048, 1024), ("expert", "embed", "ffn"), RULES, mesh)
    assert spec[0] == "model"
    assert spec[2] is None


def test_placements_refuse_an_axis_order_against_the_mesh():
    mesh = fake_mesh({"pod": 2, "data": 16, "model": 16})
    with pytest.raises(ValueError, match="mesh order"):
        placements((("data", "pod"), None), mesh)


def test_shd_is_a_no_op_without_a_context_or_on_a_plain_tensor():
    x = torch.ones(4, 8)
    assert get_ctx() is None
    assert shd(x, "act_batch", None) is x
    with use_ctx(ShardingCtx(mesh=fake_mesh({"data": 2, "model": 2}))):
        assert shd(x, "act_batch", None) is x
    assert get_ctx() is None


# ---------------------------------------------------------------------------
# Spec trees
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_abstract(arch, fmt, smoke=True):
    if smoke:
        jc = _cfgs(arch, fmt)[0]
    else:
        jc = j_get_config(arch)
    shapes, specs = jreg.abstract_params(jc)
    return _jflat(shapes), _jflat(specs), specs


@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch, fmt):
    """``param_specs`` leaf for leaf, and ``abstract_params``' shapes and
    dtypes, against JAX's ``unbox_tree`` specs and ``eval_shape``; the
    REDUCE format's o/down leaves are ``values_r``/``idx_r``."""
    jshapes, jspecs, _ = _jax_abstract(arch, fmt)
    tc = _cfgs(arch, fmt)[1]
    params, specs = treg.abstract_params(tc)
    assert _flat(specs) == jspecs
    assert _flat(treg.param_specs(tc)) == jspecs
    flat = _flat(params)
    assert set(flat) == set(jshapes)
    for path, t in flat.items():
        assert t.device.type == "meta", path
        assert tuple(t.shape) == tuple(jshapes[path].shape), path
        assert str(t.dtype).split(".")[1] == jshapes[path].dtype.name, path
    if fmt == "reduce" and arch in ("smollm-360m", "olmoe-1b-7b"):
        assert ("layers", "attn", "o", "values_r") in flat
        assert specs["layers"]["attn"]["o"]["idx_r"] == (
            "layers", "reduce_group", None)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen2-vl-72b"])
def test_abstract_params_at_published_size_allocate_nothing(arch):
    jshapes, jspecs, _ = _jax_abstract(arch, "dense", smoke=False)
    params, specs = treg.abstract_params(get_config(arch))
    assert _flat(specs) == jspecs
    for path, t in _flat(params).items():
        assert t.device.type == "meta", path
        assert tuple(t.shape) == tuple(jshapes[path].shape), path
        assert str(t.dtype).split(".")[1] == jshapes[path].dtype.name, path


def _batch(cfg, b=4, s=16):
    batch = {"tokens": torch.zeros((b, s), dtype=torch.int32)}
    if cfg.family == "vlm":
        batch["mrope_positions"] = torch.zeros((b, 3, s), dtype=torch.int32)
        batch["vision_embeds"] = torch.zeros((b, 4, cfg.d_model))
        batch["vision_pos"] = torch.zeros((b, 4), dtype=torch.int32)
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = torch.zeros((b, s, cfg.d_model))
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_cache_and_opt_specs_match_jax(arch):
    jc, tc = _cfgs(arch, "compressed")
    batch = _batch(tc)
    assert treg.batch_specs(tc, batch) == {
        k: tuple(v) for k, v in jreg.batch_specs(jc, batch).items()}
    cache = treg.abstract_cache(tc, 2, 32)
    jcache = jreg.abstract_cache(jc, 2, 32)
    tspec = treg.cache_specs(tc, cache)
    assert _flat(tspec) == _jflat(jreg.cache_specs(jc, jcache))
    for path, t in _flat(cache).items():
        assert t.device.type == "meta"
        assert len(_flat(tspec)[path]) == t.ndim, path
        assert tuple(t.shape) == tuple(_jflat(jcache)[path].shape), path
    jspecs = _jax_abstract(arch, "compressed")[2]
    specs = treg.param_specs(tc)
    assert _flat(opt_state_specs(specs)) == _jflat(j_opt_state_specs(jspecs))


# ---------------------------------------------------------------------------
# Train and serve shardings
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_mesh():
    import torch.distributed as dist

    started = not dist.is_initialized()
    mesh = tmesh.make_host_mesh()
    yield mesh
    if started:
        dist.destroy_process_group()


def _entries(tree):
    return {p: s.spec for p, s in _flat(tree).items() if s is not None}


def _jax_entries(spec_tree, shape_tree, mesh):
    shapes = _flat(shape_tree)
    return {p: tuple(j_resolve_spec(tuple(shapes[p].shape), s, J_RULES, mesh))
            for p, s in _jflat(spec_tree).items()}


def _serve_spec(tc, kind):
    if kind == "prefill":
        return {"kind": "prefill", "batch": _batch(tc, 16, 32)}
    return {"kind": "decode", "cache": treg.abstract_cache(tc, 16, 64),
            "tokens": torch.zeros((16, 1), dtype=torch.int32),
            "pos": torch.zeros((), dtype=torch.int32)}


def test_train_and_serve_shardings_replicate_on_the_host_mesh(host_mesh):
    from torch.distributed.tensor import Replicate

    tc = _cfgs("olmoe-1b-7b", "compressed")[1]
    params = treg.init_params(tc, 0, device="cpu")
    specs = treg.param_specs(tc)
    batch = _batch(tc)
    (p_sh, o_sh, b_sh), (p_out, o_out, m_out) = tsteps.train_shardings(
        tc, host_mesh, params, specs, batch)
    assert p_out is p_sh and o_out is o_sh and m_out is None
    assert set(o_sh) == {"m", "v", "step"}
    shardings = list(_flat((p_sh, o_sh, b_sh)[0]).values()) + list(
        _flat(o_sh).values()) + list(_flat(b_sh).values())
    for kind in ("prefill", "decode"):
        out = tsteps.serve_shardings(tc, host_mesh, params, specs,
                                     _serve_spec(tc, kind), cache_auto=False)
        shardings += [s for t in (out if kind == "prefill" else out[0])
                      for s in (_flat(t).values() if isinstance(t, dict)
                                else [t])]
    assert shardings
    for s in shardings:
        assert s.placements == (Replicate(), Replicate()), s
    # at world size 1 nothing is wrapped: the kernels take plain tensors
    assert tsteps.distribute_tree(params, p_sh) is not None
    same = tsteps.distribute_tree(params, p_sh)
    assert all(a is b for a, b in zip(_flat(same).values(),
                                      _flat(params).values()))


@pytest.mark.parametrize("mesh_shape", MESHES[:2], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_shardings_resolve_as_jax(arch, mesh_shape):
    """At published size: the params, the optimizer state, the batch, the
    serving batch, the decode cache and tokens resolve to JAX's entries."""
    mesh = fake_mesh(mesh_shape)
    tc = get_config(arch)
    params, specs = treg.abstract_params(tc)
    _, _, jspecs = _jax_abstract(arch, "dense", smoke=False)
    batch = _batch(tc, 256, 128)
    (p_sh, o_sh, b_sh), _ = tsteps.train_shardings(tc, mesh, params, specs, batch)
    assert _entries(p_sh) == _jax_entries(jspecs, params, mesh)
    opt = adamw_init(params)
    jo = j_opt_state_specs(jspecs)
    assert _entries(o_sh) == _jax_entries({k: jo[k] for k in opt}, opt, mesh)
    jc = j_get_config(arch)
    assert _entries(b_sh) == _jax_entries(jreg.batch_specs(jc, batch), batch,
                                          mesh)
    pre = tsteps.serve_shardings(tc, mesh, params, specs,
                                 _serve_spec(tc, "prefill"))
    assert _entries(pre[1]) == _jax_entries(
        jreg.batch_specs(jc, _serve_spec(tc, "prefill")["batch"]),
        _serve_spec(tc, "prefill")["batch"], mesh)
    dspec = _serve_spec(tc, "decode")
    (d_p, d_c, d_tok, d_pos), c_out = tsteps.serve_shardings(
        tc, mesh, params, specs, dspec, cache_auto=False)
    assert _entries(d_c) == _jax_entries(
        jreg.cache_specs(jc, jreg.abstract_cache(jc, 16, 64)), dspec["cache"],
        mesh)
    assert d_tok.spec == tuple(j_resolve_spec((16, 1), ("act_batch", None),
                                              J_RULES, mesh))
    assert d_pos.spec == ()
    auto = tsteps.serve_shardings(tc, mesh, params, specs, dspec)
    assert all(v is None for v in _flat(auto[1]).values())


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("multi,world", [(False, 256), (True, 512)])
def test_production_mesh_names_the_world_it_needs(multi, world):
    with pytest.raises(ValueError, match=f"needs world size {world}"):
        tmesh.make_production_mesh(multi_pod=multi)


def test_host_mesh_axes(host_mesh):
    assert tuple(host_mesh.mesh_dim_names) == ("data", "model")
    assert tmesh.mesh_tp(host_mesh) == 1 and tmesh.mesh_dp(host_mesh) == 1
    assert tmesh.mesh_tp(fake_mesh({"pod": 2, "data": 16, "model": 16})) == 16
    assert tmesh.mesh_dp(fake_mesh({"pod": 2, "data": 16, "model": 16})) == 32


# ---------------------------------------------------------------------------
# The REDUCE format
# ---------------------------------------------------------------------------


def _w(d_in, d_out, seed):
    return np.random.default_rng(seed).standard_normal((d_in, d_out)).astype(
        np.float32)


@pytest.mark.parametrize("d_in,d_out,groups,sparsity", [
    (64, 48, 4, 0.5), (96, 32, 2, 0.75), (60, 16, 3, 0.4)])
def test_pack_reduce_bit_exact_and_round_trips(d_in, d_out, groups, sparsity):
    w = _w(d_in, d_out, d_in + d_out)
    # the port's mask: bit-equal to JAX's (tests/test_torch_pruning.py)
    mask = colwise_nm_mask(torch.from_numpy(w), sparsity, m=d_in // groups,
                           tile=d_out).numpy()
    jv, ji = jformats.pack_reduce(jnp.asarray(w), jnp.asarray(mask), groups)
    tv, ti = formats.pack_reduce(torch.from_numpy(w), torch.from_numpy(mask),
                                 groups)
    assert ti.dtype == torch.int32
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tv.numpy().view(np.int32),
                          np.asarray(jv).view(np.int32))
    back = formats.unpack_reduce(tv, ti, d_in)
    assert torch.equal(back, torch.from_numpy(w * mask))
    assert np.array_equal(back.numpy(), np.asarray(
        jformats.unpack_reduce(jv, ji, d_in)))


@pytest.mark.parametrize("d_in,d_out,groups,n_per", [
    (64, 48, 4, 8), (2560, 960, 4, 320), (60, 16, 3, 7)])
def test_init_compressed_reduce_matches_jax(d_in, d_out, groups, n_per):
    jv, ji = jformats.init_compressed_reduce(jax.random.PRNGKey(0), d_in,
                                             d_out, groups, n_per)
    tv, ti = formats.init_compressed_reduce(torch.Generator().manual_seed(0),
                                            d_in, d_out, groups, n_per,
                                            device="cpu")
    assert tuple(tv.shape) == tuple(jv.shape) and tv.dtype == torch.float32
    assert ti.dtype == torch.int32 and np.array_equal(ti.numpy(), np.asarray(ji))
    assert abs(float(tv.std()) - float(jnp.std(jv))) < 0.2 * float(jnp.std(jv))


@pytest.mark.parametrize("groups", [0, 2, 4])
def test_reduce_linear_matches_jax(groups):
    """A reduce-mode layer under ``shard_local_reduce`` (JAX's params,
    converted): its leaves and specs, ``forward_compressed_reduce`` and
    ``linear_apply`` within REL of max|y|; a concat-mode layer keeps the
    ordinary format."""
    kw = dict(sparsity=0.5, min_dim=16, format="compressed_xla",
              shard_local_reduce=True, reduce_groups=groups)
    jcfg, tcfg = JSparsityConfig(**kw), SparsityConfig(**kw)
    jp, jspec = jsl.unbox_tree(jsl.linear_init(
        jax.random.PRNGKey(1), 96, 64, jcfg, in_ax="ffn", out_ax="embed",
        mode="reduce", use_bias=True))
    with tsl.boxing():
        tp, tspec = tsl.unbox_tree(tsl.linear_init(
            torch.Generator(), 96, 64, tcfg, in_ax="ffn", out_ax="embed",
            mode="reduce", use_bias=True, device="cpu"))
    assert tspec == {k: tuple(v) for k, v in jspec.items()}
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}
    assert np.array_equal(tp["idx_r"].numpy(), np.asarray(jp["idx_r"]))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")
    x = np.random.default_rng(2).standard_normal((3, 5, 96)).astype(np.float32)
    want = np.asarray(jsl.linear_apply(jp, jnp.asarray(x)))
    for got in (tsl.linear_apply(params, torch.from_numpy(x)),
                tsl.forward_compressed_reduce(
                    torch.from_numpy(x), params["values_r"], params["idx_r"])
                + params["b"]):
        assert float(np.abs(got.numpy() - want).max()) <= REL * float(
            np.abs(want).max())
    concat = tsl.linear_init(torch.Generator(), 96, 64, tcfg, device="cpu")
    assert set(concat) == {"values", "idx"}


def test_smollm_reduce_scoring_loss_matches_jax():
    """smollm-360m's smoke model with every o and down projection in the
    REDUCE format: the scoring loss within REL relative of JAX's on its
    converted params."""
    jc, tc = _cfgs("smollm-360m", "reduce")
    jp = jax.jit(lambda k: jsl.unbox_tree(jreg.init_fn(jc)(k))[0])(
        jax.random.PRNGKey(0))
    layers = jp["layers"]
    assert "values_r" in layers["attn"]["o"] and "values_r" in layers["mlp"]["down"]
    assert "values" in layers["attn"]["q"]
    tokens = np.random.default_rng(3).integers(0, 503, (2, 24)).astype(np.int32)
    jloss, _ = jax.jit(jreg.loss_fn(jc))(jp, {"tokens": jnp.asarray(tokens)})
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    loss, _ = treg.loss_fn(tc)(params, {"tokens": torch.from_numpy(tokens)})
    assert abs(float(loss) - float(jloss)) <= REL * abs(float(jloss))
