"""The mixture-of-experts family of the port against the JAX package, on the
CPU: the olmoe-1b-7b and moonshot-v1-16b-a3b configs (published and smoke
size), ``moe_capacity``, the router (``top_i``/``top_p`` equal, ties in
``jax.lax.top_k``'s order), the group dispatch fed JAX's own routing (bit
for bit, with dropped assignments and with two groups), ``moe_apply`` over
dense, masked and compressed experts, SwiGLU and squared ReLU (within
``MOE_RTOL`` of max|y|, aux within ``AUX_TOL``), the init tree leaf for leaf,
and the smoke models with every linear compressed (sparsity 0.5,
``min_dim=16``) through the scoring forward and loss (every ``attn_impl``),
prefill, chunked prefill, contiguous and paged decode, packed prefill,
``plan_params``, greedy generation and the paged scheduler.  Logits are
held within 1e-4 of max|logit| and caches within 1e-5.

Exact routing parity needs margins: every routing these tests run records
the gap between each token's k-th and (k+1)-th probability, and a test
asserts that each gap exceeds ``MARGIN_MIN`` (far above the 1e-7 by which
the two packages' router logits differ).  Inputs come from numpy seeds;
params come from JAX through ``params_from_jax``."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import dispatch as jdispatch
from repro.configs import get_config as j_get_config
from repro.configs import smoke_config as j_smoke_config
from repro.core.pruning import SparsityConfig as JSparsityConfig
from repro.core.sparse_linear import unbox_tree
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models import registry as jreg
from repro.serve import Engine as JEngine
from repro.serve import Scheduler as JScheduler
from repro.serve import ServeConfig as JServeConfig
from repro.serve import kv_pages as jkp
from repro.serve import synthetic_trace as j_synthetic_trace
from repro_torch import dispatch
from repro_torch._tree import keystr, leaves_with_path
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.pruning import SparsityConfig
from repro_torch.kernels import KERNELS
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models import registry as treg
from repro_torch.serve import Engine, Scheduler, ServeConfig, synthetic_trace

ARCHS = ("olmoe-1b-7b", "moonshot-v1-16b-a3b")
SPARSE = dict(sparsity=0.5, m=None, tile=None, min_dim=16,
              format="compressed_pallas")
FORMATS = {"dense": None, "masked": dict(SPARSE, format="masked"),
           "compressed": SPARSE}
LOGIT_RTOL = 1e-4  # of max|logit|
MOE_RTOL = 1e-5    # of max|y|: the same sums in another order
AUX_TOL = 1e-6
F32_TOL = 1e-5
MARGIN_MIN = 1e-4  # k-th minus (k+1)-th routing probability, every token


@pytest.fixture(autouse=True)
def dbs(tmp_path):
    dispatch.set_db(dispatch.ProfileDB(path=tmp_path / "profile.json"))
    jdispatch.set_db(jdispatch.ProfileDB(path=str(tmp_path / "jax.json")))
    yield
    dispatch.set_db(None)
    jdispatch.set_db(None)


@pytest.fixture
def margins(monkeypatch):
    """Records every port routing's smallest k-th to (k+1)-th gap; the
    test asserts the precondition after its runs (``_assert_margins``)."""
    seen = []
    route = tmoe._route

    def recording(params, cfg, xg):
        out = route(params, cfg, xg)
        top = torch.sort(out[0], dim=-1, descending=True).values
        seen.append(float((top[..., cfg.top_k - 1] - top[..., cfg.top_k]).min()))
        return out

    monkeypatch.setattr(tmoe, "_route", recording)
    return seen


def _assert_margins(seen):
    assert seen, "no routing ran"
    assert min(seen) > MARGIN_MIN, (
        f"precondition: routing margins {min(seen):.3e} <= {MARGIN_MIN}")


def _sparsity(fmt, jax_side):
    kw = FORMATS[fmt]
    if kw is None:
        return None
    return JSparsityConfig(**kw) if jax_side else SparsityConfig(**kw)


@functools.lru_cache(maxsize=None)
def _jarch(arch):
    """The arch whose JAX smoke config stands for ``arch``'s.  The two smoke
    configs differ only in ``name`` and ``source``, which no JAX function
    reads (``test_configs_match_jax`` holds the other fields), so the JAX
    side of a moonshot case runs olmoe-1b-7b's config: one JAX init and one
    set of compiled functions for both archs, the slowest steps here."""
    def strip(a):
        return dataclasses.replace(j_smoke_config(a), name="", source="")
    return ARCHS[0] if strip(arch) == strip(ARCHS[0]) else arch


def _jcfg(arch, fmt="compressed", **kw):
    cfg = j_smoke_config(_jarch(arch)).with_(**kw)
    sp = _sparsity(fmt, True)
    return cfg.with_(sparsity=sp) if sp else cfg


def _tcfg(arch, fmt="compressed", **kw):
    cfg = smoke_config(arch).with_(**kw)
    sp = _sparsity(fmt, False)
    return cfg.with_(sparsity=sp) if sp else cfg


@functools.lru_cache(maxsize=None)
def _params(arch):
    """JAX's params of the smoke model (``_jarch``: both archs share one
    draw)."""
    if _jarch(arch) != arch:
        return _params(_jarch(arch))
    jp, _ = jreg.init_params(_jcfg(arch), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, jp)


def _tparams(arch):
    return params_from_jax(_params(arch), device="cpu")


@functools.lru_cache(maxsize=None)
def _moe_params(fmt, act, seed=1):
    cfg = _jcfg("olmoe-1b-7b", fmt, mlp_act=act)
    jp = unbox_tree(jmoe.moe_init(jax.random.PRNGKey(seed), cfg))[0]
    return jax.tree_util.tree_map(np.asarray, jp)


def _ints(a):
    return torch.from_numpy(np.asarray(a, np.int32).copy())


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 503, shape).astype(np.int32)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _logits_close(got, want):
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= LOGIT_RTOL * float(np.abs(want).max()), err


def _cache_close(got, want, rows=None):
    for k in ("k", "v"):
        g, w = got[k].numpy(), np.asarray(want[k])
        if rows is not None:
            g, w = g[:, rows], w[:, rows]
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)


def _jax_route(router, cfg, xg):
    """JAX's routing, as ``repro.models.moe.moe_apply`` computes it."""
    logits = jnp.einsum("gtd,de->gte", xg, router.astype(xg.dtype),
                        preferred_element_type=jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    top_p, top_i = jax.lax.top_k(probs, cfg.top_k)
    top_p = top_p / jnp.maximum(top_p.sum(-1, keepdims=True), 1e-9)
    return probs, top_p, top_i


# ---------------------------------------------------------------------------
# Configs, capacity, init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    """Field for field, ``source`` included, at the published and the smoke
    size; the MoE fields keep JAX's defaults."""
    assert arch in list_archs()
    for mine, theirs in ((get_config(arch), j_get_config(arch)),
                         (smoke_config(arch), j_smoke_config(arch))):
        for f in dataclasses.fields(mine):
            if f.name != "sparsity":
                assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
        for prop in ("resolved_head_dim", "padded_heads", "padded_vocab",
                     "is_moe"):
            assert getattr(mine, prop) == getattr(theirs, prop), prop
    cfg = get_config(arch)
    assert (cfg.capacity_factor, cfg.dp) == (1.25, 1)
    assert (smoke_config(arch).n_experts, smoke_config(arch).top_k) == (4, 2)


def test_moe_capacity_matches_jax():
    base = get_config("olmoe-1b-7b")
    jbase = j_get_config("olmoe-1b-7b")
    for e, k in ((4, 2), (64, 8), (64, 6), (8, 1), (16, 16)):
        for cf in (0.25, 1.0, 1.25, 2.0):
            for n in (1, 3, 4, 8, 33, 64, 255, 256, 1024, 4096):
                kw = dict(n_experts=e, top_k=k, capacity_factor=cf)
                got = tmoe.moe_capacity(n, base.with_(**kw))
                assert got == jmoe.moe_capacity(n, jbase.with_(**kw)), (n, kw)
                assert got % 8 == 0 and got >= 8


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_moe_init_tree_matches_jax_leaf_for_leaf(fmt, param_dtype):
    """Names, shapes, dtypes; the expert leaves stacked [E, ...] and the
    router float32 whatever ``param_dtype`` is."""
    jcfg = _jcfg("olmoe-1b-7b", fmt, param_dtype=param_dtype)
    tcfg = _tcfg("olmoe-1b-7b", fmt, param_dtype=param_dtype)
    jp = jax.eval_shape(
        lambda: unbox_tree(jmoe.moe_init(jax.random.PRNGKey(0), jcfg))[0])
    tp = tmoe.moe_init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = {keystr(p): v for p, v in leaves_with_path(tp)}
    assert sorted(tflat) == sorted(jax.tree_util.keystr(p) for p, _ in jflat)
    for path, leaf in jflat:
        t = tflat[jax.tree_util.keystr(path)]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).replace("torch.", "") == str(leaf.dtype), path
    assert tp["router"].dtype == torch.float32
    assert tuple(tp["router"].shape) == (64, 4)
    if fmt == "compressed":
        assert tuple(tp["gate"]["values"].shape[:1]) == (4,)
        assert tp["gate"]["idx"].dtype == torch.int32


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_init_tree_matches_jax_leaf_for_leaf(arch):
    jp = jax.eval_shape(lambda: unbox_tree(
        jlm.lm_init(_jcfg(arch), jax.random.PRNGKey(0)))[0])
    tp = tlm.lm_init(_tcfg(arch), 0, device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = {keystr(p): v for p, v in leaves_with_path(tp)}
    assert sorted(tflat) == sorted(jax.tree_util.keystr(p) for p, _ in jflat)
    for path, leaf in jflat:
        t = tflat[jax.tree_util.keystr(path)]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).replace("torch.", "") == str(leaf.dtype), path
    assert "mlp" not in tp["layers"]
    assert tuple(tp["layers"]["moe"]["down"]["values"].shape[:2]) == (2, 4)


# ---------------------------------------------------------------------------
# Routing and dispatch
# ---------------------------------------------------------------------------


def test_routing_matches_jax():
    """``top_i`` equal, ``top_p`` within 1e-6, and the aux loss within
    ``AUX_TOL`` over two groups; the inputs' margins asserted first."""
    dp = 2
    jcfg = _jcfg("olmoe-1b-7b", dp=dp)
    tcfg = _tcfg("olmoe-1b-7b", dp=dp)
    jp = _moe_params("compressed", "swiglu")
    tp = params_from_jax(jp, device="cpu")
    x = _x((4, 16, 64), 10)
    xg = x.reshape(dp, -1, 64)
    jprobs, jtop_p, jtop_i = _jax_route(jnp.asarray(jp["router"]), jcfg,
                                        jnp.asarray(xg))
    probs, top_p, top_i = tmoe._route(tp, tcfg, torch.from_numpy(xg))
    srt = np.sort(np.asarray(jprobs), axis=-1)[..., ::-1]
    assert (srt[..., 1] - srt[..., 2]).min() > MARGIN_MIN  # precondition
    assert np.array_equal(top_i.numpy(), np.asarray(jtop_i))
    np.testing.assert_allclose(top_p.numpy(), np.asarray(jtop_p), atol=1e-6)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-6)
    _, jaux = jmoe.moe_apply(jp, jcfg, jnp.asarray(x))
    _, taux = tmoe.moe_apply(tp, tcfg, torch.from_numpy(x))
    assert abs(float(taux) - float(jaux)) <= AUX_TOL


def test_routing_ties_take_the_lower_expert_first():
    """A zero router gives every expert the same probability: both packages
    pick experts 0 and 1, in that order, with weights 1/2."""
    tcfg = _tcfg("olmoe-1b-7b")
    tp = {"router": torch.zeros((64, 4))}
    _, top_p, top_i = tmoe._route(tp, tcfg, torch.from_numpy(_x((1, 5, 64), 0)))
    _, jtop_p, jtop_i = _jax_route(jnp.zeros((64, 4)), _jcfg("olmoe-1b-7b"),
                                   jnp.asarray(_x((1, 5, 64), 0)))
    assert np.array_equal(top_i.numpy(), np.asarray(jtop_i))
    assert np.array_equal(top_i.numpy(), np.tile([0, 1], (1, 5, 1)))
    assert np.array_equal(top_p.numpy(), np.asarray(jtop_p))


@pytest.mark.parametrize("cf,dp", [(1.25, 1), (0.25, 1), (1.25, 2), (0.25, 2)],
                         ids=["cf1.25", "cf0.25-drops", "dp2", "dp2-drops"])
def test_dispatch_group_bit_exact_on_jax_routing(cf, dp):
    """The port's dispatch fed JAX's own ``top_i``: ``e_flat``, ``pos``,
    ``keep`` and the buffer equal bit for bit (a dropped assignment adds
    nothing to JAX's buffer and never reaches the port's)."""
    jcfg = _jcfg("olmoe-1b-7b", capacity_factor=cf)
    x = _x((dp, 64, 64), 11)
    rng = np.random.default_rng(12)
    top_i = np.stack([np.stack([rng.choice(4, 2, replace=False)
                                for _ in range(64)]) for _ in range(dp)])
    top_p = rng.random((dp, 64, 2)).astype(np.float32)
    cap = jmoe.moe_capacity(64, jcfg)
    want = jax.vmap(lambda xx, ti, tp: jmoe._dispatch_group(
        xx, ti, tp, 4, cap, 2))(jnp.asarray(x), jnp.asarray(top_i, jnp.int32),
                                jnp.asarray(top_p))
    got = tmoe._dispatch_group(torch.from_numpy(x),
                               torch.from_numpy(top_i).long(), 4, cap, 2)
    for name, g, w in zip(("buf", "e_flat", "pos", "keep"), got, want):
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    n_dropped = int((~got[3]).sum())
    if cf < 1:
        assert n_dropped > 0
    else:
        assert n_dropped == 0
    kept = got[0].abs().sum(-1) > 0
    assert int(kept.sum()) == dp * 64 * 2 - n_dropped


@pytest.mark.parametrize("fmt,act,dp", [
    (fmt, act, 1) for fmt in FORMATS for act in ("swiglu", "sq_relu")] + [
    ("compressed", "swiglu", 2), ("compressed", "sq_relu", 2)])
def test_moe_apply_matches_jax(fmt, act, dp, margins):
    jcfg = _jcfg("olmoe-1b-7b", fmt, mlp_act=act, dp=dp)
    tcfg = _tcfg("olmoe-1b-7b", fmt, mlp_act=act, dp=dp)
    jp = _moe_params(fmt, act)
    tp = params_from_jax(jp, device="cpu")
    x = _x((2, 12, 64), 13)
    jy, jaux = jmoe.moe_apply(jp, jcfg, jnp.asarray(x))
    ty, taux = tmoe.moe_apply(tp, tcfg, torch.from_numpy(x))
    _assert_margins(margins)
    jy = np.asarray(jy)
    assert float(np.abs(ty.numpy() - jy).max()) <= MOE_RTOL * float(
        np.abs(jy).max())
    assert abs(float(taux) - float(jaux)) <= AUX_TOL


def test_moe_apply_drops_like_jax(margins):
    """capacity_factor 0.25 at 48 tokens: cap 8 of about 24 assignments an
    expert, so most are dropped, in both packages alike."""
    jcfg = _jcfg("olmoe-1b-7b", capacity_factor=0.25)
    tcfg = _tcfg("olmoe-1b-7b", capacity_factor=0.25)
    jp = _moe_params("compressed", "swiglu")
    x = _x((1, 48, 64), 14)
    jy, _ = jmoe.moe_apply(jp, jcfg, jnp.asarray(x))
    ty, _ = tmoe.moe_apply(params_from_jax(jp, device="cpu"), tcfg,
                           torch.from_numpy(x))
    _assert_margins(margins)
    jy = np.asarray(jy)
    assert float(np.abs(ty.numpy() - jy).max()) <= MOE_RTOL * float(
        np.abs(jy).max())
    assert int((np.abs(jy).sum(-1) == 0).sum()) > 0  # tokens dropped entirely


def test_shard_map_impl_without_a_mesh_is_moe_apply():
    """JAX's ``moe_apply_shard_map`` with no mesh equals the port's, which
    with no context is ``moe_apply`` too (the port's expert parallelism
    over a mesh: ``tests/test_torch_moe_train.py``)."""
    jp = _moe_params("compressed", "swiglu")
    x = _x((2, 6, 64), 15)
    tcfg = _tcfg("olmoe-1b-7b", moe_impl="shard_map")
    y, aux = tmoe.moe_apply_shard_map(params_from_jax(jp, device="cpu"),
                                      tcfg, torch.from_numpy(x))
    y0, aux0 = tmoe.moe_apply(params_from_jax(jp, device="cpu"), tcfg,
                              torch.from_numpy(x))
    assert torch.equal(y, y0) and torch.equal(aux, aux0)
    jcfg = _jcfg("olmoe-1b-7b", moe_impl="shard_map")
    jy, _ = jmoe.moe_apply_shard_map(jp, jcfg, jnp.asarray(x))
    jy = np.asarray(jy)
    assert float(np.abs(y.numpy() - jy).max()) <= MOE_RTOL * float(
        np.abs(jy).max())


# ---------------------------------------------------------------------------
# The smoke models: scoring
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,attn_impl", [
    ("olmoe-1b-7b", "naive"), ("olmoe-1b-7b", "chunked"),
    ("olmoe-1b-7b", "pallas"), ("moonshot-v1-16b-a3b", "pallas")])
def test_forward_and_loss_match_jax(arch, attn_impl, margins):
    """Logits, the loss and the aux (the mean of the layers' losses); under
    ``attn_impl="pallas"`` the port's flash wrapper runs its plain version,
    JAX its kernel in interpret mode."""
    kw = dict(attn_impl=attn_impl, attn_chunk=8)
    jcfg, tcfg = _jcfg(arch, **kw), _tcfg(arch, **kw)
    toks = _tokens((2, 24), 3)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": _ints(toks)}
    jl, jaux = jlm.lm_forward(_params(arch), jcfg, jb)
    jloss, jparts = jreg.loss_fn(jcfg)(_params(arch), jb)
    with torch.no_grad():
        tl, taux = tlm.lm_forward(_tparams(arch), tcfg, tb)
        tloss, tparts = treg.loss_fn(tcfg)(_tparams(arch), tb)
    _assert_margins(margins)
    _logits_close(tl, jl)
    assert abs(float(taux) - float(jaux)) <= AUX_TOL and float(taux) > 0
    assert abs(float(tparts["aux"]) - float(jparts["aux"])) <= AUX_TOL
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=F32_TOL)
    np.testing.assert_allclose(float(tparts["nll"]), float(jparts["nll"]),
                               rtol=F32_TOL)


# ---------------------------------------------------------------------------
# The smoke models: serving steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch, margins):
    jcfg, tcfg = _jcfg(arch), _tcfg(arch)
    toks = _tokens((2, 11), 0)
    jl, jc = jreg.prefill_fn(jcfg)(_params(arch), {"tokens": jnp.asarray(toks)})
    with dispatch.phase_scope("prefill"):
        tl, tc = treg.prefill_fn(tcfg)(_tparams(arch), {"tokens": _ints(toks)})
    _assert_margins(margins)
    assert tuple(tl.shape) == (2, 1, tcfg.padded_vocab)
    _logits_close(tl, jl)
    _cache_close(tc, jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_matches_jax(arch, margins):
    """An 11-token prompt in chunks of 4 (the last one padded) into a
    16-row cache; the middle chunk without logits."""
    jcfg, tcfg = _jcfg(arch), _tcfg(arch)
    toks = _tokens((2, 11), 1)
    jc = jreg.cache_init_fn(jcfg, 2, 16)()
    tc = treg.cache_init_fn(tcfg, 2, 16, "cpu")()
    for start in range(0, 11, 4):
        chunk = toks[:, start:start + 4]
        chunk = np.pad(chunk, ((0, 0), (0, 4 - chunk.shape[1])))
        with_logits = start != 4
        jl, jc = jreg.prefill_chunk_fn(jcfg)(
            _params(arch), jc, jnp.asarray(chunk),
            jnp.asarray(start, jnp.int32), with_logits)
        with dispatch.phase_scope("prefill"):
            tl, tc = treg.prefill_chunk_fn(tcfg)(_tparams(arch), tc,
                                                 _ints(chunk), start,
                                                 with_logits)
        if with_logits:
            _logits_close(tl, jl)
        else:
            assert tl is None and jl is None
    _assert_margins(margins)
    _cache_close(tc, jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch, margins):
    """Prefill, then three contiguous decode steps at a per-slot position
    (slot 2 parked at the cache's last row)."""
    jcfg, tcfg = _jcfg(arch), _tcfg(arch)
    toks = _tokens((3, 6), 2)
    engine = Engine(tcfg, _tparams(arch))
    jengine = JEngine(jcfg, _params(arch), JServeConfig())
    jl, jc = jengine.prefill_step(toks, 12)
    tl, tc = engine.prefill_step(toks, 12)
    _logits_close(tl, jl)
    _cache_close(tc, jc)
    pos = np.array([6, 3, 11], np.int32)
    feed = np.array([[5], [77], [400]], np.int32)
    for _ in range(3):
        jl, jc = jreg.decode_fn(jcfg)(_params(arch), jc, jnp.asarray(feed),
                                      jnp.asarray(pos))
        tl, tc = engine.decode_step(tc, feed, pos)
        _logits_close(tl, jl)
        _cache_close(tc, jc)
        feed = np.asarray(jnp.argmax(jl[:, -1, :503], -1), np.int32)[:, None]
        pos = np.minimum(pos + 1, 11).astype(np.int32)
    _assert_margins(margins)


@pytest.mark.parametrize("arch", ARCHS)
def test_packed_prefill_and_paged_decode_match_jax(arch, margins):
    """Packed prefill of three prompts (one group over the whole stream),
    then four paged decode steps (one slot inactive on the trash page)."""
    ps = 4
    jcfg, tcfg = _jcfg(arch), _tcfg(arch)
    jp, tp = _params(arch), _tparams(arch)
    prompts = [np.array([5, 17, 400, 3, 99], np.int32),
               np.arange(1, 10, dtype=np.int32),
               np.array([77, 502, 0], np.int32)]
    packed = jkp.pack_prompts(prompts, [0, 1, 2])
    pool = jkp.PagePool(32 // ps * 4, ps)
    for s, p in enumerate(prompts):
        pool.alloc(s, len(p) + 6)
    tables = pool.table_array(4, -(-16 // ps))
    jcache = jreg.paged_cache_init_fn(jcfg, pool.n_pages, ps)()
    tcache = treg.paged_cache_init_fn(tcfg, pool.n_pages, ps, "cpu")()
    args = (packed.tokens, packed.slot_ids, packed.positions, tables,
            packed.last_idx)
    jl, jcache = jreg.prefill_packed_fn(jcfg, ps)(
        jp, jcache, *(jnp.asarray(a) for a in args))
    with dispatch.phase_scope("prefill"):
        tl, tcache = treg.prefill_packed_fn(tcfg, ps)(
            tp, tcache, *(_ints(a) for a in args))
    _logits_close(tl, jl)
    pos = np.array([len(p) for p in prompts] + [0], np.int32)
    toks = np.array([[3], [9], [500], [0]], np.int32)
    for _ in range(4):
        jl, jcache = jreg.paged_decode_fn(jcfg, ps)(
            jp, jcache, jnp.asarray(toks), jnp.asarray(pos),
            jnp.asarray(tables))
        with dispatch.phase_scope("decode"):
            tl, tcache = treg.paged_decode_fn(tcfg, ps)(
                tp, tcache, _ints(toks), _ints(pos), _ints(tables))
        _logits_close(tl, jl)
        toks = np.asarray(jnp.argmax(jl[:, -1, :503], -1), np.int32)[:, None]
        pos[:3] += 1
    _assert_margins(margins)
    _cache_close(tcache, jcache, rows=np.asarray(tables[:3]).reshape(-1))


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_params_tokens_match_jax(arch):
    """The expert stacks get plan tokens in both packages (``plan_params``
    reads ``values.shape[-3:]``), though no expert call dispatches."""
    hints = {"prefill": 64, "decode": 4}
    want = jdispatch.plan_params(_params(arch), phase_hints=hints)
    got = dispatch.plan_params(_tparams(arch), phase_hints=hints)
    assert sorted(got) == sorted(want)
    assert len(got) > 2 * 2  # the attention linears' tokens and the experts'


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_equals_jax(arch, margins):
    toks = _tokens((3, 7), 5)
    want = JEngine(_jcfg(arch), _params(arch),
                   JServeConfig(max_new_tokens=6)).generate(toks)
    got = Engine(_tcfg(arch), _tparams(arch),
                 ServeConfig(max_new_tokens=6)).generate(toks)
    _assert_margins(margins)
    assert np.array_equal(got["tokens"], np.asarray(want["tokens"]))
    assert np.array_equal(got["gen_lens"], np.asarray(want["gen_lens"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_scheduler_tokens_equal_jax(arch, margins):
    kw = dict(seed=3, vocab=503, prompt_lens=(3, 14), new_tokens=(2, 8))
    jsched = JScheduler(JEngine(_jcfg(arch), _params(arch), JServeConfig()),
                        n_slots=3, paged=True, page_size=8)
    want = {c.uid: c for c in jsched.run(j_synthetic_trace(5, **kw))}
    sched = Scheduler(Engine(_tcfg(arch), _tparams(arch)), n_slots=3,
                      paged=True, page_size=8)
    got = {c.uid: c for c in sched.run(synthetic_trace(5, **kw))}
    _assert_margins(margins)
    assert sorted(got) == sorted(want) == list(range(5))
    for uid, c in got.items():
        assert c.status == want[uid].status == "ok"
        assert np.array_equal(c.tokens, want[uid].tokens), uid
    assert all(k.launches == 0 for k in KERNELS)


# ---------------------------------------------------------------------------
# Training: the LM Trainer resumes an MoE model bit for bit
# ---------------------------------------------------------------------------


def test_trainer_refuses_moe_naming_the_item(tmp_path):
    """MoE training (ROADMAP item 10d; the name is kept from when the port
    refused it): the LM ``Trainer`` on the smoke olmoe-1b-7b (JAX's
    converted params, compressed experts), 4 steps with a checkpoint at
    step 2, and a run restored from it repeats steps 3 and 4 bit for bit
    (losses, params and optimizer state), with one intra-op thread as
    ``tests/test_torch_train.py`` resumes.  Each step's aux is positive.
    (The step against JAX's: ``tests/test_torch_moe_train.py``.)"""
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer

    cfg = _tcfg("olmoe-1b-7b")
    data = DataConfig(vocab_size=cfg.vocab_size, batch=2, seq_len=8)

    def trainer(d, steps):
        return Trainer(cfg, data, AdamWConfig(),
                       TrainConfig(steps=steps, ckpt_dir=str(tmp_path / d),
                                   ckpt_every=2, log_every=1),
                       params=_tparams("olmoe-1b-7b"), device="cpu")

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ta = trainer("a", 4)
        out_a = ta.run()
        trainer("b", 2).run()
        tc = trainer("b", 4)
        out_c = tc.run()
    finally:
        torch.set_num_threads(n)
    assert out_c["start_step"] == 2 and out_c["final_step"] == 4
    assert all(h["aux"] > 0 for h in out_a["history"])
    assert [h["loss"] for h in out_a["history"][2:]] == [
        h["loss"] for h in out_c["history"]]
    for a, c in zip(leaves_with_path((ta.params, ta.opt_state)),
                    leaves_with_path((tc.params, tc.opt_state)), strict=True):
        assert a[0] == c[0] and torch.equal(a[1], c[1]), keystr(a[0])


@pytest.mark.parametrize("extra", [[], ["--continuous", "--paged"]],
                         ids=["static", "continuous-paged"])
def test_serve_launcher_runs_moe(capsys, extra):
    """``python -m repro_torch.launch.serve --arch olmoe-1b-7b --smoke``:
    the static and the continuous paged launcher serve the MoE model."""
    from repro_torch.launch import serve as launch_serve

    launch_serve.main(["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--new-tokens", "4", "--requests", "3",
                       "--slots", "2", "--prompt-len", "8"] + extra)
    out = capsys.readouterr().out
    assert "arch=olmoe-1b-7b" in out
    assert ("status: ok=3" in out) if extra else ("seq1:" in out)
