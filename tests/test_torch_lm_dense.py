"""The dense-LM widening of the port against the JAX package, on the CPU:
LayerNorm, the squared-ReLU and GELU MLPs, the untied unembedding, and the
qwen2-7b and nemotron-4-15b configs at their smoke size with every linear
compressed (sparsity 0.5, ``min_dim=16``), plus a GELU variant.  Checked:
the configs field for field, the init tree leaf for leaf (names, shapes,
dtypes), the scoring logits and loss under every ``attn_impl``, prefill,
chunked prefill, contiguous and paged decode, greedy generation and the
paged scheduler's tokens, ``params_from_jax`` and checkpoints of an
untied LayerNorm model in both directions, bit for bit.  Logits are held
within 1e-4 of max|logit| and caches within 1e-5 (the same sums in
another order); norms and MLPs within 1e-5 in f32 and 2e-2 in bf16.
Inputs come from numpy seeds; params come from JAX through
``params_from_jax``."""
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
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models import mlp as jmlp
from repro.models import registry as jreg
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.serve import Engine as JEngine
from repro.serve import Scheduler as JScheduler
from repro.serve import ServeConfig as JServeConfig
from repro.serve import kv_pages as jkp
from repro.serve import synthetic_trace as j_synthetic_trace
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch import dispatch
from repro_torch._tree import keystr, leaves_with_path, tree_map
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.pruning import SparsityConfig
from repro_torch.kernels import KERNELS
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models import mlp as tmlp
from repro_torch.models import registry as treg
from repro_torch.serve import Engine, Scheduler, ServeConfig, synthetic_trace
from repro_torch.train.checkpoint import CheckpointManager

SPARSE = dict(sparsity=0.5, m=None, tile=None, min_dim=16,
              format="compressed_pallas")
LOGIT_RTOL = 1e-4  # of max|logit|
F32_TOL = 1e-5
BF16_TOL = 2e-2
# (arch, overrides): the two new configs, and GELU on qwen2-7b's untied
# RMSNorm body
CASES = {"qwen2-7b": ("qwen2-7b", {}),
         "nemotron-4-15b": ("nemotron-4-15b", {}),
         "qwen2-7b-gelu": ("qwen2-7b", {"mlp_act": "gelu"})}
NEW_ARCHS = ("qwen2-7b", "nemotron-4-15b")


@pytest.fixture(autouse=True)
def dbs(tmp_path):
    dispatch.set_db(dispatch.ProfileDB(path=tmp_path / "profile.json"))
    jdispatch.set_db(jdispatch.ProfileDB(path=str(tmp_path / "jax.json")))
    yield
    dispatch.set_db(None)
    jdispatch.set_db(None)


def _jcfg(case, sparse=True, **kw):
    arch, over = CASES[case]
    cfg = j_smoke_config(arch).with_(**over, **kw)
    return cfg.with_(sparsity=JSparsityConfig(**SPARSE)) if sparse else cfg


def _tcfg(case, sparse=True, **kw):
    arch, over = CASES[case]
    cfg = smoke_config(arch).with_(**over, **kw)
    return cfg.with_(sparsity=SparsityConfig(**SPARSE)) if sparse else cfg


@functools.lru_cache(maxsize=None)
def _params(case, sparse=True):
    jp, _ = jreg.init_params(_jcfg(case, sparse), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, jp)


def _tparams(case, sparse=True):
    return params_from_jax(_params(case, sparse), device="cpu")


def _ints(a):
    return torch.from_numpy(np.asarray(a, np.int32).copy())


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 503, shape).astype(np.int32)


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


# ---------------------------------------------------------------------------
# LayerNorm, the MLP activations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_matches_jax(kind, dtype):
    """A non-trivial scale and bias; the statistics in f32, the result in
    ``x``'s dtype."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 64)) * 3 + 0.5).astype(np.float32)
    p = {"scale": rng.standard_normal(64).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = rng.standard_normal(64).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    jy = jcommon.norm_apply({k: jnp.asarray(v) for k, v in p.items()}, jx, kind)
    ty = tcommon.norm_apply({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x).to(getattr(torch, dtype)),
                            kind)
    assert str(ty.dtype) == f"torch.{dtype}"
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_init_matches_jax(kind):
    jp = unbox_tree(jcommon.norm_init(48, kind))[0]
    tp = tcommon.norm_init(48, kind, device="cpu")
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert np.array_equal(tp[k].numpy(), np.asarray(jp[k])), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_is_jax_tanh_approximation(dtype):
    """``F.gelu(approximate="tanh")`` against ``jax.nn.gelu(approximate=
    True)`` over the whole range, large magnitudes included."""
    x = np.concatenate([np.linspace(-12, 12, 4001),
                        np.random.default_rng(1).standard_normal(4000) * 4,
                        [-1e4, -60.0, 0.0, 60.0, 1e4]]).astype(np.float32)
    jy = jax.nn.gelu(jnp.asarray(x, dtype), approximate=True)
    ty = torch.nn.functional.gelu(torch.from_numpy(x).to(getattr(torch, dtype)),
                                  approximate="tanh")
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "pruned"])
@pytest.mark.parametrize("act", ["swiglu", "sq_relu", "gelu"])
def test_mlp_matches_jax(act, sparse):
    """JAX's leaf set (no ``gate`` but for SwiGLU) and its output."""
    jcfg = _jcfg("qwen2-7b", sparse, mlp_act=act)
    tcfg = _tcfg("qwen2-7b", sparse, mlp_act=act)
    jp = unbox_tree(jmlp.mlp_init(jax.random.PRNGKey(3), jcfg))[0]
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    want = ({"gate", "up", "down"} if act == "swiglu" else {"up", "down"})
    assert set(jp) == set(tmlp.mlp_init(torch.Generator(), tcfg, "cpu")) == want
    x = np.random.default_rng(2).standard_normal((2, 7, 64)).astype(np.float32)
    jy = jmlp.mlp_apply(jp, jcfg, jnp.asarray(x))
    ty = tmlp.mlp_apply(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("act", ["swiglu", "sq_relu", "gelu"])
def test_mlp_init_d_ff_override_matches_jax(act):
    jcfg, tcfg = _jcfg("qwen2-7b", mlp_act=act), _tcfg("qwen2-7b", mlp_act=act)
    jp = jax.eval_shape(
        lambda: unbox_tree(jmlp.mlp_init(jax.random.PRNGKey(0), jcfg, 160))[0])
    tp = tmlp.mlp_init(torch.Generator().manual_seed(0), tcfg, "cpu", d_ff=160)
    jflat = {jax.tree_util.keystr(p): v
             for p, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tflat = {keystr(p): v for p, v in leaves_with_path(tp)}
    assert sorted(tflat) == sorted(jflat)
    for k, leaf in jflat.items():
        assert tuple(tflat[k].shape) == leaf.shape, k
    with pytest.raises(ValueError, match="mlp_act"):
        tmlp.mlp_init(torch.Generator(), tcfg.with_(mlp_act="relu"), "cpu")


# ---------------------------------------------------------------------------
# Configs and params
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_match_jax(arch):
    """Field for field, ``source`` included, at the published and the smoke
    size, and the derived sizes."""
    assert arch in list_archs()
    for mine, theirs in ((get_config(arch), j_get_config(arch)),
                         (smoke_config(arch), j_smoke_config(arch))):
        for f in dataclasses.fields(mine):
            if f.name != "sparsity":
                assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
        for prop in ("resolved_head_dim", "padded_heads", "padded_vocab",
                     "is_moe"):
            assert getattr(mine, prop) == getattr(theirs, prop), prop
    assert not get_config(arch).tie_embeddings


@pytest.mark.parametrize("sparse", [True, False], ids=["pruned", "dense"])
@pytest.mark.parametrize("case", list(CASES))
def test_lm_init_tree_matches_jax_leaf_for_leaf(case, sparse):
    """Names, shapes and dtypes, the ``unembed`` and LayerNorm ``bias``
    leaves included; the port's own draw puts ``unembed`` at N(0, 0.02^2)
    and the norms at ones and zeros."""
    jp = jax.eval_shape(lambda: unbox_tree(
        jlm.lm_init(_jcfg(case, sparse), jax.random.PRNGKey(0)))[0])
    tp = tlm.lm_init(_tcfg(case, sparse), 0, device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = {keystr(p): v for p, v in leaves_with_path(tp)}
    assert sorted(tflat) == sorted(jax.tree_util.keystr(p) for p, _ in jflat)
    for path, leaf in jflat:
        t = tflat[jax.tree_util.keystr(path)]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).replace("torch.", "") == str(leaf.dtype), path
    cfg = _tcfg(case, sparse)
    assert "unembed" in tp and tuple(tp["unembed"].shape) == (
        cfg.d_model, cfg.padded_vocab)
    assert abs(float(tp["unembed"].std()) - 0.02) < 2e-3
    if cfg.norm == "layernorm":
        for ln in ("ln1", "ln2"):
            assert not tp["layers"][ln]["bias"].any()
        assert not tp["final_norm"]["bias"].any()
    # tied: no unembed leaf, as in JAX
    tied = tlm.lm_init(cfg.with_(tie_embeddings=True), 0, device="cpu")
    assert "unembed" not in tied


@pytest.mark.parametrize("case", list(CASES))
def test_params_from_jax_carries_unembed_and_bias(case):
    jp, tp = _params(case), _tparams(case)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == len(leaves_with_path(tp))
    for path, leaf in flat:
        t = tp
        for k in path:
            t = t[k.key]
        assert np.array_equal(t.numpy(), leaf), path
    assert np.array_equal(tp["unembed"].numpy(), jp["unembed"])
    if CASES[case][0] == "nemotron-4-15b":
        assert np.array_equal(tp["layers"]["ln1"]["bias"].numpy(),
                              jp["layers"]["ln1"]["bias"])


# ---------------------------------------------------------------------------
# Scoring
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attn_impl", ["naive", "chunked", "pallas"])
@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_loss_match_jax(case, attn_impl):
    """The scoring logits and the loss (padded-vocab masking included);
    under ``attn_impl="pallas"`` the port's flash wrapper runs its plain
    version, JAX its kernel in interpret mode."""
    kw = dict(attn_impl=attn_impl, attn_chunk=8)
    jcfg, tcfg = _jcfg(case, **kw), _tcfg(case, **kw)
    toks = _tokens((2, 24), 3)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": _ints(toks)}
    jl = jreg.forward_fn(jcfg)(_params(case), jb)
    jloss, jaux = jreg.loss_fn(jcfg)(_params(case), jb)
    with torch.no_grad():
        tl = treg.forward_fn(tcfg)(_tparams(case), tb)
        tloss, taux = treg.loss_fn(tcfg)(_tparams(case), tb)
    assert tuple(tl.shape) == (2, 24, tcfg.padded_vocab)
    _logits_close(tl, jl)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=F32_TOL)
    np.testing.assert_allclose(float(taux["nll"]), float(jaux["nll"]),
                               rtol=F32_TOL)


def test_loss_differentiates_through_unembed_and_bias():
    """Every float leaf of an untied LayerNorm model gets a gradient."""
    from repro_torch._tree import value_and_grad

    cfg = _tcfg("nemotron-4-15b")
    (loss, _), grads = value_and_grad(
        lambda p: treg.loss_fn(cfg)(p, {"tokens": _ints(_tokens((2, 8), 4))}),
        _tparams("nemotron-4-15b"))
    assert torch.isfinite(loss)
    assert float(grads["unembed"].abs().sum()) > 0
    assert float(grads["layers"]["ln2"]["bias"].abs().sum()) > 0
    assert float(grads["final_norm"]["bias"].abs().sum()) > 0


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_matches_jax(case):
    jcfg, tcfg = _jcfg(case), _tcfg(case)
    toks = _tokens((2, 11), 0)
    jl, jc = jreg.prefill_fn(jcfg)(_params(case), {"tokens": jnp.asarray(toks)})
    with dispatch.phase_scope("prefill"):
        tl, tc = treg.prefill_fn(tcfg)(_tparams(case), {"tokens": _ints(toks)})
    assert tuple(tl.shape) == (2, 1, tcfg.padded_vocab)
    _logits_close(tl, jl)
    _cache_close(tc, jc)


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_chunk_matches_jax(case):
    """An 11-token prompt in chunks of 4 (the last one padded) into a
    16-row cache; the middle chunk without logits."""
    jcfg, tcfg = _jcfg(case), _tcfg(case)
    toks = _tokens((2, 11), 1)
    jc = jreg.cache_init_fn(jcfg, 2, 16)()
    tc = treg.cache_init_fn(tcfg, 2, 16, "cpu")()
    for start in range(0, 11, 4):
        chunk = toks[:, start:start + 4]
        chunk = np.pad(chunk, ((0, 0), (0, 4 - chunk.shape[1])))
        with_logits = start != 4
        jl, jc = jreg.prefill_chunk_fn(jcfg)(
            _params(case), jc, jnp.asarray(chunk),
            jnp.asarray(start, jnp.int32), with_logits)
        with dispatch.phase_scope("prefill"):
            tl, tc = treg.prefill_chunk_fn(tcfg)(_tparams(case), tc,
                                                 _ints(chunk), start,
                                                 with_logits)
        if with_logits:
            _logits_close(tl, jl)
        else:
            assert tl is None and jl is None
    _cache_close(tc, jc)


@pytest.mark.parametrize("per_slot", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_decode_step_matches_jax(case, per_slot):
    """Prefill, then three contiguous decode steps at a scalar or a [B]
    position (slot 2 parked at the cache's last row)."""
    jcfg, tcfg = _jcfg(case), _tcfg(case)
    toks = _tokens((3, 6), 2)
    engine = Engine(tcfg, _tparams(case))
    jengine = JEngine(jcfg, _params(case), JServeConfig())
    jl, jc = jengine.prefill_step(toks, 12)
    tl, tc = engine.prefill_step(toks, 12)
    _logits_close(tl, jl)
    _cache_close(tc, jc)
    pos = np.array([6, 3, 11], np.int32) if per_slot else np.int32(6)
    feed = np.array([[5], [77], [400]], np.int32)
    for _ in range(3):
        jl, jc = jreg.decode_fn(jcfg)(_params(case), jc, jnp.asarray(feed),
                                      jnp.asarray(pos))
        tl, tc = engine.decode_step(tc, feed, pos)
        _logits_close(tl, jl)
        _cache_close(tc, jc)
        feed = np.asarray(jnp.argmax(jl[:, -1, :503], -1), np.int32)[:, None]
        pos = np.minimum(pos + 1, 11).astype(np.int32)


@pytest.mark.parametrize("ps", [4, 8])
@pytest.mark.parametrize("case", list(CASES))
def test_packed_prefill_and_paged_decode_match_jax(case, ps):
    """Packed prefill of three prompts, then four paged decode steps (one
    slot inactive on the trash page)."""
    jcfg, tcfg = _jcfg(case), _tcfg(case)
    jp, tp = _params(case), _tparams(case)
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
    assert tuple(tl.shape) == (3, 1, tcfg.padded_vocab)
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
    _cache_close(tcache, jcache, rows=np.asarray(tables[:3]).reshape(-1))


@pytest.mark.parametrize("case", list(CASES))
def test_generate_greedy_equals_jax(case):
    toks = _tokens((3, 7), 5)
    want = JEngine(_jcfg(case), _params(case),
                   JServeConfig(max_new_tokens=6)).generate(toks)
    got = Engine(_tcfg(case), _tparams(case),
                 ServeConfig(max_new_tokens=6)).generate(toks)
    assert np.array_equal(got["tokens"], np.asarray(want["tokens"]))
    assert np.array_equal(got["gen_lens"], np.asarray(want["gen_lens"]))


@pytest.mark.parametrize("case", list(CASES))
def test_paged_scheduler_tokens_equal_jax(case):
    kw = dict(seed=3, vocab=503, prompt_lens=(3, 14), new_tokens=(2, 8))
    jsched = JScheduler(JEngine(_jcfg(case), _params(case), JServeConfig()),
                        n_slots=3, paged=True, page_size=8)
    want = {c.uid: c for c in jsched.run(j_synthetic_trace(5, **kw))}
    sched = Scheduler(Engine(_tcfg(case), _tparams(case)), n_slots=3,
                      paged=True, page_size=8)
    got = {c.uid: c for c in sched.run(synthetic_trace(5, **kw))}
    assert sorted(got) == sorted(want) == list(range(5))
    for uid, c in got.items():
        assert c.status == want[uid].status == "ok"
        assert np.array_equal(c.tokens, want[uid].tokens), uid
    assert all(k.launches == 0 for k in KERNELS)


# ---------------------------------------------------------------------------
# Checkpoints of an untied LayerNorm model, both ways
# ---------------------------------------------------------------------------


def _bits(t):
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


@functools.lru_cache(maxsize=None)
def _jax_untied_trees():
    """Smoke nemotron-4-15b (LayerNorm, untied, squared ReLU; compressed
    linears) and its AdamW state after one update, numpy leaves."""
    cfg = _jcfg("nemotron-4-15b")
    params, _ = jreg.init_params(cfg, jax.random.PRNGKey(1))
    opt = j_adamw_init(params)
    rng = np.random.default_rng(6)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype)
        if jnp.issubdtype(p.dtype, jnp.floating)
        else np.zeros(p.shape, jax.dtypes.float0), params)
    params, opt, _ = j_adamw_update(params, grads, opt, JAdamWConfig())
    tree = {"params": params, "opt": opt}
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_port_equals_jax(port_tree, jax_tree):
    jl = jax.tree_util.tree_leaves_with_path(jax_tree)
    tl = leaves_with_path(port_tree)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [
        keystr(p) for p, _ in tl]
    for (path, a), (_, t) in zip(jl, tl):
        assert str(t.dtype) == f"torch.{a.dtype.name}", path
        assert _bits(t) == np.ascontiguousarray(a).tobytes(), path


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_untied_layernorm_checkpoint_restores_bit_for_bit(tmp_path, direction):
    jtrees = _jax_untied_trees()
    assert "unembed" in jtrees["params"]
    assert "bias" in jtrees["params"]["final_norm"]
    trees = {k: params_from_jax(v, device="cpu") for k, v in jtrees.items()}
    if direction == "jax_to_port":
        JCheckpointManager(tmp_path).save(3, jtrees, metadata={"tag": "jax"})
        zeroed = {k: tree_map(torch.zeros_like, v) for k, v in trees.items()}
        out, meta = CheckpointManager(tmp_path).restore(None, zeroed)
        assert meta["tag"] == "jax" and meta["step"] == 3
        for k in jtrees:
            _assert_port_equals_jax(out[k], jtrees[k])
    else:
        CheckpointManager(tmp_path).save(4, trees, metadata={"tag": "port"})
        jmgr = JCheckpointManager(tmp_path)
        assert jmgr.validate(jmgr.dir / "step_00000004", deep=True) is None
        out, meta = jmgr.restore(None, jtrees)
        assert meta["tag"] == "port" and meta["step"] == 4
        for k in jtrees:
            for a, b in zip(jax.tree_util.tree_leaves(out[k]),
                            jax.tree_util.tree_leaves(jtrees[k])):
                a, b = np.asarray(a), np.asarray(b)
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
