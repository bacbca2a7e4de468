"""The port's paged serving path against the JAX package's, on the CPU, at
the smoke size of smollm-360m with every linear compressed (sparsity 0.5,
``min_dim=16``, so the compressed layers and their dispatch run): configs,
the stacked-layers tree and its conversion, the blocks, packed prefill and
paged decode logits (1e-4 of max|logit|, the limit resnet-tiny uses: the
same sums in another order), the page and slot pools (exact), the engine,
and the paged scheduler's greedy tokens per request (identical).  Inputs
come from numpy seeds; params come from JAX through ``params_from_jax``."""
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
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.models import registry as jreg
from repro.serve import Engine as JEngine
from repro.serve import Scheduler as JScheduler
from repro.serve import ServeConfig as JServeConfig
from repro.serve import kv_pages as jkp
from repro.serve import kv_slots as jks
from repro.serve import synthetic_trace as j_synthetic_trace
from repro_torch import dispatch
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.pruning import SparsityConfig
from repro_torch.kernels import KERNELS
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm
from repro_torch.models import registry as treg
from repro_torch.serve import (
    Engine,
    PageError,
    PagePool,
    RequestQueue,
    Scheduler,
    ServeConfig,
    SlotError,
    SlotPool,
    latency_percentiles,
    pack_prompts,
    synthetic_trace,
)
from repro_torch.serve import Request

SPARSE = dict(sparsity=0.5, m=None, tile=None, min_dim=16,
              format="compressed_pallas")
LOGIT_RTOL = 1e-4  # of max|logit|
F32_TOL = 1e-5


@pytest.fixture(autouse=True)
def dbs(tmp_path):
    dispatch.set_db(dispatch.ProfileDB(path=tmp_path / "profile.json"))
    jdispatch.set_db(jdispatch.ProfileDB(path=str(tmp_path / "jax.json")))
    yield
    dispatch.set_db(None)
    jdispatch.set_db(None)


def _t(a):
    return torch.from_numpy(np.array(a))


def _ints(a):
    return torch.from_numpy(np.asarray(a, np.int32).copy())


def _jcfg():
    return j_smoke_config("smollm-360m").with_(sparsity=JSparsityConfig(**SPARSE))


def _tcfg():
    return smoke_config("smollm-360m").with_(sparsity=SparsityConfig(**SPARSE))


@functools.lru_cache(maxsize=None)
def _params(seed=0):
    jp, _ = jreg.init_params(_jcfg(), jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, jp)


def _tparams(seed=0):
    return params_from_jax(_params(seed), device="cpu")


def _logits_close(got, want):
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= LOGIT_RTOL * float(np.abs(want).max()), err


# ---------------------------------------------------------------------------
# Configs, params, conversion
# ---------------------------------------------------------------------------


def test_configs_match_jax():
    for name in ("smollm-360m", "qwen2-0.5b", "zamba2-7b", "xlstm-350m",
                 "whisper-small", "qwen2-vl-72b"):
        for mine, theirs in ((get_config(name), j_get_config(name)),
                             (smoke_config(name), j_smoke_config(name))):
            for f in dataclasses.fields(mine):
                if f.name != "sparsity":
                    assert getattr(mine, f.name) == getattr(theirs, f.name), (
                        name, f.name)
            for prop in ("resolved_head_dim", "padded_heads", "padded_vocab"):
                assert getattr(mine, prop) == getattr(theirs, prop), prop
    assert get_config("smollm-360m").padded_heads == 15
    for get in (get_config, j_get_config):
        with pytest.raises(KeyError, match="unknown arch"):
            get("no-such-arch")


@pytest.mark.parametrize("sparse", [True, False])
def test_lm_init_tree_matches_jax_leaf_for_leaf(sparse):
    """The stacked-layers layout: the same tree, shapes and dtypes."""
    jcfg = _jcfg() if sparse else j_smoke_config("smollm-360m")
    tcfg = _tcfg() if sparse else smoke_config("smollm-360m")
    jp = jax.eval_shape(
        lambda: unbox_tree(jlm.lm_init(jcfg, jax.random.PRNGKey(0)))[0])
    tp = tlm.lm_init(tcfg, 0, device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = {jax.tree_util.keystr(p): v
             for p, v in jax.tree_util.tree_flatten_with_path(tp)[0]}
    assert sorted(tflat) == sorted(jax.tree_util.keystr(p) for p, _ in jflat)
    for path, leaf in jflat:
        t = tflat[jax.tree_util.keystr(path)]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).replace("torch.", "") == str(leaf.dtype), path
    assert tp["layers"]["attn"]["q"]["values" if sparse else "w"].shape[0] == 2
    assert treg.init_params(tcfg, 0, device="cpu").keys() == tp.keys()


def test_params_from_jax_carries_the_lm_tree():
    jp, tp = _params(), _tparams()
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(tp))
    for path, leaf in flat:
        t = tp
        for k in path:
            t = t[k.key]
        assert t.dtype == {np.dtype("float32"): torch.float32,
                           np.dtype("int32"): torch.int32}[leaf.dtype]
        assert np.array_equal(t.numpy(), leaf), path


# ---------------------------------------------------------------------------
# Blocks and the model's serving steps
# ---------------------------------------------------------------------------


def _stream():
    prompts = [np.array([5, 17, 400, 3, 99], np.int32),
               np.array([1, 2, 3, 4, 5, 6, 7, 8, 9], np.int32),
               np.array([77, 502, 0], np.int32)]
    return prompts, jkp.pack_prompts(prompts, [0, 1, 2])


def test_blocks_match_jax():
    jp, tp = _params(), _tparams()
    jl = jax.tree_util.tree_map(lambda a: a[1], jp["layers"])
    tl = tblocks.layer_params(tp["layers"], 1)
    _, packed = _stream()
    x = np.random.default_rng(0).standard_normal(
        (1, packed.total_tokens, 64), dtype=np.float32)
    jh, (jk, _) = jblocks.block_prefill_packed(
        jl, _jcfg(), jnp.asarray(x), seq_ids=jnp.asarray(packed.slot_ids),
        positions=jnp.asarray(packed.positions))
    th, (tk, _) = tblocks.block_prefill_packed(
        tl, _tcfg(), _t(x), seq_ids=_ints(packed.slot_ids),
        positions=_ints(packed.positions))
    np.testing.assert_allclose(th.numpy(), jh, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(tk.numpy(), jk, rtol=F32_TOL, atol=F32_TOL)
    kc = np.random.default_rng(1).standard_normal((9, 4, 2, 16),
                                                  dtype=np.float32)
    tables = np.array([[0, 1], [2, 3], [8, 8]], np.int32)
    pos = np.array([6, 3, 0], np.int32)
    xd = x[0, :3, None, :]
    jh, _ = jblocks.block_paged_decode(
        jl, _jcfg(), jnp.asarray(xd), (jnp.asarray(kc), jnp.asarray(kc * 2)),
        pos=jnp.asarray(pos), tables=jnp.asarray(tables), page_size=4)
    th, _ = tblocks.block_paged_decode(
        tl, _tcfg(), _t(xd), (_t(kc), _t(kc * 2)), pos=_ints(pos),
        tables=_ints(tables), page_size=4)
    np.testing.assert_allclose(th.numpy(), jh, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("ps", [4, 8])
def test_prefill_and_decode_logits_match_jax(ps):
    """Packed prefill of three prompts, then four decode steps (a slot left
    inactive on the trash page), against JAX at page size 4 and 8."""
    jp, tp = _params(), _tparams()
    jcfg, tcfg = _jcfg(), _tcfg()
    prompts, packed = _stream()
    pool = jkp.PagePool(32 // ps * 4, ps)
    for s, p in enumerate(prompts):
        pool.alloc(s, len(p) + 6)
    tables = pool.table_array(4, -(-16 // ps))
    jcache = jreg.paged_cache_init_fn(jcfg, pool.n_pages, ps)()
    tcache = treg.paged_cache_init_fn(tcfg, pool.n_pages, ps, "cpu")()
    jl, jcache = jreg.prefill_packed_fn(jcfg, ps)(
        jp, jcache, *(jnp.asarray(a) for a in (
            packed.tokens, packed.slot_ids, packed.positions, tables,
            packed.last_idx)))
    with dispatch.phase_scope("prefill"):
        tl, tcache = treg.prefill_packed_fn(tcfg, ps)(
            tp, tcache, *(_ints(a) for a in (
                packed.tokens, packed.slot_ids, packed.positions, tables,
                packed.last_idx)))
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
    live = np.asarray(tables[:3]).reshape(-1)  # every page but the trash one
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache[k].numpy()[:, live],
                                   np.asarray(jcache[k])[:, live],
                                   rtol=F32_TOL, atol=F32_TOL)


def test_decode_step_moves_nothing_to_the_host(monkeypatch):
    """A decode step reads no tensor back: ``.item()``, ``.tolist()`` and
    ``.cpu()`` are never called inside it."""
    tp = _tparams()
    cache = treg.paged_cache_init_fn(_tcfg(), 8, 4, "cpu")()
    called = []
    for name in ("item", "tolist", "cpu", "numpy"):
        orig = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda self, *a, _o=orig, _n=name, **k: (
                                called.append(_n), _o(self, *a, **k))[1])
    with dispatch.phase_scope("decode"):
        treg.paged_decode_fn(_tcfg(), 4)(
            tp, cache, _ints([[1], [2]]), _ints([0, 3]),
            _ints([[0, 1], [2, 8]]))
    assert called == []


# ---------------------------------------------------------------------------
# Page and slot pools, packed streams (exact)
# ---------------------------------------------------------------------------


def _pool_state(pool, n_slots=4, width=5):
    return (pool.table_array(n_slots, width).tolist(),
            pool.positions(n_slots).tolist(), pool.n_free, pool.n_mapped,
            pool.peak_pages, pool.fragmentation())


def test_page_pool_transitions_equal_jax():
    mine, theirs = PagePool(12, 4), jkp.PagePool(12, 4)
    ops = [("alloc", 0, 9), ("alloc", 2, 5), ("advance", 0, 6),
           ("grow", 2, 13), ("advance", 2, 11), ("alloc", 1, 16),
           ("release_unused", 0), ("free", 2), ("alloc", 3, 3),
           ("advance", 3, 3), ("free", 0), ("free", 1)]
    for op, *args in ops:
        a, b = getattr(mine, op)(*args), getattr(theirs, op)(*args)
        if op in ("advance", "release_unused"):
            assert a == b, (op, args)
        assert _pool_state(mine) == _pool_state(theirs), (op, args)
        mine.check_invariants()
    assert mine.trash_page == theirs.trash_page == 12
    for pool in (mine, theirs):
        with pytest.raises(Exception, match="cannot map"):
            pool.alloc(0, 100)
        with pytest.raises(Exception, match="holds no page table"):
            pool.free(7)
        pool.alloc(0, 4)
        with pytest.raises(Exception, match="exceeds mapped capacity"):
            pool.advance(0, 5)
        with pytest.raises(Exception, match="already holds"):
            pool.alloc(0, 4)
    with pytest.raises(PageError):
        PagePool(0, 4)


def test_page_pool_catches_a_corrupt_state():
    pool = PagePool(4, 2)
    pool.alloc(0, 4)
    pool._free.append(pool.table(0).pages[0])  # a page both free and mapped
    with pytest.raises(PageError):
        pool.check_invariants()


def test_pack_prompts_equals_jax():
    prompts = [np.arange(5), np.array([9]), np.arange(3) + 40]
    mine = pack_prompts(prompts, [2, 0, 3])
    theirs = jkp.pack_prompts(prompts, [2, 0, 3])
    for f in ("tokens", "slot_ids", "positions", "last_idx", "seq_lens"):
        a, b = getattr(mine, f), getattr(theirs, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert mine.total_tokens == theirs.total_tokens == 9
    with pytest.raises(PageError):
        pack_prompts([], [])
    with pytest.raises(PageError):
        pack_prompts([np.arange(2), []], [0, 1])


def test_slot_pool_equals_jax():
    mine, theirs = SlotPool(3, 10), jks.SlotPool(3, 10)
    for pool in (mine, theirs):
        a = pool.alloc(7)
        pool.alloc(8)
        pool.advance(a.index, 4)
        pool.free(a.index)
        pool.alloc(9)
        pool.advance(0, 2)
    assert mine.positions().tolist() == theirs.positions().tolist()
    assert ([(s.index, s.request_id, s.pos) for s in mine.active_slots()]
            == [(s.index, s.request_id, s.pos) for s in theirs.active_slots()])
    with pytest.raises(SlotError):
        mine.free(2)
    with pytest.raises(SlotError):
        mine.advance(0, 9)
    mine.alloc(1)
    with pytest.raises(SlotError, match="no free slots"):
        mine.alloc(2)


# ---------------------------------------------------------------------------
# Engine and scheduler
# ---------------------------------------------------------------------------


def test_engine_samples_greedy_with_the_vocab_mask():
    engine = Engine(_tcfg(), _tparams())
    jengine = JEngine(_jcfg(), _params(), JServeConfig())
    logits = np.random.default_rng(0).standard_normal((3, 2, 512),
                                                      dtype=np.float32)
    logits[0, -1, 510] = 1e3  # a padded id: never sampled
    got = engine.sample(_t(logits))
    want = jengine.sample(jnp.asarray(logits), jax.random.PRNGKey(0))
    assert got.dtype == torch.int32
    assert got.tolist() == np.asarray(want).tolist() and got[0] < 503
    assert sorted(engine.dispatch_plan) == sorted(jengine.dispatch_plan)
    assert all("|ph:" in t for t in engine.dispatch_plan)
    # temperature 0.7 builds and draws no padded id, not even the one with
    # the largest logit (tests/test_torch_generate.py holds its draws to
    # softmax(logits / T))
    hot = Engine(_tcfg(), _tparams(), ServeConfig(temperature=0.7))
    drawn = hot.sample(_t(np.repeat(logits[:1], 200, axis=0)))
    assert drawn.dtype == torch.int32 and int(drawn.max()) < 503


@pytest.mark.parametrize("ps,n_slots,eos", [(4, 3, False), (8, 2, True)])
def test_paged_scheduler_tokens_equal_jax(ps, n_slots, eos):
    """Greedy on a synthetic trace: the same tokens and statuses per request
    as the JAX ``Scheduler(paged=True)`` on the same params."""
    kw = dict(seed=3, vocab=503, prompt_lens=(3, 14), new_tokens=(2, 8))
    eos_id = None
    if eos:  # a token the greedy run emits, so some request stops early
        first = Scheduler(Engine(_tcfg(), _tparams()), n_slots=n_slots,
                          paged=True, page_size=ps).run(synthetic_trace(6, **kw))
        eos_id = int(max(first, key=lambda c: c.n_generated).tokens[1])
    jsched = JScheduler(JEngine(_jcfg(), _params(), JServeConfig(eos_id=eos_id)),
                        n_slots=n_slots, paged=True, page_size=ps)
    want = {c.uid: c for c in jsched.run(j_synthetic_trace(6, **kw))}
    sched = Scheduler(Engine(_tcfg(), _tparams(), ServeConfig(eos_id=eos_id)),
                      n_slots=n_slots, paged=True, page_size=ps)
    trace = synthetic_trace(6, **kw)
    got = {c.uid: c for c in sched.run(trace)}
    assert sorted(got) == sorted(want) == list(range(6))
    for uid, c in got.items():
        assert c.status == want[uid].status == "ok"
        assert np.array_equal(c.tokens, want[uid].tokens), uid
        assert c.prompt_len == want[uid].prompt_len
    st = sched.stats
    assert st["generated_tokens"] == sum(c.n_generated for c in got.values())
    assert st["completed_requests"] == 6 and st["decode_steps"] > 0
    assert st["decode_steps"] == jsched.stats["decode_steps"]
    assert all(k.launches == 0 for k in KERNELS)
    if eos:
        assert any(c.tokens[-1] == eos_id and c.n_generated < r.max_new_tokens
                   for c, r in zip((got[r.uid] for r in trace), trace))


def test_synthetic_trace_and_helpers_equal_jax():
    for args in [dict(seed=0), dict(seed=5, vocab=49152, prompt_lens=(16, 128),
                                    new_tokens=(16, 32))]:
        mine, theirs = synthetic_trace(8, **args), j_synthetic_trace(8, **args)
        for a, b in zip(mine, theirs):
            assert (a.uid, a.max_new_tokens) == (b.uid, b.max_new_tokens)
            assert np.array_equal(a.prompt, b.prompt)
    q = RequestQueue([Request(1, [1]), Request(2, [2]), Request(3, [3])])
    assert q.peek().uid == 1 and [q.pop().uid for _ in range(3)] == [1, 2, 3]
    assert not q and latency_percentiles([]) == (0.0, 0.0)
    with pytest.raises(ValueError, match="empty prompt"):
        Request(0, [])


def test_scheduler_rejects_what_waits_for_later_slices():
    """The contiguous mode and ``alloc="grow"`` run now (their parity with
    JAX is in tests/test_torch_serve_lifecycle.py); what a run cannot hold
    still raises."""
    engine = Engine(_tcfg(), _tparams())
    req = lambda: [Request(0, np.arange(5), max_new_tokens=3)]  # noqa: E731
    for kw in (dict(n_slots=2), dict(paged=True, page_size=4, alloc="grow")):
        done = Scheduler(engine, **kw).run(req())
        assert [(c.status, c.n_generated) for c in done] == [("ok", 3)], kw
    sched = Scheduler(engine, n_slots=2, paged=True, page_size=4, max_len=8)
    with pytest.raises(ValueError, match="cannot hold"):
        sched.run([Request(0, np.arange(6), max_new_tokens=4)])
    with pytest.raises(ValueError, match="kv_budget_rows"):
        Scheduler(engine, paged=True, page_size=4,
                  kv_budget_rows=4).run([Request(0, np.arange(6))])
