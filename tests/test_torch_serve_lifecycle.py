"""The port's continuous-batching scheduler, the rest of it, against the JAX
package's on the CPU, at the smoke size of smollm-360m with every linear
compressed (sparsity 0.5, ``min_dim=16``): the contiguous mode (tokens and
statuses per request identical to JAX's and to the static ``generate``),
its size guards and in-place slot admission, ``alloc="grow"`` with LIFO
preemption and token-identical restore, the request lifecycle (deadlines
under a fake clock, cancel, drain, heartbeat; every request ends in exactly
one of ``STATUSES``), ``stats``' key set, and the serving launcher with
``--device cpu``.  Params come from JAX through ``params_from_jax``."""
import functools
import types

import jax
import numpy as np
import pytest
import torch

from repro import dispatch as jdispatch
from repro import fault as jfault
from repro.configs import smoke_config as j_smoke_config
from repro.core.pruning import SparsityConfig as JSparsityConfig
from repro.models import registry as jreg
from repro.serve import STATUSES as J_STATUSES
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import RequestQueue as JRequestQueue
from repro.serve import Scheduler as JScheduler
from repro.serve import ServeConfig as JServeConfig
from repro.serve import scheduler as jsched_mod
from repro.serve import synthetic_trace as j_synthetic_trace
from repro_torch import dispatch
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.pruning import SparsityConfig
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import (
    STATUSES,
    Engine,
    PageError,
    Request,
    RequestQueue,
    Scheduler,
    ServeConfig,
    synthetic_trace,
)
from repro_torch.serve import kv_pages as tkv_pages
from repro_torch.serve import scheduler as tsched_mod

SPARSE = dict(sparsity=0.5, m=None, tile=None, min_dim=16,
              format="compressed_pallas")
TRACE_KW = dict(seed=3, vocab=503, prompt_lens=(3, 14), new_tokens=(2, 8))


@pytest.fixture(scope="module", autouse=True)
def dbs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dbs")
    dispatch.set_db(dispatch.ProfileDB(path=d / "profile.json"))
    jdispatch.set_db(jdispatch.ProfileDB(path=str(d / "jax.json")))
    yield
    dispatch.set_db(None)
    jdispatch.set_db(None)


@functools.lru_cache(maxsize=None)
def _params():
    cfg = j_smoke_config("smollm-360m").with_(sparsity=JSparsityConfig(**SPARSE))
    jp, _ = jreg.init_params(cfg, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, jp)


@pytest.fixture(scope="module")
def jengine(dbs):
    cfg = j_smoke_config("smollm-360m").with_(sparsity=JSparsityConfig(**SPARSE))
    return JEngine(cfg, _params(), JServeConfig())


@pytest.fixture(scope="module")
def tengine(dbs):
    cfg = smoke_config("smollm-360m").with_(sparsity=SparsityConfig(**SPARSE))
    return Engine(cfg, params_from_jax(_params(), device="cpu"), ServeConfig())


@pytest.fixture
def eos(jengine, tengine):
    """Set one EOS id on both engines for a test."""
    def set_(eos_id):
        jengine.scfg.eos_id = tengine.scfg.eos_id = eos_id
    yield set_
    set_(None)


def _trace(n, *, prompt=6, budget=6, seed=0, cls=Request, **kw):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(0, 503, (prompt,)).astype(np.int32),
                max_new_tokens=budget, **kw) for i in range(n)]


def _by_uid(completions):
    out = {}
    for c in completions:
        assert c.uid not in out, f"uid {c.uid} completed twice"
        out[c.uid] = c
    return out


def _same(got, want):
    """Per request: the same status and the same tokens."""
    assert sorted(got) == sorted(want)
    for uid, c in got.items():
        assert c.status == want[uid].status, (uid, c.status, want[uid].status)
        assert np.array_equal(c.tokens, want[uid].tokens), uid
        assert c.prompt_len == want[uid].prompt_len, uid


class FakeClock:
    """A clock the heartbeat moves one second per scheduler iteration."""

    def __init__(self):
        self.t = 0.0
        self.beats = 0

    def perf_counter(self):
        return self.t

    def beat(self):
        self.beats += 1
        self.t += 1.0


def _with_clock(monkeypatch, mod):
    clock = FakeClock()
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(
        perf_counter=clock.perf_counter))
    return clock


# ---------------------------------------------------------------------------
# The contiguous mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_slots,chunk,use_eos", [(3, 4, False), (2, 8, True)])
def test_contiguous_scheduler_equals_jax(jengine, tengine, eos, n_slots,
                                         chunk, use_eos):
    if use_eos:  # a token the greedy run emits, so some request stops early
        first = Scheduler(tengine, n_slots=n_slots, prefill_chunk=chunk).run(
            synthetic_trace(6, **TRACE_KW))
        eos(int(max(first, key=lambda c: c.n_generated).tokens[1]))
    jsched = JScheduler(jengine, n_slots=n_slots, prefill_chunk=chunk)
    want = _by_uid(jsched.run(j_synthetic_trace(6, **TRACE_KW)))
    sched = Scheduler(tengine, n_slots=n_slots, prefill_chunk=chunk)
    got = _by_uid(sched.run(synthetic_trace(6, **TRACE_KW)))
    _same(got, want)
    assert all(c.status == "ok" for c in got.values())
    st, jst = sched.stats, jsched.stats
    for k in ("decode_steps", "generated_tokens", "completed_requests",
              "retired_ok", "requests"):
        assert st[k] == jst[k], k
    assert sched.page_stats == {k: 0 * v for k, v in sched.page_stats.items()}
    if use_eos:
        assert any(c.n_generated < r.max_new_tokens
                   for r, c in zip(synthetic_trace(6, **TRACE_KW),
                                   (got[u] for u in range(6))))


def test_contiguous_scheduler_equals_static_generate(tengine):
    """The JAX test_mixed_length_batch_matches_static_engine on the port."""
    trace = synthetic_trace(6, **TRACE_KW)
    got = _by_uid(Scheduler(tengine, n_slots=3, prefill_chunk=4).run(trace))
    for req in trace:
        engine = Engine(tengine.cfg, tengine.params,
                        ServeConfig(max_new_tokens=req.max_new_tokens))
        ref = engine.generate(req.prompt[None, :])
        assert np.array_equal(got[req.uid].tokens, ref["tokens"][0]), req.uid


def test_padded_final_chunk_sizes_the_cache(tengine):
    """prompt 9 in chunks of 8 pads the last chunk to rows [8, 16): the
    auto-sized cache holds the padded write, so no row moves backwards."""
    req = Request(0, np.random.default_rng(11).integers(0, 503, (9,)),
                  max_new_tokens=3)
    comp = Scheduler(tengine, n_slots=1, prefill_chunk=8).run([req])[0]
    ref = Engine(tengine.cfg, tengine.params,
                 ServeConfig(max_new_tokens=3)).generate(req.prompt[None, :])
    assert np.array_equal(comp.tokens, ref["tokens"][0])


@pytest.mark.parametrize("paged", [False, True])
def test_size_guards(tengine, paged):
    kw = dict(paged=paged, page_size=4 if paged else None)
    with pytest.raises(ValueError, match="cannot hold"):
        Scheduler(tengine, n_slots=1, max_len=8, **kw).run(
            [Request(0, np.arange(6), max_new_tokens=4)])
    with pytest.raises(ValueError, match="pads the longest prompt"):
        Scheduler(tengine, n_slots=1, max_len=11, prefill_chunk=8, **kw).run(
            [Request(0, np.arange(9) + 1, max_new_tokens=2)])
    if paged:
        with pytest.raises(ValueError, match="kv_budget_rows"):
            Scheduler(tengine, page_size=4, paged=True,
                      kv_budget_rows=4).run([Request(0, np.arange(6))])
    with pytest.raises(ValueError, match="requires paged=True"):
        Scheduler(tengine, alloc="grow")
    with pytest.raises(ValueError, match="alloc must be"):
        Scheduler(tengine, paged=True, alloc="lazy")


def test_admission_writes_only_its_slots_rows(tengine):
    """Chunked prefill into slot 1 writes rows [0, 12) of slot 1 in the
    pool, in place; the other slots' rows and slot 1's later rows keep
    their bits."""
    sched = Scheduler(tengine, n_slots=3, prefill_chunk=4)
    cache = {k: torch.from_numpy(np.random.default_rng(i).standard_normal(
        (2, 3, 16, 2, 16)).astype(np.float32)) for i, k in enumerate("kv")}
    before = {k: v.clone() for k, v in cache.items()}
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    logits = sched._prefill_into(cache, 1, np.arange(10, dtype=np.int32) + 5, 4)
    assert tuple(logits.shape) == (1, 1, tengine.cfg.padded_vocab)
    for k in "kv":
        assert cache[k].data_ptr() == ptrs[k]
        for slot in (0, 2):
            assert torch.equal(cache[k][:, slot], before[k][:, slot])
        assert torch.equal(cache[k][:, 1, 12:], before[k][:, 1, 12:])
        assert not torch.equal(cache[k][:, 1, :12], before[k][:, 1, :12])
    # the prompt's rows are the full prefill's
    _, full = tengine.prefill_step(np.arange(10, dtype=np.int32)[None] + 5, 10)
    np.testing.assert_allclose(cache["k"][:, 1, :10].numpy(),
                               full["k"][:, 0].numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# alloc="grow": preemption and restore
# ---------------------------------------------------------------------------


def test_grow_preempts_and_restores_token_identically(jengine, tengine):
    """A 16-row budget (4 pages) for 2 slots of growing sequences forces
    real exhaustion: the restored requests' tokens equal an unpreempted
    run's and JAX's, with as many preemptions as JAX's."""
    base = _by_uid(Scheduler(tengine, n_slots=2, paged=True, page_size=4,
                             max_len=16).run(_trace(4)))
    kw = dict(n_slots=2, paged=True, page_size=4, max_len=16,
              kv_budget_rows=16, alloc="grow")
    tight = Scheduler(tengine, **kw)
    got = _by_uid(tight.run(_trace(4)))
    jtight = JScheduler(jengine, **kw)
    want = _by_uid(jtight.run(_trace(4, cls=JRequest)))
    assert tight.stats["preemptions"] >= 1
    assert tight.stats["preemptions"] == jtight.stats["preemptions"]
    _same(got, want)
    _same(got, base)
    assert all(c.status == "ok" for c in got.values())
    assert tight.page_stats == jtight.page_stats


def test_restore_budget_exhausts_to_failed(jengine, tengine, monkeypatch):
    """Every grow-time page claim fails: the only sequence is preempted
    once, then hits ``max_restores`` and retires "failed", keeping what it
    generated, as JAX's does under ``page_pool.alloc@grow:n=99``."""
    kw = dict(n_slots=1, paged=True, page_size=4, max_len=16, alloc="grow",
              max_restores=1)
    orig = tkv_pages.PagePool.grow

    def grow(self, seq_id, n_rows):
        if self.pages_for(n_rows) > len(self._get(seq_id).pages):
            raise PageError("no page for the grow")
        return orig(self, seq_id, n_rows)

    monkeypatch.setattr(tkv_pages.PagePool, "grow", grow)
    sched = Scheduler(tengine, **kw)
    got = _by_uid(sched.run(_trace(1, prompt=3, budget=8)))
    jsched = JScheduler(jengine, **kw)
    with jfault.fault_scope("page_pool.alloc@grow:n=99"):
        want = _by_uid(jsched.run(_trace(1, prompt=3, budget=8, cls=JRequest)))
    assert got[0].status == "failed" and sched.stats["preemptions"] == 1
    assert sched.stats["retired_failed"] == 1
    _same(got, want)
    assert sched.page_stats["pages_active"] == 0


def test_reserve_strands_pages_grow_does_not(jengine, tengine, eos):
    first = _by_uid(Scheduler(tengine, n_slots=2, paged=True, page_size=4,
                              max_len=24).run(_trace(4, prompt=4, budget=16)))
    eos(int(first[0].tokens[1]))
    runs = {}
    for alloc in ("reserve", "grow"):
        sched = Scheduler(tengine, n_slots=2, paged=True, page_size=4,
                          max_len=24, alloc=alloc)
        runs[alloc] = (sched, _by_uid(sched.run(_trace(4, prompt=4, budget=16))))
        jsched = JScheduler(jengine, n_slots=2, paged=True, page_size=4,
                            max_len=24, alloc=alloc)
        _same(runs[alloc][1], _by_uid(jsched.run(
            _trace(4, prompt=4, budget=16, cls=JRequest))))
        assert sched.page_stats == jsched.page_stats
    reserve, grow = runs["reserve"][0], runs["grow"][0]
    assert any(c.n_generated < 16 for c in runs["reserve"][1].values())
    assert reserve.page_stats["pages_stranded"] > 0
    assert grow.page_stats["pages_stranded"] == 0
    assert grow.page_stats["pages_peak"] <= reserve.page_stats["pages_peak"]
    _same(runs["grow"][1], runs["reserve"][1])


# ---------------------------------------------------------------------------
# Lifecycle: deadlines, cancel, drain, heartbeat
# ---------------------------------------------------------------------------


def _both(jengine, tengine, monkeypatch, sched_kw, make_trace, drive):
    """Run the same scenario on both schedulers, each under a fake clock;
    ``drive(sched, trace, clock)`` returns the completions."""
    out = []
    for mod, engine, cls, sched_cls in (
            (tsched_mod, tengine, Request, Scheduler),
            (jsched_mod, jengine, JRequest, JScheduler)):
        clock = _with_clock(monkeypatch, mod)
        sched = sched_cls(engine, **sched_kw)
        comps = _by_uid(drive(sched, make_trace(cls), clock))
        out.append((sched, comps, clock))
    (ts, got, tclock), (js, want, jclock) = out
    _same(got, want)
    assert tclock.beats == jclock.beats
    for k in ("decode_steps", "generated_tokens", "completed_requests",
              "preemptions") + tuple(f"retired_{s}" for s in STATUSES):
        assert ts.stats[k] == js.stats[k], k
    return ts, got, tclock


@pytest.mark.parametrize("paged", [False, True])
def test_deadlines_under_a_fake_clock_equal_jax(jengine, tengine, monkeypatch,
                                                paged):
    """A deadline that passes before a request can admit (0.5 s: the first
    sweep sees 1 s) and one that passes in flight (3.5 s, the fourth
    iteration): both retire "timeout", the second with its partial tokens;
    the heartbeat moves the clock once per iteration."""
    def make(cls):
        reqs = _trace(5, budget=8, cls=cls)
        reqs[3].deadline_s = 0.5
        reqs[1].deadline_s = 3.5
        return reqs

    kw = dict(n_slots=2, max_len=16, prefill_chunk=4, paged=paged,
              page_size=4 if paged else None)
    sched, got, clock = _both(
        jengine, tengine, monkeypatch, kw, make,
        lambda s, tr, clock: s.run(tr, heartbeat=clock.beat))
    assert got[3].status == "timeout" and got[3].n_generated == 0
    assert got[1].status == "timeout" and 0 < got[1].n_generated < 8
    assert [got[u].status for u in (0, 2, 4)] == ["ok"] * 3
    assert sched.stats["retired_timeout"] == 2


@pytest.mark.parametrize("paged", [False, True])
def test_cancel_queued_and_in_flight_equal_jax(jengine, tengine, monkeypatch,
                                               paged):
    """uid 2 is cancelled while queued, uid 0 once the run has started."""
    def drive(sched, trace, clock):
        sched.cancel(2)
        sched.cancel(99)  # unknown: ignored
        gen = sched.run_iter(trace, heartbeat=clock.beat)
        first = next(gen)
        sched.cancel(0)
        return [first] + list(gen)

    kw = dict(n_slots=2, max_len=24, prefill_chunk=4, paged=paged,
              page_size=4 if paged else None)
    sched, got, _ = _both(
        jengine, tengine, monkeypatch, kw,
        lambda cls: _trace(4, budget=12, cls=cls), drive)
    assert got[2].status == "cancelled" and got[2].n_generated == 0
    assert got[0].status == "cancelled" and 0 < got[0].n_generated < 12
    assert sched.stats["retired_cancelled"] == 2


@pytest.mark.parametrize("mode", ["contiguous", "reserve", "grow"])
def test_drain_finishes_in_flight_and_flushes_the_queue(jengine, tengine,
                                                         monkeypatch, mode):
    """Once ``should_drain`` turns true after the first completion,
    admissions stop, in-flight requests finish "ok" and queued ones flush
    "cancelled" (a preempted one "preempted"); the heartbeat beats once an
    iteration."""
    def drive(sched, trace, clock):
        draining = {"on": False}
        gen = sched.run_iter(trace, should_drain=lambda: draining["on"],
                             heartbeat=clock.beat)
        first = next(gen)
        draining["on"] = True
        return [first] + list(gen)

    kw = dict(n_slots=2, max_len=16, prefill_chunk=4,
              paged=mode != "contiguous", page_size=4,
              alloc="grow" if mode == "grow" else "reserve")
    if mode == "contiguous":
        kw["page_size"] = None
    if mode == "grow":
        kw["kv_budget_rows"] = 16
    sched, got, clock = _both(
        jengine, tengine, monkeypatch, kw,
        lambda cls: _trace(6, budget=8, cls=cls), drive)
    statuses = [c.status for c in got.values()]
    assert len(got) == 6 and "ok" in statuses
    assert "cancelled" in statuses or "preempted" in statuses
    assert sum(sched.stats[f"retired_{s}"] for s in STATUSES) == 6
    assert clock.beats >= sched.stats["decode_steps"] >= 1


def test_every_request_ends_in_exactly_one_status(tengine):
    """Cancels, deadlines, grow preemptions and a drain in one run: every
    request completes once with a status of ``STATUSES``, the per-status
    counts add up, and no page stays mapped."""
    assert STATUSES == J_STATUSES
    trace = _trace(8, budget=8, seed=2)
    trace[5].deadline_s = 1e-9
    sched = Scheduler(tengine, n_slots=3, paged=True, page_size=4,
                      max_len=16, kv_budget_rows=24, alloc="grow")
    sched.cancel(6)
    beats, seen = [], []
    gen = sched.run_iter(trace, heartbeat=lambda: beats.append(1),
                         should_drain=lambda: len(seen) >= 4)
    for c in gen:
        seen.append(c)
        if len(seen) == 1:
            sched.cancel(trace[7].uid)
    got = _by_uid(seen)
    assert sorted(got) == list(range(8))
    assert all(c.status in STATUSES for c in got.values())
    st = sched.stats
    assert sum(st[f"retired_{s}"] for s in STATUSES) == 8
    assert st["completed_requests"] == 8
    assert got[5].status == "timeout" and got[6].status == "cancelled"
    assert len(beats) >= st["decode_steps"]
    assert sched.page_stats["pages_active"] == 0


def test_stats_key_set_equals_jax_before_during_and_after(jengine, tengine):
    sched = Scheduler(tengine, n_slots=2, prefill_chunk=4)
    jsched = JScheduler(jengine, n_slots=2, prefill_chunk=4)
    assert set(sched.stats) == set(jsched.stats)
    assert set(sched.page_stats) == set(jsched.page_stats)
    assert all(v == 0 for v in sched.stats.values())
    gen = sched.run_iter(synthetic_trace(5, seed=7, vocab=503,
                                         prompt_lens=(3, 10),
                                         new_tokens=(2, 8)))
    first = next(gen)
    mid = sched.stats
    assert set(mid) == set(jsched.stats)
    assert mid["requests"] == 5 and mid["completed_requests"] >= 1
    assert mid["generated_tokens"] >= first.n_generated
    rest = list(gen)
    end = sched.stats
    assert set(end) == set(jsched.stats)
    assert all(isinstance(v, (int, float)) for v in end.values())
    assert end["completed_requests"] == end["retired_ok"] == 5
    assert end["generated_tokens"] == first.n_generated + sum(
        c.n_generated for c in rest)
    assert end["latency_p50_s"] > 0 and end["decode_tok_s"] > 0
    assert end["iter_faults"] == 0
    sched.run(synthetic_trace(2, seed=1, vocab=503, prompt_lens=(3, 4),
                              new_tokens=(2, 2)))
    assert sched.stats["completed_requests"] == 2  # a rerun resets


def test_request_queue_and_request_equal_jax():
    mine = RequestQueue(_trace(4))
    theirs = JRequestQueue(_trace(4, cls=JRequest))
    for q, cls in ((mine, Request), (theirs, JRequest)):
        q.push(cls(9, [1, 2]))
        q.push_front(cls(8, [3]))
        assert [r.uid for r in q.take(lambda r: r.uid % 2 == 1)] == [1, 3, 9]
        assert q.peek().uid == 8 and len(q) == 3
    assert [mine.pop().uid for _ in range(3)] == [
        theirs.pop().uid for _ in range(3)] == [8, 0, 2]
    with pytest.raises(ValueError, match="deadline_s"):
        Request(0, [1], deadline_s=0)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


LAUNCH = ["--arch", "smollm-360m", "--smoke", "--device", "cpu",
          "--new-tokens", "6", "--prompt-len", "8"]


@pytest.mark.parametrize("extra,expect", [
    ([], "decode"),
    (["--continuous", "--requests", "5", "--trace"], "kv=contiguous"),
    (["--continuous", "--requests", "5", "--paged", "--page-size", "4",
      "--alloc", "grow", "--kv-budget-rows", "16", "--deadline-s", "60"],
     "alloc=grow"),
])
def test_launcher_runs_on_the_cpu(capsys, extra, expect):
    launch_serve.main(LAUNCH + extra)
    out = capsys.readouterr().out
    assert expect in out and "device=cpu" in out, out
    if "--continuous" in extra:
        assert "status: ok=5" in out, out
    if "--trace" in extra:
        assert "[admit] uid=0" in out and "[retire] uid=0" in out, out


@pytest.mark.parametrize("extra,match", [
    (["--faults", "page_pool.alloc:n=1"], "item 7"),
    (["--continuous", "--trace", "out.json"], "item 7"),
    (["--paged"], "requires --continuous"),
    (["--alloc", "grow"], "require --continuous"),
])
def test_launcher_refuses_what_it_cannot_run(extra, match):
    with pytest.raises(SystemExit, match=match) as e:
        launch_serve.main(LAUNCH + extra)
    assert e.value.code not in (0, None)


def test_launcher_drains_on_a_preemption_signal_and_beats_the_watchdog(
        capsys, monkeypatch):
    """The guard's flag, as SIGTERM sets it, drains the run: in-flight
    requests finish and the queue flushes "cancelled"; the watchdog gets a
    beat every scheduler iteration and is stopped."""
    from repro_torch.train.fault import PreemptionGuard, StepWatchdog

    class Guard(PreemptionGuard):
        polls = 0

        @property
        def requested(self):
            Guard.polls += 1
            return Guard.polls > 2

        @requested.setter
        def requested(self, value):
            pass

    dogs = []

    class Dog(StepWatchdog):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.beats = 0
            dogs.append(self)

        def beat(self):
            self.beats += 1
            super().beat()

    monkeypatch.setattr(launch_serve, "PreemptionGuard", Guard)
    monkeypatch.setattr(launch_serve, "StepWatchdog", Dog)
    launch_serve.main(LAUNCH + ["--continuous", "--requests", "8",
                                "--slots", "2"])
    out = capsys.readouterr().out
    assert "[drained]" in out and "cancelled=" in out and "ok=" in out, out
    assert dogs[0].beats >= 3 and dogs[0]._stop.is_set()
