"""The port's obs layer (``repro_torch.obs``) against the JAX package's
(``repro.obs``) on the CPU: histogram percentiles equal to JAX's on the
same numpy-seeded samples (exactly: both are the same float arithmetic),
registry snapshots, span nesting, the ring's overflow and drop count, the
Chrome-trace dump accepted by both packages' validators, and the serving
scheduler's ``stats`` percentiles equal to JAX's ``Histogram`` edges over
the samples the scheduler recorded."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.obs import metrics as jmetrics
from repro.obs import validate as jvalidate
from repro_torch import obs
from repro_torch.obs import metrics, trace, validate


@pytest.fixture(autouse=True)
def clean_obs():
    """Each test starts with obs off, an empty default-size ring and a
    zeroed global registry, and leaves it so."""
    trace.set_enabled(False)
    trace.configure()
    obs.reset()
    yield
    trace.set_enabled(False)
    trace.configure()
    obs.reset()


def _samples(seed, kind, n):
    rng = np.random.default_rng(seed)
    if kind == "lognormal":  # latencies: seconds, ~1 ms to ~1 s
        return rng.lognormal(mean=-4.0, sigma=1.5, size=n)
    if kind == "uniform":
        return rng.uniform(0.0, 2.0, size=n)
    return rng.exponential(1e3, size=n)  # past the last default bucket


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind,n", [("lognormal", 1), ("lognormal", 257),
                                    ("uniform", 40), ("overflow", 33)])
def test_histogram_percentiles_equal_jax(seed, kind, n):
    """Exact equality (tolerance 0): the bucket walk and the edges are the
    same float operations in both packages."""
    ours = metrics.Registry().histogram("h")
    theirs = jmetrics.Registry().histogram("h")
    for v in _samples(seed, kind, n):
        ours.observe(v)
        theirs.observe(v)
    for p in (0, 1, 25, 50, 90, 99, 99.9, 100):
        assert ours.percentile(p) == theirs.percentile(p), p
    assert ours.summary() == theirs.summary()
    assert ours.count == theirs.count == n


@pytest.mark.parametrize("buckets", [(0.5, 1.0, 2.0), metrics.exp_buckets(
    1e-3, 10.0, 5)])
def test_histogram_custom_buckets_equal_jax(buckets):
    ours = metrics.Registry().histogram("h", buckets=buckets)
    theirs = jmetrics.Registry().histogram("h", buckets=buckets)
    for v in _samples(5, "uniform", 64):
        ours.observe(v)
        theirs.observe(v)
    assert [ours.percentile(p) for p in range(0, 101, 5)] == \
        [theirs.percentile(p) for p in range(0, 101, 5)]


def test_histogram_empty_and_bad_arguments():
    h = metrics.Registry().histogram("h")
    assert h.percentile(50) == 0.0 and h.summary()["max"] == 0.0
    h.observe(1.0)
    with pytest.raises(ValueError, match="outside"):
        h.percentile(101)
    with pytest.raises(ValueError, match="strictly increasing"):
        metrics.Registry().histogram("bad", buckets=(1.0, 1.0))
    assert metrics.exp_buckets() == jmetrics.exp_buckets()
    assert metrics.DEFAULT_BUCKETS == jmetrics.DEFAULT_BUCKETS
    for bad in (dict(start=0), dict(factor=1.0), dict(count=0)):
        with pytest.raises(ValueError, match="bad bucket spec"):
            metrics.exp_buckets(**bad)


def test_registry_snapshot_equal_jax_and_reset_in_place():
    ours, theirs = metrics.Registry(), jmetrics.Registry()
    for reg in (ours, theirs):
        c = reg.counter("serve.decode_steps")
        c.inc()
        c.inc(4)
        reg.gauge("serve.queue_depth").set(7)
        for v in (0.003, 0.02, 0.5):
            reg.histogram("serve.ttft_s").observe(v)
    assert ours.snapshot() == theirs.snapshot()
    assert ours.names() == theirs.names()
    c = ours.counter("serve.decode_steps")
    ours.reset()
    assert c.value == 0 and ours.counter("serve.decode_steps") is c
    c.inc()
    assert ours.snapshot()["counters"]["serve.decode_steps"] == 1
    with pytest.raises(TypeError, match="already registered as Counter"):
        ours.gauge("serve.decode_steps")


def test_global_registry_records_only_while_obs_is_on():
    c = metrics.counter("dispatch.resolves")
    g = metrics.gauge("serve.queue_depth")
    h = metrics.histogram("serve.ttft_s")
    c.inc()
    g.set(3)
    h.observe(0.1)
    assert (c.value, g.value, h.count) == (0, 0, 0)
    obs.set_enabled(True)
    c.inc()
    g.set(3)
    h.observe(0.1)
    assert (c.value, g.value, h.count) == (1, 3, 1)
    snap = obs.snapshot()
    assert snap["counters"]["dispatch.resolves"] == 1
    obs.reset()  # the ring AND the registry
    assert c.value == 0 and h.count == 0 and obs.events() == []


# ---------------------------------------------------------------------------
# Tracing
# ---------------------------------------------------------------------------


def test_off_spans_are_one_shared_noop_and_record_nothing():
    a, b = obs.span("serve.iter", it=0), obs.span("serve.decode")
    assert a is b
    with a as sp:
        sp.set(retired=1)
        obs.instant("serve.retire", uid=0)
    assert obs.events() == [] and obs.current_stack() == ()


def test_span_nesting_depth_and_end_args():
    obs.set_enabled(True)
    with obs.span("serve.iter", it=3) as it:
        assert obs.current_stack() == ("serve.iter",)
        with obs.span("serve.decode", active=2) as dec:
            assert obs.current_stack() == ("serve.iter", "serve.decode")
            obs.instant("serve.retire", uid=5)
            dec.set(wall_us=1.5)
        it.set(retired=1)
    assert obs.current_stack() == ()
    evs = obs.events()
    assert [(e["name"], e["ph"]) for e in evs] == [
        ("serve.iter", "B"), ("serve.decode", "B"), ("serve.retire", "i"),
        ("serve.decode", "E"), ("serve.iter", "E")]
    assert evs[0]["args"] == {"it": 3, "depth": 0}
    assert evs[1]["args"] == {"active": 2, "depth": 1}
    assert evs[2]["args"] == {"uid": 5} and evs[2]["s"] == "t"
    assert evs[3]["args"] == {"wall_us": 1.5}
    assert evs[4]["args"] == {"retired": 1}
    ts = [e["ts"] for e in evs]
    assert ts == sorted(ts)


def test_span_closes_and_records_the_error_on_an_exception():
    obs.set_enabled(True)
    with pytest.raises(KeyError):
        with obs.span("serve.iter", it=0):
            raise KeyError("boom")
    end = obs.events()[-1]
    assert end["ph"] == "E" and end["args"]["error"] == "KeyError: 'boom'"
    assert obs.current_stack() == ()


@pytest.mark.parametrize("capacity,n", [(4, 10), (1, 3), (16, 16)])
def test_ring_overflow_drops_the_oldest_and_counts(capacity, n):
    obs.configure(capacity=capacity)
    obs.set_enabled(True)
    for i in range(n):
        obs.instant("serve.retire", uid=i)
    evs = obs.events()
    assert len(evs) == min(n, capacity)
    assert [e["args"]["uid"] for e in evs] == list(range(n))[-capacity:]
    assert obs.dropped_events() == max(n - capacity, 0)
    trace.reset()
    assert obs.events() == [] and obs.dropped_events() == 0


def test_dump_is_accepted_by_both_validators(tmp_path):
    obs.configure(capacity=8)
    obs.set_enabled(True)
    metrics.counter("serve.decode_steps").inc(2)
    for it in range(3):
        with obs.span("serve.iter", it=it):
            with obs.span("serve.decode"):
                pass
            obs.instant("serve.retire", uid=it)
    path = tmp_path / "sub" / "trace.json"
    n = obs.dump_chrome_trace(path, metadata={"metrics": obs.snapshot()})
    assert n == 8
    payload = json.loads(path.read_text())
    assert payload["otherData"]["dropped_events"] == 7
    assert payload["otherData"]["metrics"]["counters"]["serve.decode_steps"] == 2
    # the ring kept the newest 8 of 15 events: a complete trailing tree only
    # when the cut falls between iterations, so validate a whole one
    obs.configure(capacity=64)
    with obs.span("serve.iter", it=9):
        obs.instant("serve.retire", uid=9)
    obs.dump_chrome_trace(path)
    assert validate.validate_chrome_trace(path) == \
        jvalidate.validate_chrome_trace(str(path)) == \
        {"events": 3, "spans": 1, "instants": 1, "lanes": 1}
    assert list(path.parent.iterdir()) == [path]  # no temp file left


@pytest.mark.parametrize("events,match", [
    ([], "empty"),
    ([{"name": "a", "ph": "B", "ts": 0, "pid": 1}], "missing fields"),
    ([{"name": "a", "ph": "Q", "ts": 0, "pid": 1, "tid": 1}], "unknown phase"),
    ([{"name": "a", "ph": "i", "ts": 5, "pid": 1, "tid": 1},
      {"name": "b", "ph": "i", "ts": 4, "pid": 1, "tid": 1}], "backwards"),
    ([{"name": "a", "ph": "E", "ts": 0, "pid": 1, "tid": 1}], "no open span"),
    ([{"name": "a", "ph": "B", "ts": 0, "pid": 1, "tid": 1},
      {"name": "b", "ph": "B", "ts": 1, "pid": 1, "tid": 1},
      {"name": "a", "ph": "E", "ts": 2, "pid": 1, "tid": 1}], "improper"),
    ([{"name": "a", "ph": "B", "ts": 0, "pid": 1, "tid": 1}], "unbalanced"),
])
def test_validators_reject_alike(events, match):
    payload = {"traceEvents": events}
    with pytest.raises(validate.TraceValidationError, match=match):
        validate.validate_chrome_trace(payload)
    with pytest.raises(jvalidate.TraceValidationError, match=match):
        jvalidate.validate_chrome_trace(payload)


def test_watchdog_dumps_the_trace_before_it_exits_42(tmp_path):
    """The abort records a ``fault.watchdog`` instant and writes the ring
    to ``trace_path`` before ``os._exit(42)``, which skips every handler:
    the trace of a hung run says where it hung."""
    path = tmp_path / "hung.json"
    snippet = ("import time\n"
               "from repro_torch import obs\n"
               "from repro_torch.train.fault import StepWatchdog\n"
               "obs.set_enabled(True)\n"
               "StepWatchdog(timeout_s=0.2, trace_path=%r).start()\n"
               "with obs.span('train.step', step=0):\n"
               "    time.sleep(30)\n" % str(path))
    src = Path(__file__).resolve().parents[1] / "src"
    r = subprocess.run([sys.executable, "-c", snippet],
                       env=dict(os.environ, PYTHONPATH=str(src)),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 42, r.stderr
    evs = json.loads(path.read_text())["traceEvents"]
    assert [(e["name"], e["ph"]) for e in evs] == [
        ("train.step", "B"), ("fault.watchdog", "i")]
    assert evs[1]["args"] == {"timeout_s": 0.2}


# ---------------------------------------------------------------------------
# The scheduler's stats: views over its registry's histograms
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    from repro_torch import dispatch
    from repro_torch.configs import smoke_config
    from repro_torch.core.pruning import SparsityConfig
    from repro_torch.models import registry as reg
    from repro_torch.serve import Engine, ServeConfig

    dispatch.set_db(dispatch.ProfileDB(
        path=tmp_path_factory.mktemp("db") / "profile.json"))
    cfg = smoke_config("smollm-360m").with_(sparsity=SparsityConfig(
        sparsity=0.5, m=None, tile=None, min_dim=16,
        format="compressed_pallas"))
    yield Engine(cfg, reg.init_params(cfg, 0, device="cpu"), ServeConfig())
    dispatch.set_db(None)


@pytest.mark.parametrize("paged", [False, True])
def test_scheduler_stats_percentiles_are_jax_histogram_edges(engine, paged):
    """``stats()``' p50/p99 equal a JAX ``Histogram`` fed the ok
    completions' own ttft, tpot and latency (tolerance 0)."""
    from repro_torch.serve import Scheduler, synthetic_trace

    sched = Scheduler(engine, n_slots=3, prefill_chunk=4, paged=paged,
                      page_size=4 if paged else None)
    comps = sched.run(synthetic_trace(7, seed=2, vocab=503, prompt_lens=(3, 12),
                                      new_tokens=(2, 7)))
    ok = [c for c in comps if c.status == "ok"]
    assert len(ok) == 7
    stats = sched.stats
    hists = {"ttft": [c.ttft_s for c in ok],
             "tpot": [(c.t_done - c.t_first) / max(c.n_generated - 1, 1)
                      for c in ok],
             "latency": [c.latency_s for c in ok]}
    for name, samples in hists.items():
        h = jmetrics.Registry().histogram(name)
        for v in samples:
            h.observe(v)
        assert stats[f"{name}_p50_s"] == h.percentile(50), name
        assert stats[f"{name}_p99_s"] == h.percentile(99), name
        ours = sched.metrics.histogram(f"{name}_s")
        assert ours.summary() == h.summary(), name
