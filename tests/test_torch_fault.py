"""The port's fault injection (``repro_torch.fault``) against the JAX
package's (``repro.fault``) on the CPU: the schedule grammar and its
rejects, the ``iter``/``n``/``p``/``@match`` schedules, and the same spec
and seed firing on the same probe indices in both packages (exactly: the
plans draw from the same ``random.Random(seed)``)."""
import warnings

import numpy as np
import pytest

from repro import fault as jfault
from repro_torch import fault, obs


@pytest.fixture(autouse=True)
def disarmed():
    fault.uninstall()
    jfault.uninstall()
    yield
    fault.uninstall()
    jfault.uninstall()
    obs.set_enabled(False)
    obs.reset()


def test_sites_are_jax_sites():
    assert fault.SITES == jfault.SITES


@pytest.mark.parametrize("spec", [
    "page_pool.alloc:n=2",
    "scheduler.iter:iter=3",
    "dispatch.execute@compressed_tiled:p=0.25",
    " train.step:iter=0 , ckpt.write:n=1,,data.batch:p=1",
    "kernel.paged_attn@decode:n=0",
    "",
])
def test_grammar_parses_as_jax(spec):
    ours, theirs = fault.parse_spec(spec, seed=4), jfault.parse_spec(spec, seed=4)
    fields = ("site", "match", "iters", "n", "p", "seen", "fired")
    assert [tuple(getattr(r, f) for f in fields) for r in ours.rules] == \
        [tuple(getattr(r, f) for f in fields) for r in theirs.rules]
    assert (ours.seed, ours.spec) == (theirs.seed, theirs.spec)


@pytest.mark.parametrize("spec,match", [
    ("page_pool.alloc", "expected 'site:kind=value'"),
    (":n=1", "expected 'site:kind=value'"),
    ("page_pool.alloc@:n=1", "bad '@' filter"),
    ("@x:n=1", "bad '@' filter"),
    ("page_pool.alloc:n", "expected 'kind=value'"),
    ("page_pool.alloc:every=2", "unknown schedule kind"),
    ("page_pool.alloc:n=two", "bad value"),
    ("page_pool.alloc:p=x", "bad value"),
    ("page_pool.alloc:p=1.5", r"p outside \[0, 1\]"),
    ("page_pool.alloc:p=-0.1", r"p outside \[0, 1\]"),
])
def test_grammar_rejects_as_jax(spec, match):
    with pytest.raises(ValueError, match=match):
        fault.parse_spec(spec)
    with pytest.raises(ValueError, match=match):
        jfault.parse_spec(spec)


def _probes(seed, n=200):
    """A numpy-seeded sequence of (site, ctx) probes over four sites."""
    rng = np.random.default_rng(seed)
    sites = ("scheduler.iter", "page_pool.alloc", "dispatch.execute",
             "train.step")
    impls = ("compressed_tiled", "compressed_pallas", "fused_sparse_pallas")
    out = []
    for i in range(n):
        site = sites[int(rng.integers(len(sites)))]
        ctx = {"it": i}
        if site == "dispatch.execute":
            ctx = {"op": "linear", "impl": impls[int(rng.integers(3))]}
        elif site == "page_pool.alloc":
            ctx = {"seq": int(rng.integers(4)), "kind": "grow"}
        out.append((site, ctx))
    return out


def _fires(mod, spec, seed, probes):
    hits = []
    with mod.fault_scope(spec, seed=seed) as plan:
        for i, (site, ctx) in enumerate(probes):
            try:
                mod.maybe_fail(site, **ctx)
            except mod.InjectedFault as e:
                hits.append((i, e.site, e.hit, tuple(sorted(e.ctx.items()))))
    return hits, dict(plan.fired), dict(plan.probes)


@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("spec", [
    "scheduler.iter:p=0.2,page_pool.alloc:p=0.1",
    "scheduler.iter:iter=4,page_pool.alloc:n=3",
    "dispatch.execute@compressed_pallas:n=2,dispatch.execute:p=0.3",
    "page_pool.alloc@grow:p=0.5,page_pool.alloc:iter=1,train.step:p=1",
    "dispatch.execute@fused_sparse_pallas:iter=2,scheduler.iter:p=0.05",
])
def test_same_spec_and_seed_fire_on_the_same_probes(spec, seed):
    probes = _probes(seed)
    ours = _fires(fault, spec, seed, probes)
    assert ours == _fires(jfault, spec, seed, probes)
    assert ours[0], "the schedule fired nothing: a vacuous comparison"


def test_schedules_iter_n_p_and_match():
    with fault.fault_scope("scheduler.iter:iter=2") as plan:
        got = []
        for i in range(5):
            try:
                fault.maybe_fail("scheduler.iter", it=i)
            except fault.InjectedFault:
                got.append(i)
    assert got == [2] and plan.fired == {"scheduler.iter": 1}
    assert plan.probes == {"scheduler.iter": 5}
    with fault.fault_scope("page_pool.alloc:n=2") as plan:
        for _ in range(2):
            with pytest.raises(fault.InjectedFault):
                fault.maybe_fail("page_pool.alloc", seq=0)
        fault.maybe_fail("page_pool.alloc", seq=0)
    with fault.fault_scope("dispatch.execute@compressed_tiled:n=1") as plan:
        fault.maybe_fail("dispatch.execute", op="linear",
                         impl="compressed_pallas")
        with pytest.raises(fault.InjectedFault) as e:
            fault.maybe_fail("dispatch.execute", op="linear",
                             impl="compressed_tiled")
        fault.maybe_fail("dispatch.execute", op="linear",
                         impl="compressed_tiled")
    assert e.value.ctx == {"op": "linear", "impl": "compressed_tiled"}
    assert (e.value.site, e.value.hit) == ("dispatch.execute", 1)
    assert str(e.value) == str(jfault.InjectedFault(
        "dispatch.execute", 1, {"op": "linear", "impl": "compressed_tiled"}))
    with fault.fault_scope("train.step:p=0"):
        for i in range(50):
            fault.maybe_fail("train.step", step=i)
    with fault.fault_scope("train.step:p=1"):
        with pytest.raises(fault.InjectedFault):
            fault.maybe_fail("train.step", step=0)


def test_scope_restores_install_uninstall():
    assert not fault.enabled() and fault.plan() is None
    fault.maybe_fail("scheduler.iter", it=0)  # disarmed: a no-op
    outer = fault.install("ckpt.write:n=1", seed=3)
    assert fault.enabled() and fault.plan() is outer and outer.seed == 3
    with fault.fault_scope("ckpt.rename:n=1") as inner:
        assert fault.plan() is inner
        fault.maybe_fail("ckpt.write", step=1)  # the outer plan is not armed
    assert fault.plan() is outer
    with pytest.raises(fault.InjectedFault):
        fault.maybe_fail("ckpt.write", step=1)
    ready = fault.parse_spec("data.batch:n=1")
    assert fault.install(ready) is ready
    assert fault.install("") is not None and not fault.enabled()
    fault.uninstall()
    assert not fault.enabled() and fault.plan() is None


def test_unknown_site_warns_once_and_counts():
    obs.set_enabled(True)
    with pytest.warns(RuntimeWarning, match="not registered"):
        fault.parse_spec("scheduler.itr:n=1")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fault.parse_spec("scheduler.itr:n=1")  # warned already
    assert obs.snapshot()["counters"]["fault.unknown_site"] == 1
    assert [e["name"] for e in obs.events()] == ["fault.unknown_site"]


def test_an_injection_is_an_instant_and_a_counter():
    obs.set_enabled(True)
    with fault.fault_scope("page_pool.alloc@grow:n=1"):
        with pytest.raises(fault.InjectedFault):
            fault.maybe_fail("page_pool.alloc", seq=2, kind="grow")
    (ev,) = obs.events()
    assert ev["name"] == "fault.inject" and ev["args"] == {
        "site": "page_pool.alloc", "hit": 1, "rule": "grow", "seq": "2",
        "kind": "grow"}
    assert obs.snapshot()["counters"]["fault.injected"] == 1
