"""Chaos runs of the port against the JAX package on the CPU, at the smoke
size of smollm-360m (JAX params converted) and resnet-tiny.

Both schedulers, the contiguous one and the paged ``alloc="grow"`` one,
serve the same trace under ``scheduler.iter:p=0.2,page_pool.alloc:p=0.1``
with seed 7 in both packages: the plans fire on the same probes, every
request ends with the same status and tokens, ``iter_faults`` and
``preemptions`` agree, and the traces carry the same sequence of ``serve.*``
and ``fault.*`` events.  Exact equality throughout (tolerance 0): the
tokens are greedy and the plans' draws are the same ``random.Random(seed)``
bits.  ``dispatch.execute`` and ``kernel.paged_attn`` are left out of the
cross-package counts: JAX probes them when it traces a step, the port on
every call.

Then the training tier's sites: ``train.step`` and ``data.batch`` faults
kill a ``SparseTrainer`` and the LM ``Trainer`` (each probing the same
sites as many times as JAX's) and a fresh trainer resumes, bit-equal to an
uninterrupted run (the LM one within 1e-6, its CPU bound), and
``ckpt.write``/``ckpt.rename`` faults never commit a checkpoint and leave
no ``tmp.*`` behind the next save."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro import dispatch as jdispatch
from repro import fault as jfault
from repro import obs as jobs
from repro.configs import smoke_config as j_smoke_config
from repro.core.pruning import SparsityConfig as JSparsityConfig
from repro.data import DataConfig as JDataConfig
from repro.models import registry as jreg
from repro.serve import Engine as JEngine
from repro.serve import Scheduler as JScheduler
from repro.serve import ServeConfig as JServeConfig
from repro.serve import synthetic_trace as j_synthetic_trace
from repro.train import SparseTrainConfig as JSparseTrainConfig
from repro.train import SparseTrainer as JSparseTrainer
from repro.train import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro_torch import dispatch, fault, obs
from repro_torch._tree import tree_leaves
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.pruning import SparsityConfig
from repro_torch.data import DataConfig
from repro_torch.serve import STATUSES, Engine, Scheduler, ServeConfig, synthetic_trace
from repro_torch.train import (CheckpointManager, SparseTrainConfig, SparseTrainer,
                               TrainConfig, Trainer)

SPARSE = dict(sparsity=0.5, m=None, tile=None, min_dim=16,
              format="compressed_pallas")
TRACE_KW = dict(seed=3, vocab=503, prompt_lens=(3, 14), new_tokens=(2, 8))
CHAOS = "scheduler.iter:p=0.2,page_pool.alloc:p=0.1"
CHAOS_SEED = 7
CROSS_SITES = ("scheduler.iter", "page_pool.alloc")  # probed alike in both
TRAIN_SITES = ("train.step", "data.batch", "ckpt.write", "ckpt.rename")
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def dbs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dbs")
    dispatch.set_db(dispatch.ProfileDB(path=d / "profile.json"))
    jdispatch.set_db(jdispatch.ProfileDB(path=str(d / "jax.json")))
    yield
    dispatch.set_db(None)
    jdispatch.set_db(None)


@pytest.fixture(autouse=True)
def clean():
    yield
    for mod in (fault, jfault):
        mod.uninstall()
    for o in (obs, jobs):
        o.set_enabled(False)
        o.reset()
    dispatch.clear_quarantine()
    jdispatch.clear_quarantine()


@functools.lru_cache(maxsize=None)
def _params():
    cfg = j_smoke_config("smollm-360m").with_(sparsity=JSparsityConfig(**SPARSE))
    jp, _ = jreg.init_params(cfg, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, jp)


@pytest.fixture(scope="module")
def engines(dbs):
    jcfg = j_smoke_config("smollm-360m").with_(sparsity=JSparsityConfig(**SPARSE))
    cfg = smoke_config("smollm-360m").with_(sparsity=SparsityConfig(**SPARSE))
    return (JEngine(jcfg, _params(), JServeConfig()),
            Engine(cfg, params_from_jax(_params(), device=CPU), ServeConfig()))


MODES = {
    "contiguous": dict(n_slots=3, prefill_chunk=4),
    # 4 pages of 4 rows for 2 growing sequences: real exhaustion as well
    "paged_grow": dict(n_slots=2, paged=True, page_size=4, max_len=24,
                       kv_budget_rows=24, alloc="grow"),
}


def _serve(mod_fault, mod_obs, sched, trace):
    mod_obs.reset()
    mod_obs.set_enabled(True)
    with mod_fault.fault_scope(CHAOS, seed=CHAOS_SEED) as plan:
        comps = sched.run(trace)
    mod_obs.set_enabled(False)
    events = [(e["name"], e["ph"]) for e in mod_obs.events()
              if e["name"].startswith(("serve.", "fault."))]
    return comps, plan, events


def _by_uid(comps):
    out = {}
    for c in comps:
        assert c.uid not in out, f"uid {c.uid} completed twice"
        out[c.uid] = c
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
def test_chaos_serving_matches_jax(engines, mode):
    jengine, tengine = engines
    kw = MODES[mode]
    n = 8
    sched = Scheduler(tengine, **kw)
    jsched = JScheduler(jengine, **kw)
    got, plan, events = _serve(fault, obs, sched,
                               synthetic_trace(n, **TRACE_KW))
    want, jplan, jevents = _serve(jfault, jobs, jsched,
                                  j_synthetic_trace(n, **TRACE_KW))
    fired = {s: plan.fired.get(s, 0) for s in CROSS_SITES}
    assert fired == {s: jplan.fired.get(s, 0) for s in CROSS_SITES}
    assert {s: plan.probes.get(s, 0) for s in CROSS_SITES} == \
        {s: jplan.probes.get(s, 0) for s in CROSS_SITES}
    assert fired["scheduler.iter"] >= 1, "no iteration fault: a vacuous run"
    if kw.get("paged"):
        assert fired["page_pool.alloc"] >= 1, "no allocator fault"
    got, want = _by_uid(got), _by_uid(want)
    assert sorted(got) == sorted(want) == list(range(n))
    for uid, c in got.items():
        assert c.status in STATUSES
        assert c.status == want[uid].status, (uid, c.status, want[uid].status)
        assert np.array_equal(c.tokens, want[uid].tokens), uid
    stats, jstats = sched.stats, jsched.stats
    assert stats["iter_faults"] == jstats["iter_faults"] == fired["scheduler.iter"]
    assert stats["preemptions"] == jstats["preemptions"]
    for s in STATUSES:
        assert stats[f"retired_{s}"] == jstats[f"retired_{s}"], s
    assert events == jevents
    assert events.count(("fault.inject", "i")) == sum(fired.values())
    assert events.count(("serve.iter_fault", "i")) == fired["scheduler.iter"]
    if kw.get("paged"):
        assert sched.page_stats == jsched.page_stats
        assert sched.page_stats["pages_active"] == 0  # no page leaked


@pytest.mark.parametrize("seed", [1, 2])
def test_chaos_survivors_equal_a_clean_run(engines, seed):
    """Under faults every request still ends in one terminal status, no page
    leaks, and each request that ends ``ok`` has the tokens of a run
    without faults (a preempted request restores token-identically)."""
    _, tengine = engines
    kw = MODES["paged_grow"]
    clean = _by_uid(Scheduler(tengine, **kw).run(synthetic_trace(8, **TRACE_KW)))
    sched = Scheduler(tengine, **kw)
    with fault.fault_scope("scheduler.iter:p=0.3,page_pool.alloc:p=0.2",
                           seed=seed):
        got = _by_uid(sched.run(synthetic_trace(8, **TRACE_KW)))
    assert sorted(got) == list(range(8))
    assert sched.page_stats["pages_active"] == 0
    for uid, c in got.items():
        if c.status == "ok":
            assert np.array_equal(c.tokens, clean[uid].tokens), uid
        else:
            assert c.status == "failed", (uid, c.status)
            assert np.array_equal(c.tokens, clean[uid].tokens[:len(c.tokens)])


def test_an_unservable_decode_fails_the_requests_in_flight(engines):
    """Every paged-attention candidate refuses: the decode step raises an
    InjectedFault past the ladder, and the requests it served fail instead
    of wedging the loop; the pools end empty."""
    _, tengine = engines
    sched = Scheduler(tengine, n_slots=2, paged=True, page_size=4)
    with fault.fault_scope("kernel.paged_attn:p=1"):
        comps = sched.run(synthetic_trace(3, **TRACE_KW))
    assert {c.status for c in comps} == {"failed"}
    assert sched.page_stats["pages_active"] == 0


# ---------------------------------------------------------------------------
# The training tier
# ---------------------------------------------------------------------------


def _tcfg(cls, ckpt_dir=None, steps=5):
    return cls(steps=steps, batch=2, lr=0.05,
               ckpt_dir=str(ckpt_dir) if ckpt_dir else None,
               ckpt_every=1 if ckpt_dir else 0)


@pytest.fixture
def one_thread():
    """One intra-op thread: the CPU's threaded kernels may split their sums
    differently between runs (see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t):
    t = t.detach().cpu().contiguous()
    return t.view(torch.uint8).numpy().tobytes() if t.numel() else b""


def _same_bits(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and _bits(x) == _bits(y)


@pytest.mark.parametrize("spec,dies_at", [("train.step:iter=3", 3),
                                          ("data.batch:iter=2", 2)])
def test_train_fault_probes_like_jax_and_resumes_bit_equal(
        tmp_path, one_thread, spec, dies_at):
    ta = SparseTrainer(_tcfg(SparseTrainConfig, tmp_path / "a"), device=CPU)
    ta.run()
    tb = SparseTrainer(_tcfg(SparseTrainConfig, tmp_path / "b"), device=CPU)
    with fault.fault_scope(spec) as plan:
        with pytest.raises(fault.InjectedFault):
            tb.run()
        tb.ckpt.wait()  # drain the in-flight async save before "restarting"
    jb = JSparseTrainer(_tcfg(JSparseTrainConfig, tmp_path / "jb"))
    with jfault.fault_scope(spec) as jplan:
        with pytest.raises(jfault.InjectedFault):
            jb.run()
        jb.ckpt.wait()
    assert plan.fired == jplan.fired == {spec.split(":")[0]: 1}
    assert {s: plan.probes.get(s, 0) for s in TRAIN_SITES} == \
        {s: jplan.probes.get(s, 0) for s in TRAIN_SITES}
    assert tb.ckpt.latest_step() == jb.ckpt.latest_step() == dies_at
    tc = SparseTrainer(_tcfg(SparseTrainConfig, tmp_path / "b"), device=CPU)
    out = tc.run()
    assert out["start_step"] == dies_at and out["final_step"] == 5
    _same_bits(ta.params, tc.params)
    _same_bits(ta.mom, tc.mom)


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn((4, 3), generator=g),
            "idx": torch.arange(6, dtype=torch.int32)}


def test_ckpt_write_fault_surfaces_and_commits_nothing(tmp_path):
    mgr = CheckpointManager(tmp_path)
    with fault.fault_scope("ckpt.write:n=1"):
        mgr.save(1, {"params": _tree()}, blocking=False)
        with pytest.raises(fault.InjectedFault):
            mgr.wait()
    assert mgr.latest_step() is None and list(mgr.dir.iterdir()) == []
    mgr.save(2, {"params": _tree()})  # the failure was consumed
    assert mgr.latest_step() == 2


def test_ckpt_rename_fault_leaves_only_a_tmp_the_next_save_collects(tmp_path):
    obs.set_enabled(True)
    mgr = CheckpointManager(tmp_path, keep=2)
    mgr.save(1, {"params": _tree()})
    with fault.fault_scope("ckpt.rename:n=1"):
        with pytest.raises(fault.InjectedFault):
            mgr.save(2, {"params": _tree()})
    assert [d.name for d in mgr.dir.glob("step_*")] == ["step_00000001"]
    assert len(list(mgr.dir.glob("tmp.*"))) == 1
    mgr.save(3, {"params": _tree()})
    assert list(mgr.dir.glob("tmp.*")) == []
    assert mgr.valid_steps() == [3, 1]
    for d in mgr.dir.glob("step_*"):
        assert mgr.validate(d, deep=True) is None, d
    counters = obs.snapshot()["counters"]
    assert counters["ckpt.saved"] == 2 and counters["ckpt.tmp_gc"] == 1
    saves = [e["args"]["step"] for e in obs.events() if e["name"] == "ckpt.save"]
    assert saves == [1, 3]


def test_a_skipped_invalid_checkpoint_is_counted(tmp_path):
    obs.set_enabled(True)
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(1, {"params": _tree()})
    mgr.save(2, {"params": _tree()})
    (mgr.dir / "step_00000002" / "manifest.json").write_text("{torn")
    trees, meta = mgr.restore(None, {"params": _tree()})
    assert meta["step"] == 1
    assert obs.snapshot()["counters"]["ckpt.invalid_skipped"] == 1
    (ev,) = [e for e in obs.events() if e["name"] == "ckpt.invalid"]
    assert ev["args"]["dir"] == "step_00000002"


# tests/test_torch_train.py's smoke LM (compressed_xla linears)
LM_SHAPE = dict(n_layers=2, d_model=64, d_ff=96, n_heads=2, n_kv_heads=1,
                head_dim=32, vocab_size=128)
LM_SPARSE = dict(sparsity=0.5, m=None, tile=None, min_dim=64,
                 format="compressed_xla")
LM_DATA = dict(vocab_size=128, batch=8, seq_len=16, seed=1)


def _lm_trainer(package, ckpt_dir, params=None):
    tcfg = dict(steps=6, ckpt_dir=str(ckpt_dir), ckpt_every=1, log_every=1)
    if package == "jax":
        cfg = j_smoke_config("smollm-360m").with_(
            sparsity=JSparsityConfig(**LM_SPARSE), **LM_SHAPE)
        return JTrainer(cfg, JDataConfig(**LM_DATA), train_cfg=JTrainConfig(**tcfg))
    cfg = smoke_config("smollm-360m").with_(
        sparsity=SparsityConfig(**LM_SPARSE), **LM_SHAPE)
    return Trainer(cfg, DataConfig(**LM_DATA), train_cfg=TrainConfig(**tcfg),
                   params=params, device=CPU)


def test_lm_trainer_data_fault_probes_like_jax_and_resumes(tmp_path):
    """A ``data.batch`` fault at step 4 kills the LM Trainer of each
    package after probing the same sites as often; a fresh port trainer
    resumes at step 4 and ends within 1e-6 of an uninterrupted run (the LM
    resume's bound on the CPU, as JAX's)."""
    spec = "data.batch:iter=4"
    probes = {}
    for package, mod in (("port", fault), ("jax", jfault)):
        t = _lm_trainer(package, tmp_path / package)
        with mod.fault_scope(spec) as plan:
            with pytest.raises(mod.InjectedFault):
                t.run()
            t.ckpt.wait()
        assert plan.fired == {"data.batch": 1}
        assert t.ckpt.latest_step() == 4
        probes[package] = {s: plan.probes.get(s, 0) for s in TRAIN_SITES}
    assert probes["port"] == probes["jax"]
    assert probes["port"]["train.step"] == 5 and probes["port"]["data.batch"] == 5
    p0 = _lm_trainer("port", tmp_path / "p0").params
    straight = _lm_trainer("port", tmp_path / "a", params=p0)
    straight.run()
    dead = _lm_trainer("port", tmp_path / "b", params=p0)
    with fault.fault_scope(spec):
        with pytest.raises(fault.InjectedFault):
            dead.run()
        dead.ckpt.wait()
    resumed = _lm_trainer("port", tmp_path / "b", params=p0)
    out = resumed.run()
    assert out["start_step"] == 4 and out["final_step"] == 6
    for a, c in zip(tree_leaves(straight.params), tree_leaves(resumed.params),
                    strict=True):
        np.testing.assert_allclose(a.float().numpy(), c.float().numpy(),
                                   atol=1e-6)
