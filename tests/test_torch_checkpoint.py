"""The port's integrity-verified checkpoints (``repro_torch.train.checkpoint``):
every case of ``tests/test_checkpoint_integrity.py`` on the port's manager
(faults injected from outside, by monkeypatch, where the JAX tests use its
fault sites), the substrate round trips, host copies taken before an async
save starts, and the two packages restoring each other's checkpoints bit
for bit: resnet-tiny's ``{"params", "mom"}`` and a smoke LM's ``{"params",
"opt"}`` with bf16 leaves."""
import json
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_vision_config as j_get_vision_config
from repro.configs import smoke_config as j_smoke_config
from repro.core.pruning import SparsityConfig as JSparsityConfig
from repro.core.sparse_linear import unbox_tree
from repro.models import registry as jreg
from repro.models import vision as jv
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro_torch._tree import keystr, leaves_with_path, tree_leaves, tree_map
from repro_torch.convert import params_from_jax
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.checkpoint import (
    ARRAYS,
    MANIFEST,
    META,
    CheckpointError,
    CheckpointManager,
)


def _tree():
    """Mixed-dtype tree covering the formats a pruned model checkpoints:
    f32 weights, bf16 scales, int32 packed indices, bool masks."""
    return {
        "w": torch.arange(12, dtype=torch.float32).reshape(3, 4) / 7.0,
        "scale": torch.full((4, 2), 0.375, dtype=torch.bfloat16),
        "idx": torch.arange(8, dtype=torch.int32).reshape(2, 4),
        "mask": torch.tensor([True, False, True, True]),
    }


def _bits(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _leaves_bitwise_equal(a, b):
    la, lb = leaves_with_path(a), leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype, path
        assert x.shape == y.shape, path
        assert _bits(x) == _bits(y), path


def _truncate(d, frac=0.5):
    f = d / ARRAYS
    data = f.read_bytes()
    f.write_bytes(data[: int(len(data) * frac)])


def _fail_once(monkeypatch, obj, name, exc=OSError):
    """Replace ``obj.name`` by a function that raises ``exc`` on its first
    call and calls the original after (the twin of a fault spec ``n=1``)."""
    real = getattr(obj, name)
    calls = []

    def once(*args, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise exc(f"injected {name} failure")
        return real(*args, **kw)

    monkeypatch.setattr(obj, name, once)


class TestManifest:
    def test_manifest_is_complete_commit_record(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        mgr.save(3, {"params": _tree()})
        d = mgr.dir / "step_00000003"
        man = json.loads((d / MANIFEST).read_text())
        assert man["step"] == 3
        assert man["arrays_bytes"] == (d / ARRAYS).stat().st_size
        assert set(man["arrays"]) == {
            "params|['w']", "params|['scale']", "params|['idx']",
            "params|['mask']"}
        ent = man["arrays"]["params|['idx']"]
        assert ent["dtype"] == "int32" and ent["shape"] == [2, 4]
        want = zlib.crc32(np.arange(8, dtype=np.int32).tobytes())
        assert ent["crc32"] == want
        assert man["arrays"]["params|['scale']"]["dtype"] == "bfloat16"

    def test_mixed_dtype_bitwise_roundtrip(self, tmp_path):
        """bf16 survives the npz void-record round trip, ints and bools keep
        their dtypes: every leaf restores bitwise identical."""
        mgr = CheckpointManager(tmp_path)
        tree = _tree()
        mgr.save(1, {"params": tree}, metadata={"step": 1})
        out, meta = mgr.restore(None, {"params": tree})
        assert meta["step"] == 1
        _leaves_bitwise_equal(tree, out["params"])

    def test_pruned_vision_tree_roundtrip(self, tmp_path):
        """A real pruned-model tree (compressed convs with int32 idx and
        conv_geom, the head) round-trips bitwise through save/restore."""
        from repro_torch.configs import get_vision_config
        from repro_torch.models.vision import vision_init

        params = vision_init(get_vision_config("resnet-tiny"), 0, device="cpu")
        mgr = CheckpointManager(tmp_path)
        mgr.save(1, {"params": params})
        out, _ = mgr.restore(1, {"params": params})
        _leaves_bitwise_equal(params, out["params"])

    def test_dtype_mismatch_requires_explicit_cast(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        mgr.save(1, {"params": {"a": torch.ones((2, 2), dtype=torch.float32)}})
        proto = {"a": torch.zeros((2, 2), dtype=torch.bfloat16)}
        with pytest.raises(ValueError, match="dtype mismatch"):
            mgr.restore(None, {"params": proto})
        out, _ = mgr.restore(None, {"params": proto}, cast=True)
        assert out["params"]["a"].dtype == torch.bfloat16
        assert torch.equal(out["params"]["a"].float(), torch.ones((2, 2)))


class TestCorruptionFallback:
    def test_truncated_newest_falls_back_to_valid(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        t1 = _tree()
        t2 = tree_map(lambda v: v + 1 if v.dtype != torch.bool else v, _tree())
        mgr.save(1, {"params": t1}, metadata={"tag": "one"})
        mgr.save(2, {"params": t2}, metadata={"tag": "two"})
        _truncate(mgr.dir / "step_00000002")
        assert mgr.latest_step() == 1
        out, meta = mgr.restore(None, {"params": t1})
        assert meta["tag"] == "one"
        _leaves_bitwise_equal(t1, out["params"])
        # an EXPLICIT request for the torn step is an error, not a fallback
        with pytest.raises(CheckpointError, match="bytes"):
            mgr.restore(2, {"params": t2})

    @pytest.mark.parametrize("frac", [0.0, 0.25, 0.6, 0.95])
    def test_truncation_fuzz_always_detected(self, tmp_path, frac):
        mgr = CheckpointManager(tmp_path)
        mgr.save(1, {"params": _tree()})
        d = mgr.dir / "step_00000001"
        _truncate(d, frac=frac)
        assert mgr.validate(d) is not None
        assert mgr.latest_step() is None

    def test_missing_meta_invalidates(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        mgr.save(1, {"params": _tree()})
        d = mgr.dir / "step_00000001"
        (d / META).unlink()
        assert mgr.validate(d) == "missing meta.json"
        assert mgr.latest_step() is None

    def test_missing_manifest_is_uncommitted(self, tmp_path):
        """No manifest == the writer died before the commit marker: the
        directory is invisible to latest_step/restore."""
        mgr = CheckpointManager(tmp_path)
        mgr.save(1, {"params": _tree()})
        (mgr.dir / "step_00000001" / MANIFEST).unlink()
        assert mgr.latest_step() is None
        with pytest.raises(CheckpointError, match="no valid checkpoint"):
            mgr.restore(None, {"params": _tree()})

    def test_bit_rot_caught_by_deep_check(self, tmp_path):
        """Same-size corruption passes the shallow size check but fails the
        deep (crc) one; restore(None) skips to the older valid step."""
        mgr = CheckpointManager(tmp_path)
        t1 = _tree()
        mgr.save(1, {"params": t1}, metadata={"tag": "good"})
        mgr.save(2, {"params": t1}, metadata={"tag": "rot"})
        f = mgr.dir / "step_00000002" / ARRAYS
        data = bytearray(f.read_bytes())
        mid = len(data) // 2
        data[mid] ^= 0xFF
        data[mid + 1] ^= 0xFF
        f.write_bytes(bytes(data))
        d = mgr.dir / "step_00000002"
        assert mgr.validate(d) is None          # shallow: size still matches
        assert mgr.validate(d, deep=True) is not None
        out, meta = mgr.restore(None, {"params": t1})
        assert meta["tag"] == "good"
        _leaves_bitwise_equal(t1, out["params"])

    def test_all_invalid_raises_with_reasons(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        mgr.save(1, {"params": _tree()})
        _truncate(mgr.dir / "step_00000001", frac=0.3)
        with pytest.raises(CheckpointError, match="skipped"):
            mgr.restore(None, {"params": _tree()})

    def test_empty_dir_raises_file_not_found(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        with pytest.raises(FileNotFoundError):
            mgr.restore(None, {"params": _tree()})
        with pytest.raises(FileNotFoundError):
            mgr.restore(7, {"params": _tree()})


class TestGC:
    def test_orphan_tmp_gc_at_init(self, tmp_path):
        orphan = tmp_path / "tmp.5.12345"
        orphan.mkdir(parents=True)
        (orphan / ARRAYS).write_bytes(b"partial write")
        CheckpointManager(tmp_path)
        assert not orphan.exists()

    def test_keep_gc_counts_only_valid(self, tmp_path):
        """An invalid directory neither counts against `keep` nor shields a
        valid one: corrupt step 4, save step 5 with keep=2: steps 3 and 5
        survive as the two newest VALID checkpoints."""
        mgr = CheckpointManager(tmp_path, keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, {"params": _tree()})
        _truncate(mgr.dir / "step_00000004")
        mgr.save(5, {"params": _tree()})
        names = sorted(p.name for p in mgr.dir.glob("step_*"))
        assert names == ["step_00000003", "step_00000004", "step_00000005"]
        assert mgr.valid_steps() == [5, 3]
        assert mgr.latest_step() == 5


class TestAsyncFailure:
    def test_write_fault_surfaces_on_wait(self, tmp_path, monkeypatch):
        mgr = CheckpointManager(tmp_path)
        _fail_once(monkeypatch, ckpt.np, "savez")
        mgr.save(1, {"params": _tree()}, blocking=False)
        with pytest.raises(OSError, match="injected savez"):
            mgr.wait()
        assert mgr.latest_step() is None
        # the failure was consumed: the manager is reusable
        mgr.save(2, {"params": _tree()})
        assert mgr.latest_step() == 2

    def test_write_fault_surfaces_on_next_save(self, tmp_path, monkeypatch):
        mgr = CheckpointManager(tmp_path)
        _fail_once(monkeypatch, ckpt.np, "savez")
        mgr.save(1, {"params": _tree()}, blocking=False)
        mgr._thread.join()
        with pytest.raises(OSError, match="injected savez"):
            mgr.save(2, {"params": _tree()})
        mgr.save(2, {"params": _tree()})
        assert mgr.latest_step() == 2

    def test_rename_fault_never_commits(self, tmp_path, monkeypatch):
        """A writer killed between the manifest write and the atomic rename
        leaves only a tmp.* orphan: no step dir, and the orphan is removed
        by the next manager (a restarted trainer)."""
        mgr = CheckpointManager(tmp_path)
        _fail_once(monkeypatch, ckpt.os, "replace")
        with pytest.raises(OSError, match="injected replace"):
            mgr.save(1, {"params": _tree()})
        assert list(mgr.dir.glob("step_*")) == []
        assert list(mgr.dir.glob("tmp.*")) != []
        mgr2 = CheckpointManager(tmp_path)
        assert list(mgr2.dir.glob("tmp.*")) == []
        assert mgr2.latest_step() is None
        mgr.save(1, {"params": _tree()})
        assert mgr.latest_step() == 1

    def test_shape_mismatch_rejected(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        mgr.save(1, {"params": {"a": torch.zeros((2, 2))}})
        with pytest.raises(ValueError, match="shape mismatch"):
            mgr.restore(None, {"params": {"a": torch.zeros((3, 3))}})

    def test_async_save_writes_the_values_of_the_save_call(self, tmp_path):
        """The host copies are taken in save(), before the writer thread
        starts: changing the tensors after save() returns changes nothing
        that is written."""
        mgr = CheckpointManager(tmp_path)
        tree = _tree()
        want = tree_map(torch.clone, tree)
        mgr.save(1, {"params": tree}, blocking=False)
        tree["w"].add_(1.0)
        tree["scale"].mul_(2.0)
        mgr.wait()
        out, _ = mgr.restore(1, {"params": want})
        _leaves_bitwise_equal(want, out["params"])


class TestSubstrate:
    """The round trips of ``tests/test_substrate.py::TestCheckpoint``."""

    def test_roundtrip(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        tree = {"a": torch.arange(6).reshape(2, 3).float(),
                "b": {"c": torch.ones((4,), dtype=torch.int32)},
                "s": [torch.zeros((), dtype=torch.int32), (torch.ones(2),)]}
        mgr.save(10, {"params": tree}, metadata={"x": 1})
        out, meta = mgr.restore(None, {"params": tree})
        _leaves_bitwise_equal(tree, out["params"])
        assert isinstance(out["params"]["s"][1], tuple)
        assert out["params"]["s"][0].shape == ()
        assert meta["step"] == 10 and meta["x"] == 1

    def test_keeps_latest_and_gc(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=2)
        tree = {"a": torch.zeros((2,))}
        for s in [1, 2, 3, 4]:
            mgr.save(s, {"params": tree})
        assert mgr.latest_step() == 4
        assert len(list(mgr.dir.glob("step_*"))) == 2

    def test_async_save(self, tmp_path):
        mgr = CheckpointManager(tmp_path)
        mgr.save(1, {"params": {"a": torch.zeros((128, 128))}}, blocking=False)
        mgr.wait()
        assert mgr.latest_step() == 1


# ---------------------------------------------------------------------------
# Each package restores the other's checkpoints, bit for bit
# ---------------------------------------------------------------------------


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_vision_trees():
    """resnet-tiny's JAX params and a momentum of non-zero float leaves
    (int and bool leaves zero), numpy leaves."""
    cfg = j_get_vision_config("resnet-tiny")
    params = _np_tree(unbox_tree(jv.vision_init(cfg, jax.random.PRNGKey(0)))[0])
    rng = np.random.default_rng(3)
    mom = jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(p.dtype)
        if np.issubdtype(p.dtype, np.floating) else np.zeros_like(p), params)
    return {"params": params, "mom": mom}


def _jax_lm_trees():
    """A bf16 smoke LM (compressed linears, int32 idx) and its AdamW state
    after one update: f32 m/v/master, int8 slots, a 0-d int32 step."""
    cfg = j_smoke_config("smollm-360m").with_(
        param_dtype="bfloat16", sparsity=JSparsityConfig(
            sparsity=0.5, format="compressed_xla", min_dim=16))
    params, _ = jreg.init_params(cfg, jax.random.PRNGKey(0))
    opt = j_adamw_init(params)
    rng = np.random.default_rng(4)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype)
        if jnp.issubdtype(p.dtype, jnp.floating)
        else np.zeros(p.shape, jax.dtypes.float0), params)
    params, opt, _ = j_adamw_update(params, grads, opt, JAdamWConfig())
    assert "master" in opt and params["embed"].dtype == jnp.bfloat16
    return {"params": _np_tree(params), "opt": _np_tree(opt)}


TREES = {"vision": _jax_vision_trees, "lm_bf16": _jax_lm_trees}


def _assert_port_equals_jax(port_tree, jax_tree):
    jl = jax.tree_util.tree_leaves_with_path(jax_tree)
    tl = leaves_with_path(port_tree)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [
        keystr(p) for p, _ in tl]
    for (path, a), (_, t) in zip(jl, tl):
        assert str(t.dtype) == f"torch.{a.dtype.name}", path
        assert tuple(t.shape) == a.shape, path
        assert _bits(t) == np.ascontiguousarray(a).tobytes(), path


@pytest.mark.parametrize("which", list(TREES))
def test_the_port_restores_a_jax_checkpoint(tmp_path, which):
    jtrees = TREES[which]()
    JCheckpointManager(tmp_path).save(5, jtrees, metadata={"tag": "jax"})
    protos = {k: params_from_jax(v, device="cpu") for k, v in jtrees.items()}
    zeroed = {k: tree_map(torch.zeros_like, v) for k, v in protos.items()}
    mgr = CheckpointManager(tmp_path)
    assert mgr.validate(mgr.dir / "step_00000005", deep=True) is None
    out, meta = mgr.restore(None, zeroed)
    assert meta["tag"] == "jax" and meta["step"] == 5
    for k in jtrees:
        _assert_port_equals_jax(out[k], jtrees[k])


@pytest.mark.parametrize("which", list(TREES))
def test_jax_restores_a_port_checkpoint(tmp_path, which):
    jtrees = TREES[which]()
    trees = {k: params_from_jax(v, device="cpu") for k, v in jtrees.items()}
    CheckpointManager(tmp_path).save(7, trees, metadata={"tag": "port"})
    jmgr = JCheckpointManager(tmp_path)
    assert jmgr.validate(jmgr.dir / "step_00000007", deep=True) is None
    out, meta = jmgr.restore(None, jtrees)
    assert meta["tag"] == "port" and meta["step"] == 7
    for k in jtrees:
        _assert_port_equals_jax(trees[k], _np_tree(out[k]))
        for a, b in zip(jax.tree_util.tree_leaves(out[k]),
                        jax.tree_util.tree_leaves(jtrees[k])):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_keys_are_jax_keystr():
    """The port keys a leaf as JAX's keystr does, dicts in sorted order."""
    tree = {"b": [torch.zeros(1), {"x": torch.zeros(1)}],
            "a": (torch.zeros(1), None)}
    jtree = {"b": [np.zeros(1), {"x": np.zeros(1)}], "a": (np.zeros(1), None)}
    assert list(ckpt._flatten(tree)) == [
        jax.tree_util.keystr(p)
        for p, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    assert len(tree_leaves(tree)) == 3
