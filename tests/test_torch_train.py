"""The port's training tier against the JAX package's, on the CPU: AdamW
(``repro_torch.optim``), the int8 gradient quantizer, the crash-safe
``SparseTrainer`` (bitwise kill -> resume), the LM ``Trainer`` and its
``make_train_step``, the fault machinery, the training launcher, and the
pruning leftovers (``prune_tree``, ``compress_layer``,
``unstructured_mask``, ``mask_is_colwise``, ``mask_nm_counts``).

Inputs are made by numpy from a seed and pass between the packages as
numpy.  AdamW amplifies rounding (its first updates are about
``lr * g / (|g| + eps)``, so a gradient element near zero turns a 1e-7
difference into a visible one), so the optimizer is first held against
JAX's on the same gradients, tightly, and only then whole trainer runs,
with the tolerances stated where they are used."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.core import pruning as jpruning
from repro.core.pruning import SparsityConfig as JSparsityConfig
from repro.core.sparse_linear import compress_layer as j_compress_layer
from repro.data import DataConfig as JDataConfig
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import clip_by_global_norm as j_clip
from repro.optim import global_norm as j_global_norm
from repro.train import SparseTrainConfig as JSparseTrainConfig
from repro.train import SparseTrainer as JSparseTrainer
from repro.train import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro_torch._tree import leaves_with_path, tree_leaves
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import pruning
from repro_torch.core.pruning import SparsityConfig
from repro_torch.core.sparse_linear import compress_layer
from repro_torch.data import DataConfig
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
)
from repro_torch.optim.grad_compress import (
    compress_with_feedback,
    dequantize_int8,
    quantize_int8,
    wire_bytes_saved,
)
from repro_torch.train import (
    SparseTrainConfig,
    SparseTrainer,
    StepWatchdog,
    StragglerMonitor,
    TrainConfig,
    Trainer,
)

REPO = Path(__file__).resolve().parent.parent
CPU = "cpu"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bits(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _f32(t) -> np.ndarray:
    return (t.detach().float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t, dtype=np.float32))


def _pairs(port_tree, jax_tree):
    """(path, port leaf, JAX leaf as numpy) in JAX's flatten order, after
    checking that the two trees have the same leaves."""
    jl = jax.tree_util.tree_leaves_with_path(jax_tree)
    tl = leaves_with_path(port_tree)
    assert len(jl) == len(tl)
    return [(path, t, np.asarray(a)) for (path, a), (_, t) in zip(jl, tl)]


def _max_err_of_max(got, want) -> float:
    """max |got - want| over max |want| (1 where want is all zero)."""
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30)
                 ) if want.size else 0.0


# ---------------------------------------------------------------------------
# AdamW against JAX's, on the same numpy gradients
# ---------------------------------------------------------------------------

ADAM_TOL = 1e-6  # of each leaf's max |value|: the same float32 ops in order
BF16_ULP = 2.0 ** -7  # one bf16 step at [1, 2), relative


def _adam_tree(rng):
    return {
        "w": rng.standard_normal((8, 16)).astype(np.float32),
        "layers": [{"b": rng.standard_normal(16).astype(np.float32) * 0.1},
                   {"b": rng.standard_normal(16).astype(np.float32)}],
        "idx": np.arange(12, dtype=np.int32).reshape(4, 3),
        "mask": rng.random((4,)) > 0.5,
    }


def _to_torch(tree, dtype):
    """numpy tree -> tensors, the float leaves cast to ``dtype``; ``None``
    stays ``None``."""
    if isinstance(tree, dict):
        return {k: _to_torch(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v, dtype) for v in tree]
    if tree is None:
        return None
    t = torch.from_numpy(np.array(tree))
    return t.to(dtype) if t.is_floating_point() else t


def _to_jax(tree, like, dtype):
    """numpy tree -> JAX arrays, the float leaves cast to ``dtype``;
    ``None`` -> a float0 cotangent of the shape of ``like``'s leaf there."""
    def one(a, p):
        if a is None:
            return np.zeros(p.shape, jax.dtypes.float0)
        return jnp.asarray(a, dtype if np.issubdtype(a.dtype, np.floating)
                           else a.dtype)

    return jax.tree_util.tree_map(one, tree, like, is_leaf=lambda x: x is None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax_over_three_steps(dtype):
    """Three updates on the same gradients: the state (m, v, master, step)
    within ADAM_TOL of each leaf's max of JAX's, the float32 params too
    (bf16 params within one bf16 step: their f32 masters agree within
    ADAM_TOL, and a last-place difference may round the cast either way),
    the global norm within 1e-6 relative; integer and bool leaves
    untouched.  The first step's gradients are tiny (the update is then
    about lr * sign(g)); the later ones' norm is above grad_clip, so the
    clip scales them."""
    rng = np.random.default_rng(0)
    base = _adam_tree(rng)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jparams = _to_jax(base, base, jdt)
    jstate = j_adamw_init(jparams)
    params = _to_torch(base, tdt)
    state = adamw_init(params)
    assert ("master" in state) == (dtype == "bfloat16") == ("master" in jstate)
    cfg = dict(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
    for step in range(3):
        scale = 1e-3 if step == 0 else 0.5
        g = jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(a.shape) * scale).astype(np.float32)
            if np.issubdtype(a.dtype, np.floating) else None, base)
        jparams, jstate, jnorm = j_adamw_update(
            jparams, _to_jax(g, base, jdt), jstate, JAdamWConfig(**cfg))
        params, state, norm = adamw_update(params, _to_torch(g, tdt), state,
                                           AdamWConfig(**cfg))
        assert abs(float(norm) - float(jnorm)) <= 1e-6 * float(jnorm)
        for path, t, a in _pairs(state, _np(jstate)):
            assert str(t.dtype) == f"torch.{a.dtype.name}", path
            if t.is_floating_point():
                assert _max_err_of_max(t, a) <= ADAM_TOL, (step, path)
            else:
                assert _bits(t) == a.tobytes(), path
        for path, t, a in _pairs(params, _np(jparams)):
            assert str(t.dtype) == f"torch.{a.dtype.name}", path
            if not t.is_floating_point():
                assert _bits(t) == np.ascontiguousarray(a).tobytes(), path
            elif dtype == "bfloat16":
                d = np.abs(_f32(t) - _f32(a))
                assert (d <= BF16_ULP * np.abs(_f32(a))).all(), (step, path)
            else:
                assert _max_err_of_max(t, a) <= ADAM_TOL, (step, path)
    assert int(state["step"]) == 3 and state["step"].dtype == torch.int32


def test_adamw_int_leaves_untouched_and_state_layout():
    params = {"w": torch.zeros(4), "idx": torch.arange(4, dtype=torch.int32)}
    state = adamw_init(params)
    assert state["m"]["idx"].dtype == torch.int8
    assert state["step"].shape == () and "master" not in state
    p2, s2, _ = adamw_update(params, {"w": torch.ones(4), "idx": None}, state,
                             AdamWConfig())
    assert torch.equal(p2["idx"], torch.arange(4, dtype=torch.int32))
    assert p2["idx"].dtype == torch.int32
    assert torch.equal(s2["m"]["idx"], state["m"]["idx"])
    assert torch.equal(params["w"], torch.zeros(4))  # functional
    assert adamw_init(params, keep_master=True)["master"]["w"] is not params["w"]


def test_clip_and_global_norm_match_jax():
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((5, 7)).astype(np.float32) * 3,
            "b": [rng.standard_normal(11).astype(np.float32)],
            "i": np.arange(3, dtype=np.int32)}
    t = params_from_jax(tree, device=CPU)
    assert abs(float(global_norm(t)) - float(j_global_norm(tree))) <= 1e-6 * float(
        j_global_norm(tree))
    for max_norm in (0.5, 1e6):
        got, norm = clip_by_global_norm(t, max_norm)
        want, jnorm = j_clip(tree, max_norm)
        assert abs(float(norm) - float(jnorm)) <= 1e-6 * float(jnorm)
        for path, g, w in _pairs(got, _np(want)):
            if g.is_floating_point():
                assert _max_err_of_max(g, w) <= 1e-6, path
            else:
                assert _bits(g) == w.tobytes()


def test_grad_clip_reports_the_norm_before_the_clip():
    params = {"w": torch.zeros(4)}
    _, _, gnorm = adamw_update(params, {"w": torch.full((4,), 1e6)},
                               adamw_init(params), AdamWConfig(grad_clip=1.0))
    assert float(gnorm) > 1e5


def test_adamw_converges_quadratic():
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    state = adamw_init(params)
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    for _ in range(300):
        g = {"w": 2 * (params["w"] - target)}
        params, state, _ = adamw_update(params, g, state, cfg)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=0.05)


# ---------------------------------------------------------------------------
# int8 gradient compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_quantize_bounded_error_and_matches_jax(seed):
    from repro.optim.grad_compress import quantize_int8 as j_quantize_int8

    x = np.random.default_rng(seed).standard_normal(256).astype(np.float32) * 3
    q, s = quantize_int8(torch.from_numpy(x))
    err = dequantize_int8(q, s) - torch.from_numpy(x)
    assert float(err.abs().max()) <= float(s) * 0.5 + 1e-6
    jq, js = j_quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)


def test_error_feedback_reduces_bias():
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(512)
                         .astype(np.float32))
    err = torch.zeros_like(g)
    total = torch.zeros_like(g)
    n = 50
    for _ in range(n):
        q, s, err = compress_with_feedback(g, err)
        total = total + dequantize_int8(q, s)
    np.testing.assert_allclose((total / n).numpy(), g.numpy(), atol=1e-3)
    assert wire_bytes_saved((4, 8)) == (128, 36)
    assert wire_bytes_saved((4, 8), torch.bfloat16) == (64, 36)


# ---------------------------------------------------------------------------
# SparseTrainer
# ---------------------------------------------------------------------------

SGD_TOL = 1e-4  # of each leaf's max |value|, PR 27's train-step tolerance
VBATCH = 2


def _cfg(ckpt_dir=None, steps=5, **kw):
    return SparseTrainConfig(
        steps=steps, batch=VBATCH, lr=0.05,
        ckpt_dir=str(ckpt_dir) if ckpt_dir else None,
        ckpt_every=1 if ckpt_dir else 0, **kw)


def _numpy_batch(step, batch=VBATCH):
    """resnet-tiny's CNHW batch of a step, drawn by numpy, the same for
    both packages' trainers."""
    rng = np.random.default_rng((11, step))
    x = rng.standard_normal((3, batch, 32, 32)).astype(np.float32)
    labels = rng.integers(0, 10, batch).astype(np.int32)
    return x, labels


class _SameBatches(SparseTrainer):
    def batch_at(self, step):
        x, y = _numpy_batch(step)
        return torch.from_numpy(x), torch.from_numpy(y).long()


class _JSameBatches(JSparseTrainer):
    def batch_at(self, step):
        x, y = _numpy_batch(step)
        return jnp.asarray(x), jnp.asarray(y)


def test_sparse_trainer_matches_jax_over_three_steps(monkeypatch):
    """Three steps of both trainers from the same weights on the same
    numpy batches: losses within 1e-5 relative, params and momentum
    within SGD_TOL of each leaf's max, integer leaves bit-equal."""
    monkeypatch.setenv("REPRO_DISPATCH_FORCE", "im2col_sparse_xla")
    jt = _JSameBatches(JSparseTrainConfig(steps=3, batch=VBATCH, lr=0.05))
    t = _SameBatches(_cfg(steps=3), params=params_from_jax(_np(jt.params),
                                                           device=CPU))
    jout, out = jt.run(), t.run()
    assert [h["step"] for h in out["history"]] == [0, 1, 2]
    for h, jh in zip(out["history"], jout["history"], strict=True):
        assert abs(h["loss"] - jh["loss"]) <= 1e-5 * abs(jh["loss"])
    for port_tree, jax_tree in ((t.params, jt.params), (t.mom, jt.mom)):
        for path, g, w in _pairs(port_tree, _np(jax_tree)):
            if g.is_floating_point():
                assert _max_err_of_max(g, w) <= SGD_TOL, path
            else:
                assert _bits(g) == w.tobytes(), path


class _OneBatch(SparseTrainer):
    def batch_at(self, step):
        return super().batch_at(0)


def test_sparse_trainer_loss_decreases():
    """The loop moves the weights downhill.  On one fixed batch, as
    ``vision.train_smoke`` trains: the stream's fresh batches move a
    random-weight resnet-tiny too little in 12 steps to tell (its loss
    stays near ln 10 either way), in the port as in JAX."""
    out = _OneBatch(SparseTrainConfig(steps=12, batch=4, lr=0.05),
                    device=CPU).run()
    losses = [h["loss"] for h in out["history"]]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]) - 0.3


def test_sparse_trainer_clean_run_result_shape(tmp_path):
    out = SparseTrainer(_cfg(tmp_path, steps=3), device=CPU).run()
    assert out["final_step"] == 3
    assert out["start_step"] == 0
    assert out["preempted"] is False
    assert out["watchdog_fired"] is False


class _Killed(RuntimeError):
    pass


class _DiesAtStep3(SparseTrainer):
    """Dies at the top of step 3, as the JAX test's
    ``fault_scope("train.step:iter=3")`` makes its trainer die."""

    def batch_at(self, step):
        if step == 3:
            raise _Killed("killed at step 3")
        return super().batch_at(step)


def _same_bits(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and _bits(x) == _bits(y)


@pytest.fixture
def one_thread():
    """One intra-op thread for the test.  On the CPU, PyTorch's threaded
    kernels (oneDNN's conv backward, the batched GEMMs of the sparse
    backward) may split their sums differently from run to run on a loaded
    machine, so the same step is bit-repeatable on the CPU only with one
    thread; on the card it is with any (``tests/test_torch_cuda.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_kill_and_resume_bitwise_identical(tmp_path, one_thread):
    """The contract: kill at step 3, restart with the same config, and the
    final params AND momentum are bitwise identical to the uninterrupted
    run."""
    ta = SparseTrainer(_cfg(tmp_path / "a"), device=CPU)
    ta.run()
    tb = _DiesAtStep3(_cfg(tmp_path / "b"), device=CPU)
    with pytest.raises(_Killed):
        tb.run()
    tb.ckpt.wait()  # drain the in-flight async save before "restarting"
    assert tb.ckpt.latest_step() == 3
    tc = SparseTrainer(_cfg(tmp_path / "b"), device=CPU)
    out = tc.run()
    assert out["start_step"] == 3 and out["final_step"] == 5
    _same_bits(ta.params, tc.params)
    _same_bits(ta.mom, tc.mom)


def test_total_budget_not_additive(tmp_path):
    """run(steps) trains TO step `steps`, restored progress included: a
    restart at the budget trains zero additional steps."""
    SparseTrainer(_cfg(tmp_path), device=CPU).run()
    out = SparseTrainer(_cfg(tmp_path), device=CPU).run()
    assert out["start_step"] == 5
    assert out["final_step"] == 5
    assert out["history"] == []


def test_data_seed_mismatch_refused(tmp_path):
    SparseTrainer(_cfg(tmp_path, steps=2), device=CPU).run()
    t2 = SparseTrainer(_cfg(tmp_path, steps=4, data_seed=7), device=CPU)
    with pytest.raises(ValueError, match="data seed"):
        t2.run()


def test_resume_skips_torn_newest_checkpoint(tmp_path):
    """A torn newest checkpoint must not poison the restart: resume falls
    back to the newest valid step and still reaches the budget."""
    t1 = SparseTrainer(_cfg(tmp_path, steps=3), device=CPU)
    t1.run()
    f = t1.ckpt.dir / "step_00000003" / "arrays.npz"
    f.write_bytes(f.read_bytes()[:100])
    out = SparseTrainer(_cfg(tmp_path, steps=5), device=CPU).run()
    assert out["start_step"] == 2
    assert out["final_step"] == 5


# ---------------------------------------------------------------------------
# The LM Trainer and make_train_step
# ---------------------------------------------------------------------------

# tests/test_substrate.py's smoke config, with compressed_xla linears
LM_SHAPE = dict(n_layers=2, d_model=64, d_ff=96, n_heads=2, n_kv_heads=1,
                head_dim=32, vocab_size=128)
LM_SPARSE = dict(sparsity=0.5, m=None, tile=None, min_dim=64,
                 format="compressed_xla")
LM_DATA = dict(vocab_size=128, batch=16, seq_len=32, seed=1)
LM_OPT = dict(lr=3e-3, weight_decay=0.01)


def _lm_cfg():
    return smoke_config("smollm-360m").with_(
        sparsity=SparsityConfig(**LM_SPARSE), **LM_SHAPE)


def _jlm_cfg():
    return j_smoke_config("smollm-360m").with_(
        sparsity=JSparsityConfig(**LM_SPARSE), **LM_SHAPE)


def _lm(tmp_path=None, steps=6, params=None, microbatches=1, **tkw):
    tcfg = TrainConfig(steps=steps, ckpt_dir=str(tmp_path) if tmp_path else None,
                       ckpt_every=3, log_every=1, microbatches=microbatches, **tkw)
    return Trainer(_lm_cfg(), DataConfig(**LM_DATA), AdamWConfig(**LM_OPT),
                   tcfg, params=params, device=CPU)


def _jax_lm_run(steps):
    """JAX's Trainer on the smoke config: its initial params (numpy) and,
    after ``steps`` steps, its history and params."""
    jt = JTrainer(_jlm_cfg(), JDataConfig(**LM_DATA), JAdamWConfig(**LM_OPT),
                  JTrainConfig(steps=steps, log_every=1))
    p0 = _np(jt.params)
    out = jt.run()
    return p0, out["history"], jt.params, jt.opt_state


# losses and grad norms: the same float32 sums in another order
LM_RTOL = 1e-5
# params: AdamW moves every element by about lr a step whatever the size of
# its gradient, so a near-zero gradient element whose sign flips moves by up
# to 2 lr; 1e-2 lr admits rounding and no such flip
LM_PARAM_ATOL = 1e-2 * LM_OPT["lr"]


def test_lm_trainer_matches_jax_over_three_steps():
    """Three AdamW steps of both trainers from JAX's initial params on the
    bit-identical SyntheticLM batches (compressed_xla linears at min_dim
    64): losses and grad norms within LM_RTOL, params within
    LM_PARAM_ATOL, the integer leaves and the step bit-equal."""
    p0, jhist, jparams, jopt = _jax_lm_run(3)
    t = _lm(steps=3, params=params_from_jax(p0, device=CPU))
    assert "values" in t.params["layers"]["mlp"]["up"]
    out = t.run()
    for h, jh in zip(out["history"], jhist, strict=True):
        for k in ("loss", "grad_norm", "nll"):
            assert abs(h[k] - jh[k]) <= LM_RTOL * abs(jh[k]), (k, h, jh)
    for tree, jtree in ((t.params, jparams), (t.opt_state, jopt)):
        for path, g, w in _pairs(tree, _np(jtree)):
            if not g.is_floating_point():
                assert _bits(g) == np.ascontiguousarray(w).tobytes(), path
    for path, g, w in _pairs(t.params, _np(jparams)):
        if g.is_floating_point():
            assert float(np.abs(_f32(g) - w).max()) <= LM_PARAM_ATOL, path


def test_lm_trainer_loss_decreases():
    out = _lm(steps=40).run()
    losses = [h["loss"] for h in out["history"]]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05


def test_lm_checkpoint_resume_matches_uninterrupted(tmp_path):
    """Stop at 3, restart with the SAME total budget: the restarted run
    resumes at step 3, completes the 6-step schedule, and its params are
    within 1e-6 of the straight run's (tests/test_substrate.py's bound,
    as JAX's LM resume is held: not bit for bit)."""
    p0 = _lm().params
    ta = _lm(tmp_path / "a", steps=6, params=p0)
    out_a = ta.run()
    _lm(tmp_path / "b", steps=3, params=p0).run()
    tc = _lm(tmp_path / "b", steps=6, params=p0)
    out_c = tc.run()
    assert out_c["start_step"] == 3
    assert out_a["final_step"] == out_c["final_step"] == 6
    for a, c in zip(tree_leaves(ta.params), tree_leaves(tc.params), strict=True):
        np.testing.assert_allclose(_f32(a), _f32(c), atol=1e-6)


def test_microbatches_match_one_batch():
    """Two microbatches of 8 against one batch of 16: the mean of two
    half-batch gradients in float32 is the full-batch gradient up to the
    order of the sum, so losses within LM_RTOL and params within
    LM_PARAM_ATOL after 3 steps."""
    p0 = _lm().params
    t1, t2 = _lm(steps=3, params=p0), _lm(steps=3, params=p0, microbatches=2)
    h1, h2 = t1.run()["history"], t2.run()["history"]
    for a, b in zip(h1, h2, strict=True):
        assert abs(a["loss"] - b["loss"]) <= LM_RTOL * abs(a["loss"])
        assert abs(a["grad_norm"] - b["grad_norm"]) <= LM_RTOL * a["grad_norm"]
    for a, b in zip(tree_leaves(t1.params), tree_leaves(t2.params), strict=True):
        assert float(np.abs(_f32(a) - _f32(b)).max()) <= LM_PARAM_ATOL


def test_train_step_is_functional_and_gives_idx_no_update():
    from repro_torch.launch.steps import make_train_step

    t = _lm()
    step = make_train_step(t.cfg, AdamWConfig(**LM_OPT))
    before = [x.clone() for x in tree_leaves((t.params, t.opt_state))]
    p, o, m = step(t.params, t.opt_state, t.data.batch_at(0))
    for x, y in zip(tree_leaves((t.params, t.opt_state)), before, strict=True):
        assert torch.equal(x, y)
    assert set(m) == {"loss", "nll", "aux", "grad_norm"}
    idx = t.params["layers"]["mlp"]["up"]["idx"]
    assert p["layers"]["mlp"]["up"]["idx"] is idx
    assert int(o["step"]) == 1


# ---------------------------------------------------------------------------
# Fault machinery and the launcher
# ---------------------------------------------------------------------------


def test_watchdog_fires_and_beats_keep_alive():
    import time

    fired = []
    wd = StepWatchdog(timeout_s=0.2, abort=lambda: fired.append(1)).start()
    time.sleep(0.6)
    wd.stop()
    assert fired and wd.fired
    fired.clear()
    wd = StepWatchdog(timeout_s=0.4, abort=lambda: fired.append(1)).start()
    for _ in range(6):
        time.sleep(0.1)
        wd.beat()
    wd.stop()
    assert not fired


def test_watchdog_default_abort_exits_42():
    """The default abort is os._exit(42), so the scheduler restarts the
    run from its last checkpoint (given a ``trace_path`` it first dumps
    the obs trace: ``tests/test_torch_obs.py``)."""
    snippet = ("import time\n"
               "from repro_torch.train.fault import StepWatchdog\n"
               "StepWatchdog(timeout_s=0.2).start()\n"
               "time.sleep(30)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-c", snippet], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 42, r.stderr


def test_straggler_detection():
    mon = StragglerMonitor(window=20, factor=2.0)
    for i in range(10):
        mon.record(i, 1.0)
    assert mon.record(10, 5.0) is True
    assert not mon.record(11, 1.1)
    assert mon.events[0]["step"] == 10
    assert mon.median == 1.0


def test_train_cli_smoke(tmp_path):
    """The twin of tests/test_launchers.py's train CLI test, on the CPU."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2-0.5b", "--smoke", "--steps", "8", "--batch", "4", "--seq",
         "32", "--ckpt-dir", str(tmp_path), "--ckpt-every", "4",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "loss" in out.stdout
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000004", "step_00000008"]


# ---------------------------------------------------------------------------
# Pruning leftovers: masks and idx bit-exact against JAX
# ---------------------------------------------------------------------------


def _w(shape, seed=0, ties=False):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.round(w, 1) if ties else w


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("sparsity", [0.5, 0.9])
def test_unstructured_mask_matches_jax(sparsity, ties):
    w = _w((24, 40), ties=ties)
    got = pruning.unstructured_mask(torch.from_numpy(w), sparsity)
    want = np.asarray(jpruning.unstructured_mask(jnp.asarray(w), sparsity))
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("tile", [1, 4, 8])
def test_mask_invariants_match_jax(tile):
    w = _w((32, 16), seed=1)
    for mask in (pruning.colwise_nm_mask(torch.from_numpy(w), 0.5, m=8, tile=tile),
                 pruning.unstructured_mask(torch.from_numpy(w), 0.5)):
        for t in (1, 4, 8):
            assert pruning.mask_is_colwise(mask, t) == jpruning.mask_is_colwise(
                mask.numpy(), t)
        assert np.array_equal(pruning.mask_nm_counts(mask, 8).numpy(),
                              jpruning.mask_nm_counts(mask.numpy(), 8))
    assert pruning.mask_is_colwise(
        pruning.colwise_nm_mask(torch.from_numpy(w), 0.5, m=8, tile=tile), tile)


def _prune_tree_input(seed=2):
    rng = np.random.default_rng(seed)
    return {
        "embed": rng.standard_normal((40, 16)).astype(np.float32),
        "layers": {"w": rng.standard_normal((3, 16, 24)).astype(np.float32),
                   "b": rng.standard_normal((3, 24)).astype(np.float32),
                   "idx": np.arange(6, dtype=np.int32).reshape(3, 2)},
        "head": [rng.standard_normal((24, 8)).astype(np.float32)],
    }


@pytest.mark.parametrize("scheme", ["colwise", "rowwise"])
@pytest.mark.parametrize("skip_embed", [False, True])
def test_prune_tree_matches_jax(scheme, skip_embed):
    """Stacked [L, d_in, d_out] weights are masked per layer; masks and the
    masked weights bit-equal to JAX's, None where JAX leaves a leaf alone
    (1-D, integer, under min_dim, or refused by is_weight)."""
    tree = _prune_tree_input()
    kw = dict(sparsity=0.5, m=8, tile=4, format="masked", min_dim=8,
              scheme=scheme)
    jis = (lambda path, leaf: jax.tree_util.keystr(path) != "['embed']"
           ) if skip_embed else None
    tis = (lambda path, leaf: path != ("embed",)) if skip_embed else None
    jmasked, jmasks = jpruning.prune_tree(jax.tree_util.tree_map(
        jnp.asarray, tree), JSparsityConfig(**kw), is_weight=jis)
    masked, masks = pruning.prune_tree(params_from_jax(tree, device=CPU),
                                       SparsityConfig(**kw), is_weight=tis)
    assert (masks["embed"] is None) == skip_embed
    assert masks["layers"]["b"] is None and masks["layers"]["idx"] is None
    assert masks["head"][0] is not None
    for path, g, w in _pairs(masked, _np(jmasked)):
        assert str(g.dtype) == f"torch.{w.dtype.name}", path
        assert _bits(g) == np.ascontiguousarray(w).tobytes(), path
    for path, g, w in _pairs(masks, _np(jmasks)):
        assert g.dtype == torch.bool and np.array_equal(g.numpy(), w), path


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("scheme", ["colwise", "rowwise"])
def test_compress_layer_matches_jax(lead, masked, scheme):
    """Dense or masked, 2-D or stacked: values bit-equal, idx bit-exact,
    the bias carried; the stacked layout is per layer."""
    kw = dict(sparsity=0.5, m=8, tile=1 if scheme == "rowwise" else 4,
              format="compressed_xla", min_dim=8, scheme=scheme)
    w = _w(lead + (16, 24), seed=3)
    layer = {"w": w, "b": _w((24,), seed=4)}
    if masked:
        mask = jpruning._mask_nd(jnp.asarray(w), lambda a: jpruning.colwise_nm_mask(
            a, 0.25, m=8, tile=kw["tile"]))
        layer = {"w": w * np.asarray(mask), "mask": np.asarray(mask),
                 "b": layer["b"]}
    want = _np(j_compress_layer(jax.tree_util.tree_map(jnp.asarray, layer),
                                JSparsityConfig(**kw)))
    got = compress_layer(params_from_jax(layer, device=CPU), SparsityConfig(**kw))
    assert set(got) == set(want) == {"values", "idx", "b"}
    for k in ("values", "idx", "b"):
        assert tuple(got[k].shape) == want[k].shape, k
        assert _bits(got[k]) == np.ascontiguousarray(want[k]).tobytes(), k
    assert got["idx"].dtype == torch.int32
    if lead:
        one = compress_layer({"w": torch.from_numpy(w.reshape((-1, 16, 24))[0])},
                             SparsityConfig(**kw))
        flat_idx = got["idx"].reshape((-1,) + tuple(got["idx"].shape[-2:]))
        if not masked:
            assert torch.equal(one["idx"], flat_idx[0])
