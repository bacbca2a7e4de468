"""Training the dense attention LM on params laid out on a data x model
mesh, on the CPU.

One world of 4 gloo ranks is spawned for the module
(``tests/_torch_layout_train_workers.py``, joined through a file store: no
network).  It runs the meshes (data 2, model 2) and (data 1, model 4).  On
each, every rank lays out (``launch.steps.distribute_tree``) the same
params, made with numpy from a seed, and takes on its shards the train
step's gradients (``launch.steps.make_grad_fn``) and AdamW's update of
them, as ``make_train_step`` does, on the same global batch (the
``Trainer`` below runs ``make_train_step`` itself), the whole run treating
PyTorch's "autograd kernel was not registered" warning as an error: no
collective that a gradient reaches runs outside the layout's autograd
Functions.

* The two smoke configs of ``test_torch_layout.py`` (qwen2-7b's, whose
  heads both model axes divide, with q/k/v biases and an untied
  unembedding; smollm-360m's ratio, whose KV heads the model axis splits
  inside a head, with tied embeddings), each in the dense, masked,
  compressed and REDUCE formats, and smollm's compressed one at 2
  microbatches.
* Against the port's whole-params step on one rank: the loss and
  ``grad_norm`` within 1e-5 relative, every gradient leaf (gathered whole)
  within 1e-5 of that leaf's max|g|, the updated params as
  :func:`_hold_update` bounds them.  Against JAX's jitted loss and
  gradients on whole params: within 1e-4.
* Each rank's local shapes of params, ``m`` and ``v`` are the shards that
  JAX's ``resolve_spec`` gives, on JAX's param specs and
  ``opt_state_specs``, for the mesh's sizes.
* The LM ``Trainer`` on laid-out params (smollm's compressed config at
  data 2 x model 2): stopped after step 2 and resumed to step 4 in a new
  ``Trainer``, bit for bit the uninterrupted run's, every rank's state
  still laid out; only global rank 0 writes; the files hold JAX's keys in
  JAX's order and restore into the port's whole-params ``Trainer`` and
  into JAX's.
* ``launch.train.train`` under the mesh lays out a dense arch's params and
  keeps a MoE arch's whole (slice 25).
* ``roofline.count`` over the model group of 2 ranks counts an all-gather
  and a reduce-scatter at 2 shards and an all-reduce at its buffer.
"""
import json
import multiprocessing
import pickle
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_layout_train_workers as workers
from repro import dispatch as jdispatch
from repro.data import DataConfig as JDataConfig
from repro.models import registry as jreg
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import opt_state_specs as j_opt_state_specs
from repro.sharding import RULES as J_RULES
from repro.sharding import resolve_spec as j_resolve_spec
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import Trainer as JTrainer
from repro_torch import dispatch
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.data import DataConfig
from repro_torch.launch.steps import make_grad_fn
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.train import TrainConfig, Trainer
from test_torch_layout import (ARCHS, FORMATS, _cfgs, _flat, _flat_specs,
                               _shard_shape, numpy_params)

WORLD = 4
MESHES = [(2, 2), (1, 4)]
CASES = ([(arch, fmt, mesh, 1) for mesh in MESHES for arch in ARCHS
          for fmt in FORMATS] + [("split", "compressed", (2, 2), 2)])
TRAINER_CASE = ("split", "compressed")
B, S = 4, 16
OPT = dict(lr=1e-3, weight_decay=0.1, grad_clip=1.0)
DATA = dict(vocab_size=503, batch=B, seq_len=S, seed=41)
PORT_RTOL = 1e-5  # loss, grad_norm
GRAD_TOL = 1e-5   # of a leaf's max|g|, whole params on one rank
JAX_TOL = 1e-4    # loss (relative) and each leaf's grads (of max|g|)
SPAWN_TIMEOUT_S = 150


def _key(case):
    arch, fmt, mesh, mb = case
    return f"{arch}-{fmt}-{mesh[0]}x{mesh[1]}" + (f"-mb{mb}" if mb > 1
                                                   else "")


def _batch():
    rng = np.random.default_rng(41)
    return {"tokens": rng.integers(0, DATA["vocab_size"], (B, S)).astype(
        np.int32)}


def port_whole(tcfg, params, mb) -> dict:
    """The port's train step on whole params (its gradients, then AdamW)."""
    p = params_from_jax(params, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    loss, _, grads = make_grad_fn(tcfg, mb)(p, batch)
    new, _, gnorm = adamw_update(p, grads, adamw_init(p), AdamWConfig(**OPT))
    return {"loss": float(loss), "grad_norm": float(gnorm),
            "grads": workers._np_tree(grads),
            "params": workers._np_tree(new)}


def jax_grads(jcfg, params) -> dict:
    """JAX's jitted loss and gradients on whole params (one compile a
    config)."""
    fn = jax.jit(jax.value_and_grad(lambda p, b: jreg.loss_fn(jcfg)(p, b),
                                    has_aux=True, allow_int=True))
    (loss, _), grads = fn(params, {k: jnp.asarray(v)
                                   for k, v in _batch().items()})
    return {"loss": float(loss), "grads": jax.tree_util.tree_map(
        lambda g: np.asarray(g) if g.dtype.kind == "f" else None, grads)}


def _spawn(outdir: Path):
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=workers.layout_train_worker,
                         args=(r, WORLD, str(outdir))) for r in range(WORLD)]
    for p in procs:
        p.start()
    return procs


def _join(procs, outdir: Path, t0: float):
    try:
        for p in procs:
            p.join(max(1.0, SPAWN_TIMEOUT_S - (time.time() - t0)))
            assert p.exitcode is not None, \
                f"a rank hung past {SPAWN_TIMEOUT_S} s"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    out = []
    for r in range(WORLD):
        path = outdir / f"rank{r}.pkl"
        assert path.exists(), (r, procs[r].exitcode)
        res = pickle.loads(path.read_bytes())
        assert "error" not in res, res.get("error")
        out.append(res)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(case -> (the port's whole-params step, JAX's gradients), each
    rank's results, the world's directory).  The references run while the
    ranks do."""
    d = tmp_path_factory.mktemp("layout_train")
    keys = {(arch, fmt) for arch, fmt, _, _ in CASES}
    params = {k: numpy_params(_cfgs(*k, 2)[1], seed)
              for seed, k in enumerate(sorted(keys))}
    cases = {_key(c): {"cfg": _cfgs(c[0], c[1], c[2][1])[1], "mesh": c[2],
                       "params": c[:2], "microbatches": c[3]} for c in CASES}
    launcher = {"dense": _cfgs("divides", "dense", 2)[1],
                "moe": smoke_config("olmoe-1b-7b").with_(tp=2)}
    (d / "cases.pkl").write_bytes(pickle.dumps({
        "meshes": MESHES, "cases": cases, "params": params,
        "batch": _batch(), "opt": OPT, "data": DATA,
        "trainer_mesh": (2, 2),
        "trainer_case": (_cfgs(*TRAINER_CASE, 2)[1], TRAINER_CASE),
        "launcher_cfgs": launcher}))
    t0 = time.time()
    procs = _spawn(d)
    dispatch.set_db(dispatch.ProfileDB(path=d / "profile.json"))
    jdispatch.set_db(jdispatch.ProfileDB(path=str(d / "jax.json")))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # smoke widths: the thread pool only costs
    try:
        port = {(a, f, mb): port_whole(_cfgs(a, f, 2)[1], params[a, f], mb)
                for a, f, _, mb in CASES}
        jax_out = {k: jax_grads(_cfgs(*k, 2)[0], params[k]) for k in params}
    finally:
        torch.set_num_threads(threads)
        dispatch.set_db(None)
        jdispatch.set_db(None)
        ranks = _join(procs, d, t0)
    refs = {_key(c): (port[c[0], c[1], c[3]], jax_out[c[:2]]) for c in CASES}
    return refs, ranks, d, params


def _rel(got, want):
    return abs(got - want) / abs(want)


def _leaf_err(got, want):
    """max|got - want| over max|want| of one leaf."""
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@pytest.mark.parametrize("case", CASES, ids=_key)
def test_laid_out_step_matches_whole_params(runs, case):
    """Every rank's loss, grad_norm and gathered gradients against the
    port's whole-params step."""
    refs, ranks, _, _ = runs
    ref = refs[_key(case)][0]
    for res in ranks:
        got = res[_key(case)]
        assert _rel(got["loss"], ref["loss"]) <= PORT_RTOL
        assert _rel(got["grad_norm"], ref["grad_norm"]) <= PORT_RTOL
        assert got["step"] == 1
        want, have = _flat(ref["grads"]), _flat(got["grads"])
        assert have.keys() == want.keys()
        for path, w in want.items():
            if w is None:
                assert have[path] is None, path
                continue
            assert _leaf_err(have[path], w) <= GRAD_TOL, path


def _hold_update(got, want, grad, grad_norm):
    """The element-wise bound on one step's updated params.  AdamW's first
    step moves an element by lr * u(g) plus the weight decay, where u(g) =
    g / (|g| + eps) (m_hat = g, v_hat = g^2), g being the gradient after the
    clip.  The laid-out run's g is the whole step's within d = GRAD_TOL *
    max|g| + PORT_RTOL * |g| (the gradients' and the clip's rounding).
    Where |g| > d both take one sign and |u(g') - u(g)| <= eps * d /
    ((|g| - d + eps) * (|g| + eps)), which is near 0 where |g| >> eps but
    not where g is small; where |g| <= d the signs may differ, so the
    bound is the most one step can move, 2 * lr.  Plus 1e-6 of |p| + lr
    for the float32 arithmetic of the update (a few ulps of its operands,
    p and lr * u)."""
    lr, eps = OPT["lr"], 1e-8
    scale = min(1.0, OPT["grad_clip"] / grad_norm)
    g = np.abs(grad.astype(np.float64)) * scale
    d = GRAD_TOL * g.max() + PORT_RTOL * g
    bound = np.where(g > d, lr * eps * d / ((g - d + eps) * (g + eps)),
                     2 * lr) + 1e-6 * (np.abs(want) + lr)
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= bound).all(), float((err - bound).max())


@pytest.mark.parametrize("case", CASES, ids=_key)
def test_laid_out_update_matches_whole_params(runs, case):
    """The params after one AdamW step on the shards, gathered, against
    the whole-params step's."""
    refs, ranks, _, _ = runs
    ref = refs[_key(case)][0]
    grads = _flat(ref["grads"])
    for res in ranks:
        got = _flat(res[_key(case)]["params"])
        for path, w in _flat(ref["params"]).items():
            if grads[path] is None:  # an integer leaf rides along
                np.testing.assert_array_equal(got[path], w)
            else:
                _hold_update(got[path], w, grads[path], ref["grad_norm"])


@pytest.mark.parametrize("case", CASES, ids=_key)
def test_laid_out_step_matches_jax(runs, case):
    """Every rank's loss and gathered gradients against JAX's jitted
    gradients on whole params."""
    refs, ranks, _, _ = runs
    ref = refs[_key(case)][1]
    want = {p: g for p, g in _flat(ref["grads"]).items() if g is not None}
    for res in ranks:
        got = res[_key(case)]
        assert _rel(got["loss"], ref["loss"]) <= JAX_TOL
        have = _flat(got["grads"])
        for path, w in want.items():
            assert _leaf_err(have[path], w) <= JAX_TOL, path


@pytest.mark.parametrize("case", CASES, ids=_key)
def test_shards_of_params_and_adamw_state_are_jax_resolved(runs, case):
    """Each rank's local shapes of the params, ``m`` and ``v`` are the shards
    JAX's ``resolve_spec`` gives on JAX's param and optimizer-state specs
    (those ``train_shardings`` resolves), and the shards are smaller than
    the whole."""
    _, ranks, _, _ = runs
    arch, fmt, mesh, _ = case
    jc = _cfgs(arch, fmt, mesh[1])[0]

    class FakeMesh:
        shape = {"data": mesh[0], "model": mesh[1]}

    shapes, specs = jreg.abstract_params(jc)
    o_specs = j_opt_state_specs(specs)
    flat = _flat(shapes)
    for tree, name in ((specs, "param_shapes"), (o_specs["m"], "m_shapes"),
                       (o_specs["v"], "v_shapes")):
        spec = _flat_specs(tree)
        want = {p: _shard_shape(a.shape, j_resolve_spec(
            tuple(a.shape), spec[p], J_RULES, FakeMesh), FakeMesh.shape)
            for p, a in flat.items()}
        for res in ranks:
            assert res[_key(case)][name] == want, name
    assert any(want[p] != tuple(a.shape) for p, a in flat.items())


def test_no_raw_collective_under_autograd(runs):
    """The warning filter of the ranks was live (a plain all-reduce
    backpropagated through raised), and every case ran under it."""
    _, ranks, _, _ = runs
    for res in ranks:
        assert res["raw_collective_raises"]
        assert all(_key(c) in res for c in CASES)


def test_laid_out_trainer_resumes_bit_for_bit(runs):
    """Stopped after step 2, resumed to step 4 in a new Trainer: every
    rank's shards of params and AdamW state equal the uninterrupted run's,
    still laid out."""
    _, ranks, _, _ = runs
    for res in ranks:
        tr = res["trainer"]
        assert tr["resumed_from"] == 2
        assert tr["bitwise"]
        assert tr["laid_out"]
        assert tr["resumed_losses"] == tr["losses"][2:]
        assert len(tr["losses"]) == 4


def test_only_rank_0_writes_the_checkpoints(runs):
    _, ranks, d, _ = runs
    assert ranks[0]["trainer"]["saves"] == [("ckpt", 2), ("ckpt", 4)]
    for res in ranks[1:]:
        assert res["trainer"]["saves"] == []
    assert sorted(p.name for p in (d / "ckpt").iterdir()) == [
        "step_00000002", "step_00000004"]


def _jax_trees(params):
    jcfg = _cfgs(*TRAINER_CASE, 2)[0]
    jp = jax.tree_util.tree_map(jnp.asarray, params[TRAINER_CASE])
    return jcfg, jp, {"params": jp, "opt": j_adamw_init(jp)}


def test_laid_out_checkpoint_holds_jax_keys_in_jax_order(runs):
    """The manifest lists every array of the whole trees under JAX's
    ``keystr``, in the order JAX's CheckpointManager writes them."""
    _, _, d, params = runs
    _, _, trees = _jax_trees(params)
    want = {f"{name}|{jax.tree_util.keystr(path)}": (tuple(leaf.shape),
                                                     str(leaf.dtype))
            for name, tree in trees.items()
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    manifest = json.loads((d / "ckpt" / "step_00000004" /
                           "manifest.json").read_text())
    assert list(manifest["arrays"]) == list(want)
    for key, ent in manifest["arrays"].items():
        assert (tuple(ent["shape"]), ent["dtype"]) == want[key], key


def test_laid_out_checkpoint_restores_into_whole_params_trainers(runs):
    """The step-4 files restore into the port's whole-params Trainer and
    into JAX's, each equal to the laid-out run's state gathered."""
    _, ranks, d, params = runs
    final = ranks[0]["trainer"]["final"]
    tcfg = _cfgs(*TRAINER_CASE, 2)[1]
    port = Trainer(tcfg, DataConfig(**DATA), AdamWConfig(**OPT),
                   TrainConfig(steps=4, ckpt_dir=str(d / "ckpt")),
                   params=params_from_jax(params[TRAINER_CASE], device="cpu"))
    assert port.maybe_restore() == 4
    jcfg, jp, _ = _jax_trees(params)
    jtr = JTrainer(jcfg, JDataConfig(**DATA), JAdamWConfig(**OPT),
                   JTrainConfig(steps=4, ckpt_dir=str(d / "ckpt")), params=jp)
    assert jtr.maybe_restore() == 4
    want = _flat(final)
    got_port = _flat(workers._np_tree({"params": port.params,
                                       "opt": port.opt_state}))
    got_jax = _flat(jax.tree_util.tree_map(
        np.asarray, {"params": jtr.params, "opt": jtr.opt_state}))
    assert got_port.keys() == want.keys() == got_jax.keys()
    for path, w in want.items():
        np.testing.assert_array_equal(got_port[path], w, err_msg=str(path))
        np.testing.assert_array_equal(got_jax[path], w, err_msg=str(path))


def test_train_launcher_lays_out_a_dense_arch_and_keeps_moe_whole(runs):
    _, ranks, _, _ = runs
    for res in ranks:
        assert res["launcher"]["dense"]["laid_out"]
        assert not res["launcher"]["moe"]["laid_out"]
        assert all(np.isfinite(v["loss"]) for v in res["launcher"].values())


def test_counter_counts_a_collective_once_over_two_ranks(runs):
    """An all-gather into 2 parts counts 2 shards, not the 3 of its output
    list read as input; a reduce-scatter of 2 shards 2; an all-reduce its
    buffer (a 4096-byte shard)."""
    _, ranks, _, _ = runs
    for res in ranks:
        assert res["counter"] == {"n": 2, "all-gather": {"all-gather": 8192},
                                  "all-reduce": {"all-reduce": 4096},
                                  "reduce-scatter": {
                                      "reduce-scatter": 8192}}
