"""MoE training on the CPU: the port's mixture of experts against the JAX
package's, and its expert parallelism against its own unsharded layer.

* The gradient of ``moe_apply`` (compressed experts, with dropped tokens)
  with respect to ``x``, the router and the expert values equals
  ``jax.grad``'s: the stable-sort routing, the trash slot that is sliced
  off and the batched gather + einsum all pass JAX's gradient; the integer
  ``idx`` leaves take none.
* One ``make_train_step`` AdamW step on olmoe-1b-7b's and
  moonshot-v1-16b-a3b's smoke configs, at 1 and 2 microbatches, against
  JAX's jitted step from the same converted params.
* ``moe_apply_shard_map`` over gloo ranks spawned locally (a (1, 2)
  mesh and a (2, 2) one): output, aux and gradients against the port's
  ``moe_apply`` over the full batch with one group a data shard (so both
  clip capacity over the same tokens), and one train step under the
  context against the unsharded step.  JAX's own sharded MoE is not the
  reference there: its shard_map test fails on this package (ROADMAP queue
  3).
* The train launcher's ``--mesh``.

Routing parity needs margins, asserted as ``tests/test_torch_moe.py``
asserts them.  Inputs come from numpy seeds; params from JAX through
``params_from_jax``.
"""
import functools
import multiprocessing
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.core.pruning import SparsityConfig as JSparsityConfig
from repro.core.sparse_linear import unbox_tree
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import moe as jmoe
from repro.models import registry as jreg
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro_torch._tree import leaves_with_path, tree_leaves, value_and_grad
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.pruning import SparsityConfig
from repro_torch.launch.steps import make_train_step
from repro_torch.models import moe as tmoe
from repro_torch.models import registry as treg
from repro_torch.optim import AdamWConfig, adamw_init

sys.path.insert(0, str(Path(__file__).parent))
import _torch_ep_workers as workers  # noqa: E402

ARCHS = ("olmoe-1b-7b", "moonshot-v1-16b-a3b")
SPARSE = dict(sparsity=0.5, m=None, tile=None, min_dim=16,
              format="compressed_xla")
REL = 1e-5          # loss, nll, aux: the same float32 sums in another order
GNORM_REL = 1e-4
PARAM_ATOL = 1e-4   # AdamW at lr 3e-4 (the default)
GRAD_REL = 1e-5     # of the gradient's max|g|
MARGIN_MIN = 1e-4
SPAWN_TIMEOUT_S = 120


@pytest.fixture
def margins(monkeypatch):
    """Every port routing's smallest k-th to (k+1)-th probability gap."""
    seen = []
    route = tmoe._route

    def recording(params, cfg, xg):
        out = route(params, cfg, xg)
        top = torch.sort(out[0].detach(), dim=-1, descending=True).values
        seen.append(float((top[..., cfg.top_k - 1] - top[..., cfg.top_k]).min()))
        return out

    monkeypatch.setattr(tmoe, "_route", recording)
    return seen


def _assert_margins(seen):
    assert seen, "no routing ran"
    assert min(seen) > MARGIN_MIN, (
        f"precondition: routing margins {min(seen):.3e} <= {MARGIN_MIN}")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 503, shape).astype(np.int32)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / max(
        float(np.abs(want).max()), 1e-30)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


# ---------------------------------------------------------------------------
# The layer's gradient against jax.grad
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _moe_case(cf):
    cfg = j_smoke_config("olmoe-1b-7b").with_(
        sparsity=JSparsityConfig(**SPARSE), capacity_factor=cf, dp=2)
    jp = unbox_tree(jmoe.moe_init(jax.random.PRNGKey(3), cfg))[0]
    return cfg, jax.tree_util.tree_map(np.asarray, jp)


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["kept", "dropped"])
def test_moe_grad_matches_jax(cf, margins):
    """d(sum(y * w) + aux)/d(x, router, expert values) of the port's
    ``moe_apply`` against ``jax.grad`` of JAX's, two dispatch groups, with
    and without dropped assignments: within GRAD_REL of each gradient's
    max|g|; the ``idx`` leaves take no gradient."""
    jcfg, jp = _moe_case(cf)
    x, w = _x((4, 16, 64), 21), _x((4, 16, 64), 22)

    def jloss(p, xx):
        y, aux = jmoe.moe_apply(p, jcfg, xx)
        return jnp.sum(y * w) + aux

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1), allow_int=True))(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x))
    cfg = smoke_config("olmoe-1b-7b").with_(
        sparsity=SparsityConfig(**SPARSE), capacity_factor=cf, dp=2)
    tp = params_from_jax(jp, device="cpu")
    xt = torch.from_numpy(x).requires_grad_()

    def tloss(p):
        y, aux = tmoe.moe_apply(p, cfg, xt)
        return (y * torch.from_numpy(w)).sum() + aux

    _, grads = value_and_grad(tloss, tp)
    _assert_margins(margins)
    xt.grad = None
    tloss(tp).backward()
    assert _rel(xt.grad.numpy(), jgx) <= GRAD_REL
    jflat = _flat(jax.tree_util.tree_map(np.asarray, jg))
    for path, g in _flat(grads).items():
        if path[-1] == "idx":
            assert g is None, path
            continue
        assert _rel(g.numpy(), jflat[path]) <= GRAD_REL, path
    kept = tmoe._dispatch_group(
        torch.from_numpy(x).reshape(2, 32, 64),
        tmoe._route(tp, cfg, torch.from_numpy(x).reshape(2, 32, 64))[2],
        cfg.n_experts, tmoe.moe_capacity(32, cfg), cfg.top_k)[3]
    assert bool((~kept).any()) == (cf < 1)


# ---------------------------------------------------------------------------
# One make_train_step step against JAX's
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_init():
    """JAX's smoke olmoe params (moonshot's smoke config equals it but for
    name and source, which no function reads: ``tests/test_torch_moe.py``
    holds the configs)."""
    cfg = j_smoke_config("olmoe-1b-7b").with_(sparsity=JSparsityConfig(**SPARSE))
    jp = jax.jit(lambda k: unbox_tree(jreg.init_fn(cfg)(k))[0])(
        jax.random.PRNGKey(0))
    return cfg, jp


@functools.lru_cache(maxsize=None)
def _jax_step(microbatches):
    cfg, jp = _jax_init()
    step = jax.jit(j_make_train_step(cfg, JAdamWConfig(), microbatches))
    batch = {"tokens": jnp.asarray(_tokens((4, 16), 5))}
    new_p, _, m = step(jp, j_adamw_init(jp), batch)
    return (jax.tree_util.tree_map(np.asarray, jp),
            jax.tree_util.tree_map(np.asarray, new_p),
            {k: float(v) for k, v in m.items()})


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, microbatches, margins):
    """Loss, nll and aux within REL, grad norm within GNORM_REL, params
    after the step within PARAM_ATOL (the integer leaves bit-equal), and
    every gradient finite.  With microbatches the aux metric is 0, as
    JAX's."""
    jp0, jp1, jm = _jax_step(microbatches)
    cfg = smoke_config(arch).with_(sparsity=SparsityConfig(**SPARSE))
    params = params_from_jax(jp0, device="cpu")
    assert "values" in params["layers"]["moe"]["up"]
    batch = {"tokens": _tokens((4, 16), 5)}
    p1, o1, m = make_train_step(cfg, AdamWConfig(), microbatches)(
        params, adamw_init(params), batch)
    _assert_margins(margins)
    assert int(o1["step"]) == 1
    for k in ("loss", "nll", "aux"):
        assert abs(float(m[k]) - jm[k]) <= REL * abs(jm[k]), (k, m[k], jm[k])
    if microbatches > 1:
        assert float(m["aux"]) == 0.0
    else:
        assert float(m["aux"]) > 0
    assert abs(float(m["grad_norm"]) - jm["grad_norm"]) <= GNORM_REL * jm["grad_norm"]
    jflat = _flat(jp1)
    for path, g in leaves_with_path(p1):
        w = jflat[path]
        if g.is_floating_point():
            assert float(np.abs(g.numpy() - w).max()) <= PARAM_ATOL, path
        else:
            assert np.array_equal(g.numpy(), w), path
    _, grads = value_and_grad(
        lambda p: treg.loss_fn(cfg)(p, {"tokens": torch.from_numpy(
            batch["tokens"])}), params)
    floats = [g for g in tree_leaves(grads) if g is not None]
    assert floats and all(bool(torch.isfinite(g).all()) for g in floats)
    assert float(grads["layers"]["moe"]["router"].abs().max()) > 0


# ---------------------------------------------------------------------------
# Expert parallelism over spawned gloo ranks
# ---------------------------------------------------------------------------


def _spawn(tmp_path, mesh_shape):
    """Run ``workers.ep_worker`` on prod(mesh_shape) spawned ranks; each
    writes its results, pickled, beside the store.  Fails (and kills the
    ranks) past SPAWN_TIMEOUT_S; a rank's exception fails the test."""
    n = int(np.prod(mesh_shape))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=workers.ep_worker,
                         args=(r, n, mesh_shape, str(tmp_path)))
             for r in range(n)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(SPAWN_TIMEOUT_S)
            assert p.exitcode is not None, f"a rank hung past {SPAWN_TIMEOUT_S} s"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    out = []
    for r in range(n):
        path = tmp_path / f"rank{r}.pkl"
        assert path.exists(), (r, procs[r].exitcode)
        res = pickle.loads(path.read_bytes())
        assert "error" not in res, res.get("error")
        out.append(res)
    return out


@pytest.fixture(scope="module", params=[(1, 2), (2, 2)], ids=["1x2", "2x2"])
def ep(request, tmp_path_factory):
    return request.param, _spawn(tmp_path_factory.mktemp("ep"), request.param)


def test_shard_map_output_and_aux_match_moe_apply(ep):
    """Every rank's y within 1e-5 of max|y| of ``moe_apply`` over the full
    batch (its rows of it), aux within 1e-6; with two model ranks each rank
    computed only half the experts."""
    _shape, out = ep
    for res in out:
        assert res["y_err"] <= 1e-5, res["y_err"]
        assert res["aux_err"] <= 1e-6, res["aux_err"]
        assert res["experts_local"] == res["n_experts"] // 2
        assert res["margin"] > MARGIN_MIN


def test_shard_map_gradients_match_moe_apply(ep):
    """d(loss)/d(x, router, expert values) within 1e-5 relative of the
    unsharded gradients: the sum of y does not multiply them by the model
    group's size."""
    _shape, out = ep
    for res in out:
        for name, err in res["grad_err"].items():
            assert err <= 1e-5, (name, err)


def test_shard_map_train_step_matches_unsharded(ep):
    """One ``make_train_step`` under the ``ShardingCtx`` with
    ``moe_impl="shard_map"`` (handed the global batch, each rank computes
    on its data shard of it; the step averages over the data ranks)
    against the unsharded step on the whole batch: metrics and params
    within 1e-5."""
    _shape, out = ep
    for res in out:
        assert res["step_metric_err"] <= 1e-5, res["step_metric_err"]
        assert res["step_param_err"] <= 1e-5, res["step_param_err"]


def test_launcher_trains_data_parallel_under_the_mesh(ep):
    """The train launcher's ``train`` under the mesh, as ``--mesh single``
    runs it (``cfg.tp`` the model axis, the MoE expert parallel): 2 steps
    with a checkpoint a step, a run restored from it to step 3; its losses
    within 1e-5 relative and its params within 1e-5 of the unsharded
    Trainer's on the whole batches (dispatch groups = the data shards).
    Only rank 0 wrote, and every rank restored from step 2."""
    _shape, out = ep
    assert out[0]["trainer_saves"] == [1, 2, 2, 3, 3], out[0]["trainer_saves"]
    assert all(res["trainer_saves"] == [] for res in out[1:])
    for res in out:
        assert res["trainer_loss_err"] <= 1e-5, res["trainer_loss_err"]
        assert res["trainer_param_err"] <= 1e-5, res["trainer_param_err"]
        assert res["trainer_resumed_from"] == 2
        assert res["trainer_steps_written"] == [
            "step_00000001", "step_00000002"], res["trainer_steps_written"]


def test_placements_split_dims_major_to_minor(ep):
    """On the (2, 2) mesh a ("pod", "data") dim gives each rank JAX's
    major-to-minor block (pod index * 2 + data index); the resolved
    placements of a ("model", "data") stack shard it as ``resolve_spec``
    says."""
    shape, out = ep
    for res in out:
        assert res["placement_ok"], res.get("placement_detail")


# ---------------------------------------------------------------------------
# The launcher's --mesh
# ---------------------------------------------------------------------------


def test_launcher_host_mesh_trains(capsys):
    from repro_torch.launch import train as launch_train

    launch_train.main(["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu",
                       "--mesh", "host", "--steps", "2", "--batch", "2",
                       "--seq", "16"])
    out = capsys.readouterr().out
    assert "step      0" in out and "step      1" in out


@pytest.mark.parametrize("mesh,world", [("single", 256), ("multi", 512)])
def test_launcher_production_mesh_names_the_world_it_needs(mesh, world):
    """``--mesh single|multi`` builds the production mesh, which refuses a
    world of one, naming the size it needs: the launcher exits non-zero."""
    from repro_torch.launch import train as launch_train

    with pytest.raises(ValueError, match=f"needs world size {world}"):
        launch_train.main(["--arch", "olmoe-1b-7b", "--smoke", "--device",
                           "cpu", "--mesh", mesh, "--steps", "1"])
