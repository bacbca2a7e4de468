"""A rank of the expert-parallel checks of ``tests/test_torch_moe_train.py``:
spawned locally, one process a rank, joined by gloo through a file
store (no network).  It imports torch and the port only, and writes its
results, pickled, to ``<outdir>/rank<r>.pkl`` (``{"error": traceback}``
where it failed), then destroys its process group."""
import pickle
import traceback
from pathlib import Path

import numpy as np

SPARSE = dict(sparsity=0.5, m=None, tile=None, min_dim=16,
              format="compressed_xla")
B, S = 4, 16


def _rel(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def _layer_checks(mesh, cfg, dp, d_idx):
    """moe_apply_shard_map on this rank's data shard against moe_apply on
    the whole batch with one group a data shard: y, aux, and the gradients
    of J = sum(y * w) / dp + aux (the mean over data ranks of each rank's
    sum(y_s * w_s) + aux)."""
    import torch
    import torch.distributed as dist

    from repro_torch._tree import value_and_grad
    from repro_torch.models import moe
    from repro_torch.sharding import ShardingCtx, use_ctx

    gen = torch.Generator().manual_seed(7)
    params = moe.moe_init(gen, cfg, device="cpu")
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))
    rows = slice(d_idx * B // dp, (d_idx + 1) * B // dp)
    ref_cfg = cfg.with_(dp=dp)

    probs = moe._route(params, ref_cfg, x.reshape(dp, B * S // dp, -1))[0]
    top = torch.sort(probs, dim=-1, descending=True).values
    margin = float((top[..., cfg.top_k - 1] - top[..., cfg.top_k]).min())

    xr = x.clone().requires_grad_()

    def ref_loss(p):
        y, aux = moe.moe_apply(p, ref_cfg, xr)
        return (y * w).sum() / dp + aux, y, aux

    (_, y_ref, aux_ref), g_ref = value_and_grad(ref_loss, params)
    xr.grad = None
    ref_loss(params)[0].backward()

    xs = x[rows].clone().requires_grad_()
    with use_ctx(ShardingCtx(mesh=mesh)):
        def loss(p):
            y, aux = moe.moe_apply_shard_map(p, cfg, xs)
            return (y * w[rows]).sum() + aux, y, aux

        (_, y, aux), g = value_and_grad(loss, params)
        xs.grad = None
        loss(params)[0].backward()
    data = mesh.get_group("data")

    def data_mean(t):
        t = t.clone()
        dist.all_reduce(t, group=data)
        return t / dp

    errs = {"x": _rel(xs.grad / dp, xr.grad[rows]),
            "router": _rel(data_mean(g["router"]), g_ref["router"])}
    for name in ("gate", "up", "down"):
        errs[f"{name}.values"] = _rel(data_mean(g[name]["values"]),
                                      g_ref[name]["values"])
    assert g["up"]["idx"] is None
    return {"y_err": _rel(y, y_ref[rows]),
            "aux_err": float((aux - aux_ref).abs()),
            "grad_err": errs, "margin": margin,
            "n_experts": cfg.n_experts,
            "experts_local": cfg.n_experts // mesh.size(1)}


def _step_checks(mesh, cfg, dp):
    """One make_train_step under the context, moe_impl="shard_map", handed
    the global batch (each rank computes on its rows), against the
    unsharded step on the whole batch with dp dispatch groups."""
    import torch

    from repro_torch._tree import tree_leaves
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import registry as reg
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.sharding import ShardingCtx, use_ctx

    params = reg.init_params(cfg, 0, device="cpu")
    tokens = np.random.default_rng(9).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    p_ref, _, m_ref = make_train_step(cfg.with_(dp=dp), AdamWConfig())(
        params, adamw_init(params), {"tokens": tokens})
    with use_ctx(ShardingCtx(mesh=mesh)):
        p, _, m = make_train_step(cfg.with_(moe_impl="shard_map"), AdamWConfig())(
            params, adamw_init(params), {"tokens": tokens})
    metric_err = max(abs(float(m[k]) - float(m_ref[k])) / abs(float(m_ref[k]))
                     for k in ("loss", "nll", "aux", "grad_norm"))
    param_err = max(float((a.float() - b.float()).abs().max())
                    for a, b in zip(tree_leaves(p), tree_leaves(p_ref), strict=True))
    assert torch.equal(p["layers"]["moe"]["up"]["idx"],
                       p_ref["layers"]["moe"]["up"]["idx"])
    return {"step_metric_err": metric_err, "step_param_err": param_err}


def _trainer_checks(mesh, cfg, dp, ckpt_dir):
    """The train launcher's ``train`` under the mesh (moe_impl="shard_map",
    ``cfg.tp`` the model axis, as ``--mesh`` sets it): 2 steps with a
    checkpoint that only rank 0 writes, then a run restored from it to
    step 3, against the unsharded Trainer's 3 steps on the whole batches
    with dp dispatch groups."""
    from repro_torch._tree import tree_leaves
    from repro_torch.data import DataConfig
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import mesh_tp
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer, checkpoint

    cfg = cfg.with_(tp=mesh_tp(mesh))
    data = DataConfig(vocab_size=cfg.vocab_size, batch=B, seq_len=S, seed=0)
    opt = AdamWConfig(lr=1e-3)
    ref = Trainer(cfg.with_(dp=dp), data, opt, TrainConfig(steps=3, log_every=1),
                  device="cpu")
    ref_out = ref.run()
    sharded = cfg.with_(moe_impl="shard_map")
    saves = []
    manager = checkpoint.CheckpointManager
    save = manager.save
    manager.save = lambda self, step, *a, **kw: (saves.append(step),
                                                  save(self, step, *a, **kw))[1]
    first = launch_train.train(sharded, data, opt, TrainConfig(
        steps=2, ckpt_dir=str(ckpt_dir), ckpt_every=1, log_every=1),
        device="cpu", mesh=mesh)
    steps_written = sorted(p.name for p in ckpt_dir.glob("step_*"))
    second = launch_train.train(sharded, data, opt, TrainConfig(
        steps=3, ckpt_dir=str(ckpt_dir), ckpt_every=1, log_every=1),
        device="cpu", mesh=mesh)
    manager.save = save
    losses = ([h["loss"] for h in first["out"]["history"]]
              + [h["loss"] for h in second["out"]["history"]])
    want = [h["loss"] for h in ref_out["history"]]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, want, strict=True))
    param_err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(
        tree_leaves(second["trainer"].params), tree_leaves(ref.params),
        strict=True))
    return {"trainer_loss_err": loss_err, "trainer_param_err": param_err,
            "trainer_resumed_from": second["out"]["start_step"],
            "trainer_steps_written": steps_written, "trainer_saves": saves}


def _placement_checks(mesh_shape):
    """A ("pod", "data") dim split major to minor on a (dp, tp) mesh named
    ("pod", "data"), and a ("model", "data") stack on the ("data", "model")
    mesh, each rank's block as ``resolve_spec`` says."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.sharding import RULES, placements, resolve_spec

    detail = []
    m2 = init_device_mesh("cpu", mesh_shape, mesh_dim_names=("pod", "data"))
    n = mesh_shape[0] * mesh_shape[1]
    spec = resolve_spec((2 * n, 3), ("act_batch", None), RULES, m2)
    want_spec = (("pod", "data"), None)
    full = torch.arange(6 * n, dtype=torch.float32).reshape(2 * n, 3)
    local = distribute_tensor(full, m2, placements(spec, m2)).to_local()
    blk = m2.get_local_rank("pod") * mesh_shape[1] + m2.get_local_rank("data")
    ok = spec == want_spec and torch.equal(local, full[2 * blk:2 * blk + 2])
    detail.append((spec, local.tolist()))

    m3 = init_device_mesh("cpu", mesh_shape, mesh_dim_names=("data", "model"))
    spec = resolve_spec((4, 6), ("expert", "embed"), RULES, m3)
    stack = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    local = distribute_tensor(stack, m3, placements(spec, m3)).to_local()
    r, c = 4 // mesh_shape[1], 6 // mesh_shape[0]
    mi, di = m3.get_local_rank("model"), m3.get_local_rank("data")
    ok = ok and torch.equal(local, stack[mi * r:(mi + 1) * r, di * c:(di + 1) * c])
    detail.append((spec, local.tolist()))
    return {"placement_ok": bool(ok), "placement_detail": detail}


def ep_worker(rank, world, mesh_shape, outdir):
    import torch
    import torch.distributed as dist

    res = {}
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{outdir}/store",
                                rank=rank, world_size=world)
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.configs import smoke_config
        from repro_torch.core.pruning import SparsityConfig

        mesh = init_device_mesh("cpu", mesh_shape,
                                mesh_dim_names=("data", "model"))
        cfg = smoke_config("olmoe-1b-7b").with_(sparsity=SparsityConfig(**SPARSE))
        dp, d_idx = mesh_shape[0], mesh.get_local_rank("data")
        res.update(_layer_checks(mesh, cfg, dp, d_idx))
        res.update(_step_checks(mesh, cfg, dp))
        res.update(_trainer_checks(mesh, cfg, dp, Path(outdir) / "ckpt"))
        res.update(_placement_checks(mesh_shape))
    except Exception:  # reported to the test through the results file
        res = {"error": traceback.format_exc()}
    finally:
        Path(outdir, f"rank{rank}.pkl").write_bytes(pickle.dumps(res))
        if dist.is_initialized():
            dist.destroy_process_group()
