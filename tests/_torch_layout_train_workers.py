"""A rank of ``tests/test_torch_layout_train.py``: spawned locally, one
process a rank, joined by gloo through a file store (no network).  It
imports torch and the port only, reads the cases from
``<outdir>/cases.pkl`` (configs, numpy params, the batch), and writes its
results, pickled, to ``<outdir>/rank<r>.pkl`` (``{"error": traceback}``
where it failed), then destroys its process group.

The whole run treats PyTorch's warning that a ``torch.distributed`` op
was backpropagated through without an autograd kernel as an error: every
collective that a gradient reaches must run inside one of the layout's
autograd Functions."""
import pickle
import traceback
import warnings
from pathlib import Path

RAW_COLLECTIVE = ".*an autograd kernel was not registered.*"


def _np_tree(tree):
    """A dict tree of tensors as numpy (``None`` kept)."""
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return None if tree is None else tree.detach().numpy()


def _local_shapes(tree, prefix=()):
    from repro_torch.sharding.api import local

    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_local_shapes(v, prefix + (k,)))
        return out
    return {prefix: tuple(local(tree).shape)}


def _laid(cfg, params, mesh):
    from repro_torch.launch.steps import distribute_tree
    from repro_torch.models import registry as reg
    from repro_torch.sharding.api import specs_to_shardings

    return distribute_tree(params, specs_to_shardings(reg.param_specs(cfg),
                                                      params, mesh))


def run_case(cfg, params, mesh, batch, microbatches, opt_cfg) -> dict:
    """The train step of the dense attention LM on laid-out params, as
    ``make_train_step`` runs it: its gradients, then AdamW on the shards.
    Returns the gathered gradients, params and metrics and the local
    shapes of params, ``m`` and ``v``."""
    import torch

    from repro_torch.launch.steps import make_grad_fn
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.sharding.api import full_tree

    laid = _laid(cfg, params, mesh)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics, grads = make_grad_fn(cfg, microbatches)(laid, batch)
    new, new_opt, gnorm = adamw_update(laid, grads, adamw_init(laid),
                                       opt_cfg)
    return {"loss": float(loss), "nll": float(metrics["nll"]),
            "grads": _np_tree(full_tree(grads)),
            "params": _np_tree(full_tree(new)),
            "grad_norm": float(gnorm),
            "param_shapes": _local_shapes(laid),
            "m_shapes": _local_shapes(new_opt["m"]),
            "v_shapes": _local_shapes(new_opt["v"]),
            "step": int(new_opt["step"])}


def raw_collective_raises(mesh) -> bool:
    """The warning filter is live: a plain all-reduce backpropagated
    through raises."""
    import torch
    import torch.distributed as dist

    x = torch.ones(4, requires_grad=True)
    y = x * 2
    dist.all_reduce(y, group=mesh.get_group("model"))
    try:
        y.sum().backward()
    except UserWarning:
        return True
    return False


def counter_world2(mesh) -> dict:
    """``roofline.count`` of one all-gather, all-reduce and reduce-scatter
    of a 4096-byte shard over the model group of 2 ranks."""
    import torch
    import torch.distributed as dist

    from repro_torch.roofline import count

    group = mesh.get_group("model")
    n = dist.get_world_size(group)
    t = torch.ones(1024)
    out = {"n": n}
    out["all-gather"] = count(lambda: dist.all_gather(
        [torch.empty_like(t) for _ in range(n)], t, group=group))
    out["all-reduce"] = count(lambda: dist.all_reduce(t, group=group))
    out["reduce-scatter"] = count(lambda: dist.reduce_scatter(
        torch.empty_like(t), [t.clone() for _ in range(n)], group=group))
    return {k: (v if k == "n" else v["collective_by_kind"])
            for k, v in out.items()}


def trainer_checks(cfg, params, mesh, spec, outdir: Path) -> dict:
    """The LM ``Trainer`` on laid-out params: 4 steps uninterrupted, and 2
    steps, a checkpoint, and a resume to 4 in a new ``Trainer``; each
    rank's saves recorded."""
    import torch

    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.sharding.api import full_tree, is_laid_out, local
    from repro_torch.train import TrainConfig, Trainer, checkpoint

    data = DataConfig(**spec["data"])
    opt = AdamWConfig(**spec["opt"])
    saves = []
    manager = checkpoint.CheckpointManager
    save = manager.save
    manager.save = lambda self, step, *a, **kw: (
        saves.append((self.dir.name, step)), save(self, step, *a, **kw))[1]
    try:
        whole = Trainer(cfg, data, opt, TrainConfig(steps=4, log_every=1),
                        params=_laid(cfg, params, mesh))
        whole_out = whole.run()
        first = Trainer(cfg, data, opt, TrainConfig(
            steps=2, ckpt_dir=str(outdir / "ckpt"), ckpt_every=100,
            log_every=1), params=_laid(cfg, params, mesh))
        first.run()
        second = Trainer(cfg, data, opt, TrainConfig(
            steps=4, ckpt_dir=str(outdir / "ckpt"), ckpt_every=100,
            log_every=1), params=_laid(cfg, params, mesh))
        second_out = second.run()
    finally:
        manager.save = save
    pairs = list(zip(_leaves({"p": whole.params, "o": whole.opt_state}),
                     _leaves({"p": second.params, "o": second.opt_state})))
    return {
        "resumed_from": second_out["start_step"],
        "bitwise": all(torch.equal(local(a), local(b)) for a, b in pairs),
        "losses": [h["loss"] for h in whole_out["history"]],
        "resumed_losses": [h["loss"] for h in second_out["history"]],
        "laid_out": all(is_laid_out(t) for t in _leaves(
            {"p": second.params, "m": second.opt_state["m"],
             "v": second.opt_state["v"]})),
        "saves": saves,
        "final": _np_tree(full_tree({"params": second.params,
                                     "opt": second.opt_state})),
    }


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def launcher_checks(mesh, cfgs, spec) -> dict:
    """``launch.train.train`` under the mesh: 1 step of each config;
    whether the trainer's params came out laid out."""
    from repro_torch.data import DataConfig
    from repro_torch.launch import train as launch_train
    from repro_torch.optim import AdamWConfig
    from repro_torch.sharding.api import laid_out_mesh
    from repro_torch.train import TrainConfig

    out = {}
    for name, cfg in cfgs.items():
        data = DataConfig(**dict(spec["data"], vocab_size=cfg.vocab_size))
        res = launch_train.train(cfg, data, AdamWConfig(**spec["opt"]),
                                 TrainConfig(steps=1, log_every=1),
                                 device="cpu", mesh=mesh)
        out[name] = {"laid_out": laid_out_mesh(res["trainer"].params)
                     is not None,
                     "loss": res["out"]["history"][-1]["loss"]}
    return out


def layout_train_worker(rank, world, outdir):
    import torch
    import torch.distributed as dist

    res = {}
    outdir = Path(outdir)
    try:
        warnings.filterwarnings("error", message=RAW_COLLECTIVE)
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{outdir}/store",
                                rank=rank, world_size=world)
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch import dispatch
        from repro_torch.convert import params_from_jax
        from repro_torch.optim import AdamWConfig

        dispatch.set_db(dispatch.ProfileDB(path=outdir / f"profile{rank}.json"))
        spec = pickle.loads((outdir / "cases.pkl").read_bytes())
        opt_cfg = AdamWConfig(**spec["opt"])
        for shape in spec["meshes"]:
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
            for key, case in spec["cases"].items():
                if case["mesh"] != shape:
                    continue
                params = params_from_jax(spec["params"][case["params"]],
                                         device="cpu")
                res[key] = run_case(case["cfg"], params, mesh, spec["batch"],
                                    case["microbatches"], opt_cfg)
            if shape != spec["trainer_mesh"]:
                continue
            res["raw_collective_raises"] = raw_collective_raises(mesh)
            res["counter"] = counter_world2(mesh)
            cfg, key = spec["trainer_case"]
            res["trainer"] = trainer_checks(
                cfg, params_from_jax(spec["params"][key], device="cpu"),
                mesh, spec, outdir)
            res["launcher"] = launcher_checks(mesh, spec["launcher_cfgs"],
                                              spec)
    except Exception:  # reported to the test through the results file
        res = {"error": traceback.format_exc()}
    finally:
        (outdir / f"rank{rank}.pkl").write_bytes(pickle.dumps(res))
        if dist.is_initialized():
            dist.destroy_process_group()
