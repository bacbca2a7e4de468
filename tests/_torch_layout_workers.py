"""A rank of ``tests/test_torch_layout.py``: spawned locally, one process a
rank, joined by gloo through a file store (no network).  It imports torch
and the port only, reads the cases from ``<outdir>/cases.pkl`` (configs,
numpy params, inputs), and writes its results, pickled, to
``<outdir>/rank<r>.pkl`` (``{"error": traceback}`` where it failed), then
destroys its process group."""
import pickle
import traceback
from pathlib import Path

import numpy as np


def _local_shapes(tree, prefix=()):
    from repro_torch.sharding.api import local

    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_local_shapes(v, prefix + (k,)))
        return out
    return {prefix: tuple(local(tree).shape)}


def run_case(cfg, params, mesh, inp) -> dict:
    """The dense attention LM on laid-out params: the scoring loss and
    forward, a prefill and ``len(inp["feeds"])`` decode steps.  Returns the
    global outputs (``sharding.full``) and the local shard shapes."""
    import torch

    from repro_torch.launch.steps import (distribute_tree, make_decode_step,
                                          make_prefill_step)
    from repro_torch.models import registry as reg
    from repro_torch.sharding.api import full, specs_to_shardings

    laid = distribute_tree(params, specs_to_shardings(reg.param_specs(cfg),
                                                      params, mesh))
    out = {"param_shapes": _local_shapes(laid)}
    score = {"tokens": torch.from_numpy(inp["score"])}
    prompt = inp["prompt"]
    b, p = prompt.shape
    with torch.no_grad():
        loss, metrics = reg.loss_fn(cfg)(laid, score)
        out["nll"] = float(metrics["nll"])
        out["loss"] = float(loss)
        out["logits"] = full(reg.forward_fn(cfg)(laid, score)).numpy()
        pl, pc = make_prefill_step(cfg)(laid, {"tokens": torch.from_numpy(
            prompt)})
        out["prefill_logits"] = full(pl).numpy()
        out["prefill_cache"] = {k: full(v).numpy() for k, v in pc.items()}
        cache = reg.cache_init_fn(cfg, b, p + len(inp["feeds"]),
                                  device="cpu", mesh=mesh)()
        for k, v in cache.items():
            v.to_local()[:, :, :p] = pc[k].to_local()
        out["cache_shapes"] = _local_shapes(cache)
        step = make_decode_step(cfg)
        out["decode_logits"] = []
        for i, feed in enumerate(inp["feeds"]):
            # a scalar position, then a per-sequence [B] one
            pos = p + i if i % 2 == 0 else np.full((b,), p + i, np.int32)
            dl, cache = step(laid, cache, torch.from_numpy(feed), pos)
            out["decode_logits"].append(full(dl).numpy())
        out["decode_cache"] = {k: full(v).numpy() for k, v in cache.items()}
    return out


def refusals(mesh, cfgs) -> dict:
    """What a laid-out tree raises where this slice does not take it: the
    loss of another family, and ``make_train_step``."""
    import torch

    from repro_torch.launch.steps import distribute_tree, make_train_step
    from repro_torch.models import registry as reg
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.sharding.api import specs_to_shardings

    out = {}
    batch = {"tokens": torch.zeros((4, 8), dtype=torch.int32)}
    for name, cfg in cfgs.items():
        params = reg.init_params(cfg, 0, device="cpu")
        laid = distribute_tree(params, specs_to_shardings(
            reg.param_specs(cfg), params, mesh))
        try:
            if name == "train":
                make_train_step(cfg, AdamWConfig())(laid, adamw_init(params),
                                                    batch)
            else:
                reg.loss_fn(cfg)(laid, batch)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def layout_worker(rank, world, outdir):
    import torch
    import torch.distributed as dist

    res = {}
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{outdir}/store",
                                rank=rank, world_size=world)
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch import dispatch
        from repro_torch.convert import params_from_jax

        dispatch.set_db(dispatch.ProfileDB(path=Path(outdir,
                                                     f"profile{rank}.json")))
        spec = pickle.loads(Path(outdir, "cases.pkl").read_bytes())
        for shape in spec["meshes"]:
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
            for key, case in spec["cases"].items():
                if case["mesh"] != shape:
                    continue
                params = params_from_jax(spec["params"][case["params"]],
                                         device="cpu")
                res[key] = run_case(case["cfg"], params, mesh, spec["inputs"])
            if shape == spec["refusal_mesh"]:
                res["refusals"] = refusals(mesh, spec["refusal_cfgs"])
    except Exception:  # reported to the test through the results file
        res = {"error": traceback.format_exc()}
    finally:
        Path(outdir, f"rank{rank}.pkl").write_bytes(pickle.dumps(res))
        if dist.is_initialized():
            dist.destroy_process_group()
