"""A rank of ``tests/test_torch_collective.py``: spawned locally, one process
a rank, joined by gloo through a file store (no network).  It imports torch
and the port only, reads the inputs from ``<outdir>/inputs.npz``, and writes
its results, pickled, to ``<outdir>/rank<r>.pkl`` (``{"error": traceback}``
where it failed), then destroys its process group."""
import pickle
import traceback
from pathlib import Path

import numpy as np


def collective_worker(rank, world, outdir):
    import torch
    import torch.distributed as dist

    res = {}
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{outdir}/store",
                                rank=rank, world_size=world)
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.optim.grad_compress import (compress_with_feedback,
                                                     crosspod_psum_compressed)
        from repro_torch.sharding import (ShardingCtx, ring_allgather_matmul,
                                          use_ctx)

        inp = np.load(Path(outdir) / "inputs.npz")
        x, w = torch.from_numpy(inp["x"]), torch.from_numpy(inp["w"])
        # the ring over model axes of 4, 2 and 1 ranks
        for n, shape, names in ((4, (4,), ("model",)),
                                (2, (2, 2), ("data", "model")),
                                (1, (4, 1), ("data", "model"))):
            mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
            res[f"ring{n}"] = ring_allgather_matmul(x, w, mesh).numpy()
        # the cross-pod reduction, this rank one pod's shard
        mesh = init_device_mesh("cpu", (world, 1),
                                mesh_dim_names=("pod", "data"))
        g = torch.from_numpy(inp["g"][rank:rank + 1])
        e = torch.from_numpy(inp["e"][rank:rank + 1])
        q, scale, _ = compress_with_feedback(g, e)
        with use_ctx(ShardingCtx(mesh=mesh)):
            reduced, new_error = crosspod_psum_compressed(g, e, axis="pod")
        res.update(q=q.numpy(), scale=scale.numpy(), reduced=reduced.numpy(),
                   new_error=new_error.numpy())
    except Exception:  # reported to the test through the results file
        res = {"error": traceback.format_exc()}
    finally:
        Path(outdir, f"rank{rank}.pkl").write_bytes(pickle.dumps(res))
        if dist.is_initialized():
            dist.destroy_process_group()
