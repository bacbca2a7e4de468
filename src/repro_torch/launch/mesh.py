"""Mesh factories (twin of ``repro/launch/mesh.py``).

Functions, not module state: importing this module starts no process
group.  A caller of ``make_production_mesh`` has started the world (one
rank a card, ``torch.distributed.init_process_group`` with its address,
world size and rank); ``make_host_mesh`` starts a world of one itself.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The production mesh: 16 x 16 ("data", "model") on one pod, 2 x 16 x
    16 ("pod", "data", "model") on two.  Raises ``ValueError`` naming the
    world size it needs where the world is another size (as
    ``jax.make_mesh`` fails when devices are short)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = PRODUCTION[multi_pod]
    need = 1
    for n in shape:
        need *= n
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != need:
        raise ValueError(
            f"the {'x'.join(map(str, shape))} {axes} mesh needs world size "
            f"{need}; this world has {have}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device=None):
    """A (1, 1) ("data", "model") mesh on ``device`` (``None``: the CPU).
    Where no process group exists it first starts a world of one from an
    in-process ``HashStore``: gloo on the CPU, NCCL on the card; no network
    is used."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = torch.device("cpu" if device is None else device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return init_device_mesh(dev.type, (1, 1),
                            mesh_dim_names=("data", "model"))


def mesh_tp(mesh) -> int:
    from repro_torch.sharding.api import axis_sizes

    return axis_sizes(mesh).get("model", 1)


def mesh_dp(mesh) -> int:
    from repro_torch.sharding.api import axis_sizes

    sizes = axis_sizes(mesh)
    return sizes.get("data", 1) * sizes.get("pod", 1)
