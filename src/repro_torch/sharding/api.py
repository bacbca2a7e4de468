"""Logical-axis sharding (twin of ``repro/sharding/api.py``): one rules
table maps logical dimension names to mesh axes, and resolution keeps, per
concrete dim, only the mesh axes that exist and divide it, so every arch of
the zoo resolves on every mesh.

Model code names logical dims (``shd``), and the param trees carry logical
specs (``models.registry.param_specs``).  A launcher installs a
``ShardingCtx``; with none installed everything is a no-op.

A spec resolves to a tuple of PartitionSpec entries, one a tensor dim:
``None``, one mesh axis name, or a tuple of names (major to minor), as
JAX's ``PartitionSpec``.  ``placements`` turns the entries into DTensor
placements, one a mesh dim.  The mesh is read only through its axis sizes:
a ``DeviceMesh``'s ``mesh_dim_names`` and ``shape``, or any object whose
``.shape`` maps axis names to sizes.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

# Default logical->mesh rules. 'pod' appears only in the multi-pod mesh; axes
# missing from the mesh are dropped at resolution time.
RULES: Dict[str, Tuple[str, ...]] = {
    # --- parameters ---
    "embed": ("data",),          # FSDP: shard the replicated-capable dim over data
    "ffn": ("model",),           # tensor parallel
    "heads": ("model",),
    "kv_heads": ("model",),
    "heads_flat": ("model",),    # flattened H*head_dim projection output
    "kv_flat": ("model",),
    "embed2": (),                # aux embed-sized dims (e.g. zamba fuse output)
    "head_dim": (),
    "vocab": ("model",),
    "expert": ("model",),        # expert parallel
    "tile": ("model",),          # compressed colwise-N:M tile axis == TP axis
    "kept": ("data",),           # FSDP the kept-index dim of compressed values
    "reduce_group": ("model",),  # shard-local reduce-mode group dim == TP axis
    "layers": (),
    # --- activations ---
    "act_batch": ("pod", "data"),
    "act_seq_sp": ("model",),    # Megatron-style sequence parallelism between blocks
    "act_embed": (),
    "act_heads": ("model",),
    "act_kv_heads": ("model",),
    "act_ffn": ("model",),
    "act_expert": ("model",),
    "act_moe_group": ("pod", "data"),  # MoE dispatch group dim == DP shards
    "act_kv_seq": ("data",),     # long-context decode: shard the KV seq dim
    "act_vocab": ("model",),
}

Spec = Tuple[Any, ...]


@dataclasses.dataclass
class ShardingCtx:
    mesh: Any
    rules: Dict[str, Tuple[str, ...]] = dataclasses.field(
        default_factory=lambda: dict(RULES))


_CURRENT: Optional[ShardingCtx] = None


def set_ctx(ctx: Optional[ShardingCtx]) -> None:
    global _CURRENT
    _CURRENT = ctx


def get_ctx() -> Optional[ShardingCtx]:
    return _CURRENT


@contextlib.contextmanager
def use_ctx(ctx: Optional[ShardingCtx]):
    prev = get_ctx()
    set_ctx(ctx)
    try:
        yield
    finally:
        set_ctx(prev)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} in the mesh's own axis order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def resolve_spec(shape: Sequence[int], names: Sequence[Optional[str]],
                 rules: Dict[str, Tuple[str, ...]], mesh) -> Spec:
    """Map logical dim names to PartitionSpec entries, keeping only mesh
    axes that exist and divide the dim (axes are applied left to right,
    greedily; a mesh axis serves at most one dim)."""
    if len(shape) != len(names):
        raise ValueError(f"shape {tuple(shape)} and names {tuple(names)} "
                         "differ in length")
    sizes = axis_sizes(mesh)
    parts, used = [], set()
    for dim, name in zip(shape, names):
        chosen = []
        if name is not None:
            prod = 1
            for ax in rules.get(name, ()):
                if ax not in sizes or ax in used:
                    continue
                if dim % (prod * sizes[ax]) == 0:
                    chosen.append(ax)
                    used.add(ax)
                    prod *= sizes[ax]
        parts.append(tuple(chosen) if len(chosen) > 1
                     else (chosen[0] if chosen else None))
    return tuple(parts)


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of resolved entries: per mesh dim, ``Shard(d)``
    where tensor dim ``d`` names that axis, else ``Replicate()`` (also for
    an axis of size 1, which splits nothing).  Several axes on one dim
    split it in mesh order, major to minor, so their order in the entry
    must be the mesh's."""
    from torch.distributed.tensor import Replicate, Shard

    sizes = axis_sizes(mesh)
    order = [ax for ax in sizes if sizes[ax] > 1]
    dim_of = {}
    for d, part in enumerate(spec):
        axes = () if part is None else (part if isinstance(part, tuple)
                                        else (part,))
        pos = [order.index(ax) for ax in axes if ax in order]
        if pos != sorted(pos):
            raise ValueError(f"entry {part} splits dim {d} against the mesh "
                             f"order {order}")
        dim_of.update({ax: d for ax in axes if ax in order})
    return tuple(Shard(dim_of[ax]) if ax in dim_of else Replicate()
                 for ax in sizes)


def shd(x, *names: Optional[str]):
    """Constrain an activation's layout by logical dim names: a DTensor is
    redistributed to the resolved placements; a plain tensor, or any tensor
    without an installed context, comes back as it is."""
    ctx = _CURRENT
    if ctx is None or x is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    spec = resolve_spec(x.shape, names, ctx.rules, ctx.mesh)
    return x.redistribute(ctx.mesh, placements(spec, ctx.mesh))


logical_constraint = shd


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A tensor's layout on a mesh: the resolved entries and the DTensor
    placements they give (the twin of ``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: Spec
    placements: tuple


def named(mesh, names, shape, rules=None) -> NamedSharding:
    spec = resolve_spec(tuple(shape), names, rules or RULES, mesh)
    return NamedSharding(mesh, spec, placements(spec, mesh))


def spec_map(fn, spec_tree, *rest):
    """``fn`` over the leaves of a logical spec tree (a spec, a tuple of
    names, is a leaf) and the values at the same places in ``rest``."""
    if isinstance(spec_tree, dict):
        return {k: spec_map(fn, v, *(r[k] for r in rest))
                for k, v in spec_tree.items()}
    return fn(spec_tree, *rest)


def specs_to_shardings(spec_tree, shape_tree, mesh, rules=None):
    """Resolve a tree of logical specs (and matching tensors or shapes) to
    :class:`NamedSharding` leaves."""
    return spec_map(
        lambda s, a: named(mesh, s, a.shape if hasattr(a, "shape") else a,
                           rules),
        spec_tree, shape_tree)
