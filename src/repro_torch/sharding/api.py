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
import sys
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

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


# ---------------------------------------------------------------------------
# Laying a tree out, and the collectives of a laid-out run
# ---------------------------------------------------------------------------

def _dtensor_cls():
    from torch.distributed.tensor import DTensor

    return DTensor


def is_laid_out(t) -> bool:
    """``t`` is a laid-out leaf (a DTensor).  No DTensor exists before
    ``torch.distributed.tensor`` is imported, so whole params never pay
    for that import."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def entry_axes(part) -> tuple:
    """The mesh axes of one resolved entry (``None``, a name or a tuple)."""
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


def rank_chunk(size: int, axes, mesh) -> Tuple[int, int]:
    """(start, stop) of this rank's chunk of a dim of ``size`` split over
    ``axes`` (major to minor), as DTensor splits it."""
    sizes = axis_sizes(mesh)
    n, index = 1, 0
    for ax in axes:
        n *= sizes[ax]
        index = index * sizes[ax] + mesh.get_local_rank(ax)
    if size % n:
        raise ValueError(f"a dim of {size} does not split over {axes} "
                         f"({n} ranks)")
    return index * (size // n), (index + 1) * (size // n)


def shard_of(t, spec: Spec, mesh):
    """This rank's shard of the whole tensor ``t`` under the resolved
    entries ``spec``: every split dim narrowed to the rank's chunk, copied
    so that the whole tensor can be freed."""
    for d, part in enumerate(spec):
        axes = [ax for ax in entry_axes(part) if axis_sizes(mesh)[ax] > 1]
        if axes:
            lo, hi = rank_chunk(t.shape[d], axes, mesh)
            t = t.narrow(d, lo, hi - lo)
    return t.clone()


def lay_out(tree, shardings):
    """``tree``'s tensors laid out by its :class:`NamedSharding` tree: every
    rank holds the whole tree (the same converted params, or the same draw
    from one seed) and keeps only its own shard of each leaf, wrapped as
    ``DTensor.from_local`` so that its global shape and placements stay
    readable.  Nothing is sent: no rank scatters to another.  At world size
    1 the tree comes back as it is."""
    def one(s: NamedSharding, t):
        if s is None or t is None or s.mesh.size() == 1:
            return t
        return _dtensor_cls().from_local(shard_of(t, s.spec, s.mesh), s.mesh,
                                         s.placements, run_check=False)

    return spec_map(one, shardings, tree)


def local(t):
    """A leaf's local tensor: a laid-out leaf's shard, else ``t``."""
    return t.to_local() if is_laid_out(t) else t


def laid_out_mesh(tree):
    """The mesh of the first laid-out leaf of a dict tree, else ``None``."""
    if isinstance(tree, dict):
        for v in tree.values():
            mesh = laid_out_mesh(v)
            if mesh is not None:
                return mesh
        return None
    return tree.device_mesh if is_laid_out(tree) else None


def split_axes(t) -> Dict[int, Tuple[str, ...]]:
    """{tensor dim: the mesh axes of more than one rank that split it, major
    to minor} of a laid-out leaf; ``{}`` for a plain tensor."""
    if not is_laid_out(t):
        return {}
    mesh = t.device_mesh
    out: Dict[int, Tuple[str, ...]] = {}
    for name, size, p in zip(mesh.mesh_dim_names, mesh.shape, t.placements):
        if size > 1 and p.is_shard():
            out[p.dim] = out.get(p.dim, ()) + (name,)
    return out


# The differentiable collectives.  Every collective that a gradient can
# reach runs inside one of these autograd Functions; a plain
# ``torch.distributed`` call remains only where no gradient flows (serving,
# ``full``, the optimizer's sums over gradients).  Each backward depends on
# how the cotangent arriving at the output lies over the group: replicated
# (every rank holds the whole cotangent, as where the output feeds work done
# alike on every rank) or partial (each rank holds its own part of it, as
# where each rank reads the output in part).


def _gathered(t, group, n: int):
    """The ``n`` ranks' ``t`` of ``group`` in rank order (one all-gather;
    gloo also runs it on CUDA tensors, staged through the host)."""
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return parts


def _summed(t, group):
    """A contiguous copy of ``t`` summed over ``group`` (one all-reduce)."""
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


class CopyToGroup(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``group``.  It
    marks where a value replicated over the group feeds work split over it
    (this rank's experts, columns or heads), so each rank's part of the
    gradient joins the others'."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group), None


class SumOverGroup(torch.autograd.Function):
    """Sum over ``group`` forward; identity backward: every rank of the group
    goes on with the same sum, and so hands back the whole gradient (JAX's
    ``psum`` under ``shard_map`` with a replicated output)."""

    @staticmethod
    def forward(ctx, t, group):
        return _summed(t, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllGather(torch.autograd.Function):
    """The ranks' ``t`` concatenated along ``dim``; the backward hands each
    rank its slice of the cotangent, summed over the group first where the
    cotangent is ``partial``."""

    @staticmethod
    def forward(ctx, t, dim, group, n, index, partial):
        ctx.dim, ctx.group, ctx.n, ctx.index, ctx.partial = (dim, group, n,
                                                             index, partial)
        return torch.cat(_gathered(t.contiguous(), group, n), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        if ctx.partial:
            grad = _summed(grad, ctx.group)
        size = grad.shape[ctx.dim] // ctx.n
        return (grad.narrow(ctx.dim, ctx.index * size, size).contiguous(),
                None, None, None, None, None)


COTANGENTS = ("replicated", "partial")


def all_gather(t, dim: int, axis: str, mesh, *, cotangent: str):
    """The ranks' ``t`` along ``axis`` concatenated along ``dim`` in rank
    order.  ``cotangent`` says how the gradient reaching the output lies
    over ``axis``: ``"replicated"`` (the output feeds work done alike on
    every rank: the backward is the rank's slice) or ``"partial"`` (each
    rank reads the output in part: the backward sums over ``axis``, then
    slices)."""
    if cotangent not in COTANGENTS:
        raise ValueError(f"cotangent must be one of {COTANGENTS}, got "
                         f"{cotangent!r}")
    n = axis_sizes(mesh)[axis]
    if n == 1:
        return t
    return _AllGather.apply(t, dim, mesh.get_group(axis), n,
                            mesh.get_local_rank(axis),
                            cotangent == "partial")


def all_reduce_sum(t, axis: str, mesh):
    """``t`` summed over the ranks of ``axis`` (a new tensor), with the
    identity backward (:class:`SumOverGroup`): the sum feeds work done
    alike on every rank of ``axis``."""
    if axis_sizes(mesh)[axis] == 1:
        return t
    return SumOverGroup.apply(t, mesh.get_group(axis))


def gather_leaf(t, keep: Tuple[str, ...] = ()):
    """A laid-out leaf gathered over every axis that splits it, except those
    in ``keep``, as a plain tensor (a dim split by several axes is gathered
    minor axis first); a plain tensor comes back as it is.  The backward is
    FSDP's: the ranks that gathered the leaf each hold part of its
    gradient, so each gathered axis sums the cotangent before its slice."""
    if not is_laid_out(t):
        return t
    mesh, x = t.device_mesh, t.to_local()
    for dim, axes in split_axes(t).items():
        for ax in reversed(axes):
            if ax not in keep:
                x = all_gather(x, dim, ax, mesh, cotangent="partial")
    return x


def as_laid_out(local_t, proto):
    """``local_t`` as the shard of a leaf laid out as ``proto`` is (the same
    mesh and placements); where ``proto`` is plain, ``local_t`` itself."""
    if not is_laid_out(proto):
        return local_t
    return _dtensor_cls().from_local(local_t, proto.device_mesh,
                                     proto.placements, run_check=False)


def sum_over_axes(tensors, axes_of, mesh):
    """Each of ``tensors`` summed over the mesh axes that ``axes_of`` names
    for it, as new tensors: for each axis, one all-reduce a dtype of every
    tensor it sums, flattened into one buffer.  For sums that no gradient
    reaches (the optimizer's, over gradients and norms), so a plain
    ``torch.distributed`` call."""
    out = list(tensors)
    sizes = axis_sizes(mesh) if mesh is not None else {}
    with torch.no_grad():
        for ax in sizes:
            if sizes[ax] == 1:
                continue
            by_dtype: Dict[Any, list] = {}
            for i, axes in enumerate(axes_of):
                if ax in axes:
                    by_dtype.setdefault(out[i].dtype, []).append(i)
            for ids in by_dtype.values():
                buf = torch.cat([out[i].reshape(-1) for i in ids])
                dist.all_reduce(buf, group=mesh.get_group(ax))
                off = 0
                for i in ids:
                    n = out[i].numel()
                    out[i] = buf[off:off + n].view(out[i].shape)
                    off += n
    return out


def full(t):
    """The global tensor of a laid-out leaf (every shard gathered), on every
    rank; a plain tensor comes back as it is.  The one call that turns the
    laid-out outputs of the serving steps into whole tensors."""
    return gather_leaf(t)


def split_dim(t, axis: str = "model"):
    """The dim of a laid-out leaf that ``axis`` splits, else ``None``."""
    for dim, axes in split_axes(t).items():
        if axis in axes:
            return dim
    return None


def laid_out_as(local_t, names, global_shape, mesh, rules=None):
    """A rank's ``local_t`` wrapped as the shard of a tensor of
    ``global_shape`` whose logical dims ``names`` resolve on ``mesh``."""
    s = named(mesh, names, global_shape, rules)
    if mesh.size() == 1:
        return local_t
    return _dtensor_cls().from_local(local_t, mesh, s.placements,
                                     run_check=False)


@dataclasses.dataclass(frozen=True)
class Layout:
    """A run on laid-out params: its mesh, and the mesh's axis sizes.
    ``tp`` is the size of the ``"model"`` axis."""

    mesh: Any

    @property
    def sizes(self) -> Dict[str, int]:
        return axis_sizes(self.mesh)

    @property
    def tp(self) -> int:
        return self.sizes.get("model", 1)

    def model_rank(self) -> int:
        if "model" not in self.sizes:
            return 0
        return self.mesh.get_local_rank("model")

    def copy_to_model(self, x):
        """``x`` as it is, its gradient summed over the model axis
        (:class:`CopyToGroup`): the input that every model rank holds whole
        of work each rank does on its own columns or heads."""
        if self.tp == 1:
            return x
        return CopyToGroup.apply(x, self.mesh.get_group("model"))

    def model_chunk(self, size: int) -> Optional[Tuple[int, int]]:
        """(start, stop) of this rank's columns of a dim of ``size`` that the
        model axis splits (``size % tp == 0``), else ``None``."""
        if self.tp == 1 or size % self.tp:
            return None
        return rank_chunk(size, ("model",), self.mesh)


_LAYOUT: Optional[Layout] = None


def current_layout() -> Optional[Layout]:
    """The layout of the running laid-out call, else ``None``."""
    return _LAYOUT


@contextlib.contextmanager
def layout_scope(mesh):
    """Run the model code within on the laid-out params of ``mesh``."""
    global _LAYOUT
    prev = _LAYOUT
    _LAYOUT = Layout(mesh)
    try:
        yield _LAYOUT
    finally:
        _LAYOUT = prev


def select_layer(t, l: int):
    """Layer ``l`` of a stacked leaf (``t[l]``); a laid-out leaf's layer is
    laid out as the leaf is, its split dims one lower (the layers dim is
    never split)."""
    if not is_laid_out(t):
        return t[l]
    from torch.distributed.tensor import Shard

    if any(p.is_shard(0) for p in t.placements):
        raise ValueError("a stacked leaf's layers dim is split")
    placements = tuple(Shard(p.dim - 1) if p.is_shard() else p
                       for p in t.placements)
    return _dtensor_cls().from_local(t.to_local()[l], t.device_mesh,
                                     placements, run_check=False)


def _items(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, prefix + (k,))
    else:
        yield prefix, tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _gather_whole(group, n: int, dims, shards) -> tuple:
    """Each of ``shards`` (one dtype) gathered whole along its ``dims``
    entry over ``group``, in one all-gather of them flattened."""
    parts = _gathered(torch.cat([s.reshape(-1) for s in shards]), group, n)
    out, off = [], 0
    for s, d in zip(shards, dims):
        out.append(torch.cat([p[off:off + s.numel()].view(s.shape)
                              for p in parts], dim=d))
        off += s.numel()
    return tuple(out)


class _GatherShards(torch.autograd.Function):
    """The FSDP gather of several leaves' shards of one dtype over
    ``group``: forward, one all-gather of the shards flattened into one
    buffer, each leaf whole along its ``dims`` entry; backward, one
    all-reduce of the whole leaves' cotangents (each rank computed on its
    own rows), then each leaf's slice."""

    @staticmethod
    def forward(ctx, group, n, index, dims, *shards):
        ctx.group, ctx.n, ctx.index, ctx.dims = group, n, index, dims
        return _gather_whole(group, n, dims, shards)

    @staticmethod
    def backward(ctx, *grads):
        buf = _summed(torch.cat([g.reshape(-1) for g in grads]), ctx.group)
        out, off = [], 0
        for g, d in zip(grads, ctx.dims):
            whole = buf[off:off + g.numel()].view(g.shape)
            off += g.numel()
            size = g.shape[d] // ctx.n
            out.append(whole.narrow(d, ctx.index * size, size).contiguous())
        return (None, None, None, None, *out)


def gather_tree(tree, axes: Tuple[str, ...] = ("pod", "data")):
    """A dict tree as the model code takes laid-out params: every laid-out
    leaf gathered over each of ``axes`` that alone splits one of its dims
    (FSDP: the params' data-split dims), in one all-gather a dtype for the
    whole tree (each rank's shards flattened into one buffer).  A leaf keeps
    the splits of the other axes (a DTensor whose ``axes`` placements are
    ``Replicate()``); one that nothing splits comes back as its plain whole
    tensor.  The backward is FSDP's (:class:`_GatherShards`): one
    all-reduce a dtype of the whole leaves' gradients, then each rank's
    slice, so a data-split leaf's gradient comes back summed over the
    ranks that gathered it."""
    from torch.distributed.tensor import Replicate

    out = spec_map(lambda t: t, tree)  # a copy of the dicts
    for ax in axes:
        todo = {}
        for path, t in _items(out):
            split = split_axes(t)
            dims = [d for d, a in split.items() if a == (ax,)]
            if dims:
                todo.setdefault(t.to_local().dtype, []).append((path, t,
                                                                 dims[0]))
        for items in todo.values():
            mesh = items[0][1].device_mesh
            args = (mesh.get_group(ax), axis_sizes(mesh)[ax],
                    mesh.get_local_rank(ax), tuple(d for _, _, d in items))
            shards = [t.to_local() for _, t, _ in items]
            if shards[0].is_floating_point():
                wholes = _GatherShards.apply(*args, *shards)
            else:  # integer and bool leaves carry no gradient
                wholes = _gather_whole(args[0], args[1], args[3], shards)
            for (path, t, _), whole in zip(items, wholes):
                placements = tuple(
                    Replicate() if name == ax else p for name, p in
                    zip(mesh.mesh_dim_names, t.placements))
                _set(out, path, _dtensor_cls().from_local(
                    whole, mesh, placements, run_check=False))
    for path, t in list(_items(out)):
        if is_laid_out(t) and not split_axes(t):
            _set(out, path, t.to_local())
    return out


def full_tree(tree):
    """Every leaf of a dict tree whole on every rank (a collective): the
    gathers of :func:`gather_tree` over every axis, one all-gather an axis
    and a dtype, then :func:`full` of any leaf that several axes split on
    one dim.  Plain leaves come back as they are."""
    out = gather_tree(tree, axes=("pod", "data", "model"))
    return spec_map(full, out)


def lay_out_like(tree, like):
    """The whole tensors of ``tree`` laid out as the leaves at the same
    places in ``like`` are: each rank keeps its own shard of a leaf whose
    counterpart is laid out (the same placements on the same mesh), and a
    leaf whose counterpart is plain comes back as it is.  Nothing is
    sent."""
    def one(t, proto):
        if not is_laid_out(proto):
            return t
        mesh = proto.device_mesh
        for d, axes in split_axes(proto).items():
            lo, hi = rank_chunk(t.shape[d], axes, mesh)
            t = t.narrow(d, lo, hi - lo)
        return _dtensor_cls().from_local(t.clone(), mesh, proto.placements,
                                         run_check=False)

    return spec_map(one, tree, like)
