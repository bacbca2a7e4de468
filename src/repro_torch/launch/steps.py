"""Step builders (train / prefill / decode) and their shardings (twin of
``repro/launch/steps.py``), shared by the LM ``Trainer``, the serving
engine and the launchers.

A sharding here is a :class:`repro_torch.sharding.NamedSharding`, the
resolved PartitionSpec entries and their DTensor placements on a mesh.  The
port runs its collectives explicitly, over the mesh's axis groups.

Serving: ``distribute_tree(params, serve_shardings(...)[0])`` lays the
params out (each rank keeps its shard of every leaf), and the prefill and
decode steps then run the dense attention LM on each rank's shards: each
takes the global batch (and a laid-out cache), computes this rank's rows
(``_data_shard``) and returns its logits and cache laid out;
``sharding.full`` gives the global tensors.  Whole params run as before.

Training: on laid-out params of the dense attention LM (the same
``distribute_tree`` of ``train_shardings``' params, and ``adamw_init`` of
them) every rank holds its shard of every param and optimizer-state leaf,
takes the global batch, computes on its rows, and differentiates its own
rows' loss through the layout's differentiable collectives; AdamW then
updates the shards (:func:`make_train_step`).  On whole params every rank
holds the whole tree: under a ``ShardingCtx`` whose mesh has data-parallel
ranks, the train step takes the global batch, computes on this rank's rows
and averages the gradients and the loss over the ranks, and the MoE layers
(``moe_impl="shard_map"``) sum over the model group themselves.  The
other families under the layout are slice 25.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch._tree import tree_map, tree_map_with_path, value_and_grad
from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry as reg
from repro_torch.optim import AdamWConfig, adamw_update, opt_state_specs
from repro_torch.sharding.api import (as_laid_out, axis_sizes, get_ctx,
                                      lay_out, local, named, spec_map,
                                      specs_to_shardings, split_axes,
                                      sum_over_axes)


def distribute_tree(tree, shardings):
    """``tree``'s tensors laid out by ``shardings`` (``sharding.lay_out``:
    each rank keeps its own shard of the whole tree it holds, as a
    DTensor); at world size 1 the tree comes back as it is."""
    return lay_out(tree, shardings)


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


def _data_axes():
    """(the installed mesh's data-parallel axes of more than one rank,
    their sizes) over the ``"pod"`` and ``"data"`` groups, major first."""
    ctx = get_ctx()
    sizes = axis_sizes(ctx.mesh) if ctx is not None else {}
    return [ax for ax in ("pod", "data") if sizes.get(ax, 1) > 1], sizes


def _data_shard(batch):
    """This rank's rows of every batch leaf: the batch dim split over the
    installed mesh's data-parallel ranks, ``"pod"`` major (JAX's
    ``act_batch`` layout, ``registry.batch_rows``, which the laid-out serving
    steps also take their rows by); without such ranks, the batch as it
    is."""
    axes, _ = _data_axes()
    if not axes:
        return batch
    return reg.batch_rows(batch, get_ctx().mesh)[0]


def _data_mean(tree):
    """Average every float leaf over the installed mesh's data-parallel
    ranks; without such ranks, the tree as it is."""
    axes, sizes = _data_axes()
    if not axes:
        return tree
    import torch.distributed as dist

    ctx = get_ctx()

    def mean(t):
        if t is None or not t.is_floating_point():
            return t
        t = t.clone()
        for ax in axes:
            dist.all_reduce(t, group=ctx.mesh.get_group(ax))
            t /= sizes[ax]
        return t

    return tree_map(mean, tree)


def _laid_grads(cfg: ModelConfig, mesh, params, batch, microbatches: int):
    """(loss, metrics, grads) of the train step on laid-out ``params``: each
    rank's gradient of its shards, laid out as the params, the whole step's.

    Each rank differentiates its own rows' loss (``registry.rank_loss``)
    with respect to its shards, through the layout's differentiable
    collectives.  Then for each data-parallel axis: a leaf that the axis
    splits came back summed over it (the FSDP gather's backward); every
    other float leaf is summed over it here.  The one leaf-level sum over
    the model axis: a column layer's leaf that the model axis does not
    split (``registry.column_layers``: its compressed ``values``, or a
    ``w``/``b`` whose d_out it does not divide) got this rank's columns'
    part only, so it is summed over the model axis.  Each sum is one
    all-reduce an axis and a dtype; then every gradient is divided by the
    data-parallel ranks, once.  Metrics (``loss``, ``nll``, ``aux``) are
    averaged over the data-parallel ranks."""
    rows, data_axes = reg.batch_rows(batch, mesh)
    live, paths = [], []

    def track(path, p):
        if not p.is_floating_point():
            return p
        leaf = local(p).detach().requires_grad_()
        live.append(leaf)
        paths.append((path, p))
        return as_laid_out(leaf, p)

    tracked = tree_map_with_path(track, params)
    mb = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                       *v.shape[1:]) for k, v in rows.items()}
    grads, loss = None, 0.0
    for i in range(microbatches):
        l, metrics = reg.rank_loss(cfg, mesh, tracked,
                                   {k: v[i] for k, v in mb.items()})
        found = torch.autograd.grad(l, live, allow_unused=True)
        g = [torch.zeros_like(p) if gi is None else gi
             for p, gi in zip(live, found)]
        if microbatches > 1:  # summed in float32, as on whole params
            g = [gi.to(torch.float32) for gi in g]
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        else:
            grads = g
        loss = loss + l.detach()
    if microbatches > 1:
        grads = [g / microbatches for g in grads]
        loss = loss / microbatches
        metrics = {"nll": loss, "aux": torch.zeros((), device=loss.device)}
    columns = reg.column_layers(cfg, axis_sizes(mesh).get("model", 1))
    sums = []
    for path, p in paths:
        split = {a for axes in split_axes(p).values() for a in axes}
        axes = tuple(ax for ax in data_axes if ax not in split)
        if ("model" not in split and path[0] == "layers"
                and path[1:3] in columns):
            axes += ("model",)
        sums.append(axes)
    grads = sum_over_axes(grads, sums, mesh)
    n = 1
    for ax in data_axes:
        n *= axis_sizes(mesh)[ax]
    found = iter(grads)
    grads = tree_map(lambda p: as_laid_out(next(found) / n, p)
                     if p.is_floating_point() else None, params)
    scalars = sum_over_axes([loss, metrics["nll"].detach(),
                             metrics["aux"].detach()],
                            [data_axes] * 3, mesh)
    loss, nll, aux = (t / n for t in scalars)
    return loss, {"nll": nll, "aux": aux}, grads


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, microbatches: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    The loss sees the whole batch (``"tokens"`` and whatever else the
    family reads: ``"enc_embeds"``, ``"vision_embeds"``, ``"vision_pos"``,
    ``"mrope_positions"``).  A mixture of experts trains too: its auxiliary
    loss reaches the router and the experts through the loss's ``aux_weight
    * aux``.  Gradient accumulation over ``microbatches`` splits every leaf
    along the batch dim and sums in float32 (a loop where JAX scans): it
    cuts activation memory for the big train cells; its metrics carry
    ``"aux": 0``, as JAX's.  Under a ``ShardingCtx`` with data-parallel
    ranks the step takes the global batch, as JAX's does, each rank
    computes on its rows (``_data_shard``), and the gradients and metrics
    are averaged over the ranks before the update.  On laid-out params of
    the dense attention LM (each rank's shards, and ``adamw_init`` of
    them) the step takes the global batch too and returns laid-out params
    and optimizer state: the gradients are the whole-params step's
    (:func:`_laid_grads`), AdamW updates each rank's shards, and the
    metrics are the whole step's on every rank.  The step is functional:
    it returns new trees and leaves its inputs as they were.
    """
    grad_fn = make_grad_fn(cfg, microbatches)

    def step(params, opt_state, batch):
        loss, metrics, grads = grad_fn(params, batch)
        new_params, new_opt, gnorm = adamw_update(params, grads, opt_state, opt_cfg)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return new_params, new_opt, metrics

    return step


def make_grad_fn(cfg: ModelConfig, microbatches: int = 1):
    """(params, batch) -> (loss, metrics, grads): what :func:`make_train_step`
    hands AdamW, the gradients before the clip.  On laid-out params the
    gradients are laid out as the params (:func:`_laid_grads`); on whole
    params they are averaged over the installed mesh's data-parallel
    ranks, where it has some."""
    lfn = reg.loss_fn(cfg)

    def grad_fn(params, batch):
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        mesh = reg.laid_out(cfg, params, "the train step")
        if mesh is not None:
            return _laid_grads(cfg, mesh, params, batch, microbatches)
        return _whole_grads(lfn, params, batch, microbatches)

    return grad_fn


def _whole_grads(lfn, params, batch, microbatches: int):
    """(loss, metrics, grads) of the train step on whole params, averaged
    over the installed mesh's data-parallel ranks where it has some."""
    batch = _data_shard(batch)
    if microbatches == 1:
        (loss, metrics), grads = value_and_grad(
            lambda p: lfn(p, batch), params)
    else:
        mb = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                           *v.shape[1:]) for k, v in batch.items()}
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device)
                         if p.is_floating_point() else None, params)
        loss = 0.0
        for i in range(microbatches):
            chunk = {k: v[i] for k, v in mb.items()}
            (l, _m), g = value_and_grad(
                lambda p: lfn(p, chunk), params)
            grads = tree_map(lambda a, g2: a + g2.to(a.dtype), grads, g)
            loss = loss + l
        grads = tree_map(lambda g: g / microbatches, grads)
        loss = loss / microbatches
        metrics = {"nll": loss, "aux": torch.zeros((), device=loss.device)}
    grads = _data_mean(grads)
    loss, metrics = _data_mean((loss, metrics))
    return loss, metrics, grads


def train_shardings(cfg: ModelConfig, mesh, param_shapes, param_specs, batch):
    """((params, opt state, batch), (params, opt state, metrics)) shardings
    of the train step: the optimizer state shards as the params do, and the
    metrics (scalars) are left to the caller (``None``)."""
    from repro_torch.optim import adamw_init

    p_sh = specs_to_shardings(param_specs, param_shapes, mesh)
    opt_shapes = adamw_init(tree_map(
        lambda a: torch.empty(a.shape, dtype=a.dtype, device="meta"),
        param_shapes))
    o_specs_full = opt_state_specs(param_specs)
    o_sh = specs_to_shardings({k: o_specs_full[k] for k in opt_shapes},
                              opt_shapes, mesh)
    b_sh = specs_to_shardings(reg.batch_specs(cfg, batch), batch, mesh)
    return (p_sh, o_sh, b_sh), (p_sh, o_sh, None)


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig):
    """(params, batch) -> (last-token logits, cache).  On laid-out params
    (the dense attention LM) the batch is global and the logits and cache
    come back laid out (``registry.prefill_fn``)."""
    return reg.prefill_fn(cfg)


def make_decode_step(cfg: ModelConfig):
    """(params, cache, tokens, pos) -> (logits, cache).  On laid-out params
    the cache is laid out (``registry.cache_init_fn(..., mesh=mesh)``, or
    the prefill step's), tokens and pos are global, and the logits come
    back laid out (``registry.decode_fn``)."""
    return reg.decode_fn(cfg)


def serve_shardings(cfg: ModelConfig, mesh, param_shapes, param_specs,
                    spec: Dict, cache_auto: bool = True):
    """Shardings of a serving step.  ``spec["kind"] == "prefill"``: (params,
    batch).  Decode: ((params, cache, tokens, pos), cache); the cache's
    entries are ``None`` under ``cache_auto`` (the layout is left to the
    step, as JAX leaves it to GSPMD), else its logical specs resolved."""
    p_sh = specs_to_shardings(param_specs, param_shapes, mesh)
    if spec["kind"] == "prefill":
        return (p_sh, specs_to_shardings(reg.batch_specs(cfg, spec["batch"]),
                                         spec["batch"], mesh))
    if cache_auto:
        c_sh = spec_map(lambda _t: None, spec["cache"])
    else:
        c_sh = specs_to_shardings(reg.cache_specs(cfg, spec["cache"]),
                                  spec["cache"], mesh)
    tok_sh = named(mesh, ("act_batch", None), spec["tokens"].shape)
    pos_sh = named(mesh, (), ())
    return (p_sh, c_sh, tok_sh, pos_sh), c_sh
