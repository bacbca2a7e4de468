"""Linear layers in the dense, masked and compressed formats (twin of
``repro/core/sparse_linear.py``).

Params are plain dicts of tensors: ``{"w"}`` (dense), ``{"w", "mask"}``
(masked), ``{"values", "idx"}`` (compressed) or ``{"values_r", "idx_r"}``
(the group-local REDUCE format of a layer whose reduction dim a
tensor-parallel mesh shards, under ``SparsityConfig.shard_local_reduce``),
each with an optional ``"b"``.

Every leaf is made through :func:`box` with its logical dim names, the names
of the JAX package's ``Boxed`` leaves.  Outside :func:`boxing` ``box``
returns the tensor, so the init functions give plain trees; inside it they
give :class:`Boxed` leaves, which :func:`unbox_tree` splits into the values
and the logical spec tree (``models.registry.param_specs``).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch._compat import resolve_device
from repro_torch.core import formats
from repro_torch.core.pruning import (SparsityConfig, choose_group,
                                      colwise_nm_mask, kept_per_group,
                                      rowwise_nm_mask)
from repro_torch.roofline.counter import counted
from repro_torch.sharding.api import (all_gather, all_reduce_sum,
                                      current_layout, gather_leaf, split_dim)
from repro_torch.roofline.kernels import linear_work


class Boxed:
    """A parameter leaf with its logical dim names (``spec``, one a dim)."""

    __slots__ = ("value", "spec")

    def __init__(self, value, spec: Tuple[Optional[str], ...]):
        self.value = value
        self.spec = tuple(spec)

    def __repr__(self):
        return f"Boxed(shape={tuple(self.value.shape)}, spec={self.spec})"


_BOXING = False


@contextlib.contextmanager
def boxing():
    """Within this scope the init functions give :class:`Boxed` leaves."""
    global _BOXING
    prev, _BOXING = _BOXING, True
    try:
        yield
    finally:
        _BOXING = prev


def box(value, spec: Tuple[Optional[str], ...]):
    """``value`` named by ``spec``: a :class:`Boxed` leaf within
    :func:`boxing`, else ``value`` itself."""
    if not _BOXING:
        return value
    if len(spec) != value.ndim:
        raise ValueError(f"spec {spec} does not name {value.ndim} dims")
    return Boxed(value, spec)


def unbox(leaf):
    """A leaf's value, boxed or not."""
    return leaf.value if isinstance(leaf, Boxed) else leaf


def box_map(fn, tree):
    """``fn`` over the :class:`Boxed` leaves of a dict tree."""
    if isinstance(tree, dict):
        return {k: box_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def unbox_tree(tree):
    """Split a tree of :class:`Boxed` leaves into (values, logical specs)."""
    return (box_map(lambda b: b.value, tree), box_map(lambda b: b.spec, tree))


def _dense_init(generator, d_in, d_out, dtype, scale):
    if scale is None:
        scale = 1.0 / np.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator, dtype=torch.float32)
    return (w * scale).to(dtype)


def linear_init(generator: torch.Generator, d_in: int, d_out: int,
                cfg: SparsityConfig, *, dtype=torch.float32,
                use_bias: bool = False, in_ax: Optional[str] = "embed",
                out_ax: Optional[str] = "ffn", scale: Optional[float] = None,
                mode: str = "concat", device=None) -> Dict[str, Any]:
    """Create a (possibly pruned) linear layer's params on ``device``
    (``None``: the CUDA card).  ``generator`` is a CPU generator, so the
    weights do not depend on the device.  ``in_ax``/``out_ax`` are the
    logical names of d_in and d_out (:func:`box`).

    ``mode="reduce"`` marks a layer whose reduction dim a tensor-parallel
    mesh shards (the o and down projections): under
    ``cfg.shard_local_reduce`` a pruned compressed one takes the REDUCE
    format, ``values_r`` [G, n, d_out] and group-local ``idx_r`` [G, n];
    otherwise the ordinary format.
    """
    if mode not in ("concat", "reduce"):
        raise ValueError(f"mode must be 'concat' or 'reduce', got {mode!r}")
    dev = resolve_device(device)
    prune = cfg.applies_to(d_in, d_out)
    params: Dict[str, Any] = {}
    if prune and cfg.compressed and mode == "reduce" and cfg.shard_local_reduce:
        g = choose_group(d_in, cfg.reduce_groups or 4)
        values, idx = formats.init_compressed_reduce(
            generator, d_in, d_out, g, kept_per_group(d_in // g, cfg.sparsity),
            dtype, scale, device=dev)
        params["values_r"] = box(values, ("reduce_group", None, out_ax))
        params["idx_r"] = box(idx, ("reduce_group", None))
    elif prune and cfg.compressed:
        values, idx = formats.init_compressed(
            generator, d_in, d_out, cfg, dtype, scale, device=dev)
        params["values"] = box(values, ("tile", "kept", None))
        params["idx"] = box(idx, ("tile", None))
    elif prune and cfg.format == "masked":
        w = _dense_init(generator, d_in, d_out, dtype, scale)
        if cfg.scheme == "rowwise":
            mask = rowwise_nm_mask(w, cfg.sparsity, m=cfg.m)
        else:
            mask = colwise_nm_mask(w, cfg.sparsity, m=cfg.m, tile=cfg.tile)
        params["w"] = box((w * mask.to(dtype)).to(dev), (in_ax, out_ax))
        params["mask"] = box(mask.to(dev), (in_ax, out_ax))
    else:
        params["w"] = box(_dense_init(generator, d_in, d_out, dtype,
                                      scale).to(dev), (in_ax, out_ax))
    if use_bias:
        params["b"] = box(torch.zeros((d_out,), dtype=dtype, device=dev),
                          (out_ax,))
    return params


@counted("linear", lambda x, values, idx: linear_work(
    x.numel() // x.shape[-1], values, idx, x.shape[-1]))
def forward_compressed_xla(x: torch.Tensor, values: torch.Tensor,
                           idx: torch.Tensor) -> torch.Tensor:
    """Tiled gather + dense einsum, the twin of the JAX package's XLA path:
    ``y[..., t*T:(t+1)*T] = x[..., idx[t]] @ values[t]``.  The sparse linear
    kernels' plain version in dispatch (``compressed_xla``), so the op
    counter counts it as theirs."""
    n_tiles, _, tile = values.shape
    xg = x[..., idx.long()]  # [..., n_tiles, k]
    y = torch.einsum("...tk,tkf->...tf", xg, values)
    return y.reshape(*x.shape[:-1], n_tiles * tile)


def forward_compressed_reduce(x: torch.Tensor, values: torch.Tensor,
                              idx: torch.Tensor) -> torch.Tensor:
    """The REDUCE format's product: x [..., d_in] split into [..., G, M],
    each group's kept rows gathered by its local ``idx`` [G, n], and one
    einsum ``"...gn,gnf->...f"`` with ``values`` [G, n, d_out].  The group
    dim stays a batch dim of the gather, so a mesh that shards it gathers
    locally and sums only the [..., d_out] output.  Plain PyTorch on the CPU
    and the card alike: the JAX package computes it in XLA, with no
    kernel."""
    g, n, _ = values.shape
    lead = x.shape[:-1]
    xg = x.reshape(*lead, g, x.shape[-1] // g)
    sel = torch.gather(xg, -1, idx.long().expand(*lead, g, n))
    return torch.einsum("...gn,gnf->...f", sel, values)


def forward_masked(x: torch.Tensor, w: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    return x @ (w * mask.to(w.dtype))


def linear_apply(params, x: torch.Tensor, *, impl: Optional[str] = None,
                 split: Optional[str] = None,
                 d_in: Optional[int] = None) -> torch.Tensor:
    """Apply a layer created by ``linear_init`` to ``x`` [..., d_in].

    A compressed layer runs the candidate ``repro_torch.dispatch`` resolves
    for its shape, device and serving phase (profile DB, else the heuristic:
    the sparse linear kernel on the card, the gather-einsum on the CPU), or
    the one ``impl`` (else an ambient ``dispatch.force_scope``) names,
    through ``dispatch.run_guarded``: a candidate that refuses to run is
    quarantined and the next one runs; raises when none is left.  A
    REDUCE-format layer runs :func:`forward_compressed_reduce`.

    Inside ``sharding.layout_scope`` (a call on laid-out params) ``split``
    says how the layer divides over the model axis (:func:`_split_apply`):
    ``"cols"`` or ``"rows"``, the latter with the layer's whole ``d_in``.
    Elsewhere ``split`` and ``d_in`` change nothing.
    """
    if split is not None:
        lay = current_layout()
        if lay is not None:
            return _split_apply(params, x, split, d_in, impl, lay)
    if "values_r" in params:
        y = forward_compressed_reduce(x, params["values_r"], params["idx_r"])
    elif "values" in params:
        from repro_torch import dispatch

        phase = dispatch.current_phase()
        site = ("linear", x.shape, params["values"].shape, x.dtype, x.device,
                phase)

        def make_key():
            return dispatch.linear_key_from(
                x.shape, params["values"].shape, x.dtype, phase=phase)

        spec = dispatch.site_impl(
            site, make_key, param_keys=("values", "idx"),
            force=dispatch.forced_impl("linear", impl), device=x.device)
        # execution guard: a candidate that refuses to run is quarantined
        # and the key re-resolves down the ladder
        y = dispatch.run_guarded(make_key, spec, lambda s: s.apply(params, x),
                                 param_keys=("values", "idx"),
                                 device=x.device)
    elif "mask" in params:
        y = forward_masked(x, params["w"], params["mask"])
    else:
        y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y


def _plain(params, x, impl):
    """The layer without its bias on plain local leaves."""
    return linear_apply({k: v for k, v in params.items() if k != "b"}, x,
                        impl=impl)


def _split_apply(params, x: torch.Tensor, split: str, d_in: Optional[int],
                 impl: Optional[str], lay) -> torch.Tensor:
    """The layer on laid-out leaves (the twin of the JAX ``shd`` of its
    output).  Every leaf is first gathered over the data-parallel axes that
    split it (FSDP); what the model axis splits stays split.  Every
    collective here is differentiable (``sharding.api``).

    ``split="cols"`` (q, k, v, gate, up): returns the rank's columns of
    d_out where the model axis splits d_out (``Layout.model_chunk``), else
    every column.  A dense or masked ``w`` holds those columns already; a
    compressed layer, whose T dim no axis splits, computes only them by
    slicing ``values[..., cols]`` (whole tiles where T < d_out).  The
    caller puts one ``Layout.copy_to_model`` at the input that its column
    layers share, so their input's gradient is summed over the model axis
    once.  A leaf that the model axis does not split (that ``values``, a
    ``w`` or ``b`` whose d_out it does not divide) thereby gets a gradient
    of this rank's columns only: the train step sums those leaves over the
    model axis (``launch.steps``).

    ``split="rows"`` (o, down): ``x`` holds the rank's columns of ``d_in``
    where the model axis splits ``d_in``, and every rank gets the whole
    output.  A dense or masked ``w`` split on d_in multiplies its rows and
    the ranks' partial products are summed over the model axis (one
    all-reduce); a REDUCE layer whose groups the model axis splits
    multiplies its own groups and sums likewise; a compressed layer, whose
    ``idx`` addresses the whole d_in, first gathers ``x`` over the model
    axis.
    """
    mesh = lay.mesh
    model_dim = {k: split_dim(v) for k, v in params.items()}
    p = {k: gather_leaf(v, keep=("model",)) for k, v in params.items()}
    if split == "cols":
        if "values_r" in p:
            raise ValueError("a REDUCE-format layer is row parallel")
        if "values" in p and model_dim["values"] is None:
            n_tiles, _, tile = p["values"].shape
            chunk = lay.model_chunk(n_tiles * tile)
            if chunk is None:
                return linear_apply(p, x, impl=impl)
            lo, hi = chunk
            if n_tiles == 1:
                sub = {"values": p["values"][..., lo:hi].contiguous(),
                       "idx": p["idx"]}
            elif lo % tile == 0 and hi % tile == 0:
                sub = {"values": p["values"][lo // tile:hi // tile],
                       "idx": p["idx"][lo // tile:hi // tile]}
            else:
                sub = None
            y = (_plain(p, x, impl)[..., lo:hi] if sub is None
                 else linear_apply(sub, x, impl=impl))
            if "b" in p:
                y = y + (p["b"] if model_dim["b"] is not None
                         else p["b"][lo:hi])
            return y
        y = linear_apply(p, x, impl=impl)
        if "w" in p and model_dim["w"] is None:
            chunk = lay.model_chunk(y.shape[-1])
            if chunk is not None:
                y = y[..., chunk[0]:chunk[1]]
        return y
    if split != "rows":
        raise ValueError(f"split must be 'cols' or 'rows', got {split!r}")
    x_split = d_in is not None and lay.model_chunk(d_in) is not None
    if "values_r" in p and model_dim["values_r"] is not None:
        # the sum feeds the residual stream, alike on every model rank
        y = all_reduce_sum(
            forward_compressed_reduce(x, p["values_r"], p["idx_r"]), "model",
            mesh)
    elif "w" in p and model_dim["w"] == 0:
        y = all_reduce_sum(_plain(p, x, impl), "model", mesh)  # as above
    else:
        out = model_dim.get("values", model_dim.get("w"))
        if x_split:
            # every rank multiplies the whole x: alike where it computes
            # every output column, in part where only its own
            x = all_gather(x, -1, "model", mesh, cotangent=(
                "replicated" if out is None else "partial"))
        y = _plain(p, x, impl)
        if out is not None:  # the layer's output columns split over model
            # the whole output feeds the residual stream, alike on every rank
            y = all_gather(y, -1, "model", mesh, cotangent="replicated")
    if "b" in params:
        y = y + gather_leaf(params["b"])
    return y


# ---------------------------------------------------------------------------
# Conversions (prune a trained dense layer -> compressed)
# ---------------------------------------------------------------------------


def compress_layer(params, cfg: SparsityConfig):
    """Convert a dense/masked layer's params into the compressed format,
    ``{"values", "idx"[, "b"]}``.  A layer without a ``mask`` is pruned
    by ``cfg`` first.  Stacked weights ([L, ..., d_in, d_out]) are packed
    one layer at a time, and the stacked (values, idx) feed the layer loop
    as they are."""
    w = params["w"]
    lead = tuple(w.shape[:-2])
    d_in, d_out = w.shape[-2:]
    meta = formats.meta_for(d_in, d_out, cfg)
    mask = params.get("mask")

    def pack2d(w2, m2):
        if m2 is None:
            if cfg.scheme == "rowwise":
                m2 = rowwise_nm_mask(w2, cfg.sparsity, m=cfg.m)
            else:
                m2 = colwise_nm_mask(w2, cfg.sparsity, m=cfg.m, tile=meta.tile)
        return formats.pack_colwise(w2, m2, meta)

    if lead:
        wf = w.reshape((-1, d_in, d_out))
        mf = (mask.reshape((-1, d_in, d_out)) if mask is not None
              else [None] * wf.shape[0])
        packed = [pack2d(a, m) for a, m in zip(wf, mf)]
        values = torch.stack([v for v, _ in packed])
        idx = torch.stack([i for _, i in packed])
        values = values.reshape(lead + tuple(values.shape[1:]))
        idx = idx.reshape(lead + tuple(idx.shape[1:]))
    else:
        values, idx = pack2d(w, mask)
    out = {"values": values, "idx": idx}
    if "b" in params:
        out["b"] = params["b"]
    return out
