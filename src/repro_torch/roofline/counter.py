"""FLOP, byte and collective counts of an eager step (twin of
``repro/roofline/hlo_analyzer.py``).

JAX re-derives a compiled step's FLOPs, HBM bytes and collective bytes from
its optimized HLO text, with loop trip counts as multipliers.  An eager
PyTorch step has no such text.  It has the aten calls it makes, and a
``TorchDispatchMode`` sees each of them on any device, ``meta`` included,
so a step is counted at full size with nothing allocated.

Accounting rules (per rank: the step as one rank runs it):
  flops  a matrix product or a convolution by ``torch.utils.flop_counter``'s
         formulas (2*M*N*K; an einsum or a matmul reaches ``mm``/``bmm``);
         every other compute op one FLOP per output element, as JAX's rule;
         views, reshapes and metadata ops (``empty``, ``detach``,
         ``arange``, a scalar read) zero, the twin of ``_ZERO_COST_OPS``
  bytes  each op's inputs plus its outputs.  Eager PyTorch fuses nothing,
         so this is eager traffic: every op is its own boundary, where
         XLA's count stops at the fusion boundaries and a chain of
         elementwise ops that XLA fuses is one pass there, several here
  collectives  each ``c10d`` (or functional collective) op the mode sees,
         max(input, output) bytes, by kind (``all-reduce``, ``all-gather``,
         ``reduce-scatter``, ``all-to-all``, ``collective-permute``).  The
         input side leaves out the arguments the op writes (a c10d op takes
         its output buffers as arguments): an all-gather into n parts
         counts n shards, a reduce-scatter its n input shards, an
         all-reduce its buffer once
  loops  a Python loop is counted each time round: the twin of the
         trip-count multipliers
  kernels  each entry point of a hand-written kernel family (``counted``)
         reports its ``roofline/kernels.py`` count, and while it runs the
         counter counts nothing else.  So a call counts the same work
         whether its CUDA kernel, its plain version or another plan of the
         same function ran; and the ctypes launches, which the mode cannot
         see, are counted at all
  peak   the most bytes of op outputs alive at once (each fresh output
         from its op until its tensor is freed): an eager peak, without the
         caching allocator's rounding and reuse

The counter never chooses an implementation, never falls back and moves
nothing between devices; a count that reads data (``roofline/kernels.py``)
reads the operands where they lie.  With no counter active an entry point's
hook is one check of a module global.
"""
from __future__ import annotations

import functools
import weakref
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline.kernels import Work

aten = torch.ops.aten

_ACTIVE = None  # the running counter, or None

_ZERO_COST = {aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
              aten.new_empty_strided, aten._local_scalar_dense, aten.arange,
              aten.detach, aten.alias, aten.lift_fresh, aten.is_same_size,
              aten.sym_size, aten.sym_stride, aten.sym_numel}

_COLLECTIVE_KINDS = (
    ("reduce_scatter", "reduce-scatter"), ("allreduce", "all-reduce"),
    ("all_reduce", "all-reduce"), ("allgather", "all-gather"),
    ("all_gather", "all-gather"), ("alltoall", "all-to-all"),
    ("all_to_all", "all-to-all"), ("send", "collective-permute"),
    ("recv", "collective-permute"), ("broadcast", "broadcast"),
)


def counted(family: str, work: Callable[..., Work]):
    """Mark a kernel family's entry point: under :func:`count`, a call
    reports ``work(*args, **kwargs)`` as ``family``'s and nothing it runs
    is counted apart.  Outside it the call costs one global check."""
    def deco(fn):
        @functools.wraps(fn)
        def entry(*args, **kwargs):
            if _ACTIVE is None:
                return fn(*args, **kwargs)
            return _ACTIVE.kernel(family, work, fn, args, kwargs)
        return entry
    return deco


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _aliases(func) -> bool:
    """The op returns views of, or writes into, its inputs (no new
    buffer)."""
    return any(r.alias_info is not None for r in func._schema.returns)


def _written(arg) -> bool:
    """A schema argument the op writes: marked ``Tensor(a!)`` where the
    schema says so, else named as c10d names its output buffers."""
    info = arg.alias_info
    return (info is not None and info.is_write) or arg.name.startswith(
        "output")


def _read_side(func, args, kwargs):
    """The tensors of a collective's arguments that it reads (every
    argument but those it writes)."""
    schema = func._schema.arguments
    read = [a for a, s in zip(args, schema) if not _written(s)]
    names = {s.name for s in schema if _written(s)}
    read += [v for k, v in kwargs.items() if k not in names]
    return _tensors(read)


def _collective_kind(func):
    if func.namespace not in ("c10d", "_c10d_functional"):
        return None
    name = func.overloadpacket.__name__
    for key, kind in _COLLECTIVE_KINDS:
        if key in name:
            return kind
    return ""  # a barrier or a wait: no traffic


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll_counts: Dict[str, int] = {}
        self.coll_bytes: Dict[str, int] = {}
        self.by_kernel: Dict[str, Dict[str, int]] = {}
        self.live = 0
        self.peak = 0
        self._quiet = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def _track(self, out) -> None:
        for t in _tensors(out):
            n = t.numel() * t.element_size()
            self.live += n
            weakref.finalize(t, self._free, n)
        self.peak = max(self.peak, self.live)

    def kernel(self, family: str, work, fn, args, kwargs):
        if self._quiet:
            return fn(*args, **kwargs)
        self._quiet += 1
        try:
            w = work(*args, **kwargs)
            out = fn(*args, **kwargs)
        finally:
            self._quiet -= 1
        k = self.by_kernel.setdefault(family, {"calls": 0, "flops": 0,
                                               "bytes": 0})
        k["calls"] += 1
        k["flops"] += w.flops
        k["bytes"] += w.bytes
        self.flops += w.flops
        self.bytes += w.bytes
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not _aliases(func):
            self._track(out)
        if self._quiet:
            return out
        kind = _collective_kind(func)
        if kind is not None:
            if kind:
                traffic = max(_nbytes(_read_side(func, args, kwargs)),
                              _nbytes(_tensors(out)))
                self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1
                self.coll_bytes[kind] = self.coll_bytes.get(kind, 0) + traffic
            return out
        packet = func.overloadpacket
        if packet in _ZERO_COST or (_aliases(func)
                                    and not func._schema.is_mutable):
            return out
        outs = _tensors(out)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        else:
            self.flops += sum(t.numel() for t in outs)
        self.bytes += _nbytes(_tensors((args, kwargs))) + _nbytes(outs)
        return out

    def totals(self) -> Dict:
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "collective_bytes": sum(self.coll_bytes.values()),
            "collective_by_kind": dict(self.coll_bytes),
            "collective_counts": dict(self.coll_counts),
            "by_kernel": {k: dict(v) for k, v in self.by_kernel.items()},
            "peak_bytes": self.peak,
        }


def count(fn, *args, **kwargs) -> Dict:
    """Run ``fn(*args, **kwargs)`` once and return what it did, the keys of
    JAX's ``analyze_hlo`` (``flops``, ``bytes``, ``collective_bytes``,
    ``collective_by_kind``, ``collective_counts``), ``by_kernel`` (per
    kernel family: ``calls``, ``flops``, ``bytes``) and ``peak_bytes``."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("count() is already running")
    counter = _Counter()
    _ACTIVE = counter
    try:
        with counter:
            fn(*args, **kwargs)
    finally:
        _ACTIVE = None
    return counter.totals()
