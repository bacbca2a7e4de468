"""Convert a JAX-side params tree into the port's tree.

The input is the JAX package's *unboxed* params tree (``unbox_tree``'s value
half) with numpy leaves, so this module needs neither JAX nor ``repro``:
dicts, lists and tuples are walked, and every array becomes a tensor of the
same dtype and values on ``device``.  Integer leaves (``idx``,
``conv_geom``) stay int32; the plain code casts where indexing needs int64.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._compat import resolve_device


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, unknown to torch
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(tree, device=None):
    """Numpy-leaf JAX params tree -> the port's tree of tensors on
    ``device`` (``None``: the CUDA card)."""
    dev = resolve_device(device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return _to_tensor(t, dev)

    return walk(tree)
