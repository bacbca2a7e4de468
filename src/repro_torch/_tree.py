"""Trees of tensors: the port's stand-in for ``jax.tree_util``.

A tree is a dict, list or tuple of trees, or a leaf; ``None`` is an empty
subtree, as in JAX.  Leaves are visited as JAX flattens the same tree:
dict keys sorted, sequences in order.  That order decides the order in
which a sum over the leaves adds (``optim.global_norm``), and a leaf's key
(:func:`keystr`'s spelling, JAX's ``keystr``) names it in a checkpoint.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the leaves at the same places
    in ``rest``; keeps ``tree``'s dicts, lists and tuples.  A ``None`` in
    ``tree`` stays ``None``; one in ``rest`` reaches ``fn``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *leaves)
                          for leaves in zip(tree, *rest, strict=True))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree, prefix: Tuple = ()):
    """``fn(path, leaf)`` over the leaves of ``tree``, keeping its
    structure; a path is the tuple of dict keys and sequence indices from
    the root (JAX's key path, with plain keys)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, prefix + (i,))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def leaves_with_path(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """``(path, leaf)`` pairs in JAX's flatten order; a path is the tuple
    of dict keys and sequence indices from the root."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in leaves_with_path(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in leaves_with_path(v, prefix + (i,))]
    return [(prefix, tree)]


def keystr(path: Tuple) -> str:
    """A path as JAX's ``keystr`` spells it: ``['blocks'][0]['w']``."""
    return "".join(f"[{k!r}]" for k in path)


def tree_leaves(tree) -> List[Any]:
    return [leaf for _path, leaf in leaves_with_path(tree)]


def value_and_grad(fn: Callable, params):
    """``(fn(params), grads)``: ``fn`` returns a scalar tensor, or a tuple
    whose first item is one (the rest comes back detached).  ``grads`` has
    ``params``' structure: the gradient of every floating-point leaf (zeros
    where ``fn`` does not use it, as ``jax.grad`` gives) and ``None`` for
    the integer and bool leaves, which ``jax.grad(allow_int=True)`` gives
    ``float0``."""
    live = []

    def track(p):
        if not p.is_floating_point():
            return p
        p = p.detach().requires_grad_()
        live.append(p)
        return p

    out = fn(tree_map(track, params))
    loss = out[0] if isinstance(out, tuple) else out
    found = iter(torch.autograd.grad(loss, live, allow_unused=True))

    def grad_of(p):
        if not p.is_floating_point():
            return None
        g = next(found)
        return torch.zeros_like(p) if g is None else g

    grads = tree_map(grad_of, params)
    out = tree_map(torch.Tensor.detach, out)
    return out, grads
