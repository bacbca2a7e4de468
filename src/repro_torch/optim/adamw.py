"""AdamW from scratch (twin of ``repro/optim/adamw.py``).

- skips integer and bool leaves (the compressed format's ``idx`` arrays
  ride along in the param tree but are not trained);
- keeps a float32 master copy when params are stored in a lower precision
  (mixed-precision training).

Every function is functional: it returns new tensors and leaves its
inputs as they were.  The sharding specs of the optimizer state
(``opt_state_specs``) come with the port's sharding.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch._tree import tree_leaves, tree_map


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params, keep_master: Optional[bool] = None) -> Dict[str, Any]:
    """``{"m", "v", "step"[, "master"]}``: float32 zeros for the float
    leaves and int8 zeros for the others (so the state has the params'
    structure), a 0-d int32 step, and a float32 copy of the params when any
    float leaf is not float32 (or ``keep_master`` asks for one).  Every
    tensor is freshly allocated, on its leaf's device."""
    if keep_master is None:
        keep_master = any(_is_float(p) and p.dtype != torch.float32
                          for p in tree_leaves(params))

    def zeros_for(p):
        return torch.zeros(p.shape, device=p.device, dtype=(
            torch.float32 if _is_float(p) else torch.int8))

    state = {
        "m": tree_map(zeros_for, params),
        "v": tree_map(zeros_for, params),
        "step": torch.zeros((), dtype=torch.int32,
                            device=tree_leaves(params)[0].device),
    }
    if keep_master:
        state["master"] = tree_map(
            lambda p: p.to(torch.float32 if _is_float(p) else p.dtype,
                           copy=True), params)
    return state


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of the float leaves, in float32, the
    leaves added in JAX's flatten order."""
    total = 0.0
    for leaf in tree_leaves(tree):
        if _is_float(leaf):
            total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / norm), the norm before the clip)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype) if _is_float(g) else g,
                    grads), norm


def adamw_update(params, grads, state, cfg: AdamWConfig, lr_scale=1.0):
    """Returns (new_params, new_state, grad_norm).  ``grads`` has the
    params' structure; its non-float leaves (``None`` or anything) are
    ignored, as are the params' integer and bool leaves."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state["step"] + 1
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)
    lr = cfg.lr * lr_scale
    has_master = "master" in state
    ref = state["master"] if has_master else params

    def upd(p, g, m, v, mp):
        if not _is_float(p):
            return p, m, v, mp
        gf = g.to(torch.float32)
        m2 = cfg.b1 * m + (1 - cfg.b1) * gf
        v2 = cfg.b2 * v + (1 - cfg.b2) * gf * gf
        mhat = m2 / b1c
        vhat = v2 / b2c
        base = mp if has_master else p.to(torch.float32)
        new = base - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                           + cfg.weight_decay * base)
        return new.to(p.dtype), m2, v2, (new if has_master else mp)

    with torch.no_grad():
        out = tree_map(upd, params, grads, state["m"], state["v"], ref)

    def part(i):
        return tree_map(lambda _p, t: t[i], params, out)

    new_state = {"m": part(1), "v": part(2), "step": step}
    if has_master:
        new_state["master"] = part(3)
    return part(0), new_state, gnorm


def opt_state_specs(param_specs):
    """Logical specs of the optimizer state: ``m``, ``v`` and ``master``
    shard as the params do, ``step`` is a scalar."""
    return {"m": param_specs, "v": param_specs, "step": (),
            "master": param_specs}
