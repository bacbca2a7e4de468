"""ResNet-style vision model on ``conv_init``/``conv_apply``, and its sparse
finetune (twin of ``repro/models/vision.py``).

CNHW layout throughout; norm layers are omitted, as in the JAX package.
Params are a plain dict tree ``{"stem", "blocks": [...], "head"}``.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch._compat import resolve_device
from repro_torch._tree import tree_map, value_and_grad
from repro_torch.configs.base import VisionConfig
from repro_torch.core.pruning import mask_project_tree
from repro_torch.core.sparse_conv import conv_apply, conv_init
from repro_torch.core.sparse_linear import linear_apply, linear_init
from repro_torch.kernels.im2col_pack.ref import out_size


def _block_strides(cfg: VisionConfig):
    """(stage, index-in-stage, stride, c_in, c_out) per block, in order."""
    out = []
    c_prev = cfg.stem_channels
    for si, (ch, n, st) in enumerate(zip(cfg.stage_channels, cfg.stage_blocks,
                                         cfg.stage_strides)):
        for bi in range(n):
            out.append((si, bi, st if bi == 0 else 1, c_prev, ch))
            c_prev = ch
    return out


def resnet_block_init(generator, c_in: int, c_out: int, cfg: VisionConfig, *,
                      stride: int = 1, dtype=torch.float32,
                      device=None) -> Dict[str, Any]:
    """One basic block: 3x3 conv -> 3x3 conv + residual, with a 1x1 strided
    projection when the shortcut changes shape."""
    opts = dict(dtype=dtype, device=device)
    params = {
        "conv1": conv_init(generator, c_in, c_out, 3, 3, cfg.sparsity, **opts),
        "conv2": conv_init(generator, c_out, c_out, 3, 3, cfg.sparsity, **opts),
    }
    if stride != 1 or c_in != c_out:
        params["proj"] = conv_init(generator, c_in, c_out, 1, 1, cfg.sparsity,
                                   **opts)
    return params


def resnet_block_apply(params, x_cnhw: torch.Tensor, *, stride: int = 1,
                       v: int = 128, impl: Optional[str] = None) -> torch.Tensor:
    """Apply one basic block to a CNHW map."""
    y = conv_apply(params["conv1"], x_cnhw, kh=3, kw=3, stride=stride, pad=1,
                   v=v, impl=impl)
    y = torch.relu(y)
    y = conv_apply(params["conv2"], y, kh=3, kw=3, stride=1, pad=1, v=v,
                   impl=impl)
    if "proj" in params:
        short = conv_apply(params["proj"], x_cnhw, kh=1, kw=1, stride=stride,
                           pad=0, v=v, impl=impl)
    else:
        short = x_cnhw
    return torch.relu(y + short)


def vision_init(cfg: VisionConfig, seed: int = 0,
                device=None) -> Dict[str, Any]:
    """Random params from ``seed`` on ``device`` (``None``: the CUDA card).
    The draw is made on the CPU, so it does not depend on the device."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator().manual_seed(seed)
    params: Dict[str, Any] = {
        "stem": conv_init(gen, cfg.c_in, cfg.stem_channels, 3, 3,
                          cfg.sparsity, dtype=dtype, device=dev),
        "blocks": [
            resnet_block_init(gen, c_in, c_out, cfg, stride=stride,
                              dtype=dtype, device=dev)
            for _si, _bi, stride, c_in, c_out in _block_strides(cfg)
        ],
    }
    params["head"] = linear_init(gen, cfg.stage_channels[-1], cfg.num_classes,
                                 cfg.sparsity, dtype=dtype, device=dev)
    return params


def vision_apply(params, cfg: VisionConfig, x_cnhw: torch.Tensor, *,
                 impl: Optional[str] = None) -> torch.Tensor:
    """Forward pass: CNHW images [C, B, H, W] -> logits [B, num_classes]."""
    y = conv_apply(params["stem"], x_cnhw, kh=3, kw=3, stride=1, pad=1,
                   v=cfg.strip_v, impl=impl)
    y = torch.relu(y)
    for block, (_si, _bi, stride, _ci, _co) in zip(params["blocks"],
                                                   _block_strides(cfg)):
        y = resnet_block_apply(block, y, stride=stride, v=cfg.strip_v,
                               impl=impl)
    feats = y.mean(dim=(2, 3)).T  # global average pool -> [B, C]
    return linear_apply(params["head"], feats)


def synth_batch(cfg: VisionConfig, seed, batch: int, device=None):
    """Synthetic classification batch drawn with numpy from ``seed`` (an int
    or a sequence of ints, as ``np.random.default_rng`` takes): per-class
    Gaussian mean images (fixed by seed 0) plus noise.  Returns (CNHW images
    [C, B, H, W] in ``cfg.dtype``, int64 labels [B])."""
    dev = resolve_device(device)
    h, w = cfg.image_hw
    means = np.random.default_rng(0).standard_normal(
        (cfg.num_classes, cfg.c_in, h, w)) * 0.5
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.num_classes, size=batch)
    x = means[labels] + 0.3 * rng.standard_normal((batch, cfg.c_in, h, w))
    x = torch.from_numpy(np.ascontiguousarray(x.transpose(1, 0, 2, 3),
                                              dtype=np.float32))
    return (x.to(device=dev, dtype=getattr(torch, cfg.dtype)),
            torch.from_numpy(labels).to(dev))


def batch_for_step(cfg: VisionConfig, seed: int, step: int, batch: int,
                   device=None):
    """The finetune batch of global step ``step``, a pure function of
    ``(seed, step)``: :func:`synth_batch` from a numpy generator seeded by
    both, so a resumed run replays the same batches.  (The JAX package folds
    the step into a ``jax.random`` key, which numpy cannot reproduce: the
    batches are the same function of the step, not the same images.)  The
    ``data.batch`` fault site probes first."""
    from repro_torch import fault as _fault

    _fault.maybe_fail("data.batch", step=step)
    return synth_batch(cfg, (seed, step), batch, device=device)


# ---------------------------------------------------------------------------
# Sparse finetuning: cross-entropy loss and an SGD/momentum train step.
# ``conv_apply`` differentiates for compressed layers (``conv2d_sparse``'s
# backward, whichever plan ran the forward) and masked ones (the library
# conv on w * mask); ``mask_project_tree`` re-projects after each update.
# ---------------------------------------------------------------------------


def vision_loss(params, cfg: VisionConfig, x_cnhw: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of ``vision_apply``'s logits against int labels,
    the log-softmax taken in float32."""
    logits = vision_apply(params, cfg, x_cnhw)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def sgd_init(params):
    """Zero momentum, one buffer per leaf.  The integer and bool leaves
    (``idx``, ``conv_geom``, ``mask``) get one too, so the momentum tree has
    the params' structure; they are never updated."""
    return tree_map(torch.zeros_like, params)


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN's deterministic algorithms in this scope, the setting as it was
    after it.  Without them the dense convs' backward (the stem and the
    unpruned projection) may add in an order that changes from run to run
    on the card; the sparse layers' backward is repeatable by itself."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def train_step(params, mom, cfg: VisionConfig, x_cnhw: torch.Tensor,
               labels: torch.Tensor, *, lr: float = 0.05,
               momentum: float = 0.9):
    """One SGD/momentum step of sparse vision finetuning; returns
    ``(params, mom, loss)`` and leaves the input trees as they were.

    The gradients of ``vision_loss`` are taken over the floating-point
    leaves only (compressed convs into their packed ``values``, masked
    layers into ``w``); ``idx``, ``conv_geom`` and ``mask`` pass through.
    Then ``m = momentum * m + g``, ``p = p - lr * m`` and the mask
    projection, as in the JAX package.  The same step on the same inputs
    gives the same bits: both sparse backwards scatter in a fixed order,
    and the loss and its gradients are taken with cuDNN's deterministic
    algorithms."""
    with _deterministic_cudnn():
        loss, grads = value_and_grad(
            lambda p: vision_loss(p, cfg, x_cnhw, labels), params)
    with torch.no_grad():
        mom = tree_map(lambda m, g: m if g is None
                       else momentum * m + g.to(m.dtype), mom, grads)
        params = tree_map(lambda p, m: p - lr * m.to(p.dtype)
                          if p.is_floating_point() else p, params, mom)
    return mask_project_tree(params), mom, loss


def train_smoke(steps: int = 2, batch: int = 4, lr: float = 0.05,
                arch: str = "resnet-tiny", verbose: bool = True, device=None):
    """An N-step sparse finetune of resnet-tiny (compressed convs) on one
    fixed batch, on ``device`` (``None``: the CUDA card): the check that
    the conv backward stays alive end to end.  Raises unless the loss falls
    over the run; returns the losses."""
    from repro_torch.configs import get_vision_config

    cfg = get_vision_config(arch)
    params = vision_init(cfg, 0, device=device)
    x, labels = synth_batch(cfg, 1, batch, device=device)
    mom = sgd_init(params)
    losses = []
    for _ in range(max(steps, 2)):
        params, mom, loss = train_step(params, mom, cfg, x, labels, lr=lr)
        losses.append(float(loss))
        if verbose:
            print(f"train_smoke step {len(losses)}: loss={losses[-1]:.4f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(
            f"sparse finetune smoke did not reduce the loss: {losses}")
    return losses


def vision_accuracy(params, cfg: VisionConfig, x_cnhw: torch.Tensor,
                    labels: torch.Tensor, *, impl: Optional[str] = None) -> float:
    logits = vision_apply(params, cfg, x_cnhw, impl=impl)
    return float((logits.argmax(dim=-1) == labels).float().mean())


def conv_hints(cfg: VisionConfig, batch: int = 1) -> Dict[str, Dict[str, int]]:
    """Per-layer map-shape hints for ``dispatch.plan_params(conv_hints=...)``.

    Walks the blocks with ``vision_apply``'s stride arithmetic, so every
    planned conv token is the one ``conv_apply`` resolves at the call site.
    Keys are layer-path substrings (``blocks[i]/conv1`` ...) as
    ``dispatch.iter_op_layers`` names them.
    """
    h, w = cfg.image_hw
    hints: Dict[str, Dict[str, int]] = {
        "stem": {"h": h, "w": w, "batch": batch, "stride": 1, "pad": 1,
                 "v": cfg.strip_v},
    }
    for i, (_si, _bi, stride, _ci, _co) in enumerate(_block_strides(cfg)):
        hints[f"blocks[{i}]/conv1"] = {
            "h": h, "w": w, "batch": batch, "stride": stride, "pad": 1,
            "v": cfg.strip_v}
        hints[f"blocks[{i}]/proj"] = {
            "h": h, "w": w, "batch": batch, "stride": stride, "pad": 0,
            "v": cfg.strip_v}
        h = out_size(h, 3, stride, 1)
        w = out_size(w, 3, stride, 1)
        hints[f"blocks[{i}]/conv2"] = {
            "h": h, "w": w, "batch": batch, "stride": 1, "pad": 1,
            "v": cfg.strip_v}
    return hints
