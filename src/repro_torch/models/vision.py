"""ResNet-style vision model on ``conv_init``/``conv_apply`` (twin of
``repro/models/vision.py``'s inference half).

CNHW layout throughout; norm layers are omitted, as in the JAX package.
Params are a plain dict tree ``{"stem", "blocks": [...], "head"}``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch._compat import resolve_device
from repro_torch.configs.base import VisionConfig
from repro_torch.core.sparse_conv import conv_apply, conv_init
from repro_torch.core.sparse_linear import linear_apply, linear_init


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


def synth_batch(cfg: VisionConfig, seed: int, batch: int, device=None):
    """Synthetic classification batch drawn with numpy from ``seed``:
    per-class Gaussian mean images (fixed by seed 0) plus noise.  Returns
    (CNHW images [C, B, H, W] in ``cfg.dtype``, int64 labels [B])."""
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


def vision_accuracy(params, cfg: VisionConfig, x_cnhw: torch.Tensor,
                    labels: torch.Tensor, *, impl: Optional[str] = None) -> float:
    logits = vision_apply(params, cfg, x_cnhw, impl=impl)
    return float((logits.argmax(dim=-1) == labels).float().mean())
