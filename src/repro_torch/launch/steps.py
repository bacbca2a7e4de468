"""The train step builder (twin of the train half of
``repro/launch/steps.py``).

``make_train_step`` is the step the LM ``Trainer`` runs.  The JAX package
jits it with sharding specs (``train_shardings``) and also builds the
serving steps here; those come with the port's sharding and serving
launchers.
"""
from __future__ import annotations

import torch

from repro_torch._tree import tree_map, value_and_grad
from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry as reg
from repro_torch.optim import AdamWConfig, adamw_update


def check_trainable(cfg: ModelConfig) -> None:
    """Refuse a mixture-of-experts config: its auxiliary loss's gradient
    through the LM ``Trainer`` waits for MoE training (ROADMAP queue 1 item
    10d)."""
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE training ({cfg.n_experts} experts) waits for "
            "ROADMAP queue 1 item 10d, MoE training; the port serves and "
            "scores MoE models")


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, microbatches: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    The loss sees the whole batch (``"tokens"`` and whatever else the
    family reads: ``"enc_embeds"``, ``"vision_embeds"``, ``"vision_pos"``,
    ``"mrope_positions"``).  Gradient accumulation over ``microbatches``
    splits every leaf along the batch dim and sums in float32 (a loop where
    JAX scans): it cuts activation memory for the big train cells.  The
    step is functional: it returns new trees and leaves its inputs as they
    were.
    """
    check_trainable(cfg)
    lfn = reg.loss_fn(cfg)

    def step(params, opt_state, batch):
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
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
        new_params, new_opt, gnorm = adamw_update(params, grads, opt_state, opt_cfg)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return new_params, new_opt, metrics

    return step
