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


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, microbatches: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    Gradient accumulation over ``microbatches`` along the batch dim, in
    float32 (a loop where JAX scans): it cuts activation memory for the big
    train cells.  The step is functional: it returns new trees and leaves
    its inputs as they were.
    """
    lfn = reg.loss_fn(cfg)

    def step(params, opt_state, batch):
        tokens = torch.as_tensor(batch["tokens"])
        if microbatches == 1:
            (loss, metrics), grads = value_and_grad(
                lambda p: lfn(p, {"tokens": tokens}), params)
        else:
            b = tokens.shape[0]
            mb = tokens.reshape(microbatches, b // microbatches,
                                *tokens.shape[1:])
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device)
                             if p.is_floating_point() else None, params)
            loss = 0.0
            for chunk in mb:
                (l, _m), g = value_and_grad(
                    lambda p: lfn(p, {"tokens": chunk}), params)
                grads = tree_map(lambda a, g2: a + g2.to(a.dtype), grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
            metrics = {"nll": loss, "aux": torch.zeros((), device=loss.device)}
        new_params, new_opt, gnorm = adamw_update(params, grads, opt_state, opt_cfg)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return new_params, new_opt, metrics

    return step
