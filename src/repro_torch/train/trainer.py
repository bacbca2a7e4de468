"""Trainer: the LM training loop (twin of ``repro/train/trainer.py``):
AdamW steps on deterministic data, async checkpoints, preemption, watchdog
and straggler instrumentation, and restart from the newest valid
checkpoint.

On the card the compressed linears run the sparse linear kernel forward
and their autograd twin's backward.  The flash-attention kernel has no
gradient (nor has JAX's), so train under ``attn_impl="naive"`` or
``"chunked"``.

Under a ``ShardingCtx`` over more than one rank every rank runs the loop
on the same global batches (the step computes on its own rows), every rank
restores, only global rank 0 writes checkpoints, and ``run`` returns on
every rank after its final checkpoint is written.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

from repro_torch import fault as _fault
from repro_torch._compat import resolve_device
from repro_torch._tree import tree_leaves
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch.steps import make_train_step
from repro_torch.models import registry as reg
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.sharding import get_ctx
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault import PreemptionGuard, StepWatchdog, StragglerMonitor


def _ranks():
    """(this process's global rank, whether the installed ``ShardingCtx``
    spans more than one rank)."""
    ctx = get_ctx()
    if ctx is None or ctx.mesh is None or ctx.mesh.size() == 1:
        return 0, False
    import torch.distributed as dist

    return dist.get_rank(), True


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    microbatches: int = 1
    watchdog_timeout_s: float = 3600.0
    seed: int = 0


class Trainer:
    """The LM trainer on ``device`` (``None``: the CUDA card; given
    ``params`` decide it)."""

    def __init__(
        self,
        cfg: ModelConfig,
        data_cfg: DataConfig,
        opt_cfg: AdamWConfig = AdamWConfig(),
        train_cfg: TrainConfig = TrainConfig(),
        params=None,
        device=None,
    ):
        self.cfg = cfg
        self.train_cfg = train_cfg
        self.data = SyntheticLM(data_cfg)
        if params is None:
            params = reg.init_params(cfg, train_cfg.seed,
                                     device=resolve_device(device))
        self.params = params
        self.device = tree_leaves(params)[0].device
        self.opt_state = adamw_init(params)
        self.step_fn = make_train_step(cfg, opt_cfg,
                                       microbatches=train_cfg.microbatches)
        self.start_step = 0
        self.ckpt = CheckpointManager(train_cfg.ckpt_dir) if train_cfg.ckpt_dir else None
        self.history: list[Dict[str, float]] = []
        self.straggler = StragglerMonitor()
        self.preempt = PreemptionGuard()
        self.watchdog: Optional[StepWatchdog] = None

    # ------------------------------------------------------------------
    def maybe_restore(self) -> int:
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return 0
        trees, meta = self.ckpt.restore(
            None, {"params": self.params, "opt": self.opt_state}
        )
        self.params = trees["params"]
        self.opt_state = trees["opt"]
        self.start_step = int(meta["step"])
        return self.start_step

    def save(self, step: int, blocking: bool = True):
        if self.ckpt is None or _ranks()[0] != 0:
            return
        self.ckpt.save(
            step,
            {"params": self.params, "opt": self.opt_state},
            metadata={"step": step, "data": self.data.state_dict(step),
                      "arch": self.cfg.name},
            blocking=blocking,
        )

    # ------------------------------------------------------------------
    def run(self, steps: Optional[int] = None) -> Dict[str, Any]:
        """Train to a TOTAL budget of ``steps``.

        ``steps`` counts from step 0 including restored progress: a run
        killed at step k and restarted with the same budget completes the
        original schedule (trains ``steps - k`` more), it does not train
        ``steps`` *additional* steps.  A restore at or past the budget
        trains nothing and returns immediately after the final checkpoint.
        """
        steps = steps or self.train_cfg.steps
        self.preempt.install()
        self.watchdog = StepWatchdog(self.train_cfg.watchdog_timeout_s).start()
        step = self.maybe_restore()
        end = steps
        preempted = False
        try:
            while step < end:
                t0 = time.perf_counter()
                _fault.maybe_fail("train.step", step=step)
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, self.data.batch_at(step))
                if (step % self.train_cfg.log_every == 0) or step == end - 1:
                    m = {k: float(v) for k, v in metrics.items()}
                    dur = time.perf_counter() - t0
                    m.update(step=step, sec_per_step=dur)
                    self.history.append(m)
                self.watchdog.beat()
                self.straggler.record(step, time.perf_counter() - t0)
                step += 1
                if self.ckpt and step % self.train_cfg.ckpt_every == 0:
                    self.save(step, blocking=False)
                if self.preempt.requested:
                    preempted = True
                    break
            # final (preemption-safe) checkpoint; save() drains the async
            # writer first, so a failed background save surfaces here.  A
            # crash mid-loop propagates WITHOUT this save: exactly a kill.
            if self.ckpt:
                self.save(step, blocking=True)
            if _ranks()[1]:
                import torch.distributed as dist

                dist.barrier()
        finally:
            self.watchdog.stop()
            self.preempt.uninstall()
        return {
            "final_step": step,
            "start_step": self.start_step,
            "preempted": preempted,
            "watchdog_fired": self.watchdog.fired,
            "history": self.history,
            "stragglers": self.straggler.events,
        }
