"""SparseTrainer: crash-safe driver of the paper's masked/compressed
finetune loop (twin of ``repro/train/sparse.py``).

The paper's accuracy story (dense 0.953 -> one-shot 0.750 -> finetuned
0.953) puts a finetune run between pruning and serving, and such runs die
to preemption.  So the loop is built around one contract:

    **Resume determinism.**  Kill the process at any step k, restart it with
    the same config, and the final params are *bitwise identical* to the
    uninterrupted run.

Everything the contract needs is checkpointed or derivable:

  * params AND momentum round-trip exactly through the integrity-verified
    :class:`~repro_torch.train.checkpoint.CheckpointManager` (int ``idx`` /
    ``conv_geom`` leaves and bool masks keep their dtypes, bf16 its bits);
  * data is a pure function of (seed, step), ``vision.batch_for_step``, so
    the pipeline "state" in the checkpoint metadata is the step counter
    plus the seed it must match;
  * the step, ``vision.train_step``, gives the same bits for the same
    inputs on the card (its backwards scatter in a fixed order, and cuDNN
    runs its deterministic algorithms), so replaying steps k..N from a
    restored state is the computation the uninterrupted run performed.
    On the CPU that holds with one intra-op thread
    (``torch.set_num_threads(1)``): PyTorch's threaded CPU kernels may
    split their sums differently from run to run on a loaded machine.

The JAX package's fault probes are planted at the same places: the
``train.step`` site at the top of each step, ``data.batch`` in
``vision.batch_for_step`` and ``ckpt.write``/``ckpt.rename`` in the
checkpoint writer.  A fault there propagates like a crash, without the
final save, and a fresh trainer on the same directory resumes from the last
checkpoint.  Each step is a ``train.step`` span, counted in ``train.steps``,
with the logged loss in the ``train.loss`` gauge.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

from repro_torch import fault as _fault
from repro_torch._compat import resolve_device
from repro_torch._tree import tree_leaves
from repro_torch.configs.base import VisionConfig
from repro_torch.obs import metrics as _om
from repro_torch.obs import trace as _ot
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault import PreemptionGuard, StepWatchdog, StragglerMonitor

_C_STEPS = _om.counter("train.steps")
_G_LOSS = _om.gauge("train.loss")


@dataclasses.dataclass
class SparseTrainConfig:
    steps: int = 8              # TOTAL budget, restored progress included
    batch: int = 4
    lr: float = 0.05
    momentum: float = 0.9
    data_seed: int = 0          # batch_for_step stream; pinned in metadata
    init_seed: int = 0
    arch: str = "resnet-tiny"
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0         # 0 = only the final checkpoint
    keep: int = 3
    log_every: int = 1
    watchdog_timeout_s: float = 3600.0


class SparseTrainer:
    """Drives ``vision.train_step`` (SGD/momentum + per-step mask
    projection) over any layer format ``vision_init`` produces, on
    ``device`` (``None``: the CUDA card; given ``params`` decide it)."""

    def __init__(self, train_cfg: SparseTrainConfig = SparseTrainConfig(), *,
                 cfg: Optional[VisionConfig] = None, params=None, device=None):
        from repro_torch.configs import get_vision_config
        from repro_torch.models import vision

        self.train_cfg = train_cfg
        self.cfg = cfg if cfg is not None else get_vision_config(train_cfg.arch)
        if params is None:
            params = vision.vision_init(self.cfg, train_cfg.init_seed,
                                        device=resolve_device(device))
        self.params = params
        self.device = tree_leaves(params)[0].device
        self.mom = vision.sgd_init(params)
        self.start_step = 0
        self.ckpt = (CheckpointManager(train_cfg.ckpt_dir, keep=train_cfg.keep)
                     if train_cfg.ckpt_dir else None)
        self.history: list = []
        self.straggler = StragglerMonitor()
        self.preempt = PreemptionGuard()
        self.watchdog: Optional[StepWatchdog] = None

    # ------------------------------------------------------------------
    def batch_at(self, step: int):
        from repro_torch.models import vision

        return vision.batch_for_step(self.cfg, self.train_cfg.data_seed, step,
                                     self.train_cfg.batch, device=self.device)

    def step_fn(self, params, mom, x, labels):
        from repro_torch.models import vision

        return vision.train_step(params, mom, self.cfg, x, labels,
                                 lr=self.train_cfg.lr,
                                 momentum=self.train_cfg.momentum)

    def maybe_restore(self) -> int:
        """Restore the newest *valid* checkpoint (torn/corrupt ones are
        skipped by the manager).  Raises if the checkpointed data seed does
        not match this trainer's: resuming onto a different batch stream
        would silently break the determinism contract."""
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return 0
        trees, meta = self.ckpt.restore(
            None, {"params": self.params, "mom": self.mom})
        data = meta.get("data", {})
        if "seed" in data and int(data["seed"]) != self.train_cfg.data_seed:
            raise ValueError(
                f"checkpoint was trained on data seed {data['seed']}, this "
                f"trainer is configured with {self.train_cfg.data_seed}")
        self.params = trees["params"]
        self.mom = trees["mom"]
        self.start_step = int(meta["step"])
        return self.start_step

    def save(self, step: int, blocking: bool = True):
        if self.ckpt is None:
            return
        self.ckpt.save(
            step,
            {"params": self.params, "mom": self.mom},
            metadata={"step": step,
                      "data": {"seed": self.train_cfg.data_seed, "step": step},
                      "arch": self.cfg.name},
            blocking=blocking,
        )

    # ------------------------------------------------------------------
    def run(self, steps: Optional[int] = None) -> Dict[str, Any]:
        """Train to a TOTAL budget of ``steps`` (default: config), restoring
        any checkpointed progress first: same budget semantics as
        :meth:`Trainer.run`."""
        tc = self.train_cfg
        end = steps or tc.steps
        self.preempt.install()
        self.watchdog = StepWatchdog(tc.watchdog_timeout_s).start()
        step = self.maybe_restore()
        preempted = False
        loss = float("nan")
        try:
            while step < end:
                t0 = time.perf_counter()
                _fault.maybe_fail("train.step", step=step)
                with _ot.span("train.step", step=step):
                    x, y = self.batch_at(step)
                    self.params, self.mom, loss = self.step_fn(
                        self.params, self.mom, x, y)
                _C_STEPS.inc()
                dur = time.perf_counter() - t0
                if (step % tc.log_every == 0) or step == end - 1:
                    loss = float(loss)
                    _G_LOSS.set(loss)
                    self.history.append(
                        {"step": step, "loss": loss, "sec_per_step": dur})
                self.watchdog.beat()
                self.straggler.record(step, dur)
                step += 1
                if self.ckpt and tc.ckpt_every and step % tc.ckpt_every == 0:
                    self.save(step, blocking=False)
                if self.preempt.requested:
                    preempted = True
                    break
            # final (preemption-safe) checkpoint; save() waits on any async
            # writer first, so a failed background save surfaces here.  A
            # crash mid-loop propagates WITHOUT this save: exactly a kill.
            if self.ckpt:
                self.save(step, blocking=True)
        finally:
            self.watchdog.stop()
            self.preempt.uninstall()
        return {
            "final_step": step,
            "start_step": self.start_step,
            "preempted": preempted,
            "watchdog_fired": self.watchdog.fired,
            "history": self.history,
            "loss": float(loss) if loss == loss else loss,
        }
