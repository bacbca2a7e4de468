"""Training tier (twin of ``repro/train``): checkpoints, fault machinery,
the sparse vision finetune and the LM trainer."""
from repro_torch.train.checkpoint import CheckpointError, CheckpointManager  # noqa: F401
from repro_torch.train.fault import PreemptionGuard, StepWatchdog, StragglerMonitor  # noqa: F401
from repro_torch.train.sparse import SparseTrainConfig, SparseTrainer  # noqa: F401
from repro_torch.train.trainer import TrainConfig, Trainer  # noqa: F401
