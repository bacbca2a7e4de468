"""Vision architecture config (twin of ``repro/configs/base.py::VisionConfig``)."""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core.pruning import DENSE, SparsityConfig


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """A small ResNet-style stack of basic blocks built on
    ``conv_init``/``conv_apply``, so a config drives the pruned-conv path end
    to end."""

    name: str = "vision"
    c_in: int = 3
    stem_channels: int = 16
    stage_channels: Tuple[int, ...] = (16, 32)
    stage_blocks: Tuple[int, ...] = (1, 1)
    stage_strides: Tuple[int, ...] = (1, 2)
    image_hw: Tuple[int, int] = (32, 32)
    num_classes: int = 10
    strip_v: int = 128                     # packed-strip width of the convs
    sparsity: SparsityConfig = DENSE
    dtype: str = "float32"
    source: str = ""

    def with_(self, **kw) -> "VisionConfig":
        return dataclasses.replace(self, **kw)
