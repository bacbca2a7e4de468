"""Vision config registry (twin of ``repro/configs/__init__.py``'s vision
half; the LM configs come with a later slice)."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import VisionConfig  # noqa: F401

_VISION_MODULES = {
    "resnet-tiny": "repro_torch.configs.resnet_tiny",
}


def list_vision_archs() -> List[str]:
    return list(_VISION_MODULES)


def get_vision_config(name: str) -> VisionConfig:
    if name not in _VISION_MODULES:
        raise KeyError(
            f"unknown vision arch {name!r}; known: {list(_VISION_MODULES)}")
    return importlib.import_module(_VISION_MODULES[name]).CONFIG
