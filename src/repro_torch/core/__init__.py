"""Pruning, compressed formats and the sparse linear and conv layers.

The masked-finetune hooks are exported here.  ``sparse_conv`` imports the
kernels, whose plain versions import ``core.formats``, so its two hooks are
looked up when first asked for rather than when this package is imported.
"""
from repro_torch.core.pruning import mask_project_tree  # noqa: F401

_FROM_SPARSE_CONV = ("apply_conv_mask", "refresh_conv_mask")


def __getattr__(name):
    if name in _FROM_SPARSE_CONV:
        from repro_torch.core import sparse_conv

        return getattr(sparse_conv, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
