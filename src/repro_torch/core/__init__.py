"""Pruning, compressed formats and the sparse linear and conv layers (twin
of ``repro/core/__init__.py``'s exports).

``sparse_conv`` imports the kernels, whose plain versions import
``core.formats``, so its names are looked up when first asked for rather
than when this package is imported.
"""
from repro_torch.core.formats import (  # noqa: F401
    ColwiseMeta,
    init_compressed,
    meta_for,
    pack_colwise,
    unpack_colwise,
)
from repro_torch.core.pruning import (  # noqa: F401
    DENSE,
    SparsityConfig,
    colwise_importance,
    colwise_nm_mask,
    conv_colwise_nm_mask,
    mask_project_tree,
    prune_tree,
    resolve_dims,
    rowwise_nm_mask,
    unstructured_mask,
)
from repro_torch.core.sparse_linear import (  # noqa: F401
    compress_layer,
    forward_compressed_xla,
    forward_masked,
    linear_apply,
    linear_init,
)

_FROM_SPARSE_CONV = ("apply_conv_mask", "compress_conv_layer",
                     "compress_conv_tree", "conv_apply", "conv_init",
                     "prune_conv_tree", "refresh_conv_mask")


def __getattr__(name):
    if name in _FROM_SPARSE_CONV:
        from repro_torch.core import sparse_conv

        return getattr(sparse_conv, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
