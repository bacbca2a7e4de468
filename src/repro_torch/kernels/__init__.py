"""The port's hand-written Hopper kernels, each beside its plain version.

``KERNELS`` lists every kernel of the library with its launch count.
"""
from repro_torch.kernels.colwise_nm.kernel import (
    COLWISE_NM_LINEAR,
    COLWISE_NM_LINEAR_TILED,
    COLWISE_NM_STRIPS,
    COLWISE_NM_STRIPS_PIPELINED,
    COLWISE_NM_STRIPS_PIPELINED_TILED,
    COLWISE_NM_STRIPS_TILED,
)
from repro_torch.kernels.conv_gemm.kernel import (
    CONV2D_FUSED,
    CONV2D_FUSED_BANDED,
    CONV2D_FUSED_BANDED_TILED,
    CONV2D_FUSED_TILED,
)
from repro_torch.kernels.flash_attn.kernel import FLASH_ATTENTION, FLASH_ATTENTION_TILED
from repro_torch.kernels.flash_attn.paged import PAGED_ATTENTION, PAGED_ATTENTION_SPLIT
from repro_torch.kernels.im2col_pack.kernel import IM2COL_PACK, IM2COL_PACK_TILED

KERNELS = (CONV2D_FUSED, IM2COL_PACK, COLWISE_NM_STRIPS, COLWISE_NM_LINEAR,
           COLWISE_NM_STRIPS_PIPELINED, CONV2D_FUSED_BANDED, FLASH_ATTENTION,
           PAGED_ATTENTION, COLWISE_NM_LINEAR_TILED, FLASH_ATTENTION_TILED,
           CONV2D_FUSED_BANDED_TILED, PAGED_ATTENTION_SPLIT,
           COLWISE_NM_STRIPS_TILED, COLWISE_NM_STRIPS_PIPELINED_TILED,
           CONV2D_FUSED_TILED, IM2COL_PACK_TILED)


def reset_launch_counts() -> None:
    for kernel in KERNELS:
        kernel.launches = 0
