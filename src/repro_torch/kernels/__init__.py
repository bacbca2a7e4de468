"""The port's hand-written Hopper kernels, each beside its plain version.

``KERNELS`` lists every kernel of the library with its launch count.
"""
from repro_torch.kernels.colwise_nm.kernel import (
    COLWISE_NM_LINEAR,
    COLWISE_NM_STRIPS,
    COLWISE_NM_STRIPS_PIPELINED,
)
from repro_torch.kernels.conv_gemm.kernel import CONV2D_FUSED, CONV2D_FUSED_BANDED
from repro_torch.kernels.im2col_pack.kernel import IM2COL_PACK

KERNELS = (CONV2D_FUSED, IM2COL_PACK, COLWISE_NM_STRIPS, COLWISE_NM_LINEAR,
           COLWISE_NM_STRIPS_PIPELINED, CONV2D_FUSED_BANDED)


def reset_launch_counts() -> None:
    for kernel in KERNELS:
        kernel.launches = 0
