from repro_torch.kernels.conv_gemm.kernel import (  # noqa: F401
    CONV2D_FUSED,
    CONV2D_FUSED_BANDED,
    banded_smem_bytes,
    conv2d_fused_banded_cuda,
    conv2d_fused_cuda,
    fused_smem_bytes,
)
from repro_torch.kernels.conv_gemm.ops import (  # noqa: F401
    banded_bytes_moved,
    compress_conv_weights,
    conv2d_fused,
    conv2d_fused_banded,
    conv2d_sparse,
    conv2d_two_kernel,
    conv2d_two_kernel_pipelined,
    conv2d_xla_ref,
)
from repro_torch.kernels.conv_gemm.plan import band_plan  # noqa: F401
from repro_torch.kernels.conv_gemm.ref import (  # noqa: F401
    conv2d_cnhw_ref,
    conv2d_fused_banded_ref,
    conv2d_fused_ref,
)
