from repro_torch.kernels.conv_gemm.kernel import (  # noqa: F401
    CONV2D_FUSED,
    conv2d_fused_cuda,
)
from repro_torch.kernels.conv_gemm.ops import (  # noqa: F401
    compress_conv_weights,
    conv2d_fused,
    conv2d_sparse,
    conv2d_two_kernel,
)
from repro_torch.kernels.conv_gemm.ref import (  # noqa: F401
    conv2d_cnhw_ref,
    conv2d_fused_ref,
)
