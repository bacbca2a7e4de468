from repro_torch.kernels.conv_gemm.kernel import (  # noqa: F401
    CONV2D_FUSED,
    CONV2D_FUSED_BANDED,
    CONV2D_FUSED_BANDED_TILED,
    BANDED_TILED_POSITIONS,
    banded_smem_bytes,
    banded_tiled_config,
    banded_tiled_geometry,
    banded_tiled_smem_bytes,
    banded_tiled_takes,
    conv2d_fused_banded_cuda,
    conv2d_fused_banded_scalar_cuda,
    conv2d_fused_banded_tiled_cuda,
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
from repro_torch.kernels.conv_gemm.plan import (  # noqa: F401
    band_plan,
    tiled_band_origin,
    tiled_band_plan,
)
from repro_torch.kernels.conv_gemm.ref import (  # noqa: F401
    conv2d_cnhw_ref,
    conv2d_fused_banded_ref,
    conv2d_fused_banded_tiled_ref,
    conv2d_fused_ref,
)
