from repro_torch.kernels.colwise_nm.kernel import (  # noqa: F401
    COLWISE_NM_LINEAR,
    COLWISE_NM_LINEAR_TILED,
    COLWISE_NM_STRIPS,
    COLWISE_NM_STRIPS_PIPELINED,
    TILED_BN,
    colwise_nm_matmul_cuda,
    colwise_nm_matmul_strips_cuda,
    colwise_nm_matmul_strips_pipelined_cuda,
    colwise_nm_matmul_tiled_cuda,
    linear_smem_bytes,
    linear_tiled_smem_bytes,
    pipelined_smem_bytes,
    strips_smem_bytes,
    tiled_block_rows,
)
from repro_torch.kernels.colwise_nm.ops import (  # noqa: F401
    colwise_nm_matmul,
    colwise_nm_matmul_strips,
    colwise_nm_matmul_strips_pipelined,
    colwise_nm_matmul_tiled,
)
from repro_torch.kernels.colwise_nm.ref import (  # noqa: F401
    colwise_nm_matmul_ref,
    colwise_nm_matmul_strips_pipelined_ref,
    colwise_nm_matmul_strips_ref,
)
