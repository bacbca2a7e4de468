from repro_torch.kernels.colwise_nm.kernel import (  # noqa: F401
    COLWISE_NM_STRIPS,
    colwise_nm_matmul_strips_cuda,
)
from repro_torch.kernels.colwise_nm.ops import colwise_nm_matmul_strips  # noqa: F401
from repro_torch.kernels.colwise_nm.ref import (  # noqa: F401
    colwise_nm_matmul_ref,
    colwise_nm_matmul_strips_ref,
)
