from repro_torch.kernels.im2col_pack.kernel import (  # noqa: F401
    IM2COL_PACK,
    im2col_pack_cuda,
    strip_tap_coords,
    tap_coords,
)
from repro_torch.kernels.im2col_pack.ops import im2col_pack  # noqa: F401
from repro_torch.kernels.im2col_pack.ref import (  # noqa: F401
    im2col_cnhw,
    im2col_pack_ref,
    out_size,
    pack_strips,
)
