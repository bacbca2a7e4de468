from repro_torch.kernels.im2col_pack.kernel import (  # noqa: F401
    IM2COL_PACK,
    IM2COL_PACK_TILED,
    IM2COL_TILED_BLOCKS,
    IM2COL_TILED_CBS,
    IM2COL_TILED_ROWS,
    IM2COL_TILED_TGS,
    IM2COL_TILED_THREADS,
    IM2COL_TILED_UNROLLS,
    im2col_pack_cuda,
    im2col_pack_scalar_cuda,
    im2col_pack_tiled_cuda,
    im2col_tiled_config,
    im2col_tiled_geometry,
    im2col_tiled_takes,
    strip_tap_coords,
    tap_coords,
)
from repro_torch.kernels.im2col_pack.ops import im2col_pack  # noqa: F401
from repro_torch.kernels.im2col_pack.ref import (  # noqa: F401
    im2col_cnhw,
    im2col_pack_ref,
    im2col_pack_tiled_ref,
    out_size,
    pack_strips,
)
