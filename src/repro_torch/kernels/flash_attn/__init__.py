from repro_torch.kernels.flash_attn.kernel import (  # noqa: F401
    FLASH_ATTENTION,
    FLASH_ATTENTION_TILED,
    FLASH_TILED_SHAPES,
    flash_attention_cuda,
    flash_attention_scalar_cuda,
    flash_attention_tiled_cuda,
    flash_smem_bytes,
    flash_tiled_config,
    flash_tiled_smem_bytes,
    flash_tiled_takes,
)
from repro_torch.kernels.flash_attn.ops import flash_attention  # noqa: F401
from repro_torch.kernels.flash_attn.paged import (  # noqa: F401
    PAGED_ATTENTION,
    PAGED_ATTENTION_SPLIT,
    PAGED_SPLIT_ROWS,
    PAGED_SPLIT_WARPS,
    paged_attention,
    paged_attention_cuda,
    paged_attention_scalar_cuda,
    paged_attention_split_cuda,
    paged_launch_smem_bytes,
    paged_smem_bytes,
    paged_split_config,
    paged_split_smem_bytes,
    paged_split_takes,
    paged_split_tile_bound,
)
from repro_torch.kernels.flash_attn.ref import (  # noqa: F401
    flash_attention_gqa_ref,
    flash_attention_ref,
    paged_attention_ref,
    paged_attention_split_ref,
    paged_split_tiles,
)
