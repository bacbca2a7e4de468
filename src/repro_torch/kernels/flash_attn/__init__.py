from repro_torch.kernels.flash_attn.kernel import (  # noqa: F401
    FLASH_ATTENTION,
    flash_attention_cuda,
    flash_smem_bytes,
)
from repro_torch.kernels.flash_attn.ops import flash_attention  # noqa: F401
from repro_torch.kernels.flash_attn.paged import (  # noqa: F401
    PAGED_ATTENTION,
    paged_attention,
    paged_attention_cuda,
    paged_smem_bytes,
)
from repro_torch.kernels.flash_attn.ref import (  # noqa: F401
    flash_attention_gqa_ref,
    flash_attention_ref,
    paged_attention_ref,
)
