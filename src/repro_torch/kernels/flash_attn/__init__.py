from repro_torch.kernels.flash_attn.paged import (  # noqa: F401
    PAGED_ATTENTION,
    paged_attention,
    paged_attention_cuda,
    paged_smem_bytes,
)
from repro_torch.kernels.flash_attn.ref import paged_attention_ref  # noqa: F401
