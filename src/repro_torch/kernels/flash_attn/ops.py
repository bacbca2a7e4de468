"""Public flash-attention entry point (twin of
``repro/kernels/flash_attn/ops.py``): the GQA layout and the choice between
the kernel and its plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels._build import NO_VJP, check_no_grad
from repro_torch.kernels.flash_attn.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attn.ref import flash_attention_gqa_ref
from repro_torch.roofline.counter import counted
from repro_torch.roofline.kernels import flash_work


def _work(q, k, v, *, causal=True, **_):
    b, sq, h, d = q.shape
    return flash_work(b, sq, k.shape[1], h, k.shape[2], d, causal,
                      q.element_size())


@counted("flash", _work)
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """q [B, Sq, H, D]; k/v [B, Sk, KV, D] (GQA).  Returns [B, Sq, H, D].

    A CPU tensor runs the plain version (the JAX package runs its kernel in
    interpret mode there) after the head map ``(h * KV) // H`` and the
    transposes to [BH, S, D] (:func:`flash_attention_gqa_ref`); a tensor on
    any other device goes to a kernel (:func:`flash_attention_cuda` picks
    one of two by the shape; both give the same bits), which reads the
    layout and maps the heads in place, or raises: there is no fallback.  Forward only: raises when autograd would record
    the call, on either device.  ``block_q``/``block_k`` are the Pallas
    grid's tiles; they change no value (the kernel has its own tile, and
    only where bf16 rounds the probabilities may differ), so they are
    checked and not used.
    """
    if block_q <= 0 or block_k <= 0:
        raise ValueError(f"block_q={block_q} and block_k={block_k} must be "
                         "positive")
    if q.device.type != "cpu":
        return flash_attention_cuda(q, k, v, causal=causal)
    check_no_grad("flash attention", q, k, v, why=NO_VJP)
    return flash_attention_gqa_ref(q, k, v, causal=causal)
