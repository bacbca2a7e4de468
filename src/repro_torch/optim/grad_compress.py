"""Gradient compression for slow links: int8 quantization with error
feedback (twin of ``repro/optim/grad_compress.py``).

Quantize to int8 for the slow leg of a reduction and carry the
quantization error into the next step (error feedback keeps SGD unbiased
in the long run: Karimireddy et al., 2019).  The quantizer is pure; the
cross-pod reduction that uses it (``crosspod_psum_compressed``) comes with
the port's sharding.
"""
from __future__ import annotations

from typing import Tuple

import torch


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_with_feedback(grad: torch.Tensor, error: torch.Tensor):
    """(grad + carried error) -> (int8 payload, scale, new error)."""
    g = grad.to(torch.float32) + error
    q, scale = quantize_int8(g)
    return q, scale, g - dequantize_int8(q, scale)


def wire_bytes_saved(shape, dtype=torch.float32) -> Tuple[int, int]:
    """(bytes_uncompressed, bytes_compressed) per hop for reporting."""
    n = 1
    for d in shape:
        n *= d
    return n * torch.empty((), dtype=dtype).element_size(), n * 1 + 4
