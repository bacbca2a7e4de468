"""Gradient compression for slow links: int8 quantization with error
feedback (twin of ``repro/optim/grad_compress.py``).

Quantize to int8 for the slow leg of a reduction and carry the
quantization error into the next step (error feedback keeps SGD unbiased
in the long run: Karimireddy et al., 2019).  The quantizer is pure;
:func:`crosspod_psum_compressed` runs it around the all-reduce over the
installed mesh's ``"pod"`` axis.
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


def crosspod_psum_compressed(grad: torch.Tensor, error: torch.Tensor,
                             axis: str = "pod"):
    """Error-feedback int8 reduction over mesh axis ``axis`` (the twin of
    the JAX package's ``shard_map`` body): each rank passes its own shard.

    Returns ``(reduced, new_error)``: ``reduced`` is the ``all_reduce`` sum
    over the group of ``axis`` in the installed ``ShardingCtx`` of each
    rank's ``dequantize_int8(q, scale)``, in float32.  With no context, or
    where the axis has one rank, it is this rank's own dequantized part.
    As in the JAX package, the values reduced are those float32 dequantized
    parts, not the int8 payload: the JAX code psums f32 although its
    docstring says the int8 payload crosses the link, so no int8 wire
    format is added here.  The sum runs on the tensors' own device.
    """
    from repro_torch.sharding.api import axis_sizes, get_ctx

    q, scale, new_error = compress_with_feedback(grad, error)
    reduced = dequantize_int8(q, scale)
    ctx = get_ctx()
    if ctx is not None and axis_sizes(ctx.mesh).get(axis, 1) > 1:
        import torch.distributed as dist

        dist.all_reduce(reduced, group=ctx.mesh.get_group(axis))
    return reduced, new_error


def wire_bytes_saved(shape, dtype=torch.float32) -> Tuple[int, int]:
    """(bytes_uncompressed, bytes_compressed) per hop for reporting."""
    n = 1
    for d in shape:
        n *= d
    return n * torch.empty((), dtype=dtype).element_size(), n * 1 + 4
