"""Flash attention on Hopper (``csrc/flash_attention.cu``), the twin of
``repro/kernels/flash_attn/kernel.py::flash_attention_pallas``.

``flash_smem_bytes`` is the shared memory the kernel's launch requests: the
wrapper sizes the launch with it and the C side refuses any other size.
The kernel is forward only, as the Pallas kernel is (it has no VJP).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import (
    DTYPE_CODE,
    FLOAT_DTYPES,
    SMEM_BYTES,
    CudaKernel,
    check_cuda_tensor,
    check_same_device,
)

FLASH_ATTENTION = CudaKernel(
    "flash_attention", "repro_flash_attention",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8,
    source="src/repro_torch/csrc/flash_attention.cu",
    replaces="src/repro/kernels/flash_attn/kernel.py:69 flash_attention_pallas",
    sized_smem=True,
)

FLASH_BLOCK_Q = 64  # query rows of a block (csrc/flash_attention.cu kBq)
FLASH_BLOCK_K = 64  # keys of a staged K/V tile (kBk)
FLASH_MAX_D = 128  # widest head the kernel's register accumulators take (kMaxD)
MAX_GRID_YZ = 65535  # heads and batch are the grid's y and z


def flash_smem_bytes(head_dim: int) -> Optional[int]:
    """Shared memory of one flash launch: the f32 Q and K tiles (rows padded
    by one float), the V tile and the probabilities (rows padded by two).
    ``None`` where the kernel takes no such head (``head_dim`` outside
    1..``FLASH_MAX_D``, where a thread's accumulators would not fit in its
    registers)."""
    if not 0 < head_dim <= FLASH_MAX_D:
        return None
    ld = head_dim + 1
    floats = (FLASH_BLOCK_Q * ld + FLASH_BLOCK_K * ld + FLASH_BLOCK_K * head_dim
              + FLASH_BLOCK_Q * (FLASH_BLOCK_K + 2))
    return 4 * floats


def check_no_grad(*tensors: torch.Tensor) -> None:
    """Raise where autograd would record the call: the kernel has no
    backward, as the Pallas kernel has no VJP (``jax.grad`` through it
    fails).  Callers score under ``torch.no_grad()``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "flash attention is forward only (the reference kernel has no "
            "gradient); call it under torch.no_grad() or on tensors that do "
            "not require grad")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True) -> torch.Tensor:
    """Launch the flash kernel; semantics == ``flash_attention_ref`` with
    ``ops.flash_attention``'s GQA map.

    Either q [BH, Sq, D] with k/v [BH, Sk, D] (the Pallas kernel's layout),
    or q [B, Sq, H, D] with k/v [B, Sk, KV, D], read in place: q head h
    reads KV head (h * KV) // H, with no expanded copy.  Contiguous CUDA
    tensors of one dtype (f32 or bf16); ``causal`` is the top-left mask
    ``kpos <= qpos``.  Returns the output in q's layout and dtype.  The
    Pallas kernel's ``block_q``/``block_k`` have no counterpart: the kernel
    tiles by ``FLASH_BLOCK_Q`` x ``FLASH_BLOCK_K``.
    """
    if q.dim() == 3:
        return flash_attention_cuda(q[:, :, None], k[:, :, None],
                                    v[:, :, None], causal=causal)[:, :, 0]
    check_cuda_tensor("q", q, FLOAT_DTYPES, 4)
    check_cuda_tensor("k", k, (q.dtype,), 4)
    check_cuda_tensor("v", v, (q.dtype,), 4)
    check_same_device(q, k, v)
    check_no_grad(q, k, v)
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, sk, kv, d) or v.shape != k.shape:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if b == 0 or sq == 0 or sk == 0 or h == 0 or kv == 0:
        raise ValueError("flash attention needs at least one query, key and "
                         f"head, got q {tuple(q.shape)}, k {tuple(k.shape)}")
    if b > MAX_GRID_YZ or h > MAX_GRID_YZ:
        raise ValueError(f"batch {b} and heads {h} must be <= {MAX_GRID_YZ}")
    smem = flash_smem_bytes(d)
    if smem is None or smem > SMEM_BYTES:
        raise ValueError(f"head_dim {d}: the flash kernel takes 1.."
                         f"{FLASH_MAX_D}")
    out = torch.empty_like(q)
    FLASH_ATTENTION.launch(
        q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        DTYPE_CODE[q.dtype], b, sq, sk, h, kv, d, int(bool(causal)),
        smem_bytes=smem)
    return out
