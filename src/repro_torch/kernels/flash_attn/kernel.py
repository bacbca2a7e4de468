"""Flash attention on Hopper, the twin of
``repro/kernels/flash_attn/kernel.py::flash_attention_pallas``, in two
kernels with the same bits: ``csrc/flash_attention_tiled.cu`` (register-tiled,
cp.async double-buffered) for the heads :func:`flash_tiled_takes` accepts,
``csrc/flash_attention.cu`` for every other head up to ``FLASH_MAX_D``.
:func:`flash_attention_cuda` routes between them by that rule of the shape.

``flash_smem_bytes`` and ``flash_tiled_smem_bytes`` are the shared memory
each kernel's launch requests: the wrapper sizes the launch with it and the
C side refuses any other size.  The kernels are forward only, as the Pallas
kernel is (it has no VJP).
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

FLASH_ATTENTION_TILED = CudaKernel(
    "flash_attention_tiled", "repro_flash_attention_tiled",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10,
    source="src/repro_torch/csrc/flash_attention_tiled.cu",
    replaces="src/repro/kernels/flash_attn/kernel.py:69 flash_attention_pallas",
    sized_smem=True,
)

FLASH_BLOCK_Q = 64  # query rows of a block (csrc/flash_attention.cu kBq)
FLASH_BLOCK_K = 64  # keys of a staged K/V tile (kBk)
FLASH_MAX_D = 128  # widest head the kernel's register accumulators take (kMaxD)
MAX_GRID_YZ = 65535  # flash_attention.cu: heads and batch are the grid's y and z;
# flash_attention_tiled.cu: batch and query blocks
# csrc/flash_attention_tiled.cu's instances: (query rows of a block, rows a
# thread); 8 rows a thread only for heads up to FLASH_TILED_RPT8_MAX_D
FLASH_TILED_SHAPES = ((64, 4), (64, 8), (128, 4), (128, 8))
FLASH_TILED_RPT8_MAX_D = 64


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


def flash_tiled_smem_bytes(head_dim: int, dtype: torch.dtype,
                           rows: int) -> Optional[int]:
    """Shared memory of one tiled flash launch with ``rows`` query rows a
    block: the Q tile and two stages of the K and V tiles in ``dtype``, rows
    padded by 16 bytes, and the f32 probabilities ``[64][rows + 4]``.
    ``None`` where the kernel takes no such head: ``head_dim`` outside
    1..``FLASH_MAX_D`` or not a whole number of 16-byte copies, or a dtype
    or block it has no instance for."""
    if dtype not in FLOAT_DTYPES or rows not in {r for r, _ in FLASH_TILED_SHAPES}:
        return None
    itemsize = torch.empty((), dtype=dtype).element_size()
    vec = 16 // itemsize
    if not 0 < head_dim <= FLASH_MAX_D or head_dim % vec:
        return None
    ld = head_dim + vec
    return ((rows + 4 * FLASH_BLOCK_K) * ld * itemsize
            + FLASH_BLOCK_K * (rows + 4) * 4)


def flash_tiled_config(head_dim: int, dtype: torch.dtype) -> tuple:
    """(query rows of a block, rows a thread) of the tiled kernel for a head
    of ``head_dim`` in ``dtype``: a rule of the shape, fitted to
    ``repro_torch.kernels.flash_attn.tune``'s sweep on the H100 (PERF.md):
    at smollm-360m's scoring shape, with D 16, 32, 64 and 128, its pick was
    within 2% of the best instance in each of the eight cases.  Narrow heads
    take 128 rows a block and 8 a thread (their accumulators are few); D 64
    takes 64 x 4 in f32 and 128 x 8 in bf16 (whose staged tiles are half the
    size); wider heads 64 x 4, the only instance whose registers and f32
    shared memory fit at D 128."""
    if head_dim <= 32:
        return (128, 8)
    if head_dim <= FLASH_TILED_RPT8_MAX_D and dtype == torch.bfloat16:
        return (128, 8)
    return (64, 4)


def flash_tiled_takes(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> bool:
    """Whether the tiled kernel takes this call: q's dtype f32 with
    ``D % 4 == 0`` or bf16 with ``D % 8 == 0`` (whole 16-byte rows),
    ``D <= FLASH_MAX_D``, the launch's shared memory within a block's, and
    every base pointer 16-byte aligned.  A rule of the shape and the
    pointers alone: the wrapper never reacts to a failed build or launch."""
    d = q.shape[-1]
    rows, _ = flash_tiled_config(d, q.dtype)
    smem = flash_tiled_smem_bytes(d, q.dtype, rows)
    return (smem is not None and smem <= SMEM_BYTES
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))


def check_no_grad(*tensors: torch.Tensor) -> None:
    """Raise where autograd would record the call: the kernel has no
    backward, as the Pallas kernel has no VJP (``jax.grad`` through it
    fails).  Callers score under ``torch.no_grad()``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "flash attention is forward only (the reference kernel has no "
            "gradient); call it under torch.no_grad() or on tensors that do "
            "not require grad")


def _check_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple:
    """The checks both kernels' wrappers make; returns (B, Sq, Sk, H, KV, D)."""
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
    return b, sq, sk, h, kv, d


def _per_head(launcher, q, k, v, **kw) -> torch.Tensor:
    """The Pallas kernel's layout q [BH, Sq, D], k/v [BH, Sk, D] as one head
    of [B, S, 1, D] (the same memory, read in place)."""
    return launcher(q[:, :, None], k[:, :, None], v[:, :, None], **kw)[:, :, 0]


def flash_attention_scalar_cuda(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *,
                                causal: bool = True) -> torch.Tensor:
    """Launch ``csrc/flash_attention.cu`` (any head of 1..``FLASH_MAX_D``,
    any alignment), in :func:`flash_attention_cuda`'s layouts and
    semantics.  The wrapper routes to it only the heads
    :func:`flash_tiled_takes` refuses; called directly, it is the bitwise
    yardstick of the tiled kernel."""
    if q.dim() == 3:
        return _per_head(flash_attention_scalar_cuda, q, k, v, causal=causal)
    b, sq, sk, h, kv, d = _check_flash(q, k, v)
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


def flash_attention_tiled_cuda(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool = True,
                               shape: Optional[tuple] = None) -> torch.Tensor:
    """Launch ``csrc/flash_attention_tiled.cu``: the same function and bits
    as :func:`flash_attention_scalar_cuda`, for the calls
    :func:`flash_tiled_takes` accepts (raises on any other).  ``shape`` is
    the instance, (query rows of a block, rows a thread), one of
    ``FLASH_TILED_SHAPES`` (every choice gives the same bits); by default
    :func:`flash_tiled_config`'s."""
    if q.dim() == 3:
        return _per_head(flash_attention_tiled_cuda, q, k, v, causal=causal,
                         shape=shape)
    b, sq, sk, h, kv, d = _check_flash(q, k, v)
    if not flash_tiled_takes(q, k, v):
        raise ValueError(f"head_dim {d} in {q.dtype} with these pointers: "
                         "the tiled flash kernel takes whole 16-byte rows "
                         f"up to D {FLASH_MAX_D}, 16-byte aligned")
    rows, rpt = flash_tiled_config(d, q.dtype) if shape is None else shape
    if ((rows, rpt) not in FLASH_TILED_SHAPES
            or (rpt == 8 and d > FLASH_TILED_RPT8_MAX_D)):
        raise ValueError(f"shape {(rows, rpt)} is not an instance of the "
                         f"tiled kernel for head_dim {d}: one of "
                         f"{FLASH_TILED_SHAPES}, 8 rows a thread up to D "
                         f"{FLASH_TILED_RPT8_MAX_D}")
    if -(-sq // rows) > MAX_GRID_YZ:
        raise ValueError(f"{sq} queries in blocks of {rows}: at most "
                         f"{MAX_GRID_YZ} blocks (the grid's z)")
    smem = flash_tiled_smem_bytes(d, q.dtype, rows)
    if smem > SMEM_BYTES:
        raise ValueError(f"shape {(rows, rpt)} at head_dim {d} needs {smem} "
                         f"bytes of shared memory; at most {SMEM_BYTES}")
    out = torch.empty_like(q)
    FLASH_ATTENTION_TILED.launch(
        q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        DTYPE_CODE[q.dtype], b, sq, sk, h, kv, d, int(bool(causal)), rows,
        rpt, smem_bytes=smem)
    return out


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True) -> torch.Tensor:
    """Launch a flash kernel; semantics == ``flash_attention_ref`` with
    ``ops.flash_attention``'s GQA map.

    Either q [BH, Sq, D] with k/v [BH, Sk, D] (the Pallas kernel's layout),
    or q [B, Sq, H, D] with k/v [B, Sk, KV, D], read in place: q head h
    reads KV head (h * KV) // H, with no expanded copy.  Contiguous CUDA
    tensors of one dtype (f32 or bf16); ``causal`` is the top-left mask
    ``kpos <= qpos``.  Returns the output in q's layout and dtype.  Takes
    the tiled kernel where :func:`flash_tiled_takes` says so and the other
    kernel elsewhere; both give the same bits, and a failed launch raises.
    The Pallas kernel's ``block_q``/``block_k`` have no counterpart: the
    kernels tile by their own blocks and 64-key K/V tiles.
    """
    if q.dim() == 3:
        return _per_head(flash_attention_cuda, q, k, v, causal=causal)
    if flash_tiled_takes(q, k, v):
        return flash_attention_tiled_cuda(q, k, v, causal=causal)
    return flash_attention_scalar_cuda(q, k, v, causal=causal)
