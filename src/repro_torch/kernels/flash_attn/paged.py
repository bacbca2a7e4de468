"""Ragged paged decode attention on Hopper (``csrc/paged_attention.cu``), the
twin of ``repro/kernels/flash_attn/paged.py``.

``paged_smem_bytes`` is the shared memory the kernel's launch requests: the
wrapper sizes the launch with it, the C side refuses any other size, and the
dispatch registry's feasibility predicates call the same function.
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
from repro_torch.kernels.flash_attn.ref import paged_attention_ref

PAGED_ATTENTION = CudaKernel(
    "paged_attention", "repro_paged_attention",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10,
    source="src/repro_torch/csrc/paged_attention.cu",
    replaces="src/repro/kernels/flash_attn/paged.py:141 paged_attention_pallas",
    sized_smem=True,
)


def paged_smem_bytes(page_size: int, head_dim: int, rows: int) -> int:
    """Shared memory of one paged-attention launch for ``rows`` = g * block_q
    query rows a block: the f32 q rows, one staged page of K (rows padded by
    one float) and V, the scores, the accumulator and m, l, alpha."""
    floats = (rows * head_dim + page_size * (head_dim + 1)
              + page_size * head_dim + rows * page_size + rows * head_dim
              + 3 * rows)
    return 4 * floats


def paged_attention_cuda(q: torch.Tensor, k_new: torch.Tensor,
                         v_new: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, tables: torch.Tensor,
                         lengths: torch.Tensor, *, page_size: int,
                         block_q: int = 8) -> torch.Tensor:
    """Launch the paged kernel; semantics == :func:`paged_attention_ref`.

    q [B, Sq, H, D]; k_new/v_new [B, Sq, KV, D] (this step's keys, not yet
    written); k_pages/v_pages [P, page_size, KV, D]; tables [B, n_max] int32
    (entries past a sequence's length may name any page, the trash page
    included: they are never read); lengths [B] int32.  Requires
    H % KV == 0.  ``block_q`` query rows share a block.
    """
    check_cuda_tensor("q", q, FLOAT_DTYPES, 4)
    for name, t in (("k_new", k_new), ("v_new", v_new), ("k_pages", k_pages),
                    ("v_pages", v_pages)):
        check_cuda_tensor(name, t, (q.dtype,), 4)
    check_cuda_tensor("tables", tables, (torch.int32,), 2)
    check_cuda_tensor("lengths", lengths, (torch.int32,), 1)
    check_same_device(q, k_new, v_new, k_pages, v_pages, tables, lengths)
    b, sq, h, d = q.shape
    n_phys, ps, kv, dk = k_pages.shape
    if h % kv != 0:
        raise ValueError(f"paged kernel needs H % KV == 0, got {h} % {kv}")
    if ps != page_size:
        raise ValueError(f"page_size {page_size} != physical page rows {ps}")
    if (tuple(k_new.shape) != (b, sq, kv, d) or v_new.shape != k_new.shape
            or v_pages.shape != k_pages.shape or dk != d):
        raise ValueError(
            f"shapes do not match: q {tuple(q.shape)}, k_new "
            f"{tuple(k_new.shape)}, v_new {tuple(v_new.shape)}, pages "
            f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    if tables.shape[0] != b or tuple(lengths.shape) != (b,):
        raise ValueError(f"tables {tuple(tables.shape)} and lengths "
                         f"{tuple(lengths.shape)} must have {b} rows")
    if block_q <= 0:
        raise ValueError(f"block_q={block_q} must be positive")
    block_q = min(block_q, sq)
    smem = paged_smem_bytes(page_size, d, (h // kv) * block_q)
    if smem > SMEM_BYTES:
        raise ValueError(f"block_q={block_q} needs {smem} bytes of shared "
                         f"memory; at most {SMEM_BYTES}")
    if b == 0 or tables.shape[1] == 0:
        raise ValueError("paged attention needs at least one sequence and "
                         "one table column")
    out = torch.empty_like(q)
    PAGED_ATTENTION.launch(
        q.device, q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(), tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), DTYPE_CODE[q.dtype], b, sq, h, kv,
        d, n_phys, page_size, tables.shape[1], block_q, smem_bytes=smem)
    return out


def paged_attention(q, k_new, v_new, k_pages, v_pages, tables, lengths, *,
                    page_size: int, impl: Optional[str] = None) -> torch.Tensor:
    """Dispatch-resolved paged attention (the serving decode entry point).

    Forms the execution :func:`~repro_torch.dispatch.paged_attn_key` (page
    size pinned, so only the kernel geometries of that page size are
    feasible) and runs the candidate dispatch resolves for it: on a CUDA
    device the kernel, or a ``TuningError`` when no geometry fits.  A CPU
    tensor runs the plain version, whichever candidate names it, as the
    other kernels' wrappers do.  ``impl`` forces a candidate, the plain
    ``paged_attn_ref`` included.
    """
    from repro_torch import dispatch

    b, sq, h, d = q.shape
    kv = k_pages.shape[2]
    phase = dispatch.current_phase()

    def make_key():
        return dispatch.paged_attn_key(
            q_rows=b * sq, n_heads=h, kv_heads=kv, head_dim=d,
            kv_capacity=tables.shape[1] * page_size, page_size=page_size,
            dtype=q.dtype, phase=phase)

    site = ("paged_attn", q.shape, k_pages.shape, tables.shape, q.dtype,
            q.device, page_size, phase)
    spec = dispatch.site_impl(site, make_key, param_keys=(),
                              force=dispatch.forced_impl("paged_attn", impl),
                              device=q.device)
    if spec.backend == "cuda" and q.device.type != "cpu":
        return paged_attention_cuda(q, k_new, v_new, k_pages, v_pages, tables,
                                    lengths, page_size=page_size,
                                    block_q=spec.geom("bq", 8))
    return paged_attention_ref(q, k_new, v_new, k_pages, v_pages, tables,
                               lengths)
