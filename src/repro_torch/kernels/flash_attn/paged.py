"""Ragged paged decode attention on Hopper, the twin of
``repro/kernels/flash_attn/paged.py``, in two kernels:
``csrc/paged_attention_split.cu`` (a sequence's pages split over the warps
of one block, one combine at the end) for the calls :func:`paged_split_takes`
accepts, ``csrc/paged_attention.cu`` (the pages walked one after another)
for the others.  :func:`paged_attention_cuda` routes between them by that
rule of the shape and the pointers.  The two sum in another order, so they
agree to rounding, not bit for bit.

``paged_smem_bytes`` and ``paged_split_smem_bytes`` are the shared memory
each kernel's launch requests: the wrapper sizes the launch with it and the
C side refuses any other size; ``paged_launch_smem_bytes`` is that of the
kernel the rule picks, which the dispatch registry's feasibility predicates
call.  The kernels are forward only, as the Pallas kernel is: each wrapper
raises where autograd would record the call.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels._build import (
    DTYPE_CODE,
    FLOAT_DTYPES,
    NO_VJP,
    SMEM_BYTES,
    CudaKernel,
    check_cuda_tensor,
    check_no_grad,
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

PAGED_ATTENTION_SPLIT = CudaKernel(
    "paged_attention_split", "repro_paged_attention_split",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11,
    source="src/repro_torch/csrc/paged_attention_split.cu",
    replaces="src/repro/kernels/flash_attn/paged.py:141 paged_attention_pallas",
    sized_smem=True,
)

# csrc/paged_attention_split.cu's instances: warps a block, and query rows a
# lane holds (a block holds its sequence's g * Sq rows, at most the largest)
PAGED_SPLIT_WARPS = (4, 8, 16)
PAGED_SPLIT_ROWS = (4, 8, 16)
PAGED_SPLIT_MAX_D = 128  # a lane owns at most 4 columns of the PV product
PAGED_SPLIT_MAX_PAGE = 32  # lane j scores a page's key j


def paged_smem_bytes(page_size: int, head_dim: int, rows: int) -> int:
    """Shared memory of one ``paged_attention.cu`` launch for ``rows`` =
    g * block_q query rows a block: the f32 q rows, one staged page of K
    (rows padded by one float) and V, the scores, the accumulator and m, l,
    alpha."""
    floats = (rows * head_dim + page_size * (head_dim + 1)
              + page_size * head_dim + rows * page_size + rows * head_dim
              + 3 * rows)
    return 4 * floats


def _split_rows(rows: int) -> Optional[int]:
    """The split kernel's rows instance (query rows a lane holds) for
    ``rows`` = g * Sq query rows a block: the smallest of
    ``PAGED_SPLIT_ROWS`` that holds them, ``None`` past the largest."""
    for inst in PAGED_SPLIT_ROWS:
        if 0 < rows <= inst:
            return inst
    return None


def paged_split_tile_bound(page_size: int, n_max: int, sq: int) -> int:
    """The most tiles one sequence can give the split kernel: the ``n_max``
    pages of its table row, then its ``sq`` new keys in chunks of
    ``page_size`` rows."""
    return n_max + -(-sq // page_size)


def paged_split_smem_bytes(page_size: int, head_dim: int, rows: int,
                           itemsize: int, warps: int, tiles: int) -> int:
    """Shared memory of one ``paged_attention_split.cu`` launch with
    ``rows`` = g * Sq query rows, ``warps`` warps and at most ``tiles``
    tiles a sequence (:func:`paged_split_tile_bound`): the f32 q rows of
    the rows instance, then for each warp the larger of its slots (a page
    of K rows padded by 16 bytes, then its V rows, in the operands' dtype;
    two slots, or one where ``warps >= tiles`` and no warp gets a second
    tile) and its f32 partial m, l, acc for the combine, each rounded up to
    16 bytes."""
    def up16(x):
        return -(-x // 16) * 16

    slots = (1 if warps >= tiles else 2) * page_size * (
        2 * head_dim + 16 // itemsize) * itemsize
    partial = 4 * rows * (head_dim + 2)
    return (up16(4 * _split_rows(rows) * head_dim)
            + warps * up16(max(slots, partial)))


@functools.lru_cache(maxsize=None)
def paged_split_config(page_size: int, head_dim: int, rows: int, tiles: int,
                       dtype: torch.dtype) -> Optional[tuple]:
    """(warps, rows instance) of the split kernel for ``rows`` = g * Sq
    query rows a block and at most ``tiles`` tiles a sequence, or ``None``
    where it takes no such shape: ``dtype`` f32 or bf16 with whole 16-byte
    rows, ``head_dim`` up to ``PAGED_SPLIT_MAX_D``, ``page_size`` up to
    ``PAGED_SPLIT_MAX_PAGE``, ``rows`` up to the largest rows instance, the
    launch within a block's shared memory.  The warps are the most of
    ``PAGED_SPLIT_WARPS`` that fit."""
    if dtype not in FLOAT_DTYPES:
        return None
    itemsize = dtype.itemsize
    inst = _split_rows(rows)
    if (inst is None or not 0 < head_dim <= PAGED_SPLIT_MAX_D
            or (head_dim * itemsize) % 16
            or not 0 < page_size <= PAGED_SPLIT_MAX_PAGE):
        return None
    for warps in sorted(PAGED_SPLIT_WARPS, reverse=True):
        if paged_split_smem_bytes(page_size, head_dim, rows, itemsize, warps,
                                  tiles) <= SMEM_BYTES:
            return warps, inst
    return None


def _split_plan(q: torch.Tensor, k_pages: torch.Tensor,
                tables: torch.Tensor) -> Optional[tuple]:
    """(rows, tiles, warps, rows instance) of the split kernel for this
    call's shapes, or ``None`` where its rule refuses them: g * Sq query
    rows a block, the most tiles a sequence can give, and
    :func:`paged_split_config`'s instance."""
    sq, h, d = q.shape[1:]
    ps, kv = k_pages.shape[1], k_pages.shape[2]
    if h % kv:
        return None
    rows = (h // kv) * sq
    tiles = paged_split_tile_bound(ps, tables.shape[-1], sq)
    cfg = paged_split_config(ps, d, rows, tiles, q.dtype)
    return None if cfg is None else (rows, tiles, *cfg)


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def paged_split_takes(q: torch.Tensor, k_new: torch.Tensor,
                      v_new: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, tables: torch.Tensor) -> bool:
    """Whether the split kernel takes this call: H % KV == 0, a shape
    :func:`paged_split_config` has an instance for (whole 16-byte rows, D
    <= 128, page size <= 32, g * Sq <= 16 query rows a block, the shared
    memory within a block's), and q and the K/V tensors 16-byte aligned.  A
    rule of the shapes and the pointers alone: the wrapper never reacts to a
    failed build or launch."""
    return (_split_plan(q, k_pages, tables) is not None
            and _aligned(q, k_new, v_new, k_pages, v_pages))


def paged_launch_smem_bytes(page_size: int, head_dim: int, n_heads: int,
                            kv_heads: int, q_len: int, n_max: int,
                            dtype: torch.dtype, block_q: int) -> int:
    """Shared memory of the launch :func:`paged_attention_cuda` makes for
    16-byte aligned operands with ``q_len`` query rows a sequence and a
    table of ``n_max`` pages: the split kernel's where its shape rule holds,
    else ``paged_attention.cu``'s for ``min(block_q, q_len)`` query rows a
    block."""
    g = n_heads // kv_heads
    tiles = paged_split_tile_bound(page_size, n_max, q_len)
    cfg = paged_split_config(page_size, head_dim, g * q_len, tiles, dtype)
    if n_heads % kv_heads == 0 and cfg is not None:
        return paged_split_smem_bytes(page_size, head_dim, g * q_len,
                                      dtype.itemsize, cfg[0], tiles)
    return paged_smem_bytes(page_size, head_dim, g * min(block_q, q_len))


def _check_paged(q, k_new, v_new, k_pages, v_pages, tables, lengths,
                 page_size) -> tuple:
    """The checks both kernels' wrappers make after ``check_no_grad``;
    returns (B, Sq, H, KV, D, P)."""
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
    if b == 0 or tables.shape[1] == 0:
        raise ValueError("paged attention needs at least one sequence and "
                         "one table column")
    return b, sq, h, kv, d, n_phys


def paged_attention_scalar_cuda(q: torch.Tensor, k_new: torch.Tensor,
                                v_new: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor, tables: torch.Tensor,
                                lengths: torch.Tensor, *, page_size: int,
                                block_q: int = 8) -> torch.Tensor:
    """Launch ``csrc/paged_attention.cu`` (any head, page size and
    alignment), in :func:`paged_attention_cuda`'s layouts and semantics.
    ``block_q`` query rows share a block.  The wrapper routes to it only
    the calls :func:`paged_split_takes` refuses; called directly, it is the
    split kernel's yardstick."""
    check_no_grad("paged_attention", q, k_new, v_new, k_pages, v_pages,
                  why=NO_VJP)
    b, sq, h, kv, d, n_phys = _check_paged(q, k_new, v_new, k_pages, v_pages,
                                           tables, lengths, page_size)
    if block_q <= 0:
        raise ValueError(f"block_q={block_q} must be positive")
    block_q = min(block_q, sq)
    smem = paged_smem_bytes(page_size, d, (h // kv) * block_q)
    if smem > SMEM_BYTES:
        raise ValueError(f"block_q={block_q} needs {smem} bytes of shared "
                         f"memory; at most {SMEM_BYTES}")
    out = torch.empty_like(q)
    PAGED_ATTENTION.launch(
        q.device, q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(), tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), DTYPE_CODE[q.dtype], b, sq, h, kv,
        d, n_phys, page_size, tables.shape[1], block_q, smem_bytes=smem)
    return out


def paged_attention_split_cuda(q: torch.Tensor, k_new: torch.Tensor,
                               v_new: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, tables: torch.Tensor,
                               lengths: torch.Tensor, *, page_size: int,
                               warps: Optional[int] = None) -> torch.Tensor:
    """Launch ``csrc/paged_attention_split.cu`` for the calls
    :func:`paged_split_takes` accepts (raises on any other), in
    :func:`paged_attention_cuda`'s layouts and semantics.  ``warps`` a
    block is the instance, one of ``PAGED_SPLIT_WARPS`` (each gives the
    same function, summed in another order); by default
    :func:`paged_split_config`'s."""
    check_no_grad("paged_attention_split", q, k_new, v_new, k_pages, v_pages,
                  why=NO_VJP)
    dims = _check_paged(q, k_new, v_new, k_pages, v_pages, tables, lengths,
                        page_size)
    plan = _split_plan(q, k_pages, tables)
    if plan is None or not _aligned(q, k_new, v_new, k_pages, v_pages):
        raise ValueError(
            f"q {tuple(q.shape)} {q.dtype}, page size {page_size}: the split "
            "paged kernel takes whole 16-byte rows up to D "
            f"{PAGED_SPLIT_MAX_D}, pages of up to {PAGED_SPLIT_MAX_PAGE} "
            f"rows, up to {PAGED_SPLIT_ROWS[-1]} query rows a KV head "
            "(g * Sq), 16-byte aligned q and K/V")
    return _launch_split(q, k_new, v_new, k_pages, v_pages, tables, lengths,
                         page_size, dims, plan, warps)


def _launch_split(q, k_new, v_new, k_pages, v_pages, tables, lengths,
                  page_size, dims, plan, warps=None) -> torch.Tensor:
    """The split launch for checked operands (``dims`` from
    ``_check_paged``) and the ``plan`` :func:`_split_plan` gave."""
    b, sq, h, kv, d, n_phys = dims
    rows, tiles, auto_warps, inst = plan
    warps = auto_warps if warps is None else warps
    if warps not in PAGED_SPLIT_WARPS:
        raise ValueError(f"{warps} warps is not an instance of the split "
                         f"paged kernel: one of {PAGED_SPLIT_WARPS}")
    smem = paged_split_smem_bytes(page_size, d, rows, q.element_size(), warps,
                                  tiles)
    if smem > SMEM_BYTES:
        raise ValueError(f"{warps} warps need {smem} bytes of shared memory; "
                         f"at most {SMEM_BYTES}")
    out = torch.empty_like(q)
    PAGED_ATTENTION_SPLIT.launch(
        q.device, q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(), tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), DTYPE_CODE[q.dtype], b, sq, h, kv,
        d, n_phys, page_size, tables.shape[1], warps, inst, smem_bytes=smem)
    return out


def paged_attention_cuda(q: torch.Tensor, k_new: torch.Tensor,
                         v_new: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, tables: torch.Tensor,
                         lengths: torch.Tensor, *, page_size: int,
                         block_q: int = 8) -> torch.Tensor:
    """Launch a paged kernel; semantics == :func:`paged_attention_ref`.

    q [B, Sq, H, D]; k_new/v_new [B, Sq, KV, D] (this step's keys, not yet
    written); k_pages/v_pages [P, page_size, KV, D]; tables [B, n_max] int32
    (entries past a sequence's length may name any page, the trash page
    included: they are never read); lengths [B] int32.  Requires
    H % KV == 0.  Takes the split kernel where :func:`paged_split_takes`
    says so and ``paged_attention.cu`` elsewhere, with ``block_q`` query
    rows a block; a failed launch raises.
    """
    check_no_grad("paged attention", q, k_new, v_new, k_pages, v_pages,
                  why=NO_VJP)
    plan = (_split_plan(q, k_pages, tables)
            if q.dim() == 4 and k_pages.dim() == 4 and tables.dim() == 2
            else None)
    if plan is not None and _aligned(q, k_new, v_new, k_pages, v_pages):
        dims = _check_paged(q, k_new, v_new, k_pages, v_pages, tables,
                            lengths, page_size)
        return _launch_split(q, k_new, v_new, k_pages, v_pages, tables,
                             lengths, page_size, dims, plan)
    return paged_attention_scalar_cuda(q, k_new, v_new, k_pages, v_pages,
                                       tables, lengths, page_size=page_size,
                                       block_q=block_q)


def paged_attention(q, k_new, v_new, k_pages, v_pages, tables, lengths, *,
                    page_size: int, impl: Optional[str] = None) -> torch.Tensor:
    """Dispatch-resolved paged attention (the serving decode entry point).

    Forms the execution :func:`~repro_torch.dispatch.paged_attn_key` (page
    size pinned, so only the kernel geometries of that page size are
    feasible) and runs the candidate dispatch resolves for it: on a CUDA
    device the kernel, or a ``TuningError`` when no geometry fits.  A CPU
    tensor runs the plain version, whichever candidate names it, as the
    other kernels' wrappers do.  ``impl`` forces a candidate, the plain
    ``paged_attn_ref`` included.  The call goes through
    ``dispatch.run_guarded``, with the ``kernel.paged_attn`` fault site
    inside it.
    """
    from repro_torch import dispatch
    from repro_torch import fault as _fault

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

    def call(s):
        # the kernel's own fault site: a hit quarantines the current rung
        # and run_guarded re-resolves
        _fault.maybe_fail("kernel.paged_attn", impl=s.name, phase=phase)
        if s.backend == "cuda" and q.device.type != "cpu":
            return paged_attention_cuda(q, k_new, v_new, k_pages, v_pages,
                                        tables, lengths, page_size=page_size,
                                        block_q=s.geom("bq", 8))
        return paged_attention_ref(q, k_new, v_new, k_pages, v_pages, tables,
                                   lengths)

    return dispatch.run_guarded(make_key, spec, call, param_keys=(),
                                device=q.device)
