"""Dispatch-predicate consistency (DP3xx): the registry's shared-memory
counts against the launches its candidates' wrappers make.

The JAX package's bug class: a VMEM predicate that assumed bf16 operands
under-counted every f32 key, so the dispatcher admitted a kernel whose
scratch could not fit.  Here each ``backend == "cuda"`` candidate's count is
recomputed **independently**: for a call of the probe key's shapes, the
launch the candidate's wrapper would make (the kernel its shape rule picks,
at the geometry it picks, such as ``tiled_block_rows`` for the tiled
linear), sized by the kernel modules' ``*_smem_bytes`` functions with the
element size taken from the key's dtype.  DP301 fires where the registry's
``smem_bytes(key)`` is below the largest such launch, DP302 where
``feasible(key)`` admits a launch above ``SMEM_BYTES``.

A paged-attention key counts ``q_rows`` query rows without saying how many
a sequence holds, so its calls are every ``Sq`` from 1 to the most either
kernel takes a block (``bq`` for ``paged_attention.cu``, 16 rows for the
split kernel), the batch filling the rest.

These are project rules: they import torch and the port's registry (on the
CPU; nothing is built or launched), so they run only when the tree analyzed
holds the real ``src/repro_torch``.  :func:`probe_launches` is also what
``chip_smoke.py`` drives on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional

from repro_torch.analysis.engine import PORT, Context, Rule, register

_REGISTRY_PATH = f"{PORT}/dispatch/registry.py"


def _itemsize(key) -> int:
    # the checker's own statement of the dtype law: if the registry's
    # _itemsize ever became a constant, the two would disagree and fire
    return 4 if key.dtype == "f32" else 2


def probe_keys(R) -> List:
    """Representative keys of each op: small and large, in f32 and bf16,
    the JAX checker's keys with tile 64 twins (the widths the tiled linear
    and fused kernels take), then over-budget ones (:func:`over_budget`).
    The JAX checker's 2M-wide linear key is a large key here: the linear
    launches are bounded by their geometry (``colwise_nm_linear.cu``
    stages at most 32 columns of a tile), so no linear key is over
    budget."""
    keys = [R.linear_key(512, 1 << 21, 512, 128, 128, "float32")]
    for dt in ("float32", "bfloat16"):
        keys.append(R.linear_key(8, 512, 512, 128, 128, dt))
        keys.append(R.linear_key(8, 512, 512, 64, 64, dt))
        keys.append(R.linear_key(256, 2048, 1024, 256, 128, dt))
        keys.append(R.conv_key(16, 28, 28, 128, 3, 3, 1, 1, 72, 128,
                               v=128, dtype=dt, batch=1))
        keys.append(R.conv_key(16, 28, 28, 64, 3, 3, 1, 1, 72, 64,
                               v=128, dtype=dt, batch=1))
        keys.append(R.conv_key(32, 56, 56, 256, 3, 3, 1, 1, 144, 128,
                               v=128, dtype=dt, batch=4))
        keys.append(R.paged_attn_key(8, 8, 2, 64, 256, page_size=0, dtype=dt))
        keys.append(R.paged_attn_key(8, 8, 2, 64, 256, page_size=16,
                                     dtype=dt))
    return keys + over_budget(R)


def over_budget(R) -> List:
    """Keys some candidate cannot launch within a block's shared memory: a
    stem-scale conv (the banded kernels' map windows) and a paged head of
    D 256 with 64 query heads a KV head (``paged_attention.cu``'s rows)."""
    return [R.conv_key(64, 224, 224, 128, 7, 7, 2, 3, 288, 128, v=128,
                       dtype="float32", batch=8),
            R.paged_attn_key(8, 64, 1, 256, 4096, page_size=32,
                             dtype="float32")]


def small(key) -> bool:
    """A key the card runs in phase 19 (its calls take milliseconds)."""
    if key.op == "linear":
        return key.batch <= 8
    if key.op == "conv":
        return key.get("b") == 1 and key.get("h") <= 28
    return key.get("hd") <= 64


@dataclasses.dataclass(frozen=True)
class Launch:
    """One call of a key's shapes and the launch its wrapper makes there.

    ``call`` is the call's shapes (linear: ``rows, d_in``; conv: the map
    ``c, b, h, w``; paged: ``b, sq, n_max``), ``kernel`` the ``CudaKernel``
    name of the launch whose shared memory is counted, ``smem`` its bytes
    and ``sized`` whether that kernel takes the size from its wrapper (and
    so keeps it in ``last_smem_bytes``)."""

    call: tuple
    kernel: str
    smem: int
    sized: bool = True


def _conv_geom(key):
    from repro_torch.kernels.im2col_pack.ref import out_size

    c, h = key.get("c"), key.get("h")
    w = key.get("w", h)
    b = max(key.get("b", 1), 1)
    kh, kw, s, p = key.get("kh"), key.get("kw"), key.get("s", 1), key.get("p", 0)
    return c, b, h, w, kh, kw, s, p, out_size(h, kh, s, p), out_size(w, kw, s, p)


def _strips_launch(key, v: int, hb: int, bk: int, pipelined: bool,
                   n_strips: int) -> Optional[Launch]:
    from repro_torch.kernels.colwise_nm import kernel as ck

    ib, tile, k = _itemsize(key), key.tile, key.k_kept
    n_tiles = key.d_out // tile
    geo = ck.strips_tiled_geometry(n_strips, v, n_tiles, k, tile, ib, hb)
    call = _conv_geom(key)[:4]
    if geo is not None:
        name = ("colwise_nm_matmul_strips_pipelined_tiled" if pipelined
                else "colwise_nm_matmul_strips_tiled")
        return Launch(call, name, ck.strips_tiled_smem_bytes(
            k, tile, geo["rg"], v, ib, geo["lanes"]))
    if not pipelined:
        return Launch(call, "colwise_nm_matmul_strips",
                      ck.strips_smem_bytes(tile, min(bk, k)), sized=False)
    if v > ck.MAX_PIPELINED_V or (v * ib) % 16:
        return None  # the wrapper refuses the call
    return Launch(call, "colwise_nm_matmul_strips_pipelined",
                  ck.pipelined_smem_bytes(v, min(bk, k), ib))


def probe_launches(spec, key) -> List[Launch]:
    """The launches ``spec``'s wrapper makes for the calls of ``key``'s
    shapes (empty where it refuses every such call), recomputed from the
    kernel modules' functions, not from the registry's."""
    import torch

    from repro_torch.kernels.colwise_nm import kernel as ck
    from repro_torch.kernels.conv_gemm import kernel as gk
    from repro_torch.kernels.conv_gemm.plan import band_plan
    from repro_torch.kernels.flash_attn import paged as pk

    family = spec.name.split("@")[0]
    geom = dict(spec.geometry)
    ib, tile, k = _itemsize(key), key.tile, key.k_kept
    if key.op in ("linear", "conv") and (tile <= 0 or key.d_out % tile):
        return []
    n_tiles = key.d_out // max(tile, 1)
    if family == "compressed_pallas":
        return [Launch((key.batch, key.d_in), "colwise_nm_matmul",
                       ck.linear_smem_bytes(tile, geom["bb"],
                                            min(geom["bk"], k)))]
    if family == "compressed_tiled":
        if tile % ck.TILED_BN:
            return []
        bm = ck.tiled_block_rows(key.batch, key.d_out)
        return [Launch((key.batch, key.d_in), "colwise_nm_matmul_tiled",
                       ck.linear_tiled_smem_bytes(bm, ck.TILED_BK, ib))]
    if key.op == "conv":
        c, b, h, w, kh, kw, s, p, ho, wo = _conv_geom(key)
        if ho <= 0 or wo <= 0:
            return []
        call = (c, b, h, w)
        if family == "im2col_sparse_pallas":
            v = key.get("v", 128)
            got = _strips_launch(key, v, 1, 128, False, -(-b * ho * wo // v))
            return [got]
        v = geom["v"]
        n_strips = -(-b * ho * wo // v)
        if family == "fused_sparse_pallas":
            geo = gk.fused_tiled_geometry(c, b, h, w, kh, kw, s, p, v,
                                          n_tiles, k, tile, ib)
            if geo is not None:
                return [Launch(call, "conv2d_fused_tiled",
                               gk.fused_tiled_smem_bytes(
                                   kh * kw * c, geo["cpt"], geo["group"],
                                   tile, geo["bk"], ib))]
            return [Launch(call, "conv2d_fused",
                           gk.fused_smem_bytes(tile, min(geom["bk"], k)),
                           sized=False)]
        if family == "fused_banded_pallas":
            geo = gk.banded_tiled_geometry(c, b, h, w, kh, kw, s, p, v,
                                           geom["hb"], n_tiles, k, tile, ib)
            if geo is not None:
                return [Launch(call, "conv2d_fused_banded_tiled",
                               gk.banded_tiled_smem_bytes(
                                   c, geo["plane"], n_tiles, k, tile, ib,
                                   geo["group"]))]
            if (w * ib) % 4:
                return []
            hb = max(min(geom["hb"], n_strips), 1)
            _, rows = band_plan(b=b, h=h, kh=kh, stride=s, pad=p, ho=ho,
                                wo=wo, v=v, hb=hb)
            return [Launch(call, "conv2d_fused_banded", gk.banded_smem_bytes(
                c, w, rows, min(geom["bk"], k), ib))]
        if family == "two_kernel_pipelined":
            got = _strips_launch(key, v, geom["hb"], geom["bk"], True,
                                 n_strips)
            return [] if got is None else [got]
        return []
    if family == "paged_attn_pallas":
        ps, bq = geom["ps"], geom["bq"]
        hd, kv = key.get("hd", key.d_in), max(key.k_kept, 1)
        h = key.d_out // max(hd, 1)
        pinned = key.get("ps", 0)
        if (pinned and pinned != ps) or h % kv:
            return []
        g, n_max = h // kv, -(-key.get("kvcap", 128) // ps)
        dtype = torch.float32 if key.dtype == "f32" else torch.bfloat16
        out = []
        for sq in range(1, min(key.batch, max(bq, pk.PAGED_SPLIT_ROWS[-1])) + 1):
            call = (max(key.batch // sq, 1), sq, n_max)
            tiles = pk.paged_split_tile_bound(ps, n_max, sq)
            cfg = pk.paged_split_config(ps, hd, g * sq, tiles, dtype)
            if cfg is not None:
                out.append(Launch(call, "paged_attention_split",
                                  pk.paged_split_smem_bytes(
                                      ps, hd, g * sq, ib, cfg[0], tiles)))
            else:
                out.append(Launch(call, "paged_attention", pk.paged_smem_bytes(
                    ps, hd, g * min(bq, sq))))
        return out
    return []


def audit(R):
    """``(spec, key, launches)`` of every CUDA candidate of each probe key's
    op, with the launches :func:`probe_launches` gives."""
    out = []
    for key in probe_keys(R):
        for spec in R.REGISTRY.candidates(key.op):
            if spec.backend == "cuda":
                out.append((spec, key, probe_launches(spec, key)))
    return out


def _audit(ctx: Context):
    if ctx.root is None or not (ctx.root / _REGISTRY_PATH).is_file():
        return None, ()
    from repro_torch.dispatch import registry as R

    return R, audit(R)


@register
class SmemPredicateUnderCount(Rule):
    """DP301: a CUDA candidate's ``smem_bytes(key)`` claims less than the
    shared memory its wrapper's launch requests for a call of the key's
    shapes: the JAX package's dtype-blind predicate, here a count that
    misses a kernel the shape rule picks, a geometry or an element size."""

    id = "DP301"
    title = "shared-memory count under the launch's"

    def check_project(self, ctx: Context) -> Iterable:
        R, pairs = _audit(ctx)
        if R is None:
            return
        for spec, key, launches in pairs:
            if not launches:
                continue
            most = max(launches, key=lambda la: la.smem)
            declared = spec.smem_bytes(key)
            if declared < most.smem:
                yield self.finding(
                    _REGISTRY_PATH, 1,
                    f"{spec.op}:{spec.name} smem_bytes({key.token}) = "
                    f"{declared} under-counts the {most.kernel} launch of "
                    f"{most.smem} bytes for a call of shapes {most.call} "
                    f"(dtype {key.dtype})",
                    anchor=f"{spec.op}:{spec.name}:{key.dtype}")


@register
class FeasibleAdmitsOverBudget(Rule):
    """DP302: ``feasible(key)`` admits a key one of whose launches requests
    more than ``SMEM_BYTES``: the dispatcher would pick a kernel that the
    launch refuses, failing on the card instead of going down the plan
    ladder."""

    id = "DP302"
    title = "feasibility predicate admits an over-budget launch"

    def check_project(self, ctx: Context) -> Iterable:
        R, pairs = _audit(ctx)
        if R is None:
            return
        for spec, key, launches in pairs:
            most = max((la.smem for la in launches), default=0)
            if most > R.SMEM_BYTES and spec.feasible(key)[0]:
                yield self.finding(
                    _REGISTRY_PATH, 1,
                    f"{spec.op}:{spec.name} feasible({key.token}) admits a "
                    f"launch of {most} bytes against {R.SMEM_BYTES}",
                    anchor=f"{spec.op}:{spec.name}:{key.dtype}:budget")
