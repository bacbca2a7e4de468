"""Operator registry: the candidate implementations behind each logical op
(twin of ``repro/dispatch/registry.py``).

A logical op (``linear``, ``conv``, ``paged_attn``) maps to a list of
:class:`ImplSpec` candidates, each declaring which param keys it executes from, a feasibility
predicate over the :class:`OpKey`, its shared-memory footprint, how to apply
it and how to build a synthetic benchmark of it for the profiler.  Candidate
names, geometry suffixes and ``OpKey.token`` strings are the JAX registry's,
so a name forced in one package means the same plan in the other.

A hand-written kernel registers one candidate per point of its geometry
grid.  Its predicate compares the shared memory its launch would request,
computed by the same function the kernel's wrapper sizes the launch with,
with the 227 KB one Hopper block may use.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.sparse_linear import forward_compressed_xla, forward_masked
from repro_torch.kernels._build import SMEM_BYTES
from repro_torch.kernels.colwise_nm.kernel import (
    MAX_PIPELINED_V,
    TILED_BK,
    TILED_BN,
    linear_smem_bytes,
    linear_tiled_smem_bytes,
    pipelined_smem_bytes,
    strips_smem_bytes,
    strips_tiled_geometry,
    tiled_block_rows,
)
from repro_torch.kernels.colwise_nm.ops import (colwise_nm_matmul,
                                                colwise_nm_matmul_tiled)
from repro_torch.kernels.conv_gemm import ops as conv_ops
from repro_torch.kernels.conv_gemm.kernel import (banded_smem_bytes,
                                                  banded_tiled_geometry,
                                                  fused_smem_bytes,
                                                  fused_tiled_geometry)
from repro_torch.kernels.conv_gemm.plan import band_plan
from repro_torch.kernels.conv_gemm.ref import conv2d_cnhw_ref
from repro_torch.kernels.flash_attn.paged import (
    PAGED_SPLIT_ROWS,
    paged_attention_cuda,
    paged_attention_ref,
    paged_launch_smem_bytes,
)
from repro_torch.kernels.im2col_pack.ref import im2col_pack_ref, out_size


def bucket_batch(n: int) -> int:
    """Round a leading-dim size up to a power of two (min 8), so the profile
    DB is keyed by a bounded family of batch buckets."""
    b = 8
    while b < n:
        b *= 2
    return b


def bucket_dim(n: int) -> int:
    """Power-of-two bucket for the reduction dim of linear keys, so the
    call site (exact d_in) and the params scan (max kept index + 1) land in
    the same token."""
    return bucket_batch(n)


@dataclasses.dataclass(frozen=True)
class OpKey:
    """Hashable identity of one operator instance (static shapes only)."""

    op: str          # "linear" | "conv" | "paged_attn"
    batch: int       # bucketed leading-dim rows (GEMM) / output positions (conv)
    d_in: int        # reduction dim (linear) / kh*kw*c (conv)
    d_out: int
    k_kept: int      # kept reduction indices per tile
    tile: int        # output-feature tile width sharing one index set
    dtype: str = "f32"
    extra: Tuple[Tuple[str, int], ...] = ()
    # serving-phase tag ("prefill" | "decode"); "" = phase-agnostic.  The
    # same weights see [B*S]-row operands in prefill and [B]-row operands in
    # decode, so a phase-tagged key gets its own profile-DB entry.
    phase: str = ""

    @functools.cached_property
    def token(self) -> str:
        """Stable string key for the profile DB (the JAX package's format)."""
        base = (f"{self.op}|b{self.batch}|i{self.d_in}|o{self.d_out}"
                f"|k{self.k_kept}|t{self.tile}|{self.dtype}")
        for k, v in self.extra:
            base += f"|{k}{v}"
        if self.phase:
            base += f"|ph:{self.phase}"
        return base

    def get(self, name: str, default: int = 0) -> int:
        for k, v in self.extra:
            if k == name:
                return v
        return default


_DTYPE_TAGS = {torch.float32: "f32", torch.bfloat16: "bf16",
               torch.float16: "f16", "float32": "f32", "bfloat16": "bf16",
               "float16": "f16"}
_TAG_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
               "f16": torch.float16}


def _dtype_tag(dtype) -> str:
    return _DTYPE_TAGS.get(dtype, str(dtype))


def linear_key(batch: int, d_in: int, d_out: int, k_kept: int, tile: int,
               dtype="float32", phase: str = "") -> OpKey:
    return OpKey(op="linear", batch=bucket_batch(batch), d_in=bucket_dim(d_in),
                 d_out=d_out, k_kept=k_kept, tile=tile, dtype=_dtype_tag(dtype),
                 phase=phase)


def linear_key_from(x_shape: Sequence[int], values_shape: Sequence[int],
                    dtype="float32", phase: str = "") -> OpKey:
    """OpKey from an activation shape and a compressed values shape (only
    the trailing [n_tiles, k_kept, tile] of ``values_shape`` matter)."""
    n_tiles, k_kept, tile = values_shape[-3:]
    rows = 1
    for s in x_shape[:-1]:
        rows *= int(s)
    return linear_key(max(rows, 1), int(x_shape[-1]), int(n_tiles * tile),
                      int(k_kept), int(tile), dtype, phase=phase)


def conv_key(c: int, h: int, w: int, o: int, kh: int, kw: int, stride: int,
             pad: int, k_kept: int, tile: int, v: int = 128,
             dtype="float32", batch: int = 1, phase: str = "") -> OpKey:
    """OpKey for a conv operator instance; the map shape rides in ``extra``."""
    n_pos_h = (h + 2 * pad - kh) // stride + 1
    n_pos_w = (w + 2 * pad - kw) // stride + 1
    return OpKey(
        op="conv", batch=bucket_batch(max(batch * n_pos_h * n_pos_w, 1)),
        d_in=kh * kw * c, d_out=o, k_kept=k_kept, tile=tile,
        dtype=_dtype_tag(dtype),
        extra=(("b", batch), ("c", c), ("h", h), ("w", w), ("kh", kh),
               ("kw", kw), ("s", stride), ("p", pad), ("v", v)),
        phase=phase,
    )


@dataclasses.dataclass(frozen=True)
class ImplSpec:
    """One candidate implementation of a logical op.

    ``backend`` is ``"cuda"`` (a hand-written kernel) or ``"torch"`` (plain
    PyTorch); ``smem_bytes`` is the shared memory the candidate's kernel
    launch requests for a key (0 for plain PyTorch).  ``make_bench(key,
    device)`` returns a zero-argument closure over synthetic operands.
    """

    name: str
    op: str
    backend: str
    requires: frozenset
    priority: int                      # heuristic rank (lower preferred)
    feasible: Callable[[OpKey], Tuple[bool, str]]
    smem_bytes: Callable[[OpKey], int]
    apply: Optional[Callable] = None   # (params, x, **op_args) -> y
    make_bench: Optional[Callable] = None
    geometry: Tuple[Tuple[str, int], ...] = ()

    def geom(self, name: str, default: int = 0) -> int:
        for k, v in self.geometry:
            if k == name:
                return v
        return default

    def __repr__(self):
        return f"ImplSpec({self.op}:{self.name}, backend={self.backend})"


def geometry_name(base: str, geometry: Tuple[Tuple[str, int], ...],
                  default: Tuple[Tuple[str, int], ...]) -> str:
    """Candidate name for one geometry point: the default geometry keeps the
    bare family name, the others get a suffix like ``base@bb256_bk128``."""
    if geometry == default:
        return base
    return base + "@" + "_".join(f"{k}{v}" for k, v in geometry)


class OperatorRegistry:
    def __init__(self):
        self._impls: Dict[str, Dict[str, ImplSpec]] = {}
        self.generation = 0  # bumped on register(); invalidates dispatch memos

    def register(self, spec: ImplSpec) -> ImplSpec:
        self._impls.setdefault(spec.op, {})[spec.name] = spec
        self.generation += 1
        return spec

    def ops(self) -> List[str]:
        return sorted(self._impls)

    def get(self, op: str, name: str) -> ImplSpec:
        try:
            return self._impls[op][name]
        except KeyError:
            known = sorted(self._impls.get(op, {}))
            raise KeyError(
                f"no impl {name!r} registered for op {op!r}; known: {known}"
            ) from None

    def candidates(self, op: str, *, param_keys=None,
                   device_type: Optional[str] = None) -> List[ImplSpec]:
        """All candidates for an op, optionally only those executable from a
        param-dict key set; of those, only the most specific are kept, so
        ``dense`` ({w}) never runs a masked layer ({w, mask}) and drops its
        mask.  With ``device_type="cuda"``, where a hand-written kernel can
        run the layer, only the ``cuda`` candidates remain: a layer on the
        card runs plain PyTorch only when the caller forces it."""
        specs = list(self._impls.get(op, {}).values())
        if param_keys is not None:
            pk = frozenset(param_keys)
            specs = [s for s in specs if s.requires <= pk]
            specs = [s for s in specs
                     if not any(s.requires < o.requires for o in specs)]
        if device_type == "cuda" and any(s.backend == "cuda" for s in specs):
            specs = [s for s in specs if s.backend == "cuda"]
        return specs

    def feasible(self, key: OpKey, *, param_keys=None,
                 device_type: Optional[str] = None) -> List[ImplSpec]:
        return [s for s in self.candidates(key.op, param_keys=param_keys,
                                           device_type=device_type)
                if s.feasible(key)[0]]


REGISTRY = OperatorRegistry()

# Per-op geometry grids (the JAX registry's).  Each point becomes one
# registered candidate; the first entry is the default and keeps the bare
# family name.
LINEAR_GEOMETRY = (
    (("bb", 128), ("bk", 128)),
    (("bb", 256), ("bk", 128)),
    (("bb", 128), ("bk", 64)),
)
FUSED_CONV_GEOMETRY = (
    (("v", 128), ("bk", 128)),
    (("v", 256), ("bk", 128)),
    (("v", 128), ("bk", 64)),
)
# strip width x block_k x band depth hb (strips per band of the banded conv;
# strips per block of the pipelined strip GEMM)
BANDED_CONV_GEOMETRY = (
    (("v", 128), ("bk", 128), ("hb", 2)),
    (("v", 256), ("bk", 128), ("hb", 2)),
    (("v", 128), ("bk", 128), ("hb", 4)),
    (("v", 128), ("bk", 64), ("hb", 1)),
)


def _always(key: OpKey) -> Tuple[bool, str]:
    return True, "ok"


def _no_smem(key: OpKey) -> int:
    return 0


def _itemsize(key: OpKey) -> int:
    return 4 if key.dtype == "f32" else 2


def _tile_ok(key: OpKey) -> Tuple[bool, str]:
    # the kernels take any tile width (their 8-row register blocks guard
    # the ragged last one); the tiles must cover d_out
    if key.d_out % key.tile != 0:
        return False, f"d_out={key.d_out} not divisible by tile={key.tile}"
    return True, "ok"


def _smem_feasible(smem_fn, *checks):
    """Predicate: ``_tile_ok``, then each extra check, then the launch's
    shared memory within a block's."""

    def feasible(key: OpKey) -> Tuple[bool, str]:
        for check in (_tile_ok, *checks):
            ok, reason = check(key)
            if not ok:
                return ok, reason
        smem = smem_fn(key)
        if smem > SMEM_BYTES:
            return False, f"shared memory {smem} > {SMEM_BYTES}"
        return True, "ok"

    return feasible


def _rand(shape, seed, dtype_tag, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return x.to(_TAG_DTYPES.get(dtype_tag, torch.float32))


def _synth_compressed(key: OpKey, device):
    """Strided synthetic (values, idx) of the key's geometry and dtype."""
    n_tiles = key.d_out // key.tile
    values = _rand((n_tiles, key.k_kept, key.tile), 1, "f32", device)
    values = (values / key.k_kept ** 0.5).to(_TAG_DTYPES.get(key.dtype,
                                                              torch.float32))
    stride = max(key.d_in // key.k_kept, 1)
    idx1 = (torch.arange(key.k_kept, device=device) * stride) % key.d_in
    idx = torch.sort(idx1).values[None, :].expand(n_tiles, key.k_kept)
    return values, idx.to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# Linear candidates
# ---------------------------------------------------------------------------


def _apply_linear_xla(params, x):
    return forward_compressed_xla(x, params["values"], params["idx"])


def _apply_linear_pallas(params, x, block_b: int = 128, block_k: int = 128):
    return colwise_nm_matmul(x, params["values"], params["idx"],
                             block_b=block_b, block_k=block_k)


def _apply_linear_tiled(params, x):
    return colwise_nm_matmul_tiled(x, params["values"], params["idx"])


def _apply_linear_masked(params, x):
    return forward_masked(x, params["w"], params["mask"])


def _apply_linear_dense(params, x):
    return x @ params["w"]


def _bench_linear(key: OpKey, device, apply_fn):
    x = _rand((key.batch, key.d_in), 0, key.dtype, device)
    values, idx = _synth_compressed(key, device)
    params = {"values": values, "idx": idx}
    return lambda: apply_fn(params, x)


def _bench_linear_dense(key: OpKey, device):
    x = _rand((key.batch, key.d_in), 0, key.dtype, device)
    w = _rand((key.d_in, key.d_out), 2, key.dtype, device) / key.d_in ** 0.5
    return lambda: x @ w


def _linear_smem_for(block_b: int, block_k: int):
    return lambda key: linear_smem_bytes(key.tile, block_b,
                                         min(block_k, key.k_kept))


REGISTRY.register(ImplSpec(
    name="compressed_xla", op="linear", backend="torch",
    requires=frozenset({"values", "idx"}), priority=10,
    feasible=_always, smem_bytes=_no_smem,
    apply=_apply_linear_xla,
    make_bench=functools.partial(_bench_linear, apply_fn=_apply_linear_xla),
))

for _geom in LINEAR_GEOMETRY:
    _bb, _bk = dict(_geom)["bb"], dict(_geom)["bk"]
    _apply = functools.partial(_apply_linear_pallas, block_b=_bb, block_k=_bk)
    REGISTRY.register(ImplSpec(
        name=geometry_name("compressed_pallas", _geom, LINEAR_GEOMETRY[0]),
        op="linear", backend="cuda",
        requires=frozenset({"values", "idx"}), priority=10,
        feasible=_smem_feasible(_linear_smem_for(_bb, _bk)),
        smem_bytes=_linear_smem_for(_bb, _bk),
        apply=_apply,
        make_bench=functools.partial(_bench_linear, apply_fn=_apply),
        geometry=_geom,
    ))


def _tiled_smem(key: OpKey) -> int:
    return linear_tiled_smem_bytes(tiled_block_rows(key.batch, key.d_out),
                                   TILED_BK, _itemsize(key))


def _tiled_width_ok(key: OpKey) -> Tuple[bool, str]:
    if key.tile % TILED_BN:
        return False, (f"tile={key.tile} is not a multiple of the tiled "
                       f"kernel's {TILED_BN} columns")
    return True, "ok"


# A port-only family (the JAX registry has none): the tiled kernel, ranked
# before compressed_pallas wherever its tile-width rule holds.  Its rows per
# block come from the wrapper's shape rule, so it has no geometry grid.
REGISTRY.register(ImplSpec(
    name="compressed_tiled", op="linear", backend="cuda",
    requires=frozenset({"values", "idx"}), priority=5,
    feasible=_smem_feasible(_tiled_smem, _tiled_width_ok),
    smem_bytes=_tiled_smem,
    apply=_apply_linear_tiled,
    make_bench=functools.partial(_bench_linear, apply_fn=_apply_linear_tiled),
))

REGISTRY.register(ImplSpec(
    name="masked", op="linear", backend="torch",
    requires=frozenset({"w", "mask"}), priority=20,
    feasible=_always, smem_bytes=_no_smem,
    apply=_apply_linear_masked, make_bench=_bench_linear_dense,
))

REGISTRY.register(ImplSpec(
    name="dense", op="linear", backend="torch",
    requires=frozenset({"w"}), priority=30,
    feasible=_always, smem_bytes=_no_smem,
    apply=_apply_linear_dense, make_bench=_bench_linear_dense,
))


# ---------------------------------------------------------------------------
# Conv candidates (GEMM view: [P, KhKwC] x [KhKwC, O]): the plan ladder
# fused -> banded -> pipelined two-kernel -> two-kernel -> reference
# ---------------------------------------------------------------------------


def _conv_args(key: OpKey):
    return dict(kh=key.get("kh"), kw=key.get("kw"), stride=key.get("s", 1),
                pad=key.get("p", 0), v=key.get("v", 128))


def _conv_hw(key: OpKey):
    """(c, b, h, w, ho, wo) of a conv key."""
    c, h = key.get("c"), key.get("h")
    w = key.get("w", h)
    b = max(key.get("b", 1), 1)
    ho = out_size(h, key.get("kh"), key.get("s", 1), key.get("p", 0))
    wo = out_size(w, key.get("kw"), key.get("s", 1), key.get("p", 0))
    return c, b, h, w, ho, wo


def _synth_conv_input(key: OpKey, device):
    c, b, h, w, _, _ = _conv_hw(key)
    return _rand((c, b, h, w), 3, key.dtype, device)


def _has_map(key: OpKey) -> Tuple[bool, str]:
    if key.get("c") <= 0 or key.get("h") <= 0:
        return False, "conv geometry (c, h, w) missing from key extras"
    return True, "ok"


def _bench_conv(key: OpKey, device, apply_fn):
    x = _synth_conv_input(key, device)
    values, idx = _synth_compressed(key, device)
    params = {"values": values, "idx": idx}
    args = _conv_args(key)
    return lambda: apply_fn(params, x, **args)


def _bench_conv_dense(key: OpKey, device):
    x = _synth_conv_input(key, device)
    a = _conv_args(key)
    wt = _rand((key.d_out, a["kh"], a["kw"], key.get("c")), 4, key.dtype,
               device)
    return lambda: conv2d_cnhw_ref(x, wt, stride=a["stride"], pad=a["pad"])


def _bench_conv_im2col_dense(key: OpKey, device):
    x = _synth_conv_input(key, device)
    a = _conv_args(key)
    w = _rand((key.d_in, key.d_out), 5, key.dtype, device) / key.d_in ** 0.5

    def run():
        strips = im2col_pack_ref(x, a["kh"], a["kw"], a["stride"], a["pad"],
                                 a["v"])
        return strips.transpose(1, 2).reshape(-1, key.d_in) @ w

    return run


def _apply_conv_xla(params, x, *, kh, kw, stride=1, pad=0, v=128):
    return conv_ops.conv2d_xla_ref(x, params["values"], params["idx"], kh=kh,
                                   kw=kw, stride=stride, pad=pad, v=v)


def _apply_conv_two_kernel(params, x, *, kh, kw, stride=1, pad=0, v=128):
    return conv_ops.conv2d_two_kernel(x, params["values"], params["idx"],
                                      kh=kh, kw=kw, stride=stride, pad=pad, v=v)


def _apply_conv_fused(params, x, *, kh, kw, stride=1, pad=0, v=128,
                      geom_v=128, geom_bk=128):
    # the fused kernel's strips never exist in device memory, so its strip
    # width is execution geometry: the candidate's, not the caller's v
    return conv_ops.conv2d_fused(x, params["values"], params["idx"], kh=kh,
                                 kw=kw, stride=stride, pad=pad, v=geom_v,
                                 block_k=geom_bk)


def _apply_conv_banded(params, x, *, kh, kw, stride=1, pad=0, v=128,
                       geom_v=128, geom_bk=128, geom_hb=2):
    return conv_ops.conv2d_fused_banded(x, params["values"], params["idx"],
                                        kh=kh, kw=kw, stride=stride, pad=pad,
                                        v=geom_v, block_k=geom_bk, hb=geom_hb)


def _apply_conv_pipelined(params, x, *, kh, kw, stride=1, pad=0, v=128,
                          geom_v=128, geom_bk=128, geom_hb=2):
    # the pipelined plan writes and reads its own strips, so the candidate's
    # strip width applies to both of its kernels
    return conv_ops.conv2d_two_kernel_pipelined(
        x, params["values"], params["idx"], kh=kh, kw=kw, stride=stride,
        pad=pad, v=geom_v, block_k=geom_bk, hb=geom_hb)


def _strips_tiled_smem(key: OpKey, v: int, hb: int) -> Optional[int]:
    """Shared memory of the tiled strip GEMM at strip width ``v`` and ``hb``
    strips a block, where its shape rule takes the key's strips (fresh
    strips are 16-byte aligned), else ``None``."""
    _, b, _, _, ho, wo = _conv_hw(key)
    if ho <= 0 or wo <= 0:
        return None
    geo = strips_tiled_geometry(-(-b * ho * wo // v), v, key.d_out // key.tile,
                                key.k_kept, key.tile, _itemsize(key), hb)
    return None if geo is None else geo["smem"]


def _strips_smem(key: OpKey) -> int:
    """Shared memory of the strip GEMM the shape rule picks for a key: the
    tiled one where ``strips_tiled_geometry`` takes the strips, else
    ``colwise_nm_strips.cu`` (``block_k`` 128)."""
    tiled = _strips_tiled_smem(key, key.get("v", 128), 1)
    if tiled is not None:
        return tiled
    return strips_smem_bytes(key.tile, min(128, key.k_kept))


def _fused_smem_for(geom_v: int, geom_bk: int):
    """Shared memory of the fused kernel the shape rule picks for a key: the
    tiled one where ``fused_tiled_geometry`` takes the shape at the
    candidate's strip width (fresh values are 16-byte aligned), else
    ``conv2d_fused.cu`` (``block_k`` chunks its staged values)."""

    def smem(key: OpKey) -> int:
        c, b, h, w, _, _ = _conv_hw(key)
        tiled = fused_tiled_geometry(
            c, b, h, w, key.get("kh"), key.get("kw"), key.get("s", 1),
            key.get("p", 0), geom_v, key.d_out // key.tile, key.k_kept,
            key.tile, _itemsize(key))
        if tiled is not None:
            return tiled["smem"]
        return fused_smem_bytes(key.tile, min(geom_bk, key.k_kept))

    return smem


def _banded_smem_for(geom_v: int, geom_bk: int, geom_hb: int):
    """Shared memory of the banded kernel the shape rule picks for a key:
    the tiled one where ``banded_tiled_geometry`` takes the shape (a fresh
    map is 16-byte aligned), else ``conv2d_fused_banded.cu``."""

    def smem(key: OpKey) -> int:
        c, b, h, w, ho, wo = _conv_hw(key)
        tiled = banded_tiled_geometry(
            c, b, h, w, key.get("kh"), key.get("kw"), key.get("s", 1),
            key.get("p", 0), geom_v, geom_hb, key.d_out // key.tile,
            key.k_kept, key.tile, _itemsize(key))
        if tiled is not None:
            return tiled["smem"]
        _, band_rows = band_plan(b=b, h=h, kh=key.get("kh"),
                                 stride=key.get("s", 1), pad=key.get("p", 0),
                                 ho=ho, wo=wo, v=geom_v, hb=geom_hb)
        return banded_smem_bytes(c, w, band_rows, min(geom_bk, key.k_kept),
                                 _itemsize(key))

    return smem


def _banded_rows_ok(key: OpKey) -> Tuple[bool, str]:
    if (key.get("w", key.get("h")) * _itemsize(key)) % 4:
        return False, "map rows are not a multiple of 4 bytes"
    return True, "ok"


def _pipelined_smem_for(geom_v: int, geom_bk: int, geom_hb: int):
    """Shared memory of the pipelined strip GEMM the shape rule picks for a
    key: the tiled one (``hb`` strips a block; ``block_k`` does not change
    its launch) where ``strips_tiled_geometry`` takes the strips, else
    ``colwise_nm_strips_pipelined.cu``."""

    def smem(key: OpKey) -> int:
        tiled = _strips_tiled_smem(key, geom_v, geom_hb)
        if tiled is not None:
            return tiled
        return pipelined_smem_bytes(geom_v, min(geom_bk, key.k_kept),
                                    _itemsize(key))

    return smem


def _pipelined_v_ok_for(geom_v: int):
    def ok(key: OpKey) -> Tuple[bool, str]:
        if geom_v > MAX_PIPELINED_V or (geom_v * _itemsize(key)) % 16:
            return False, f"strip width {geom_v} not a 16-byte multiple <= {MAX_PIPELINED_V}"
        return True, "ok"

    return ok


REGISTRY.register(ImplSpec(
    name="dense_conv", op="conv", backend="torch",
    requires=frozenset({"w"}), priority=30,
    feasible=_always, smem_bytes=_no_smem,
    make_bench=_bench_conv_dense,
))

REGISTRY.register(ImplSpec(
    name="im2col_dense_gemm", op="conv", backend="torch",
    requires=frozenset({"w"}), priority=20,
    feasible=_always, smem_bytes=_no_smem,
    make_bench=_bench_conv_im2col_dense,
))

REGISTRY.register(ImplSpec(
    name="im2col_sparse_xla", op="conv", backend="torch",
    requires=frozenset({"values", "idx"}), priority=10,
    feasible=_always, smem_bytes=_no_smem,
    apply=_apply_conv_xla,
    make_bench=functools.partial(_bench_conv, apply_fn=_apply_conv_xla),
))

REGISTRY.register(ImplSpec(
    name="im2col_sparse_pallas", op="conv", backend="cuda",
    requires=frozenset({"values", "idx"}), priority=10,
    feasible=_smem_feasible(_strips_smem), smem_bytes=_strips_smem,
    apply=_apply_conv_two_kernel,
    make_bench=functools.partial(_bench_conv, apply_fn=_apply_conv_two_kernel),
))

for _geom in FUSED_CONV_GEOMETRY:
    _gv, _gbk = dict(_geom)["v"], dict(_geom)["bk"]
    _apply = functools.partial(_apply_conv_fused, geom_v=_gv, geom_bk=_gbk)
    REGISTRY.register(ImplSpec(
        name=geometry_name("fused_sparse_pallas", _geom,
                           FUSED_CONV_GEOMETRY[0]),
        op="conv", backend="cuda",
        requires=frozenset({"values", "idx"}), priority=5,
        feasible=_smem_feasible(_fused_smem_for(_gv, _gbk), _has_map),
        smem_bytes=_fused_smem_for(_gv, _gbk),
        apply=_apply,
        make_bench=functools.partial(_bench_conv, apply_fn=_apply),
        geometry=_geom,
    ))

for _family, _apply_fn, _smem_for, _checks_for, _prio in (
        ("fused_banded_pallas", _apply_conv_banded, _banded_smem_for,
         lambda gv: (_has_map, _banded_rows_ok), 6),
        ("two_kernel_pipelined", _apply_conv_pipelined, _pipelined_smem_for,
         lambda gv: (_has_map, _pipelined_v_ok_for(gv)), 8)):
    for _geom in BANDED_CONV_GEOMETRY:
        _gv, _gbk, _ghb = (dict(_geom)["v"], dict(_geom)["bk"],
                           dict(_geom)["hb"])
        _apply = functools.partial(_apply_fn, geom_v=_gv, geom_bk=_gbk,
                                   geom_hb=_ghb)
        _smem = _smem_for(_gv, _gbk, _ghb)
        REGISTRY.register(ImplSpec(
            name=geometry_name(_family, _geom, BANDED_CONV_GEOMETRY[0]),
            op="conv", backend="cuda",
            requires=frozenset({"values", "idx"}), priority=_prio,
            feasible=_smem_feasible(_smem, *_checks_for(_gv)),
            smem_bytes=_smem,
            apply=_apply,
            make_bench=functools.partial(_bench_conv, apply_fn=_apply),
            geometry=_geom,
        ))


# ---------------------------------------------------------------------------
# Paged attention (the serving tier's paged KV cache): page_size x block_q
# geometry grid.  Page size is a cache-layout decision, so a key has two
# flavours: a planning key (no "ps" extra) admits every geometry, which is
# how choose_page_size picks the layout before the cache exists, and an
# execution key (pinned "ps") admits the kernel geometries of that page size
# and the plain version.
# ---------------------------------------------------------------------------

PAGED_ATTN_GEOMETRY = (
    (("ps", 16), ("bq", 8)),
    (("ps", 8), ("bq", 8)),
    (("ps", 32), ("bq", 8)),
    (("ps", 16), ("bq", 16)),
)

DEFAULT_PAGE_SIZE = dict(PAGED_ATTN_GEOMETRY[0])["ps"]


def paged_attn_key(q_rows: int, n_heads: int, kv_heads: int, head_dim: int,
                   kv_capacity: int, page_size: int = 0, dtype="float32",
                   phase: str = "") -> OpKey:
    """OpKey for one paged-attention instance.

    ``page_size == 0`` builds the planning flavour; nonzero pins the physical
    layout.  ``kv_capacity`` (table width x page size) is bucketed like
    batch, so the DB is keyed by a bounded family of cache capacities.
    """
    extra = (("hd", head_dim), ("kvcap", bucket_batch(max(kv_capacity, 1))))
    if page_size:
        extra += (("ps", page_size),)
    return OpKey(op="paged_attn", batch=bucket_batch(max(q_rows, 1)),
                 d_in=head_dim, d_out=n_heads * head_dim, k_kept=kv_heads,
                 tile=8, dtype=_dtype_tag(dtype), extra=extra, phase=phase)


def _paged_smem_for(geom_ps: int, geom_bq: int):
    # the largest launch of a call of the key, with a table as wide as the
    # key's (bucketed) cache capacity: the key's q_rows say nothing of the
    # rows a sequence, so each Sq from 1 to the most either kernel takes a
    # block (geom_bq for paged_attention.cu, PAGED_SPLIT_ROWS[-1] for the
    # split kernel, whose launch at a decode step's Sq of 1 can be far the
    # larger), each the split kernel's where its shape rule takes it, else
    # paged_attention.cu's
    def smem(key: OpKey) -> int:
        hd, kv = key.get("hd", key.d_in), max(key.k_kept, 1)
        h = key.d_out // max(hd, 1)
        n_max = -(-key.get("kvcap", 128) // geom_ps)
        dtype = _TAG_DTYPES.get(key.dtype, torch.float32)
        top = min(key.batch, max(geom_bq, PAGED_SPLIT_ROWS[-1]))
        return max(paged_launch_smem_bytes(geom_ps, hd, h, kv, sq, n_max,
                                           dtype, geom_bq)
                   for sq in range(1, top + 1))

    return smem


def _paged_feasible_for(geom_ps: int, geom_bq: int):
    def feasible(key: OpKey) -> Tuple[bool, str]:
        hd, kv = key.get("hd"), key.k_kept
        if hd <= 0 or kv <= 0:
            return False, "paged geometry (hd, kv) missing from key extras"
        h = key.d_out // hd
        if h % kv != 0:
            return False, f"H={h} not divisible by KV={kv} (head-map GQA)"
        pinned = key.get("ps", 0)
        if pinned and pinned != geom_ps:
            return False, f"cache layout pinned to page size {pinned}"
        smem = _paged_smem_for(geom_ps, geom_bq)(key)
        if smem > SMEM_BYTES:
            return False, f"shared memory {smem} > {SMEM_BYTES}"
        return True, "ok"

    return feasible


def _synth_paged(key: OpKey, ps: int, device):
    """Deterministic decode-shaped operands for a paged-attention bench:
    three-quarter-full caches, so the last page is ragged."""
    hd, kv = key.get("hd"), key.k_kept
    h = key.d_out // hd
    b = key.batch
    n_max = -(-key.get("kvcap", 128) // ps)
    p = b * n_max
    q = _rand((b, 1, h, hd), 1, key.dtype, device)
    kn = _rand((b, 1, kv, hd), 2, key.dtype, device)
    vn = _rand((b, 1, kv, hd), 3, key.dtype, device)
    kp = _rand((p + 1, ps, kv, hd), 4, key.dtype, device)
    vp = _rand((p + 1, ps, kv, hd), 5, key.dtype, device)
    tables = torch.arange(p, dtype=torch.int32, device=device).reshape(b, n_max)
    lengths = torch.full((b,), max(key.get("kvcap", 128) * 3 // 4, 1),
                         dtype=torch.int32, device=device)
    return q, kn, vn, kp, vp, tables, lengths


def _bench_paged_ref(key: OpKey, device):
    ps = key.get("ps", 0) or DEFAULT_PAGE_SIZE
    args = _synth_paged(key, ps, device)
    return lambda: paged_attention_ref(*args)


def _bench_paged_cuda(key: OpKey, device, geom_ps: int, geom_bq: int):
    # the candidate's own page size, not the key's: a planning key races the
    # physical layouts of every geometry
    args = _synth_paged(key, geom_ps, device)
    if device.type == "cpu":  # the plain version, as the other wrappers run
        return lambda: paged_attention_ref(*args)
    return lambda: paged_attention_cuda(*args, page_size=geom_ps,
                                        block_q=geom_bq)


REGISTRY.register(ImplSpec(
    name="paged_attn_ref", op="paged_attn", backend="torch",
    requires=frozenset(), priority=10,
    feasible=_always, smem_bytes=_no_smem,
    make_bench=_bench_paged_ref,
))

for _geom in PAGED_ATTN_GEOMETRY:
    _gps, _gbq = dict(_geom)["ps"], dict(_geom)["bq"]
    REGISTRY.register(ImplSpec(
        name=geometry_name("paged_attn_pallas", _geom, PAGED_ATTN_GEOMETRY[0]),
        op="paged_attn", backend="cuda",
        requires=frozenset(), priority=5,
        feasible=_paged_feasible_for(_gps, _gbq),
        smem_bytes=_paged_smem_for(_gps, _gbq),
        make_bench=functools.partial(_bench_paged_cuda, geom_ps=_gps,
                                     geom_bq=_gbq),
        geometry=_geom,
    ))
