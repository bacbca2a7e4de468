"""Dispatch layer: pick the implementation that runs a logical op (twin of
``repro/dispatch/dispatch.py``).

Selection order for :func:`best_impl` (first hit wins):

  1. ``force=``          the call site names a candidate; an unknown name, or
                         one that cannot execute the layer's params, raises
                         ``KeyError``.  Only a forced name runs plain PyTorch
                         on a layer a hand-written kernel could run on the
                         card.
  2. profile DB entry    a profiled winner for this exact ``OpKey.token``
                         that is still registered, runs on the device and is
                         feasible.
  3. heuristic           among the feasible candidates for the device (on a
                         CUDA device only the ``cuda`` ones where the op has
                         any, on the CPU all, ``torch`` ones first), registry
                         priority, then a family's default geometry before
                         its variants, then the smallest footprint.  (The
                         JAX heuristic has no geometry rung, so on a TPU it
                         can pick a variant unmeasured; here only a profile
                         does.)

Where no candidate is feasible the lookup raises :class:`TuningError`: the
JAX package's "degraded" rung, which runs the smallest-footprint candidate
anyway, has no counterpart.  Profiling never happens inside a forward:
:func:`plan_params` (with ``profile=True``) and :func:`ensure_profiled` fill
the DB beforehand.  The port has no environment switches: the force, the
profiling and the DB are arguments.  A candidate that fails to build or
launch raises; nothing moves down the ladder quietly.  Inside
:func:`phase_scope` every key a call site forms carries the serving phase,
so prefill and decode shapes are planned and profiled apart; inside
:func:`force_scope` a call site that names no candidate runs the one the
scope names for its op.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterable, Mapping, Optional

from repro_torch._compat import resolve_device
from repro_torch.dispatch.profiler import ProfileDB, TuningError, profile_op
from repro_torch.dispatch.registry import (
    DEFAULT_PAGE_SIZE,
    REGISTRY,
    ImplSpec,
    OpKey,
    conv_key,
    linear_key,
    linear_key_from,
    paged_attn_key,
)

_DB: Optional[ProfileDB] = None
_SITE_MEMO: Dict[tuple, ImplSpec] = {}
# Ambient serving phase ("prefill" | "decode" | None) and forced candidates
# ({op: name}).  The serving engine runs each step inside phase_scope, so
# every call site in the model forms a phase-tagged key without a phase
# argument threaded through the model; the call sites read both when they
# form their keys.
_PHASE: Optional[str] = None
_FORCED: Dict[str, str] = {}


@contextlib.contextmanager
def phase_scope(phase: Optional[str]):
    """Tag the dispatch lookups made in this scope with a serving phase."""
    global _PHASE
    prev = _PHASE
    _PHASE = phase or None
    try:
        yield
    finally:
        _PHASE = prev


def current_phase() -> str:
    """The ambient serving phase ("" outside any phase_scope)."""
    return _PHASE or ""


@contextlib.contextmanager
def force_scope(**impls: str):
    """Run every call site of op ``op`` that names no candidate itself under
    candidate ``impls[op]`` in this scope, e.g. ``force_scope(linear=
    "compressed_xla", paged_attn="paged_attn_ref")`` to replay a model
    through its plain versions on the card (the JAX package reads
    ``REPRO_DISPATCH_FORCE`` for this; the port has no environment
    switches)."""
    global _FORCED
    prev = _FORCED
    _FORCED = {**prev, **impls}
    try:
        yield
    finally:
        _FORCED = prev


def forced_impl(op: str, impl: Optional[str]) -> Optional[str]:
    """``impl`` when the call site names one, else the ambient
    :func:`force_scope` candidate of ``op`` (``None`` when there is none)."""
    return impl if impl is not None else _FORCED.get(op)


def get_db() -> ProfileDB:
    """The process-wide profile DB (at ``profiler.DEFAULT_DB_PATH`` unless
    :func:`set_db` swapped in another)."""
    global _DB
    if _DB is None:
        _DB = ProfileDB()
    return _DB


def set_db(db: Optional[ProfileDB]) -> None:
    """Swap the process-wide profile DB (tests, benchmark isolation);
    ``None`` goes back to the default one at its next use."""
    global _DB
    _DB = db
    _SITE_MEMO.clear()


def _heuristic(specs, key: OpKey, device_type: str) -> ImplSpec:
    on_card = device_type == "cuda"

    def rank(s: ImplSpec):
        backend_match = 0 if (s.backend == "cuda") == on_card else 1
        # a geometry variant (``family@...``) is the profiler's pick: without
        # a measurement the family's default geometry runs
        return (backend_match, s.priority, "@" in s.name, s.smem_bytes(key))

    return min(specs, key=rank)


def resolve(key: OpKey, *, param_keys: Optional[Iterable[str]] = None,
            force: Optional[str] = None, db: Optional[ProfileDB] = None,
            device=None):
    """``(spec, source)``: the implementation to run for ``key`` on
    ``device`` (``None``: the CUDA card) and the rung that chose it,
    ``"forced"``, ``"db"`` or ``"heuristic"``.  A pure lookup: it never
    times anything.  Raises :class:`TuningError` where no candidate the
    device may run is feasible."""
    pk = frozenset(param_keys) if param_keys is not None else None
    the_db = db if db is not None else get_db()
    return _resolve(key, pk, force, the_db, resolve_device(device).type)


def best_impl(key: OpKey, *, param_keys: Optional[Iterable[str]] = None,
              force: Optional[str] = None, db: Optional[ProfileDB] = None,
              device=None) -> ImplSpec:
    """The implementation to run for ``key`` (see the module docstring);
    ``param_keys`` restricts the candidates to those executable from a
    layer's params (a compressed layer cannot run ``dense``)."""
    return resolve(key, param_keys=param_keys, force=force, db=db,
                   device=device)[0]


def site_impl(site: tuple, make_key: Callable[[], OpKey], *,
              param_keys: Iterable[str], force: Optional[str],
              device) -> ImplSpec:
    """:func:`best_impl` for a call site of the process-wide DB.  ``site``
    is a hashable tuple of everything ``make_key`` reads (shapes, dtype,
    device, op arguments), so a forward forms each layer's key and token
    once per DB state instead of at every call."""
    the_db = get_db()
    memo_key = (site, force, the_db.uid, the_db.generation,
                REGISTRY.generation)
    spec = _SITE_MEMO.get(memo_key)
    if spec is None:
        spec = best_impl(make_key(), param_keys=param_keys, force=force,
                         device=device)
        if len(_SITE_MEMO) > 4096:
            _SITE_MEMO.clear()
        _SITE_MEMO[memo_key] = spec
    return spec


def _resolve(key: OpKey, pk, force: Optional[str], db: ProfileDB,
             device_type: str) -> tuple:
    if force is not None:
        by_name = {s.name: s for s in REGISTRY.candidates(key.op, param_keys=pk)}
        if force in by_name:
            return by_name[force], "forced"
        known = sorted(s.name for s in REGISTRY.candidates(key.op))
        if force not in known:
            raise KeyError(f"force={force!r} is not a registered {key.op!r} "
                           f"impl; known: {known}")
        raise KeyError(
            f"force={force!r} cannot execute a {key.op!r} layer with params "
            f"{sorted(pk or ())}; it requires "
            f"{sorted(REGISTRY.get(key.op, force).requires)}")

    cands = REGISTRY.candidates(key.op, param_keys=pk, device_type=device_type)
    feasible = [s for s in cands if s.feasible(key)[0]]
    if not feasible:
        reasons = {s.name: s.feasible(key)[1] for s in cands}
        raise TuningError(
            f"no candidate for {key.token} executable from params "
            f"{sorted(pk or ())} is feasible on {device_type}: {reasons}")
    rec = db.get(key.token)
    if rec is not None:
        spec = next((s for s in feasible if s.name == rec.get("impl")), None)
        if spec is not None:
            return spec, "db"
    return _heuristic(feasible, key, device_type), "heuristic"


def ensure_profiled(key: OpKey, *, param_keys=None,
                    db: Optional[ProfileDB] = None, iters: int = 20,
                    device=None) -> Dict:
    """Profile ``key`` on ``device`` unless the DB has an entry for it;
    return the record."""
    the_db = db if db is not None else get_db()
    rec = the_db.get(key.token)
    if rec is None:
        rec = profile_op(key, the_db, iters=iters, param_keys=param_keys,
                         device=device)
    return rec


def linear_impl(x_shape, values_shape, dtype="float32", *,
                force: Optional[str] = None, device=None) -> ImplSpec:
    """Implementation of a compressed linear layer from the activation and
    values shapes, in the ambient serving phase."""
    key = linear_key_from(x_shape, values_shape, dtype, phase=current_phase())
    return best_impl(key, param_keys=("values", "idx"), force=force,
                     device=device)


def iter_compressed_layers(tree, prefix: str = ""):
    """Yield (path, values, idx) for every compressed layer of a params
    tree."""
    for path, _op, info in iter_op_layers(tree, prefix):
        yield path, info["values"], info["idx"]


def iter_op_layers(tree, prefix: str = ""):
    """Yield (path, op, info) for every compressed layer of a params tree.

    ``op`` is ``"conv"`` when the layer carries ``conv_init``'s ``conv_geom``
    [kh, kw, c_in] leaf (values and idx alone do not tell a conv from a
    linear layer), else ``"linear"``.  ``info`` holds ``values``/``idx``,
    and ``kh``/``kw``/``c_in`` for a conv.
    """
    if isinstance(tree, dict):
        if "values" in tree and "idx" in tree:
            info = {"values": tree["values"], "idx": tree["idx"]}
            if "conv_geom" in tree:
                geom = [int(g) for g in tree["conv_geom"].reshape(-1, 3)[0]]
                info["kh"], info["kw"], info["c_in"] = geom
                yield prefix or ".", "conv", info
            else:
                yield prefix or ".", "linear", info
        for k, v in tree.items():
            if k in ("values", "idx", "conv_geom"):
                continue
            yield from iter_op_layers(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from iter_op_layers(v, f"{prefix}[{i}]")


def _match_conv_hint(conv_hints: Optional[Mapping[str, Mapping[str, int]]],
                     path: str) -> Optional[Mapping[str, int]]:
    """Most specific (longest) hint whose key is a substring of ``path``;
    the empty-string key is the catch-all."""
    if not conv_hints:
        return None
    best = None
    for pat, hint in conv_hints.items():
        if pat in path and (best is None or len(pat) > len(best[0])):
            best = (pat, hint)
    return best[1] if best else None


def plan_params(params, *, batch_hint: int = 8, db: Optional[ProfileDB] = None,
                profile: bool = False,
                phase_hints: Optional[Mapping[str, int]] = None,
                conv_hints: Optional[Mapping[str, Mapping[str, int]]] = None,
                ) -> Dict[str, str]:
    """Build-time dispatch plan of a params tree: ``{token: impl name}``.

    Resolves each distinct OpKey of the tree's compressed layers and, with
    ``profile=True``, first profiles every token the DB lacks on the device
    the layer's params live on.  A linear layer is planned for
    ``batch_hint`` operand rows, or, with ``phase_hints`` (serving phase ->
    operand rows, e.g. ``{"prefill": batch * prompt_len, "decode":
    batch}``), once per phase under a phase-tagged key.  Conv layers need
    the map shape, which is a call-time property: ``conv_hints`` maps a
    layer-path substring to ``{"h", "w", "batch", "stride", "pad", "v"}``
    (``w`` defaults to ``h``,
    ``stride`` to 1, ``pad`` to kh//2, ``batch`` to 1, ``v`` to 128; the
    longest matching key wins, ``""`` is the catch-all), and
    ``models.vision.conv_hints`` gives the exact per-layer hints.  A conv
    layer without a hint is skipped.
    """
    the_db = db if db is not None else get_db()
    hints: Mapping[str, int] = phase_hints if phase_hints else {"": batch_hint}
    plan: Dict[str, str] = {}

    def plan_key(key: OpKey, device) -> None:
        if key.token in plan:
            return
        if profile:
            ensure_profiled(key, param_keys=("values", "idx"), db=the_db,
                            device=device)
        plan[key.token] = best_impl(key, param_keys=("values", "idx"),
                                    db=the_db, device=device).name

    for path, op, info in iter_op_layers(params):
        values, idx = info["values"], info["idx"]
        n_tiles, k_kept, tile = (int(s) for s in values.shape[-3:])
        if op == "conv":
            hint = _match_conv_hint(conv_hints, path)
            if hint is None:
                continue  # no map-shape hint: the conv token cannot be formed
            kh, kw, c = info["kh"], info["kw"], info["c_in"]
            h = int(hint["h"])
            plan_key(conv_key(
                c, h, int(hint.get("w", h)), n_tiles * tile, kh, kw,
                int(hint.get("stride", 1)), int(hint.get("pad", kh // 2)),
                k_kept, tile, v=int(hint.get("v", 128)), dtype=values.dtype,
                batch=int(hint.get("batch", 1))), values.device)
            continue
        # d_in is not stored in the compressed layout; the max kept index
        # bounds it from below and OpKey buckets d_in to a power of two, so
        # this lands in the call site's token whenever the kept rows reach
        # the top half of the reduction dim.
        d_in = int(idx.max()) + 1 if idx.numel() else k_kept
        for ph, rows in hints.items():
            plan_key(linear_key(rows, d_in, n_tiles * tile, k_kept, tile,
                                dtype=values.dtype, phase=ph), values.device)
    return plan


def choose_page_size(n_heads: int, kv_heads: int, head_dim: int,
                     kv_capacity: int, *, q_rows: int = 8, dtype="float32",
                     phase: str = "decode", db: Optional[ProfileDB] = None,
                     profile: bool = False, device=None) -> int:
    """The KV page size of a serving configuration (the cache-layout plan).

    Resolves the unpinned planning key: with ``profile=True`` (or a warm
    DB) the page sizes of ``PAGED_ATTN_GEOMETRY`` have been raced for this
    shape on ``device`` and the winner's is returned; otherwise the
    heuristic decides (``DEFAULT_PAGE_SIZE`` when the plain version wins,
    as it does on the CPU).
    """
    key = paged_attn_key(q_rows, n_heads, kv_heads, head_dim, kv_capacity,
                         page_size=0, dtype=dtype, phase=phase)
    if profile:
        ensure_profiled(key, param_keys=(), db=db, device=device)
    spec = best_impl(key, param_keys=(), db=db, device=device)
    return spec.geom("ps", 0) or DEFAULT_PAGE_SIZE
