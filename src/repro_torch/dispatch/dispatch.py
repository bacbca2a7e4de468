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
profiling, the DB and the quarantine TTL are arguments.

The sparse call sites run their candidate through :func:`run_guarded`: a
candidate that refuses to run (an injected fault, a wrapper's shape rule)
is quarantined and the key re-resolves, on the card among the hand-written
kernels alone, until none is left.  A kernel that fails to build or to
launch raises at once: the device is broken, and CUDA errors are sticky.
Inside
:func:`phase_scope` every key a call site forms carries the serving phase,
so prefill and decode shapes are planned and profiled apart; inside
:func:`force_scope` a call site that names no candidate runs the one the
scope names for its op.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Iterable, Mapping, Optional, Union

from repro_torch import fault as _fault
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
from repro_torch.kernels import _build
from repro_torch.obs import metrics as _om
from repro_torch.obs import trace as _ot

# Cached instruments (created once): while obs is off each costs one check
_C_RESOLVE = _om.counter("dispatch.resolves")
_C_MEMO_HIT = _om.counter("dispatch.memo_hits")
_C_DB_HIT = _om.counter("dispatch.db_hits")
_C_DB_MISS = _om.counter("dispatch.db_misses")
_C_CANDS = _om.counter("dispatch.candidates_considered")
_C_QUARANTINE = _om.counter("dispatch.quarantine")
_C_EXEC_RETRY = _om.counter("dispatch.execute_retries")

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

# ---------------------------------------------------------------------------
# Execution-time quarantine (with TTL/backoff re-probe)
# ---------------------------------------------------------------------------
#
# When a resolved candidate refuses to run (an injected fault, a wrapper's
# shape rule), run_guarded denylists (op, family) here and re-resolves.  The
# family is the name before a geometry suffix: ``fused_sparse_pallas@v256_bk128``
# launches the same hand-written kernel as ``fused_sparse_pallas``, so the
# whole family leaves the candidate space (the JAX package denylists each
# geometry's name on its own).  Quarantine is never written to the profile
# DB, and _Q_GEN joins every memo key, so a quarantined family stops running
# at once despite the per-site memo.
#
# Entries EXPIRE: each carries a monotonic deadline (the base TTL doubled per
# consecutive failure, capped at 2**6 times).  An expired entry moves to
# probation: the family rejoins the candidate space, and the next guarded
# execution decides its fate:
#
#       active ──ttl elapses──► probation ──run_guarded ok──► (entry gone)
#         ▲                        │
#         └──── guarded failure ───┘   (fails += 1, ttl doubles)


class _QuarantineEntry:
    __slots__ = ("fails", "until", "probation", "reason")

    def __init__(self, fails: int, until: float, reason: str):
        self.fails = fails
        self.until = until
        self.probation = False
        self.reason = reason


_QUARANTINE: Dict[tuple, _QuarantineEntry] = {}
_Q_GEN = 0

_now = time.monotonic  # test seam: monkeypatch dispatch._now for fake clocks
_TTL_BACKOFF = 2.0
_TTL_MAX_DOUBLINGS = 6  # cap the backoff at base * 2**6
_TTL_S = 30.0

# what a candidate's refusal to run raises: the wrapper's shape and dtype
# rules (ValueError, TypeError), a lookup's TuningError and an injected
# fault.  A failed build or launch (RuntimeError) is not among them, nor are
# operands on a device the kernel cannot take (_build.DeviceError).
_RECOVERABLE = (_fault.InjectedFault, TuningError, ValueError, TypeError)


def family(impl: str) -> str:
    """A candidate's family: its name without the geometry suffix."""
    return impl.split("@", 1)[0]


def quarantine_ttl_s() -> float:
    """Base quarantine TTL in seconds (default 30); <= 0: never expire."""
    return _TTL_S


def set_quarantine_ttl_s(seconds: float) -> None:
    """Set the base quarantine TTL (the JAX package reads it from
    ``REPRO_DISPATCH_QUARANTINE_TTL_S``)."""
    global _TTL_S
    _TTL_S = float(seconds)


def _entry_ttl(fails: int) -> float:
    base = quarantine_ttl_s()
    if base <= 0:
        return float("inf")
    return base * _TTL_BACKOFF ** min(fails - 1, _TTL_MAX_DOUBLINGS)


def quarantine(op: str, impl: str, reason: str = "") -> bool:
    """Denylist ``impl``'s family for ``op`` in this process.  True when this
    starts a new quarantine period (a first failure, or a failed re-probe of
    an expired entry, which doubles the TTL); False when the family is
    already quarantined.  Emits a ``dispatch.quarantine`` instant and bumps
    its counter."""
    global _Q_GEN
    fam = family(impl)
    ent = _QUARANTINE.get((op, fam))
    if ent is not None and not ent.probation:
        return False
    if ent is None:
        ent = _QuarantineEntry(1, 0.0, reason)
        _QUARANTINE[(op, fam)] = ent
    else:
        # failed re-probe: back off exponentially
        ent.fails += 1
        ent.probation = False
        ent.reason = reason or ent.reason
    ent.until = _now() + _entry_ttl(ent.fails)
    _Q_GEN += 1
    _C_QUARANTINE.inc()
    _ot.instant("dispatch.quarantine", op=op, impl=fam,
                reason=reason[:200] if reason else "",
                fails=ent.fails, ttl_s=_entry_ttl(ent.fails),
                denylist=len(_QUARANTINE))
    return True


def _sweep_expired() -> None:
    """Move entries whose TTL elapsed to probation and bump the memo
    generation, so the change shows through the memos."""
    global _Q_GEN
    now = _now()
    for (op, fam), ent in _QUARANTINE.items():
        if not ent.probation and now >= ent.until:
            ent.probation = True
            _Q_GEN += 1
            _ot.instant("dispatch.quarantine_expired", op=op, impl=fam,
                        fails=ent.fails)


def _is_quarantined(op: str, impl: str) -> bool:
    """Actively denylisted (probation entries are eligible again)."""
    ent = _QUARANTINE.get((op, family(impl)))
    return ent is not None and not ent.probation


def _clear_probation(op: str, impl: str) -> None:
    """A guarded execution of a probation family succeeded: it has
    recovered, so its entry goes (the fail count resets)."""
    global _Q_GEN
    fam = family(impl)
    ent = _QUARANTINE.get((op, fam))
    if ent is not None and ent.probation:
        del _QUARANTINE[(op, fam)]
        _Q_GEN += 1
        _ot.instant("dispatch.quarantine_recovered", op=op, impl=fam,
                    fails=ent.fails)


def quarantined(op: Optional[str] = None) -> frozenset:
    """The *active* denylist: ``{(op, family)}`` pairs, or the family names
    of one ``op``.  Probation entries are not listed."""
    if op is None:
        return frozenset(k for k, e in _QUARANTINE.items() if not e.probation)
    return frozenset(f for (o, f), e in _QUARANTINE.items()
                     if o == op and not e.probation)


def quarantine_info(op: str, impl: str) -> Optional[Dict]:
    """``{fails, until, probation, reason}`` of ``impl``'s family, or None
    when it has no entry (never failed, or recovered)."""
    ent = _QUARANTINE.get((op, family(impl)))
    if ent is None:
        return None
    return {"fails": ent.fails, "until": ent.until,
            "probation": ent.probation, "reason": ent.reason}


def clear_quarantine() -> None:
    """Empty the denylist (tests; operator intervention)."""
    global _Q_GEN
    if _QUARANTINE:
        _QUARANTINE.clear()
        _Q_GEN += 1


def run_guarded(key: Union[OpKey, Callable[[], OpKey]], spec: ImplSpec,
                call: Callable[[ImplSpec], object], *,
                param_keys: Optional[Iterable[str]] = None, device=None):
    """``call(spec)`` with quarantine and degradation.

    The ``dispatch.execute`` fault site probes first, then ``call`` runs.
    When it refuses to run (:data:`_RECOVERABLE`), the candidate's family is
    quarantined and ``key`` (an :class:`OpKey`, or a function that forms it,
    called only then) re-resolves on ``device`` without any force, so a
    forced candidate degrades too: on a CUDA device among the hand-written
    kernels alone.  The last refusal is raised once no untried candidate is
    left (where none left is feasible, with the lookup's
    :class:`TuningError` as its cause).  A build or launch failure
    propagates at once.  No synchronization is added: a launch is
    asynchronous, and what goes wrong on the device shows at the next
    synchronizing call.
    """
    tried = set()
    while True:
        try:
            _fault.maybe_fail("dispatch.execute", op=spec.op, impl=spec.name)
            out = call(spec)
        except _build.DeviceError:
            raise
        except _RECOVERABLE as e:
            if callable(key):
                key = key()
            tried.add(spec.name)
            quarantine(key.op, spec.name, reason=f"{type(e).__name__}: {e}")
            try:
                nxt = best_impl(key, param_keys=param_keys, device=device)
            except TuningError as none_left:
                raise e from none_left
            if nxt.name in tried:
                raise
            _C_EXEC_RETRY.inc()
            _ot.instant("dispatch.execute_retry", op=key.op,
                        failed=spec.name, retry=nxt.name)
            spec = nxt
            continue
        if _QUARANTINE:
            # a probation family that just ran has recovered
            _clear_probation(spec.op, spec.name)
        return out


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
    device_type = resolve_device(device).type
    if _QUARANTINE:
        _sweep_expired()
    _C_RESOLVE.inc()
    with _ot.span("dispatch.resolve", token=key.token, op=key.op,
                  phase=key.phase) as sp:
        spec, source = _resolve(key, pk, force, the_db, device_type)
        sp.set(impl=spec.name, source=source)
    if _ot.enabled():
        # every decision is auditable: the winner, its geometry, why it won
        # and the shared memory its launch requests (the JAX package's
        # ``vmem_bytes``)
        _ot.instant(
            "dispatch.decision", op=key.op, token=key.token,
            phase=key.phase, impl=spec.name, source=source,
            geometry="_".join(f"{k}{v}" for k, v in spec.geometry) or "default",
            backend=spec.backend, smem_bytes=int(spec.smem_bytes(key)),
            device=device_type)
    return spec, source


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
    if _QUARANTINE:
        # an expired entry flips to probation (and bumps _Q_GEN) before the
        # memo is read, or a memoized degradation would outlive its TTL
        _sweep_expired()
    memo_key = (site, force, the_db.uid, the_db.generation,
                REGISTRY.generation, _Q_GEN)
    spec = _SITE_MEMO.get(memo_key)
    if spec is not None:
        _C_MEMO_HIT.inc()
    else:
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
    _C_CANDS.inc(len(cands))
    feasible = [s for s in cands if s.feasible(key)[0]]
    if not feasible:
        reasons = {s.name: s.feasible(key)[1] for s in cands}
        raise TuningError(
            f"no candidate for {key.token} executable from params "
            f"{sorted(pk or ())} is feasible on {device_type}: {reasons}")
    if _QUARANTINE:
        # drop the quarantined families (after the device's filter, so the
        # card never falls back to plain PyTorch); probation entries stay
        # eligible, which IS the re-probe.  Where quarantine would leave
        # nothing feasible, the feasible set stays whole and run_guarded
        # raises if the failure recurs.
        alive = [s for s in feasible if not _is_quarantined(key.op, s.name)]
        if alive:
            feasible = alive
    rec = db.get(key.token)
    if rec is not None:
        spec = next((s for s in feasible if s.name == rec.get("impl")), None)
        if spec is not None:
            _C_DB_HIT.inc()
            return spec, "db"
    _C_DB_MISS.inc()
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

    with _ot.span("dispatch.plan_params", profile=bool(profile),
                  phases=",".join(sorted(hints))) as sp:
        for path, op, info in iter_op_layers(params):
            values, idx = info["values"], info["idx"]
            n_tiles, k_kept, tile = (int(s) for s in values.shape[-3:])
            if op == "conv":
                hint = _match_conv_hint(conv_hints, path)
                if hint is None:
                    continue  # no map-shape hint: no conv token to form
                kh, kw, c = info["kh"], info["kw"], info["c_in"]
                h = int(hint["h"])
                plan_key(conv_key(
                    c, h, int(hint.get("w", h)), n_tiles * tile, kh, kw,
                    int(hint.get("stride", 1)), int(hint.get("pad", kh // 2)),
                    k_kept, tile, v=int(hint.get("v", 128)),
                    dtype=values.dtype, batch=int(hint.get("batch", 1))),
                    values.device)
                continue
            # d_in is not stored in the compressed layout; the max kept index
            # bounds it from below and OpKey buckets d_in to a power of two,
            # so this lands in the call site's token whenever the kept rows
            # reach the top half of the reduction dim.
            d_in = int(idx.max()) + 1 if idx.numel() else k_kept
            for ph, rows in hints.items():
                plan_key(linear_key(rows, d_in, n_tiles * tile, k_kept, tile,
                                    dtype=values.dtype, phase=ph),
                         values.device)
        sp.set(planned=len(plan))
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
