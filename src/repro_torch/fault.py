"""Deterministic, seeded fault injection (twin of ``repro/fault.py``).

Named **fault sites** planted at the runtime's failure boundaries probe
:func:`maybe_fail`, and a **fault plan** installed by :func:`install` or
:func:`fault_scope` decides which probes raise a typed
:class:`InjectedFault`.  Everything is deterministic under a seed, so a
chaos run that found a leak replays bit for bit.

  * **Free when off.**  Every probe first reads one module-global bool;
    with no plan installed (the default) ``maybe_fail`` returns at once.
  * **Arguments, not environment.**  The JAX package also arms a plan from
    ``REPRO_FAULTS``/``REPRO_FAULTS_SEED`` at import; the port reads no
    environment variable, so a plan is installed by argument (the serve
    launcher's ``--faults SPEC --faults-seed N``).
  * **Observable.**  Every injection emits a ``fault.inject`` obs instant
    and bumps the ``fault.injected`` counter.

Schedule grammar (comma-separated entries)::

    site[@match]:kind=value

  ``site``   one of :data:`SITES`.  An unknown site still parses and arms,
             but the first plan entry or probe naming one warns once and
             bumps ``fault.unknown_site``: a misspelled site never fires;
  ``match``  optional filter: the entry applies only to probes whose
             context (the ``**ctx`` of :func:`maybe_fail`) holds the value,
             e.g. ``dispatch.execute@compressed_tiled:n=1``;
  ``kind``   ``iter=K`` fire on the entry's K-th matching probe (0-based);
             ``n=K``    fire on the first K matching probes;
             ``p=F``    fire each matching probe with probability F, drawn
                        from the plan's ``random.Random(seed)``.

The plan's RNG is Python's, as in the JAX package, so the same spec, seed
and sequence of probes fire on the same probes in both packages.

Fault sites (the JAX package's eight; see ``docs/robustness.md``):

    ``page_pool.alloc``   PagePool.alloc / PagePool.grow, before any mutation
    ``dispatch.execute``  dispatch.run_guarded, before each candidate runs
    ``kernel.paged_attn`` the paged-attention call inside run_guarded
    ``scheduler.iter``    top of each scheduler iteration
    ``train.step``        top of each trainer step
    ``ckpt.write``        checkpoint save, before any file is written
    ``ckpt.rename``       after a complete tmp dir, before the atomic rename
    ``data.batch``        data-pipeline batch materialization

Every site probes on every call here: the JAX package probes
``dispatch.execute`` and ``kernel.paged_attn`` at trace time only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import warnings
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.obs import metrics as _om
from repro_torch.obs import trace as _ot

__all__ = [
    "SITES", "InjectedFault", "FaultRule", "FaultPlan", "parse_spec",
    "enabled", "plan", "install", "uninstall", "fault_scope", "maybe_fail",
]

SITES: Tuple[str, ...] = (
    "page_pool.alloc",
    "dispatch.execute",
    "kernel.paged_attn",
    "scheduler.iter",
    "train.step",
    "ckpt.write",
    "ckpt.rename",
    "data.batch",
)

_C_INJECTED = _om.counter("fault.injected")
_C_UNKNOWN_SITE = _om.counter("fault.unknown_site")
_WARNED_UNKNOWN: Set[str] = set()
_SITE_SET = frozenset(SITES)


def _note_unknown_site(site: str, where: str) -> None:
    """Warn once per unknown site (plan entries and armed probes)."""
    if site in _SITE_SET or site in _WARNED_UNKNOWN:
        return
    _WARNED_UNKNOWN.add(site)
    _C_UNKNOWN_SITE.inc()
    _ot.instant("fault.unknown_site", site=site, where=where)
    warnings.warn(
        f"fault site {site!r} ({where}) is not registered in fault.SITES; "
        f"a misspelled site never fires", RuntimeWarning, stacklevel=3)


class InjectedFault(RuntimeError):
    """Raised by an armed fault site.  Carries the site name, the 1-based
    injection ordinal at that site, and the probe's context kwargs."""

    def __init__(self, site: str, hit: int, ctx: Optional[Dict] = None):
        self.site = site
        self.hit = hit
        self.ctx = dict(ctx or {})
        detail = f" {self.ctx}" if self.ctx else ""
        super().__init__(f"injected fault at {site} (hit #{hit}){detail}")


@dataclasses.dataclass
class FaultRule:
    """One parsed schedule entry.  ``seen``/``fired`` count *matching*
    probes, so ``iter``/``n`` schedules on a filtered rule count only the
    probes the filter admits."""

    site: str
    match: Optional[str] = None
    iters: frozenset = frozenset()
    n: int = 0
    p: float = 0.0
    seen: int = 0
    fired: int = 0

    def applies(self, ctx: Dict) -> bool:
        if self.match is None:
            return True
        return any(self.match == str(v) for v in ctx.values())

    def wants(self, rng: random.Random) -> bool:
        """Advance this rule's probe counter; True if it schedules a fault
        now.  A ``p`` rule always draws, so the draw sequence does not depend
        on other rules firing."""
        i = self.seen
        self.seen += 1
        fire = i in self.iters or i < self.n
        if self.p > 0.0:
            fire = (rng.random() < self.p) or fire
        return fire


class FaultPlan:
    """A set of :class:`FaultRule` plus the seeded RNG and hit bookkeeping
    (``probes`` and ``fired``: per-site counts)."""

    def __init__(self, rules: List[FaultRule], seed: int = 0,
                 spec: str = ""):
        self.rules = list(rules)
        self.seed = int(seed)
        self.spec = spec
        self._rng = random.Random(self.seed)
        self.probes: Dict[str, int] = {}
        self.fired: Dict[str, int] = {}

    def probe(self, site: str, ctx: Dict) -> None:
        """Count one probe of ``site``; raise :class:`InjectedFault` if any
        matching rule schedules a fault for it."""
        self.probes[site] = self.probes.get(site, 0) + 1
        hit: Optional[FaultRule] = None
        for rule in self.rules:
            if rule.site != site or not rule.applies(ctx):
                continue
            if rule.wants(self._rng) and hit is None:
                hit = rule
        if hit is None:
            return
        hit.fired += 1
        self.fired[site] = self.fired.get(site, 0) + 1
        _C_INJECTED.inc()
        _ot.instant("fault.inject", site=site, hit=self.fired[site],
                    rule=hit.match or "*", **{k: str(v) for k, v in ctx.items()})
        raise InjectedFault(site, self.fired[site], ctx)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"FaultPlan({self.spec!r}, seed={self.seed}, fired={self.fired})"


def parse_spec(spec: str, seed: int = 0) -> FaultPlan:
    """Parse the schedule grammar into a :class:`FaultPlan`."""
    rules: List[FaultRule] = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        site, sep, sched = entry.partition(":")
        if not sep or not site:
            raise ValueError(
                f"fault entry {entry!r}: expected 'site:kind=value'")
        match = None
        if "@" in site:
            site, match = site.split("@", 1)
            if not site or not match:
                raise ValueError(f"fault entry {entry!r}: bad '@' filter")
        kind, sep, value = sched.partition("=")
        if not sep:
            raise ValueError(f"fault entry {entry!r}: expected 'kind=value'")
        try:
            if kind == "iter":
                rule = FaultRule(site, match, iters=frozenset({int(value)}))
            elif kind == "n":
                rule = FaultRule(site, match, n=int(value))
            elif kind == "p":
                rule = FaultRule(site, match, p=float(value))
            else:
                raise ValueError(
                    f"fault entry {entry!r}: unknown schedule kind {kind!r} "
                    f"(use iter=K, n=K, or p=F)")
        except (TypeError, ValueError) as e:
            if "unknown schedule kind" in str(e):
                raise
            raise ValueError(f"fault entry {entry!r}: bad value {value!r}")
        if rule.p < 0.0 or rule.p > 1.0:
            raise ValueError(f"fault entry {entry!r}: p outside [0, 1]")
        _note_unknown_site(rule.site, "plan entry")
        rules.append(rule)
    return FaultPlan(rules, seed=seed, spec=spec)


# module-global fast path: maybe_fail reads one bool while injection is off
_ENABLED: bool = False
_PLAN: Optional[FaultPlan] = None


def enabled() -> bool:
    """Is a fault plan armed?"""
    return _ENABLED


def plan() -> Optional[FaultPlan]:
    """The armed plan (its ``probes``/``fired`` counts are what a chaos
    run asserts against), or None."""
    return _PLAN


def install(spec, seed: Optional[int] = None) -> FaultPlan:
    """Arm a fault plan process-wide.  ``spec`` is a grammar string or a
    ready :class:`FaultPlan`; returns the installed plan."""
    global _ENABLED, _PLAN
    if isinstance(spec, FaultPlan):
        p = spec
    else:
        p = parse_spec(str(spec), seed=0 if seed is None else seed)
    _PLAN = p
    _ENABLED = bool(p.rules)
    return p


def uninstall() -> None:
    """Disarm injection (probes return to the one-bool fast path)."""
    global _ENABLED, _PLAN
    _ENABLED = False
    _PLAN = None


@contextlib.contextmanager
def fault_scope(spec, seed: int = 0):
    """Arm ``spec`` inside this scope only, restoring the previous plan (or
    the disarmed state) on exit.  Yields the :class:`FaultPlan`."""
    global _ENABLED, _PLAN
    prev = (_ENABLED, _PLAN)
    p = install(spec, seed=seed)
    try:
        yield p
    finally:
        _ENABLED, _PLAN = prev


def maybe_fail(site: str, **ctx) -> None:
    """Probe a fault site: a no-op unless a plan is armed; raises
    :class:`InjectedFault` when the armed plan schedules a fault here."""
    if not _ENABLED:
        return
    _note_unknown_site(site, "probe")
    _PLAN.probe(site, ctx)
