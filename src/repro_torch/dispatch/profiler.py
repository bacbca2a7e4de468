"""Profiler and persistent profile DB (paper §3.3; twin of
``repro/dispatch/profiler.py``).

  * :class:`ProfileDB`: a versioned, environment-fingerprinted JSON store of
    profiling results.  A file written under another GPU, CUDA or torch
    version, another schema, or another digest of the kernels' sources and
    flags, is ignored on load.  Writes are atomic
    (temp file + ``os.replace``), and an in-memory LRU bounds the entries.
  * :func:`profile_op`: times every feasible candidate the device may run
    for an :class:`OpKey` and records the winner, so one pass picks the
    implementation and its geometry together.
  * :func:`device_time_us`: the timer, the device's time of one call.
  * :class:`Tuner`: the deprecated (tile, block_b, block_k) tuner, kept
    for callers of the seed's ``core.tuning``.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import tempfile
import time
from collections import OrderedDict
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from repro_torch._compat import resolve_device
from repro_torch.dispatch.registry import (LINEAR_GEOMETRY, REGISTRY,
                                           ImplSpec, OpKey)
from repro_torch.kernels import _build
from repro_torch.kernels.colwise_nm.kernel import linear_smem_bytes
from repro_torch.obs import metrics as _om
from repro_torch.obs import trace as _ot

_C_PROFILE_RUNS = _om.counter("dispatch.profile_runs")
_C_PROFILED_CANDS = _om.counter("dispatch.profiled_candidates")

SCHEMA_VERSION = 1
DEFAULT_DB_PATH = _build.BUILD_ROOT / "dispatch_profile.json"
TIMER_REPS = 3  # replays (CUDA) or calls (CPU) whose median is the time


class TuningError(RuntimeError):
    """No feasible candidate exists for an operator shape."""


def env_fingerprint() -> Dict[str, str]:
    """Identity of the profiling environment: a profile holds only on the
    card and software that produced it, and only for the kernels it timed
    (``kernels``: the digest the library is built under, which changes with
    any ``.cu``/``.cuh`` source or ``nvcc`` flag; read from the files, so it
    needs no compiler)."""
    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability(0)
        device, capability = torch.cuda.get_device_name(0), f"{major}.{minor}"
    else:
        device, capability = "cpu", ""
    return {"device": device, "capability": capability,
            "cuda": str(torch.version.cuda), "torch": torch.__version__,
            "schema": SCHEMA_VERSION, "kernels": _build._digest()}


def device_time_us(fn: Callable[[], object], iters: int = 20,
                   device=None) -> float:
    """Time of one ``fn()`` in microseconds.

    On a CUDA device, ``iters`` back-to-back calls are captured in one CUDA
    graph and the graph is replayed between two CUDA events
    ``TIMER_REPS`` times; the median replay over ``iters`` is the device's
    time of one call, with the host's launch cost left out and L2 warm, as
    between the layers of a forward.  On the CPU it is the median of
    ``TIMER_REPS`` calls on the host clock.
    """
    dev = resolve_device(device)
    if dev.type != "cuda":
        fn()
        times = []
        for _ in range(TIMER_REPS):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
        return sorted(times)[len(times) // 2]
    with torch.cuda.device(dev):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm up off the capture, as graphs need
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        times = []
        for _ in range(TIMER_REPS):
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e3 / iters)
        del graph
    return sorted(times)[len(times) // 2]


class ProfileDB:
    """Persistent profile store: ``{version, fingerprint, entries}``.

    ``entries`` maps an :attr:`OpKey.token` to a JSON record; every
    :meth:`put` writes the file.  The default path lies under the
    repository's gitignored ``build/repro_torch/``.
    """

    MAX_ENTRIES = 1024  # the LRU's bound
    _uid_counter = 0  # process-unique instance ids (id() can be recycled)

    def __init__(self, path=None):
        self.path = Path(path) if path is not None else DEFAULT_DB_PATH
        self.fingerprint = env_fingerprint()
        self._entries: "OrderedDict[str, Dict]" = OrderedDict()
        self.invalidated = False  # a stale or foreign file was ignored
        self.generation = 0       # bumped on every mutation (memo invalidation)
        ProfileDB._uid_counter += 1
        self.uid = ProfileDB._uid_counter
        self._load()

    def _load(self) -> None:
        if not self.path.exists():
            return
        try:
            data = json.loads(self.path.read_text())
        except (OSError, json.JSONDecodeError):
            self.invalidated = True
            return
        if not isinstance(data, dict) or data.get("version") != SCHEMA_VERSION:
            self.invalidated = True
            return
        if data.get("fingerprint") != self.fingerprint:
            self.invalidated = True
            return
        for k, v in data.get("entries", {}).items():
            self._entries[k] = v

    def save(self) -> None:
        """Atomic write: a temp file in the same directory, then
        ``os.replace``, so a reader never sees a torn file."""
        self.path.parent.mkdir(parents=True, exist_ok=True)
        payload = json.dumps({
            "version": SCHEMA_VERSION,
            "fingerprint": self.fingerprint,
            "entries": dict(self._entries),
        }, indent=1)
        fd, tmp = tempfile.mkstemp(dir=str(self.path.parent),
                                   prefix=self.path.name, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(payload)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def get(self, token: str) -> Optional[Dict]:
        rec = self._entries.get(token)
        if rec is not None:
            self._entries.move_to_end(token)
        return rec

    def put(self, token: str, record: Dict) -> None:
        self._entries[token] = record
        self._entries.move_to_end(token)
        while len(self._entries) > self.MAX_ENTRIES:
            self._entries.popitem(last=False)
        self.generation += 1
        self.save()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, token: str) -> bool:
        return token in self._entries

    def tokens(self) -> List[str]:
        return list(self._entries)


def profile_op(key: OpKey, db: Optional[ProfileDB] = None, *,
               impls: Optional[List[ImplSpec]] = None, iters: int = 20,
               param_keys=None, device=None) -> Dict:
    """Time every feasible candidate for ``key`` that ``device`` (``None``:
    the CUDA card) may run, by :func:`device_time_us`; record and return the
    winner's record ``{"impl", "wall_us", "all": {name: us}}``.  On the card
    that is the hand-written kernels alone wherever the op has one.  A
    candidate that fails to build or launch raises."""
    dev = resolve_device(device)
    if impls is None:
        impls = REGISTRY.candidates(key.op, param_keys=param_keys,
                                    device_type=dev.type)
    feasible = [s for s in impls if s.feasible(key)[0] and s.make_bench]
    if not feasible:
        reasons = {s.name: s.feasible(key)[1] for s in impls}
        raise TuningError(f"no feasible candidate for {key.token}: {reasons}")
    _C_PROFILE_RUNS.inc()
    timings: Dict[str, float] = {}
    with _ot.span("dispatch.profile", token=key.token,
                  candidates=len(feasible)) as psp:
        for spec in feasible:
            with _ot.span("dispatch.profile.candidate", impl=spec.name) as sp:
                timings[spec.name] = device_time_us(
                    spec.make_bench(key, dev), iters=iters, device=dev)
                sp.set(wall_us=timings[spec.name])
            _C_PROFILED_CANDS.inc()
            # each candidate's time as an event of its own, so a trace alone
            # rebuilds the whole race
            _ot.instant("dispatch.candidate_wall", token=key.token,
                        impl=spec.name, wall_us=timings[spec.name])
        winner = min(timings, key=timings.get)
        psp.set(winner=winner, wall_us=timings[winner])
    record = {"impl": winner, "wall_us": timings[winner], "all": timings}
    if db is not None:
        db.put(key.token, record)
    return record


# ---------------------------------------------------------------------------
# DEPRECATED geometry-level tuning shim (the seed's Tuner: tile x block_b x
# block_k).  profile_op over the registry's geometry-pinned candidates
# replaces it; the class stays for callers of ``core.tuning``.  Its block
# grid is the registry's LINEAR_GEOMETRY, and its feasibility the linear
# kernel's shared memory against a Hopper block's, where the JAX package
# weighs VMEM: that predicate does not grow with d_in, so shapes the JAX
# tuner refuses for VMEM are feasible here.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Candidate:
    tile: int
    block_b: int
    block_k: int
    wall_us: Optional[float] = None
    smem_bytes: int = 0
    feasible: bool = True
    score: float = 0.0


def _linear_smem(block_b: int, block_k: int, tile: int) -> int:
    return linear_smem_bytes(tile, block_b, block_k)


def _takes_geometry(tile: int, device: torch.device) -> bool:
    """Whether the linear that ``tile`` routes to on ``device`` takes the
    block geometry: ``colwise_nm_linear.cu`` does; the tiled kernel (a
    multiple of 64 columns) and the plain version do not."""
    from repro_torch.kernels.colwise_nm import TILED_BN

    return device.type == "cuda" and tile % TILED_BN != 0


def _time_tile(batch, d_in, d_out, sparsity, tile, device,
               *geometry) -> float:
    """Device time of the sparse linear at ``tile``: on the card the
    hand-written kernel the tile routes to (the tiled one for a multiple
    of 64 columns, else ``colwise_nm_linear.cu`` at ``geometry``, a
    ``(block_b, block_k)`` pair), on the CPU its plain version."""
    from repro_torch.core.formats import init_compressed
    from repro_torch.core.pruning import SparsityConfig
    from repro_torch.kernels.colwise_nm import (TILED_BN, colwise_nm_matmul,
                                                colwise_nm_matmul_tiled)

    gen = torch.Generator().manual_seed(0)
    x = torch.randn((batch, d_in), generator=gen).to(device)
    cfg = SparsityConfig(sparsity, m=None, tile=tile, format="compressed_xla")
    values, idx = init_compressed(gen, d_in, d_out, cfg, device=device)
    if tile % TILED_BN == 0:
        fn = colwise_nm_matmul_tiled
    elif geometry:
        bb, bk = geometry
        fn = functools.partial(colwise_nm_matmul, block_b=bb, block_k=bk)
    else:
        fn = colwise_nm_matmul
    with torch.no_grad():
        return device_time_us(lambda: fn(x, values, idx), iters=5,
                              device=device)


def enumerate_candidates(d_in: int, d_out: int) -> List[Candidate]:
    tiles = sorted({t for t in (32, 64, 128, 256, 512, d_out)
                    if d_out % t == 0})
    blocks = [(dict(g)["bb"], dict(g)["bk"]) for g in LINEAR_GEOMETRY]
    out = []
    for t in tiles:
        for bb, bk in blocks:
            sm = _linear_smem(bb, bk, t)
            out.append(Candidate(tile=t, block_b=bb, block_k=bk,
                                 smem_bytes=sm,
                                 feasible=sm <= _build.SMEM_BYTES))
    return out


class Tuner:
    """DEPRECATED block-geometry tuner over (tile, block_b, block_k).

    Geometry selection lives in the dispatch candidate space: profile the
    :class:`OpKey` and the winning candidate's ``geometry`` is the tuned
    block.  Backed by a :class:`ProfileDB`, so a pick is versioned,
    fingerprinted and written atomically, and a seed-era cache (a bare
    dict, no version) is dropped on load.  ``profile=True`` times each
    tile on ``device`` (``None``: the CUDA card), and on the card each
    block geometry of a tile that routes to ``colwise_nm_linear.cu``.
    """

    def __init__(self, cache_path=None, device=None):
        self.device = resolve_device(device)
        self.db = ProfileDB(path=cache_path if cache_path is not None
                            else _build.BUILD_ROOT / "tuning_cache.json")
        self.path = self.db.path

    @property
    def cache(self) -> Dict[str, Dict]:
        return dict(self.db._entries)

    def _key(self, batch, d_in, d_out, sparsity) -> str:
        return f"b{batch}_i{d_in}_o{d_out}_s{int(sparsity * 100)}"

    def tune(self, batch: int, d_in: int, d_out: int, sparsity: float = 0.5,
             profile: bool = True) -> Dict:
        """The winning ``{"tile", "block_b", "block_k", "wall_us",
        "smem_bytes"}`` (cached).  ``profile=False`` times nothing and takes
        the feasible candidate of least shared memory, then least tile."""
        key = self._key(batch, d_in, d_out, sparsity)
        cached = self.db.get(key)
        if cached is not None:
            return cached
        cands = enumerate_candidates(d_in, d_out)
        feasible = [c for c in cands if c.feasible]
        if not feasible:
            least = min(c.smem_bytes for c in cands) if cands else 0
            raise TuningError(
                f"no feasible kernel candidate for shape batch={batch}, "
                f"d_in={d_in}, d_out={d_out}, sparsity={sparsity}: smallest "
                f"candidate needs {least} B of shared memory (budget "
                f"{_build.SMEM_BYTES} B)")
        if not profile:
            best = min(feasible, key=lambda c: (c.smem_bytes, c.tile))
        else:
            # a tile routed to colwise_nm_linear.cu on the card is timed at
            # each block geometry; elsewhere the time depends on the tile
            # alone, and within it the geometry of least shared memory
            # scores best
            walls: Dict[tuple, float] = {}
            for c in feasible:
                geo = ((c.block_b, c.block_k)
                       if _takes_geometry(c.tile, self.device) else ())
                if (c.tile, geo) not in walls:
                    walls[(c.tile, geo)] = _time_tile(
                        batch, d_in, d_out, sparsity, c.tile, self.device,
                        *geo)
                c.wall_us = walls[(c.tile, geo)]
                c.score = c.wall_us * (1.0 + c.smem_bytes
                                       / _build.SMEM_BYTES * 0.1)
            best = min(feasible, key=lambda c: c.score)
        result = {"tile": best.tile, "block_b": best.block_b,
                  "block_k": best.block_k, "wall_us": best.wall_us,
                  "smem_bytes": best.smem_bytes}
        self.db.put(key, result)
        return result

    def tuned_tile(self, batch: int, d_in: int, d_out: int,
                   sparsity: float = 0.5) -> int:
        return int(self.tune(batch, d_in, d_out, sparsity)["tile"])
