"""Atomic, async, *integrity-verified* checkpointing (twin of
``repro/train/checkpoint.py``, with the same files on disk, so each package
restores the other's checkpoints).

Checkpoints store trees of tensors keyed by tree path, the key spelled as
JAX's ``keystr`` spells it (``name|['blocks'][0]['conv1']['values']``),
plus a JSON metadata blob (step, data-pipeline state, config provenance).

Write protocol (all inside ``<dir>/tmp.<step>.<pid>``, then one atomic
rename to ``<dir>/step_<k>``):

    1. ``arrays.npz``     the payload.  numpy has no bfloat16, so a bf16
                          tensor is written as 2-byte void records (its
                          bits) and the manifest records the logical dtype;
                          it is read back through int16, never through a
                          numpy bfloat16 dtype.
    2. ``meta.json``      caller metadata + step + wall time.
    3. ``manifest.json``  written LAST: per-array crc32 + dtype + shape and
                          the byte size of ``arrays.npz``.  Its presence is
                          the commit marker: a directory without a parseable
                          manifest (torn write, preempted writer, truncated
                          copy) is *invalid* and restore skips it.

A preempted writer can therefore never corrupt the latest checkpoint, and a
corrupted directory (bit rot, partial copy) is detected rather than
restored: :meth:`CheckpointManager.restore` falls back to the newest *valid*
step, and :meth:`latest_step` reports only valid directories.

Saves may run on a daemon thread (``blocking=False``).  The host copies of
the tensors are taken in :meth:`save` before the thread starts, so the
thread only writes files and a step that runs meanwhile cannot change what
is written.  An exception in the thread (disk full, a failed rename) is
kept and re-raised from :meth:`wait` or the next :meth:`save`.  Orphaned
``tmp.*`` directories from writers that died mid-save are removed at
startup and after every successful save.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zipfile
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import fault as _fault
from repro_torch._tree import keystr, leaves_with_path, tree_map_with_path
from repro_torch.obs import metrics as _om
from repro_torch.obs import trace as _ot

ARRAYS = "arrays.npz"
META = "meta.json"
MANIFEST = "manifest.json"
MANIFEST_FORMAT = 1

_C_SAVED = _om.counter("ckpt.saved")
_C_INVALID = _om.counter("ckpt.invalid_skipped")
_C_TMP_GC = _om.counter("ckpt.tmp_gc")

# logical dtypes numpy lacks: stored as void records of their width, read
# back through the integer dtype of that width
_BITS_VIEW = {"bfloat16": (torch.bfloat16, torch.int16, np.int16)}


class CheckpointError(RuntimeError):
    """A checkpoint directory failed integrity validation."""


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as numpy, bf16 as 2-byte void records."""
    t = t.detach().to("cpu", copy=True)
    name = _dtype_name(t.dtype)
    if name in _BITS_VIEW:
        _, int_dt, _ = _BITS_VIEW[name]
        return t.view(int_dt).numpy().view(f"V{t.element_size()}")
    return t.numpy()


def _flatten(tree) -> Dict[str, Tuple[np.ndarray, str]]:
    """``keystr -> (host array, logical dtype name)``."""
    return {keystr(path): (_host_array(leaf), _dtype_name(leaf.dtype))
            for path, leaf in leaves_with_path(tree)}


def _as_tensor(v: np.ndarray, name: str, where: str) -> torch.Tensor:
    """The array ``v`` read from an npz as a tensor of the logical dtype
    ``name``; raises :class:`CheckpointError` where the stored dtype
    cannot hold it."""
    if name in _BITS_VIEW:
        torch_dt, _, np_int = _BITS_VIEW[name]
        if v.dtype.itemsize != np.dtype(np_int).itemsize or v.dtype.kind != "V":
            raise CheckpointError(f"{where} stored as {v.dtype}, manifest "
                                  f"says {name}")
        return torch.from_numpy(np.asarray(v, order="C").view(np_int)).view(torch_dt)
    want = np.dtype(name)
    if v.dtype != want:
        # void records of the same width carry the bits of a dtype numpy
        # degraded on write; view restores the logical dtype
        if v.dtype.kind == "V" and v.dtype.itemsize == want.itemsize:
            v = v.view(want)
        else:
            raise CheckpointError(f"{where} stored as {v.dtype}, manifest "
                                  f"says {want}")
    return torch.from_numpy(np.asarray(v, order="C"))


def _unflatten_like(proto, arrays: Dict[str, torch.Tensor], *, cast: bool = False):
    """Rebuild ``proto``'s structure from ``arrays``, each leaf on the
    proto leaf's device, validating shape AND dtype per leaf.  A checkpoint
    whose dtype differs from the proto (bf16 checkpoint into an f32 model
    or vice versa) raises unless ``cast=True`` explicitly opts into the
    conversion."""

    def load(path, leaf):
        key = keystr(path)
        if key not in arrays:
            raise KeyError(f"checkpoint missing {key}")
        t = arrays[key]
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt "
                             f"{tuple(t.shape)} vs model {tuple(leaf.shape)}")
        if t.dtype != leaf.dtype:
            if not cast:
                raise ValueError(
                    f"dtype mismatch for {key}: ckpt {_dtype_name(t.dtype)} "
                    f"vs model {_dtype_name(leaf.dtype)} (pass cast=True to "
                    f"opt into the conversion)")
            t = t.to(leaf.dtype)
        return t.to(leaf.device)

    return tree_map_with_path(load, proto)


def _array_entry(v: np.ndarray, name: str) -> Dict[str, Any]:
    return {
        "dtype": name,
        "shape": list(v.shape),
        "crc32": zlib.crc32(np.ascontiguousarray(v).tobytes()),
    }


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # any tmp.* at startup is an orphan from a writer that died mid-save
        self._gc_tmp()

    # -- save -----------------------------------------------------------
    def save(self, step: int, trees: Dict[str, Any], metadata: Optional[Dict] = None,
             blocking: bool = True):
        """trees: name -> tree of tensors (e.g. {'params': ..., 'opt': ...}).

        Serializes against any in-flight async save first, which also
        re-raises a previous async failure: a dying writer is never silent.
        """
        self.wait()
        payload, dtypes = {}, {}
        for name, tree in trees.items():
            for k, (v, dt) in _flatten(tree).items():
                payload[f"{name}|{k}"] = v
                dtypes[f"{name}|{k}"] = dt
        meta = dict(metadata or {}, step=step, time=time.time())

        def write():
            _fault.maybe_fail("ckpt.write", step=step)
            tmp = self.dir / f"tmp.{step}.{os.getpid()}"
            tmp.mkdir(parents=True, exist_ok=True)
            np.savez(tmp / ARRAYS, **payload)
            (tmp / META).write_text(json.dumps(meta))
            # manifest last: its presence commits the directory as complete
            manifest = {
                "format": MANIFEST_FORMAT,
                "step": step,
                "arrays_bytes": (tmp / ARRAYS).stat().st_size,
                "arrays": {k: _array_entry(v, dtypes[k])
                           for k, v in payload.items()},
            }
            (tmp / MANIFEST).write_text(json.dumps(manifest))
            _fault.maybe_fail("ckpt.rename", step=step)
            final = self.dir / f"step_{step:08d}"
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)  # atomic on POSIX
            _C_SAVED.inc()
            _ot.instant("ckpt.save", step=step, arrays=len(payload),
                        bytes=manifest["arrays_bytes"])
            self._gc()

        if blocking:
            write()
        else:
            def guarded():
                try:
                    write()
                except BaseException as e:  # noqa: BLE001 - surfaced on wait
                    self._error = e

            self._thread = threading.Thread(target=guarded, daemon=True)
            self._thread.start()

    def wait(self):
        """Join any in-flight async save; re-raise its failure if it died."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc_tmp(self):
        """Remove orphaned ``tmp.*`` write directories.  Safe whenever no
        writer is in flight (saves serialize through :meth:`wait`)."""
        for t in self.dir.glob("tmp.*"):
            shutil.rmtree(t, ignore_errors=True)
            _C_TMP_GC.inc()

    def _gc(self):
        self._gc_tmp()
        # keep the newest `keep` VALID checkpoints: invalid (torn/corrupt)
        # directories neither count against the budget nor shield a valid
        # one from staying restorable
        valid = [d for d in sorted(self.dir.glob("step_*")) if self.validate(d) is None]
        for old in valid[: -self.keep]:
            shutil.rmtree(old, ignore_errors=True)

    # -- validation -------------------------------------------------------
    def validate(self, d: Path, deep: bool = False) -> Optional[str]:
        """Why ``d`` is not a restorable checkpoint, or None if it is.

        Shallow (default): manifest parses, files exist, ``arrays.npz`` has
        the committed byte size; catches torn writes and truncation without
        reading array data.  ``deep=True`` additionally re-reads every array
        and checks crc32/dtype/shape against the manifest (the restore path).
        """
        try:
            manifest = json.loads((d / MANIFEST).read_text())
        except (OSError, ValueError):
            return "missing or unparseable manifest.json"
        if not isinstance(manifest.get("arrays"), dict):
            return "manifest has no arrays table"
        if not (d / META).is_file():
            return "missing meta.json"
        try:
            size = (d / ARRAYS).stat().st_size
        except OSError:
            return "missing arrays.npz"
        if size != manifest.get("arrays_bytes"):
            return (f"arrays.npz is {size} bytes, manifest committed "
                    f"{manifest.get('arrays_bytes')}")
        if not deep:
            return None
        try:
            self._load_arrays(d, manifest)
        except (CheckpointError, OSError, ValueError) as e:
            return str(e)
        return None

    def _load_arrays(self, d: Path, manifest: Dict) -> Dict[str, torch.Tensor]:
        """Load + integrity-check every array against the manifest; returns
        CPU tensors of the manifest's logical dtypes."""
        try:
            with np.load(d / ARRAYS, allow_pickle=False) as z:
                arrays = {k: z[k] for k in z.files}
        except (OSError, ValueError, zlib.error, zipfile.BadZipFile) as e:
            raise CheckpointError(f"unreadable arrays.npz in {d.name}: {e}")
        out = {}
        for key, ent in manifest["arrays"].items():
            if key not in arrays:
                raise CheckpointError(f"{d.name}: array {key!r} missing")
            v = arrays[key]
            t = _as_tensor(v, ent["dtype"], f"{d.name}: {key!r}")
            if tuple(v.shape) != tuple(ent["shape"]):
                raise CheckpointError(
                    f"{d.name}: {key!r} shape {v.shape} vs manifest "
                    f"{tuple(ent['shape'])}")
            if zlib.crc32(np.ascontiguousarray(v).tobytes()) != ent["crc32"]:
                raise CheckpointError(f"{d.name}: {key!r} checksum mismatch")
            out[key] = t
        return out

    # -- restore ----------------------------------------------------------
    def _step_dirs(self) -> List[Path]:
        return sorted(self.dir.glob("step_*"), reverse=True)

    def valid_steps(self) -> List[int]:
        """Steps of every (shallow-)valid checkpoint, newest first."""
        return [int(d.name.split("_")[1]) for d in self._step_dirs()
                if self.validate(d) is None]

    def latest_step(self) -> Optional[int]:
        """Newest *valid* step (torn/corrupt directories are skipped)."""
        steps = self.valid_steps()
        return steps[0] if steps else None

    def restore(self, step: Optional[int], protos: Dict[str, Any], *,
                cast: bool = False) -> Tuple[Dict[str, Any], Dict]:
        """protos: name -> tree of tensors (structure, shape, dtype and
        device source). Returns (trees, metadata).

        ``step=None`` restores the newest checkpoint that passes deep
        integrity validation, skipping any torn or corrupted newer
        directory; an explicit ``step`` that fails validation raises
        :class:`CheckpointError`.  ``cast=True`` opts into dtype conversion
        when the checkpoint and proto dtypes differ.
        """
        if step is not None:
            d = self.dir / f"step_{step:08d}"
            if not d.is_dir():
                raise FileNotFoundError(f"no checkpoint for step {step} in {self.dir}")
            reason = self.validate(d)
            if reason is not None:
                raise CheckpointError(f"checkpoint {d.name} invalid: {reason}")
            manifest = json.loads((d / MANIFEST).read_text())
            arrays = self._load_arrays(d, manifest)
            return self._build(d, arrays, protos, cast)
        tried = []
        for d in self._step_dirs():
            reason = self.validate(d)
            if reason is None:
                try:
                    manifest = json.loads((d / MANIFEST).read_text())
                    arrays = self._load_arrays(d, manifest)
                    return self._build(d, arrays, protos, cast)
                except CheckpointError as e:
                    reason = str(e)
            tried.append(f"{d.name}: {reason}")
            _C_INVALID.inc()
            _ot.instant("ckpt.invalid", dir=d.name, reason=reason[:200])
        if tried:
            raise CheckpointError(
                f"no valid checkpoint in {self.dir}; skipped: {tried}")
        raise FileNotFoundError(f"no checkpoints in {self.dir}")

    def _build(self, d: Path, arrays: Dict[str, torch.Tensor],
               protos: Dict[str, Any], cast: bool) -> Tuple[Dict[str, Any], Dict]:
        meta = json.loads((d / META).read_text())
        out = {}
        for name, proto in protos.items():
            sub = {
                k.split("|", 1)[1]: v for k, v in arrays.items() if k.startswith(name + "|")
            }
            out[name] = _unflatten_like(proto, sub, cast=cast)
        return out, meta
