"""Build, load and launch the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects are linked into one shared library with
a plain C interface that is loaded with ``ctypes``.  The library lands in
``build/repro_torch/<digest>/`` at the repository root, where ``digest``
hashes the sources and flags, so an edited source builds anew and an
unchanged one is reused.  Nothing is built when a module is imported: the
first launch builds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "librepro_torch_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "toolkit is needed to build the port's kernels")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sum(_sources(), []):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile and link the kernels unless this digest is already built.
    Returns the library's path; the compiler's output (``-Xptxas -v``:
    registers, shared memory, spills) is kept beside it in ``build.log``."""
    lib = BUILD_ROOT / _digest() / LIB_NAME
    if lib.exists():
        return lib
    nvcc = nvcc_path()
    sources, _ = _sources()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    procs = []
    try:
        t0 = time.perf_counter()
        for src in sources:
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
                   str(tmp / (src.stem + ".o"))]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp / LIB_NAME),
             *(str(tmp / (s.stem + ".o")) for s in sources)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
        log.append(f"== built in {time.perf_counter() - t0:.1f} s")
        lib.parent.mkdir(parents=True, exist_ok=True)
        (tmp / "build.log").write_text("\n".join(log))
        os.replace(tmp / "build.log", lib.parent / "build.log")
        os.replace(tmp / LIB_NAME, lib)
    finally:
        for _src, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


class CudaKernel:
    """One kernel of the shared library: its C entry point, where it comes
    from, and how many times it has been launched.

    ``launches`` rises by one for every successful launch and nowhere else,
    so a caller can reset it, run a path, and see which kernels it used.
    """

    def __init__(self, name: str, symbol: str, argtypes: Sequence, *,
                 source: str, replaces: str):
        self.name = name
        self.symbol = symbol
        self.argtypes = [*argtypes, ctypes.c_void_p]  # + the CUDA stream
        self.source = source
        self.replaces = replaces
        self.launches = 0

    @functools.cached_property
    def _fn(self):
        """The C entry point, built and typed at the first launch."""
        fn = getattr(load_library(), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        return fn

    def launch(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream; raise on any CUDA error
        the launch reports.  Does not synchronise."""
        if len(args) + 1 != len(self.argtypes):
            raise TypeError(f"{self.name} takes {len(self.argtypes) - 1} "
                            f"arguments, got {len(args)}")
        with torch.cuda.device(device):
            err = self._fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            msg = load_library().repro_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err} "
                               f"({msg})")
        self.launches += 1


def check_cuda_tensor(name: str, t: torch.Tensor, dtypes, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of one of ``dtypes``
    with ``ndim`` dimensions: what every kernel wrapper accepts."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must have dtype in {dtypes}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_compressed(values: torch.Tensor, idx: torch.Tensor,
                     dtype: torch.dtype, block_k: int, smem_per_row: int) -> None:
    """Checks shared by the sparse-GEMM wrappers: ``values``/``idx`` on the
    card in the packed layout, and one ``block_k`` chunk of staged rows
    (``smem_per_row`` bytes each) within a block's shared memory."""
    check_cuda_tensor("values", values, (dtype,), 3)
    check_cuda_tensor("idx", idx, (torch.int32,), 2)
    if tuple(idx.shape) != tuple(values.shape[:2]):
        raise ValueError(f"idx {tuple(idx.shape)} does not match values "
                         f"{tuple(values.shape)}")
    if block_k <= 0 or block_k * smem_per_row > SMEM_BYTES:
        raise ValueError(f"block_k={block_k} needs {block_k * smem_per_row} "
                         f"bytes of shared memory; at most {SMEM_BYTES}")


FLOAT_DTYPES = (torch.float32, torch.bfloat16)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}  # csrc/common.cuh
SMEM_BYTES = 227 * 1024  # shared memory one Hopper block may use
