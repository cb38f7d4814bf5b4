"""Build and bind the port's CUDA kernels.

Each ``ops/csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds, not minutes)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<hash>.so csrc/<name>.cu

Libraries land in ``determined_tpu_torch/_build/`` (git-ignored), named by
a hash of the sources and flags, so an edited kernel is rebuilt and an
unchanged one is built once per checkout. A kernel is built at its first
launch in a process; ``build_all`` builds every kernel at once, one
``nvcc`` per source started together (``chip_smoke.py`` uses it). The
``-Xptxas -v`` report (registers, shared memory, spills) is kept beside
each library as ``<name>-<hash>.log``.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
wrapper raises ``CudaKernelError`` when that is not 0. Nothing here is
imported or built when the module is imported: the CPU tests import every
module of the port.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


class CudaKernelError(RuntimeError):
    """A kernel failed to build, load or launch."""


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise CudaKernelError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


class CudaKernel:
    """One ``csrc/<name>.cu`` library: built at first use, bound through
    ctypes, with a plain launch counter. ``launches`` rises by one where
    the library's kernel is launched, and nowhere else."""

    def __init__(self, name: str, symbol: str, argtypes: Sequence) -> None:
        self.name = name
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._err = None
        self._lock = threading.Lock()

    @property
    def source(self) -> Path:
        return CSRC / f"{self.name}.cu"

    def library_path(self) -> Path:
        digest = _digest([self.source, *sorted(CSRC.glob("*.cuh"))])
        return BUILD_DIR / f"{self.name}-{digest}.so"

    def _start_build(self) -> Optional[subprocess.Popen]:
        """Start nvcc for this library unless it is already built."""
        out = self.library_path()
        if out.exists():
            return None
        nvcc = _nvcc()
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        with open(out.with_suffix(".log"), "w") as log:
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                 str(self.source)],
                stdout=log, stderr=subprocess.STDOUT,
            )
        proc.tmp_path = tmp  # type: ignore[attr-defined]
        return proc

    def _finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:
            return
        rc = proc.wait()
        out = self.library_path()
        if rc != 0:
            log = out.with_suffix(".log").read_text()
            raise CudaKernelError(
                f"nvcc failed for {self.source.name} (exit {rc}):\n{log}"
            )
        os.replace(proc.tmp_path, out)  # type: ignore[attr-defined]

    def _bind(self) -> None:
        lib = ctypes.CDLL(str(self.library_path()))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = lib.dtpu_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn, self._err = fn, err

    def load(self) -> None:
        with self._lock:
            if self._fn is None:
                self._finish_build(self._start_build())
                self._bind()

    def launch(self, *args) -> None:
        """Call the C entry point (it launches on the given stream and
        returns cudaGetLastError()); raise if the launch was refused."""
        if self._fn is None:
            self.load()
        rc = self._fn(*args)
        if rc != 0:
            msg = self._err(rc).decode(errors="replace")
            raise CudaKernelError(f"{self.name}: launch failed ({rc}: {msg})")
        self.launches += 1

    def ptxas_report(self) -> List[str]:
        """The -Xptxas -v lines naming each kernel (mangled), its
        registers, spills and shared memory, from this library's build
        log."""
        log = self.library_path().with_suffix(".log")
        if not log.exists():
            return []
        return [
            line.strip() for line in log.read_text().splitlines()
            if "registers" in line or "spill" in line
            or "Function properties for" in line
        ]


FLASH_FWD = CudaKernel(
    "flash_fwd", "dtpu_flash_fwd",
    [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
     _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
     _I, _I, _I, _F, _P],
)
PAGED_ATTENTION = CudaKernel(
    "paged_attention", "dtpu_paged_attention",
    [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
     _L, _L, _L, _F, _P],
)
FLASH_FWD_MONO = CudaKernel(
    "flash_fwd_mono", "dtpu_flash_fwd_mono",
    [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
     _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _I, _F, _P],
)
FLASH_BWD_MONO = CudaKernel(
    "flash_bwd_mono", "dtpu_flash_bwd_mono",
    [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
     _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _I, _F, _P],
)
#: The three blocked backward kernels share one C signature
#: (``DTPU_BLOCKED_BWD_ARGS`` in ``csrc/blocked_bwd.cuh``); the 12 strides
#: go as a pointer to a host array.
_BLOCKED_BWD_ARGS = [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _P, _I, _I, _I, _F, _P]
FLASH_BWD_BLOCKED = CudaKernel(
    "flash_bwd_blocked", "dtpu_flash_bwd_blocked", _BLOCKED_BWD_ARGS)
FLASH_BWD_DQ = CudaKernel("flash_bwd_dq", "dtpu_flash_bwd_dq",
                          _BLOCKED_BWD_ARGS)
FLASH_BWD_DKV = CudaKernel("flash_bwd_dkv", "dtpu_flash_bwd_dkv",
                           _BLOCKED_BWD_ARGS)
KERNELS: Dict[str, CudaKernel] = {
    k.name: k for k in (FLASH_FWD, PAGED_ATTENTION, FLASH_FWD_MONO,
                        FLASH_BWD_MONO, FLASH_BWD_BLOCKED, FLASH_BWD_DQ,
                        FLASH_BWD_DKV)
}


def build_all() -> float:
    """Build every kernel library, one nvcc per source started together;
    returns the wall seconds taken (0 when all were already built)."""
    t0 = time.perf_counter()
    procs = [(k, k._start_build()) for k in KERNELS.values()]
    for k, proc in procs:
        k._finish_build(proc)
    for k in KERNELS.values():
        k.load()
    return time.perf_counter() - t0


def _digest(sources: Sequence[Path]) -> str:
    """The nvcc flags and `sources` (names and bytes), hashed."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def sources_digest() -> str:
    """A digest of every source ``nvcc`` compiles here (``csrc/*.cu`` and
    ``*.cuh``) and of the flags: it changes whenever a library's hash
    name does, so a cache keyed by it (``ops/flash_autotune.py``) goes
    stale when a kernel is redesigned."""
    return _digest(sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]))


def dtype_code(dtype: torch.dtype) -> int:
    """The C entry points' dtype switch: 0 = float32, 1 = bfloat16."""
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise ValueError(
        f"CUDA attention kernels take float32 or bfloat16, got {dtype}"
    )


#: Head dims the kernels are instantiated for.
HEAD_DIMS = (16, 32, 64, 128)


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
