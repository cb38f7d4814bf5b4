"""ctypes binding for the native data loader (``native/dataloader.cpp``).

Port of ``determined_tpu/data/native.py``. The C++ source is the repo's
own host loader (mmap'd shards, splitmix64 row offsets, a prefetch ring
of worker threads); reading it imports nothing of the JAX package. It is
built with ``g++`` at first use into ``determined_tpu_torch/_build/``
(git-ignored), named by a hash of the source and flags, so an edited
source is rebuilt and an unchanged one is built once per checkout; the
library is written under a temporary name and renamed into place, so
processes building at once never load a half-written file. Without a
compiler ``load_library()`` returns None and ``tokens.TokenDataset``
takes the pure-python stream, the same batches bit for bit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

_REPO_ROOT = Path(__file__).resolve().parents[2]
SRC = _REPO_ROOT / "native" / "dataloader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> Path:
    """Where the built library lives (named by source + flags hash)."""
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libdtpu_dataloader-{digest.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    try:
        so = library_path()
    except OSError:  # the source is not in this checkout
        return None
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)
        return so
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library() -> Optional[ctypes.CDLL]:
    """The compiled loader library, or None (→ python fallback)."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        so = _build()
        if so is None:
            _build_failed = True
            return None
        lib = ctypes.CDLL(str(so))
        lib.dl_open.restype = ctypes.c_void_p
        lib.dl_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
        ]
        lib.dl_total_tokens.restype = ctypes.c_uint64
        lib.dl_total_tokens.argtypes = [ctypes.c_void_p]
        lib.dl_next.restype = ctypes.c_int
        lib.dl_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
        lib.dl_skip.restype = None
        lib.dl_skip.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.dl_close.restype = None
        lib.dl_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


class NativeLoader:
    """Thin RAII wrapper over the C handle."""

    def __init__(
        self,
        paths: List[str],
        token_bytes: int,
        batch: int,
        seq: int,
        seed: int = 0,
        shuffle: bool = True,
        n_threads: int = 2,
        queue_depth: int = 4,
    ) -> None:
        lib = load_library()
        if lib is None:
            raise RuntimeError("native loader unavailable (no g++?)")
        self._lib = lib
        arr = (ctypes.c_char_p * len(paths))(
            *[p.encode() for p in paths]
        )
        self._handle = lib.dl_open(
            arr, len(paths), token_bytes, batch, seq,
            ctypes.c_uint64(seed), int(shuffle), n_threads, queue_depth,
        )
        if not self._handle:
            raise ValueError(
                f"dl_open failed (paths readable? enough tokens for seq={seq}?)"
            )
        self.batch = batch
        self.seq = seq

    @property
    def total_tokens(self) -> int:
        return int(self._lib.dl_total_tokens(self._handle))

    def next_into(self, out) -> None:
        """Fill a preallocated int32 numpy array [batch, seq] in place."""
        if not self._handle:
            raise RuntimeError("native loader is closed")
        if out.dtype.name != "int32" or out.shape != (self.batch, self.seq) \
                or not out.flags.c_contiguous:
            raise ValueError(
                f"next_into needs a C-contiguous int32 [{self.batch}, "
                f"{self.seq}] array, got {out.dtype} {out.shape}"
            )
        ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        rc = self._lib.dl_next(self._handle, ptr)
        if rc != 0:
            raise RuntimeError("dl_next failed (loader closed?)")

    def skip(self, n_batches: int) -> None:
        self._lib.dl_skip(self._handle, ctypes.c_uint64(n_batches))

    def close(self) -> None:
        if self._handle:
            self._lib.dl_close(self._handle)
            self._handle = None

    def __del__(self) -> None:  # best-effort; explicit close preferred
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass
