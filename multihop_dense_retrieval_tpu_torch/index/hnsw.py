"""ctypes binding for the native HNSW index (``native/hnsw.cpp``).

The host tier of approximate MIPS: the counterpart of the reference's
``--hnsw`` mode and of the JAX package's ``index/hnsw.py``, over the same
C++ source, so a graph file written by either binding loads in the other.
The card's exact kernels (``ops/mips.py``) are the serving path; this tier
serves an index kept in host RAM.

The shared library is compiled at first use with
``g++ -O3 -std=c++17 -shared -fPIC`` (plus ``-fopenmp`` and ``-mavx2
-mfma`` where they work) into ``_build/`` beside this file, a git-ignored
directory of the port; the JAX binding's ``native/libhnsw.so`` is never
written.  The file name carries a hash of the source and the flags, and
each build compiles to a per-process temporary name and renames it into
place, so processes racing on a fresh checkout never load a half-written
library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parents[2] / "native" / "hnsw.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
BASE_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lib = None
_lib_lock = threading.Lock()


def _host_simd_flags() -> list:
    """[-mavx2 -mfma] when the host CPU has both (the JAX binding's rule:
    the same inner products, bit for bit, faster), else []."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    flags = set(line.split(":", 1)[1].split())
                    if "avx2" in flags and "fma" in flags:
                        return ["-mavx2", "-mfma"]
                    break
    except OSError:
        pass
    return []


def library_path() -> Path:
    """Build the library if needed; return its path (under BUILD_DIR)."""
    src = SRC.read_bytes()
    simd = _host_simd_flags()
    variants = ([simd + ["-fopenmp"], ["-fopenmp"], simd, []]
                if simd else [["-fopenmp"], []])
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    last_err = ""
    for flags in variants:
        tag = hashlib.sha256(src + " ".join(BASE_FLAGS + flags).encode()
                             ).hexdigest()[:12]
        lib = BUILD_DIR / f"libhnsw-{tag}.so"
        if lib.exists():
            return lib
        tmp = BUILD_DIR / f"libhnsw-{tag}.so.{os.getpid()}.tmp"
        cmd = ["g++", *BASE_FLAGS, "-o", str(tmp), str(SRC), *flags]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
        except FileNotFoundError as e:
            raise RuntimeError("cannot build the HNSW library: g++ is not "
                               "on PATH") from e
        except subprocess.CalledProcessError as e:
            last_err = e.stderr.decode()
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, lib)
        return lib
    raise RuntimeError(f"cannot build the HNSW library:\n{last_err}")


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(library_path()))
        vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fp = ctypes.POINTER(ctypes.c_float)
        for name, args, res in (
                ("hnsw_new", [i, i, i, ctypes.c_uint64], vp),
                ("hnsw_free", [vp], None),
                ("hnsw_add_batch", [vp, i64, fp], None),
                ("hnsw_size", [vp], i64),
                ("hnsw_search_batch", [vp, i64, fp, i, i,
                                       ctypes.POINTER(i64), fp], None),
                ("hnsw_save", [vp, ctypes.c_char_p], i),
                ("hnsw_load", [ctypes.c_char_p], vp),
                ("hnsw_has_openmp", [], i),
                ("hnsw_max_threads", [], i)):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        _lib = lib
        return lib


def openmp_info() -> Tuple[bool, int]:
    """(compiled with OpenMP, max threads): the build and a batched search
    run multi-threaded when True, race-free within one call."""
    lib = _load()
    return bool(lib.hnsw_has_openmp()), int(lib.hnsw_max_threads())


class _SharedExclusiveLock:
    """Readers-writer lock: searches share, adds exclude everything.
    Writer-preferring, so a stream of searches cannot starve an add."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    @contextmanager
    def shared(self):
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                if not self._readers:
                    self._cond.notify_all()

    @contextmanager
    def exclusive(self):
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writer = True
        try:
            yield
        finally:
            with self._cond:
                self._writer = False
                self._cond.notify_all()


class HNSWIndex:
    """Approximate MIPS over host RAM: ``add`` then ``search``, as FAISS.

    Concurrent ``search`` calls run in parallel; ``add`` takes the lock
    exclusively, because the native insert reallocates the buffers a
    concurrent search reads (ctypes releases the GIL)."""

    def __init__(self, dim: int, M: int = 32, ef_construction: int = 200,
                 seed: int = 0, _handle=None):
        self._lib = _load()
        self.dim = dim
        self._lock = _SharedExclusiveLock()
        self._h = _handle if _handle is not None else self._lib.hnsw_new(
            dim, M, ef_construction, seed)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.hnsw_free(self._h)
            self._h = None

    def __len__(self) -> int:
        with self._lock.shared():
            return int(self._lib.hnsw_size(self._h))

    def add(self, vectors: np.ndarray):
        v = np.ascontiguousarray(vectors, np.float32)
        if v.ndim != 2 or v.shape[1] != self.dim:
            raise ValueError(f"vectors {v.shape}, index dim {self.dim}")
        with self._lock.exclusive():
            self._lib.hnsw_add_batch(
                self._h, v.shape[0],
                v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))

    def search(self, queries: np.ndarray, k: int,
               ef_search: int = 128) -> Tuple[np.ndarray, np.ndarray]:
        """(scores (B, k) fp32 inner products, ids (B, k) int64); an id is
        -1 where the index holds fewer than k rows."""
        q = np.ascontiguousarray(queries, np.float32)
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise ValueError(f"queries {q.shape}, index dim {self.dim}")
        nq = q.shape[0]
        ids = np.empty((nq, k), np.int64)
        scores = np.empty((nq, k), np.float32)
        with self._lock.shared():
            self._lib.hnsw_search_batch(
                self._h, nq, q.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                k, ef_search,
                ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return scores, ids

    def save(self, path: str):
        with self._lock.shared():          # save reads; add excludes it
            rc = self._lib.hnsw_save(self._h, path.encode())
        if rc != 0:
            raise IOError(f"hnsw_save failed: {path}")

    @classmethod
    def load(cls, path: str, dim: Optional[int] = None) -> "HNSWIndex":
        """A graph file of either binding.  ``dim``, when given, must be
        the file's: the native handle strides queries by the file's."""
        with open(path, "rb") as f:
            file_dim = struct.unpack("<i", f.read(4))[0]
        if dim is not None and dim != file_dim:
            raise ValueError(f"index file has dim={file_dim}, caller "
                             f"expected {dim}")
        lib = _load()
        h = lib.hnsw_load(path.encode())
        if not h:
            raise IOError(f"hnsw_load failed: {path}")
        return cls(file_dim, _handle=h)
