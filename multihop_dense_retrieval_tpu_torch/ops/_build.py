"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into ``_build/lib<name>-<hash>.so``
(``_build/`` sits beside this file and is git-ignored) with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

The hash covers the source and the headers it may include, so an edited
kernel rebuilds.  ``build_all`` starts one ``nvcc`` per source at once and
waits for all of them.  Every C entry point returns ``cudaGetLastError()``
as an int; ``check`` raises on a non-zero code.  Nothing here runs at import
time: the CPU tests import every module and have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("mips_scan", "mips_scan_mma", "mips_scan_i8", "two_phase",
           "chunk_max_mma", "chunk_max_i8", "rescan_mma", "fused_attention",
           "encoder_fused")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
F = ctypes.c_float
# argtypes of every C entry point: pointers and streams are c_void_p
SIGNATURES = {
    "mips_scan": {
        "mips_scan_topk": ([P, P, P, P, I, I, LL, LL, I, I, LL, I, I,
                            P, P, P, P, P], I),
    },
    "two_phase": {
        "chunk_max": ([I, P, P, P, I, LL, LL, I, I, I, P, P], I),
        "rescan": ([I, P, P, P, P, I, I, I, I, LL, P, P], I),
    },
    "mips_scan_mma": {
        "mips_scan_mma": ([P, P, I, LL, LL, I, I, I, I, LL, I, LL, P, P, P,
                           P, P], I),
    },
    "mips_scan_i8": {
        "mips_scan_i8": ([P, P, P, P, I, LL, LL, I, I, I, I, LL, I, LL, P,
                          P, P, P, P], I),
    },
    "chunk_max_mma": {
        "chunk_max_mma": ([P, P, I, LL, LL, I, I, I, LL, I, I, P, P], I),
    },
    "chunk_max_i8": {
        "chunk_max_i8": ([P, P, P, I, LL, LL, I, I, I, LL, I, I, P, P], I),
    },
    "rescan_mma": {
        "rescan_mma": ([I, P, P, P, P, I, I, LL, LL, I, I, I, I, I, I, LL,
                        P, P], I),
    },
    "fused_attention": {
        "fused_attention": ([I, I, I, P, P, P, P, I, I, I, I, I, F, LL, P,
                             P], I),
        "attention_divide": ([P, P, P, I, P], I),
    },
    "encoder_fused": {
        "bias_gelu": ([I, I, P, P, P, LL, I, P], I),
        "masked_softmax": ([I, I, P, P, P, LL, I, I, F, P], I),
        "add_layer_norm": ([I, I, P, P, P, LL, P, P, P, LL, I, F, F, P], I),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}   # nvcc's output (register/smem use) per source


def _nvcc() -> str:
    cand = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cand.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cand.append("/usr/local/cuda/bin/nvcc")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the port's CUDA kernels build with "
                       "the CUDA toolkit on the GPU host")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=SOURCES) -> float:
    """Compile every missing library, one nvcc process per source, all
    started together.  Returns the wall seconds spent."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, p in procs:
        log, _ = p.communicate()
        BUILD_LOG[name] = log
        if p.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {p.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LIBS[name] = lib
    return lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
