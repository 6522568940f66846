"""Build and load the port's CUDA kernels.

Each source under ``kernels/csrc/`` is compiled by ``nvcc`` into a shared
library with a plain C interface, for ``sm_90a``, at first use, and loaded
with ``ctypes``.  Libraries go to ``<repo>/build/kernels/``, named by a
hash of the source and the flags, so an edited source is rebuilt and an unchanged one is reused within
a checkout.  Nothing here falls back: a missing ``nvcc`` or a failed
compile raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

__all__ = ["build_dir", "nvcc_path", "compile_source", "load", "BUILD_LOG"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> {"seconds": build wall (0.0 when reused), "log": nvcc output}
BUILD_LOG: dict = {}
_LOADED: dict = {}
_LOCK = threading.Lock()


def build_dir() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source with the CUDA toolkit's nvcc")


def compile_source(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists;
    returns the library path."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = build_dir()
    lib = out_dir / f"lib{name}-{digest}.so"
    if lib.exists():
        BUILD_LOG[name] = {"seconds": 0.0, "log": "reused " + str(lib)}
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".lib{name}-{digest}.{os.getpid()}.so"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {src}:\n{log}")
    os.replace(tmp, lib)
    BUILD_LOG[name] = {"seconds": seconds, "log": log}
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(compile_source(name)))
            _LOADED[name] = lib
        return lib
