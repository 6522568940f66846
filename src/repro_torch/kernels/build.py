"""Build and load the port's CUDA kernels.

Each ``.cu`` source under ``kernels/csrc/`` is compiled by ``nvcc`` into a
shared library with a plain C interface, for ``sm_90a``, at first use, and
loaded with ``ctypes``.  Libraries go to ``<repo>/build/kernels/``, named by
a hash of the source, of every ``csrc/`` header it includes, and of the
flags, so an edited source or header is rebuilt and an unchanged one is
reused within a checkout.  ``compile_all`` runs one ``nvcc`` per source, all
at once.  Nothing here falls back: a missing ``nvcc`` or a failed compile
raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

__all__ = ["build_dir", "nvcc_path", "compile_source", "compile_all", "load",
           "source_digest", "BUILD_LOG", "SOURCES"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
# every kernel source of the port, by name (csrc/<name>.cu)
SOURCES = ("abft_matmul", "abft_matmul_acc", "abft_matmul_grouped",
           "checksum_encode", "flash_attention", "tf32_split")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> {"seconds": build wall (0.0 when reused), "log": nvcc output}
BUILD_LOG: dict = {}
_LOADED: dict = {}
_LOCK = threading.Lock()
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.M)


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


def _local_includes(path: pathlib.Path, seen: set) -> None:
    """Add ``path`` and every file it reaches by ``#include "..."``,
    resolved beside the including file, to ``seen`` (system headers in
    <...> are not followed)."""
    if path in seen:
        return
    seen.add(path)
    for inc in _INCLUDE.findall(path.read_text()):
        dep = (path.parent / inc).resolve()
        if dep.is_file():
            _local_includes(dep, seen)


def source_digest(name: str) -> str:
    """Hash of ``csrc/<name>.cu``, the local headers it includes (by name
    and content, in a fixed order) and the nvcc flags."""
    seen: set = set()
    _local_includes((CSRC / f"{name}.cu").resolve(), seen)
    h = hashlib.sha256()
    for path in sorted(seen):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def compile_source(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists;
    returns the library path."""
    src = CSRC / f"{name}.cu"
    digest = source_digest(name)
    out_dir = build_dir()
    lib = out_dir / f"lib{name}-{digest}.so"
    if lib.exists():
        # keep the entry of a build made earlier in this process
        BUILD_LOG.setdefault(name, {"seconds": 0.0,
                                    "log": "reused " + str(lib)})
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


def compile_all(names) -> dict:
    """Compile several sources at once, one ``nvcc`` each; returns
    {name: library path}.  Raises the first failure."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(compile_source, names)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(compile_source(name)))
            _LOADED[name] = lib
        return lib
