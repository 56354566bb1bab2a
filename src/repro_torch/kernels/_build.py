"""Build-at-first-use of the CUDA sources under ``csrc/`` into one shared
library with a plain C interface, loaded with ``ctypes``.

Each ``.cu`` is compiled by its own ``nvcc`` process (all started together)
for ``sm_90a`` and the objects are linked into ``libcrossbar_<hash>.so`` under
``build/repro_torch/`` at the root of the checkout,
keyed by a hash of the sources and flags, so an unchanged tree reuses its
library and a changed source rebuilds.  A failed build raises; nothing
falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
last_build_seconds: Optional[float] = None  # None: library was found built


def build_dir() -> str:
    root = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))
    return os.path.join(root, "build", "repro_torch")


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the CUDA "
        "kernels are built from source at first use and cannot run without it"
    )


def _sources():
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh"))
    )


def _source_hash(paths) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _compile(paths, out: str) -> None:
    nvcc = nvcc_path()
    work = out + f".{os.getpid()}.tmp"
    os.makedirs(work, exist_ok=True)
    try:
        units = [p for p in paths if p.endswith(".cu")]
        objs = [os.path.join(work, os.path.basename(p) + ".o") for p in units]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(units, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        for src, proc, log in zip(units, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n{log}")
        lib_tmp = os.path.join(work, "lib.so")
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", lib_tmp, *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {link.returncode}):\n{link.stdout}")
        os.replace(lib_tmp, out)  # atomic: a concurrent build sees all or nothing
    finally:
        shutil.rmtree(work, ignore_errors=True)


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _LIB, last_build_seconds
    with _LOCK:
        if _LIB is not None:
            return _LIB
        paths = _sources()
        out = os.path.join(build_dir(), f"libcrossbar_{_source_hash(paths)}.so")
        if not os.path.isfile(out):
            os.makedirs(os.path.dirname(out), exist_ok=True)
            t0 = time.perf_counter()
            _compile(paths, out)
            last_build_seconds = time.perf_counter() - t0
        _LIB = ctypes.CDLL(out)
        return _LIB
