"""Build CUDA sources with ``nvcc`` into plain-C shared libraries, load them
with ``ctypes``, and count kernel launches.

A library is built at first use into ``build/kernels/`` at the root of the
checkout (listed in ``.gitignore``), named by a hash of its source and
flags, so an edited source rebuilds and an unchanged one is reused. Only
the repository's own sources are compiled.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Sequence

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "..", "..", "..", "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
#: every kernel source of the port
SOURCES = ("spmm_bcsr.cu", "spmm_bcsr_unfused.cu", "gather_rows.cu")

#: launches per kernel name since the last reset; a wrapper adds one where
#: it launches its kernel and nowhere else
launches: Dict[str, int] = {}

_loaded: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def count_launch(name: str) -> None:
    launches[name] = launches.get(name, 0) + 1


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME); the CUDA "
                           "kernels are built from source at first use")
    return path


def library_path(source: str) -> str:
    """Where the library built from ``csrc/<source>`` lives."""
    with open(os.path.join(CSRC, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.abspath(os.path.join(
        BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so"))


def build_all(sources: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every ``csrc/<source>`` whose library does not exist yet, one
    ``nvcc`` per source, all started together; return each library's path.
    A library is written under a temporary name and published with
    ``os.replace``, so a concurrent or interrupted build never leaves a
    truncated file behind. Raises with the compiler's output if any build
    fails."""
    paths = {src: library_path(src) for src in sources}
    running = []
    for src, out in paths.items():
        if os.path.exists(out):
            continue
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
        running.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for src, out, tmp, proc in running:
        _stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) building "
                          f"{src}:\n{stderr}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def build(source: str) -> str:
    """Compile ``csrc/<source>`` unless its library exists; return its
    path."""
    return build_all((source,))[source]


def load_library(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built first if needed."""
    if source not in _loaded:
        _loaded[source] = ctypes.CDLL(build(source))
    return _loaded[source]
