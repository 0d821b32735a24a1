"""Build CUDA sources with ``nvcc`` into plain-C shared libraries, load them
with ``ctypes``, and count kernel launches.

A library is built at first use into ``build/kernels/`` at the root of the
checkout (listed in ``.gitignore``), named by a hash of its source, of
every header in ``csrc/`` and of the flags, so an edited source or header
rebuilds and an unchanged one is reused. The compiler's report (``ptxas
-v``: registers, spills, shared memory per kernel) is kept beside the
library. Only the repository's own sources are compiled.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "..", "..", "..", "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: what a source may include from ``csrc/``
HEADER_SUFFIXES = (".cuh", ".h")
#: every kernel source of the port
SOURCES = ("spmm_bcsr.cu", "spmm_bcsr_unfused.cu", "gather_rows.cu",
           "flash_attention.cu")

#: launches per kernel name since the last reset; a wrapper adds one where
#: it launches its kernel and nowhere else
launches: Dict[str, int] = {}

_loaded: Dict[str, ctypes.CDLL] = {}
# a serving tier launches from its worker thread while the main thread may
# launch too: one lock keeps the first build and every count exact
_lock = threading.Lock()


def reset_launches() -> None:
    with _lock:
        for name in launches:
            launches[name] = 0


def count_launch(name: str) -> None:
    with _lock:
        launches[name] = launches.get(name, 0) + 1


def cuda_tool(name: str) -> str:
    """The path of a CUDA toolkit program (``nvcc``, ``cuobjdump``): on
    PATH, else under ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``)."""
    path = shutil.which(name)
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(home, "bin", name)
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found (PATH, CUDA_HOME); the CUDA "
                           f"kernels are built from source at first use")
    return path


def library_path(source: str) -> str:
    """Where the library built from ``csrc/<source>`` lives: named by a
    hash of the source, of every header in ``csrc/`` (a source may include
    any of them) and of the flags."""
    digest = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC)
                     if f.endswith(HEADER_SUFFIXES))
    for name in (source, *headers):
        with open(os.path.join(CSRC, name), "rb") as f:
            digest.update(f"{name}\0".encode() + f.read() + b"\0")
    digest.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.abspath(os.path.join(
        BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so"))


def build_log(source: str) -> str:
    """The compiler's report from building ``csrc/<source>`` (empty if
    the library has not been built here)."""
    try:
        with open(library_path(source) + ".log") as f:
            return f.read()
    except FileNotFoundError:
        return ""


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
        cmd = [cuda_tool("nvcc"), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, src)]
        running.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for src, out, tmp, proc in running:
        _stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) building "
                          f"{src}:\n{stderr}")
        else:
            with open(f"{tmp}.log", "w") as f:
                f.write(stderr)
            os.replace(f"{tmp}.log", f"{out}.log")
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def build(source: str) -> str:
    """Compile ``csrc/<source>`` unless its library exists; return its
    path."""
    return build_all((source,))[source]


def load_library(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built first if needed (by
    one thread: others wait for it)."""
    lib = _loaded.get(source)
    if lib is None:
        with _lock:
            if source not in _loaded:
                _loaded[source] = ctypes.CDLL(build(source))
            lib = _loaded[source]
    return lib
