r"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with
``nvcc`` for ``sm_90a`` into ``_build/<name>-<hash>.so`` inside the package
(a directory ``.gitignore`` lists), loaded with ``ctypes``. The hash covers
the source, every shared header ``csrc/*.cuh`` and the flags, so an edited
source or header is rebuilt and an unchanged one is loaded as it is. Nothing
is built when a module is imported: the kernel wrappers call :func:`load` on
their first launch, and :func:`build_all` compiles every source at once, one
``nvcc`` process each, all started together. :func:`host_library` builds a
host C++ source with ``g++`` into the same directory, keyed the same way.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Iterable, List

from .. import trace

__all__ = ["CSRC", "BUILD_DIR", "SOURCES", "NVCC_FLAGS", "HOST_FLAGS",
           "library_path", "build_all", "load", "host_library"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("lstm_scan", "geometry_tail", "serve_scan", "lstm_cell_batched")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
HOST_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (searched PATH and $CUDA_HOME/bin): "
                       "the CUDA kernels build only on a host with the CUDA "
                       "toolkit")


def _keyed_path(name: str, sources: List[str], flags) -> str:
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in sources:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def library_path(name: str) -> str:
    r"""Where ``csrc/<name>.cu`` builds to, keyed by its content, the
    shared headers' and the flags."""
    return _keyed_path(name, [os.path.join(CSRC, f"{name}.cu")] + sorted(
        glob.glob(os.path.join(CSRC, "*.cuh"))), NVCC_FLAGS)


def host_library(src: str) -> str:
    r"""Build the host C++ source ``src`` with ``g++`` into
    ``_build/<stem>-<hash>.so`` (keyed by its content and ``HOST_FLAGS``,
    written to a temporary file and renamed into place, so that processes
    building at once never see a partial library); returns its path.
    Raises ``OSError`` without ``g++`` and ``CalledProcessError`` when the
    compile fails."""
    out = _keyed_path(os.path.splitext(os.path.basename(src))[0], [src],
                      HOST_FLAGS)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *HOST_FLAGS, src, "-o", tmp], check=True,
                       capture_output=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _start(name: str):
    r"""Start ``nvcc`` for one source into a temporary file; returns
    ``(process, tmp_path, final_path)`` or ``None`` when already built."""
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names: Iterable[str] = SOURCES) -> List[str]:
    r"""Compile the named sources in parallel (one ``nvcc`` each) and return
    their library paths. Raises with the compiler's output if one fails."""
    names = list(names)
    jobs = [(n, _start(n)) for n in names]
    errors = []
    for name, job in jobs:
        if job is None:
            continue
        proc, tmp, out = job
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [library_path(n) for n in names]


def load(name: str) -> ctypes.CDLL:
    r"""The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            with trace.span("native.build"):
                lib = ctypes.CDLL(build_all([name])[0])
            _LOADED[name] = lib
        return lib
