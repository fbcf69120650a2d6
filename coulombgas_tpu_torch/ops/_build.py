"""Builds the CUDA sources under ``csrc/`` with ``nvcc`` and loads them.

Each ``csrc/<name>.cu`` becomes ``build/lib<name>.so`` (in the directory that
holds the package, listed in ``.gitignore``): a shared library with a plain C
interface, loaded with ``ctypes``.  No PyTorch header is included, so a build
takes seconds.  A library is built at first use, or all at once and in
parallel by ``build_all``.  A build or load failure raises: nothing falls
back to another implementation.

``nvcc`` writes to a name of its own process and the finished library is
renamed into place, so processes that build at once (the ranks of a
multi-GPU run reaching their first launch together) each load a whole
library, never a half-written one.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

__all__ = ["KERNEL_SOURCES", "build_all", "load_library", "check_launch",
           "SMEM_LIMIT_BYTES"]

KERNEL_SOURCES = ("flow_jac", "fused_logp", "chol_logdet", "flow_d2", "flow_large")

# Shared memory one block may use on Hopper (dynamic, after opt-in).
SMEM_LIMIT_BYTES = 232448

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin)")


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, name + ".cu")


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, "lib%s.so" % name)


def _partial_path(name: str) -> str:
    return "%s.%d.partial" % (library_path(name), os.getpid())


def _command(name: str) -> list[str]:
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", _partial_path(name), source_path(name),
    ]


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not os.path.isfile(lib):
        return True
    newest = max(os.path.getmtime(os.path.join(CSRC_DIR, f))
                 for f in os.listdir(CSRC_DIR))
    return os.path.getmtime(lib) < newest


def build_all(names=KERNEL_SOURCES, force: bool = False) -> dict[str, str]:
    """Compile the named sources, all ``nvcc`` processes started together.

    Returns ``{name: compiler output}`` (register and shared-memory use from
    ``-Xptxas -v``) for the libraries that were built.  Raises on failure.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {
        name: subprocess.Popen(_command(name), stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
        for name in names if force or _stale(name)
    }
    logs, failed = {}, []
    for name, proc in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(_partial_path(name), library_path(name))
    if failed:
        raise RuntimeError("nvcc failed for %s:\n%s" % (
            ", ".join(failed), "\n".join(logs[n] for n in failed)))
    return logs


def load_library(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``; builds it first if needed."""
    if name not in _LIBS:
        build_all((name,))
        _LIBS[name] = ctypes.CDLL(library_path(name))
    return _LIBS[name]


def check_launch(code: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launcher."""
    if code != 0:
        raise RuntimeError("%s: CUDA launch failed with error code %d" % (what, code))
