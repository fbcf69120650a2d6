"""Native (C++) host-side enumeration, loaded with ctypes.

The port's copy of ``coulombgas_tpu/ops/native``: ``manybody.cpp`` (C ABI
``cg_enumerate_subsets``) is built with the host ``g++`` at first use into
``build/lib_manybody.so`` (``ops/_build.py:BUILD_DIR``, git-ignored; never
beside the source), written to a name of this process and renamed into
place, so processes that build at once each load a whole library.  Where no
``g++`` is on ``PATH`` the caller takes the pure-Python DFS of
``physics/orbitals.py:manybody_orbitals``, and this module says so in one
printed line; a compiler that is present but fails raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import numpy as np

from .._build import BUILD_DIR

__all__ = ["enumerate_subsets", "native_available"]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "manybody.cpp")
_SO = os.path.join(BUILD_DIR, "lib_manybody.so")
_lock = threading.Lock()
_lib = None
_no_compiler = False


def _build() -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    partial = "%s.%d.partial" % (_SO, os.getpid())
    proc = subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", partial],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("g++ failed to build %s:\n%s" % (_SRC, proc.stdout + proc.stderr))
    os.replace(partial, _SO)


def _load():
    """The built library, or None where no ``g++`` is on ``PATH``."""
    global _lib, _no_compiler
    if _lib is not None or _no_compiler:
        return _lib
    with _lock:
        if _lib is not None or _no_compiler:
            return _lib
        if not os.path.isfile(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            if shutil.which("g++") is None:
                _no_compiler = True
                print("coulombgas_tpu_torch.ops.native: no g++ on PATH; enumerating "
                      "many-body states with the Python DFS")
                return None
            _build()
        lib = ctypes.CDLL(_SO)
        lib.cg_enumerate_subsets.restype = ctypes.c_int64
        lib.cg_enumerate_subsets.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ]
        _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def enumerate_subsets(Es: np.ndarray, n: int, Emax_total: int) -> np.ndarray | None:
    """All strictly increasing n-subsets of [0, M) with sum(Es[subset]) <= cutoff.

    Returns an (n_states, n) int64 array (unsorted in energy), or None where
    no ``g++`` is on ``PATH`` (the caller then takes the Python DFS).
    """
    lib = _load()
    if lib is None:
        return None
    Es = np.ascontiguousarray(Es, dtype=np.int64)
    M = Es.size
    ptr = Es.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    count = lib.cg_enumerate_subsets(ptr, M, n, Emax_total, None, 0)
    out = np.empty((count, n), dtype=np.int64)
    filled = lib.cg_enumerate_subsets(
        ptr, M, n, Emax_total, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), count
    )
    if filled != count:
        raise RuntimeError("native enumeration filled %d of %d states" % (filled, count))
    return out
