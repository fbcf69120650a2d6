"""How many times each hand-written kernel ran on the device, and what the
optimizer's apply did on the host, in one place.

``launches[name]`` counts the runs of kernel ``name`` in this process.  A
wrapper adds one where it launches its kernel (``launched``); a call made
while its stream is being captured into a CUDA graph launches nothing and
adds nothing.  What a captured graph runs is read from the graph itself:
``graph_launches`` counts its kernel nodes by the kernel each one runs, and
each replay adds that count (``replayed``).

``events[name]`` counts how often something happened on the host
(``count``): ``sr.lu_fallbacks``, the float64 SR's damped Cholesky solves
that found the matrix not positive definite and fell to LU.
``spans[name]`` holds the host seconds and calls of a timed region
(``timed``): ``sr.solve``, an epoch's damped solves of both Fisher blocks.
"""

from __future__ import annotations

import contextlib
import ctypes
import re
import time

import torch

__all__ = ["launches", "launched", "reset", "kernel_counter", "graph_kernels",
           "graph_launches", "replayed", "events", "count", "spans", "timed"]

# Each counter's kernel symbol (csrc/): the depth-2 closure kernel's two
# counters are its instantiations without and with the Laplacian, told apart
# by its last template argument, LAP.
SYMBOLS = {"flow_u_jac": "cg_flow_jac_kernel", "fused_logp": "cg_fused_logp_kernel",
           "chol_logdet": "cg_chol_logdet_kernel", "flow_u_jac_large": "cg_flow_large_kernel",
           "flow_u_jac_d2": "cg_flow_d2_rows_kernel",
           "flow_u_jac_lap_d2": "cg_flow_d2_rows_kernel"}

launches = dict.fromkeys(SYMBOLS, 0)
events = {"sr.lu_fallbacks": 0}
spans = {}  # name -> {"seconds": s, "calls": k}


def launched(name: str):
    """Count one launch of kernel ``name`` on the current stream; nothing
    while that stream is captured (the graph's replays count it)."""
    if not torch.cuda.is_current_stream_capturing():
        launches[name] += 1


def reset():
    for name in launches:
        launches[name] = 0
    for name in events:
        events[name] = 0
    spans.clear()


def count(name: str):
    """Count one host event ``name``."""
    events[name] = events.get(name, 0) + 1


@contextlib.contextmanager
def timed(name: str):
    """Add the host seconds of the enclosed block and one call to
    ``spans[name]``.  Nothing here waits for the device: where the block
    reads no result back, the seconds are those of its launches."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        span = spans.setdefault(name, {"seconds": 0.0, "calls": 0})
        span["seconds"] += time.perf_counter() - t0
        span["calls"] += 1


def replayed(counts: dict):
    """Count one replay of a graph that runs ``counts`` (``graph_launches``)."""
    for name, k in counts.items():
        launches[name] += k


def kernel_counter(symbol: str) -> str | None:
    """The counter of the kernel named ``symbol`` (mangled, as the CUDA
    driver API names it, or demangled); None for a kernel that is not counted."""
    m = re.match(r"_Z(\d+)", symbol)
    if m:  # _Z <length> <name> [I <template arguments> E] <parameters>
        end = m.end() + int(m.group(1))
        name = symbol[m.end():end]
        args = re.match(r"I((?:L[a-z]+n?\d+E)*)E", symbol[end:])
        lap = bool(args) and args.group(1).endswith("Lb1E")
    else:  # [void ]<name>[<template arguments>](<parameters>)
        m = re.match(r"(?:void\s+)?(\w+)(?:<([^<>]*)>)?", symbol)
        name = m.group(1)
        lap = bool(m.group(2)) and m.group(2).replace(" ", "").endswith(",true")
    if name == SYMBOLS["flow_u_jac_d2"]:
        return "flow_u_jac_lap_d2" if lap else "flow_u_jac_d2"
    return next((c for c, s in SYMBOLS.items() if s == name), None)


class _KernelNodeParams(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


_KERNEL_NODE = 0  # CU_GRAPH_NODE_TYPE_KERNEL
_libcuda = []


def _cu():
    if not _libcuda:
        _libcuda.append(ctypes.CDLL("libcuda.so.1"))
    return _libcuda[0]


def _call(name: str, *args):
    code = getattr(_cu(), name)(*args)
    if code != 0:
        raise RuntimeError("%s failed with CUresult %d" % (name, code))


def graph_kernels(graph) -> list[str]:
    """The symbol of the kernel each kernel node of ``graph`` runs, a
    ``torch.cuda.CUDAGraph(keep_graph=True)`` after its capture, read
    through the CUDA driver API."""
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    _call("cuGraphGetNodes", g, None, ctypes.byref(count))
    nodes = (ctypes.c_void_p * count.value)()
    _call("cuGraphGetNodes", g, nodes, ctypes.byref(count))
    symbols = []
    for node in nodes:
        node = ctypes.c_void_p(node)
        kind = ctypes.c_int(-1)
        _call("cuGraphNodeGetType", node, ctypes.byref(kind))
        if kind.value != _KERNEL_NODE:
            continue
        params = _KernelNodeParams()
        _call("cuGraphKernelNodeGetParams_v2", node, ctypes.byref(params))
        name = ctypes.c_char_p()
        if params.func:
            _call("cuFuncGetName", ctypes.byref(name), ctypes.c_void_p(params.func))
        else:
            _call("cuKernelGetName", ctypes.byref(name), ctypes.c_void_p(params.kern))
        symbols.append(name.value.decode())
    return symbols


def graph_launches(graph) -> dict:
    """What one replay of ``graph`` runs, by counter (``graph_kernels``)."""
    counts = dict.fromkeys(launches, 0)
    for symbol in graph_kernels(graph):
        name = kernel_counter(symbol)
        if name is not None:
            counts[name] += 1
    return counts
