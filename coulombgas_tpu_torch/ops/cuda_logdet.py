"""Batched log det of small SPD matrices on the GPU — hand-written CUDA.

Counterpart of ``coulombgas_tpu/ops/pallas_logdet.py``.  The kernel
(``csrc/chol_logdet.cu``) runs persistent groups of warps, each eliminating
one matrix at a time in shared memory in panels of 8 columns: every warp of
the group factors the panel for its share of the rows in registers, then
the group subtracts the panel's product from the trailing block in register
tiles.  One number per matrix leaves.  Its plain version is
``ops.logdet.chol_logdet_ref``.

The launch plan (``k3_plan``: warps a group, groups a block, shared bytes,
grid) is computed here, from the matrix size and the card's SM count, and
checked by the C launcher, which refuses a plan it cannot run.  So the plan
and ``chol_logdet_fits`` answer without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import counters
from ._build import SMEM_LIMIT_BYTES, check_launch, load_library
from .logdet import chol_logdet_ref

__all__ = ["chol_logdet_cuda", "chol_logdet_plain", "chol_logdet_fits",
           "K3Plan", "k3_plan", "k3_plans", "k3_schedule", "k3_smem_bytes", "K3_MAX_M"]


# The plain PyTorch version of the kernel, same signature.
chol_logdet_plain = chol_logdet_ref

# The kernel's limits (csrc/chol_logdet.cu): m <= 256 (a lane holds at most
# 8 slots of panel rows), a block at most 256 threads; panels of 8 columns.
K3_MAX_M = 256
K3_NB = 8
K3_BLOCK = 256
# One SM of the card (Hopper): shared memory (each block also takes 1 KB of
# it), threads, registers; and the H100 SXM's SM count.  A block of this
# kernel reserves all 16 named barriers (its barrier ids are run-time values),
# and the runtime then holds at most 4 blocks an SM
# (cudaOccupancyMaxActiveBlocksPerMultiprocessor on the H100).
SM_SMEM_BYTES = 233472
SM_BLOCK_RESERVED = 1024
SM_THREADS = 2048
SM_REGS = 65536
K3_BLOCKS_PER_SM = 4
H100_SMS = 132


class K3Plan(NamedTuple):
    """A launch of the kernel: ``warps`` a group (one matrix at a time),
    ``groups`` a block, ``smem`` bytes a block, ``grid`` blocks, and the
    blocks an SM holds by the plan's own count (``blocks_per_sm``)."""
    m: int
    batch: int
    warps: int
    groups: int
    smem: int
    grid: int
    blocks_per_sm: int


def k3_matrix_floats(m: int) -> int:
    """Floats of one matrix packed by rows of 4 x 4 tiles (cg_k3_matrix_floats)."""
    t = (m + 3) // 4
    return 8 * t * (t + 1)


def k3_row(r: int) -> int:
    """Offset of row r in the packed matrix (cg_k3_row): row 4t + i holds
    columns 0 .. 4t + 3."""
    t = r // 4
    return 8 * t * (t + 1) + (r % 4) * 4 * (t + 1)


def k3_smem_bytes(m: int, groups: int) -> int:
    """Shared bytes of a block (cg_chol_logdet_smem): per group a packed
    matrix and the panel's columns U and V."""
    mp = 4 * ((m + 3) // 4)
    return 4 * groups * (k3_matrix_floats(m) + 2 * K3_NB * mp)


def k3_slots(m: int, warps: int) -> int:
    """Slots of 32 panel rows a lane holds (cg_k3_slots): lanes 8..31 of the
    first take 24 rows a warp, each further slot 32 a warp."""
    below = 4 * ((m + 3) // 4) - 8 - 24 * warps
    return 1 + -(-below // (32 * warps)) if below > 0 else 1


def _register_cap(m: int, warps: int) -> int:
    """Registers a thread under the instantiation's ``__launch_bounds__``:
    256 threads and 4, 3 or 2 blocks an SM by the panel's slots a lane."""
    slots = k3_slots(m, warps)
    min_blocks = 4 if slots <= 2 else 3 if slots <= 4 else 2
    return SM_REGS // (K3_BLOCK * min_blocks) // 8 * 8


def k3_warps(m: int) -> int:
    """Warps a group by m: one up to 64 (no barrier but the warp's own), 4 up
    to 128, 8 above."""
    return 1 if m <= 64 else 4 if m <= 128 else 8


def _blocks_per_sm(m: int, warps: int, groups: int) -> int:
    threads = 32 * warps * groups
    smem = k3_smem_bytes(m, groups)
    if smem > SMEM_LIMIT_BYTES:
        return 0
    return min(SM_SMEM_BYTES // (smem + SM_BLOCK_RESERVED), SM_THREADS // threads,
               SM_REGS // (threads * _register_cap(m, warps)), K3_BLOCKS_PER_SM)


def k3_plans(m: int, batch: int, sms: int = H100_SMS, warps: int | None = None) -> list[K3Plan]:
    """Every plan the kernel can run for ``batch`` m x m matrices on a card of
    ``sms`` SMs: ``warps`` a group (all of 1, 2, 4 and 8 if None) and each
    count of groups a block that fits; the grid is the blocks the batch
    needs, at most those resident.  Raises ``ValueError`` where m is past the
    kernel or ``warps`` is not a group's size."""
    if not 0 <= m <= K3_MAX_M:
        raise ValueError("m = %d is past the kernel's limit of %d" % (m, K3_MAX_M))
    if warps is not None and not 1 <= warps <= K3_BLOCK // 32:
        raise ValueError("warps = %d" % warps)
    plans = []
    for w in (1, 2, 4, 8) if warps is None else (warps,):
        gmax = K3_BLOCK // (32 * w) if w == 1 else min(K3_BLOCK // (32 * w), 15)
        for g in range(1, gmax + 1):
            bps = _blocks_per_sm(m, w, g)
            if bps >= 1:
                grid = max(1, min(-(-batch // g), sms * bps))
                plans.append(K3Plan(m, batch, w, g, k3_smem_bytes(m, g), grid, bps))
    return plans


def k3_plan(m: int, batch: int, sms: int = H100_SMS) -> K3Plan:
    """The launch plan for ``batch`` m x m matrices on a card of ``sms`` SMs.

    Of ``k3_plans`` with ``k3_warps(m)`` warps a group, the one of least cost
    in matrix times: the matrices of the busiest SM (blocks go to the SMs in
    turn), or the matrices a group takes one after the other times the
    groups that fill an SM (16 warps, where a matrix is latency-bound),
    whichever is larger; of equal costs the fewest groups a block.  Raises
    ``ValueError`` where m is past the kernel."""
    w = k3_warps(m)

    def cost(p):
        load = [0] * sms
        for gg, mats in enumerate(k3_schedule(p)):
            load[gg // p.groups % sms] += len(mats)
        return max(max(load), -(-batch // (p.grid * p.groups)) * max(1, 16 // w)), p.groups

    return min(k3_plans(m, batch, sms, w), key=cost)


def k3_schedule(plan: K3Plan) -> list[list[int]]:
    """The matrices each group eliminates, in its order, as the kernel walks
    them: group g = block * groups + its index in the block takes g, g + G,
    g + 2G, ... with G = grid * groups."""
    G = plan.grid * plan.groups
    return [list(range(g, plan.batch, G)) for g in range(G)]


def chol_logdet_fits(m: int, device=None) -> bool:
    """Whether the wrapper takes an m x m matrix on ``device`` (default:
    CUDA): for the kernel m <= ``K3_MAX_M``, one matrix and its panel within
    a block's shared memory (answered without the library).  On a CPU device
    the wrapper takes its plain version, which takes any size."""
    if device is not None and torch.device(device).type == "cpu":
        return True
    return 0 <= m <= K3_MAX_M


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library("chol_logdet")
    lib.cg_chol_logdet.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    lib.cg_chol_logdet.restype = ctypes.c_int
    lib.cg_chol_logdet_smem.argtypes = [ctypes.c_int] * 2
    lib.cg_chol_logdet_smem.restype = ctypes.c_int
    lib.cg_chol_logdet_occupancy.argtypes = [ctypes.c_int] * 3
    lib.cg_chol_logdet_occupancy.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _plan(m: int, batch: int, device_index: int) -> K3Plan:
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return k3_plan(m, batch, sms)


def occupancy(plan: K3Plan) -> int:
    """Blocks of ``plan`` resident on one SM as the CUDA runtime counts them
    (registers of the built instantiation included); needs the library."""
    return _lib().cg_chol_logdet_occupancy(plan.m, plan.warps, plan.groups)


def _launch(A, plan: K3Plan):
    """One launch of the kernel on A (batch, m, m), f32, contiguous, on CUDA,
    under ``plan``, which must be for A's m and batch (the wrapper's cached
    ``k3_plan``; the smoke and ``scripts/compare_kernels_torch.py`` also run
    the other plans of ``k3_plans``)."""
    B, m, _ = A.shape
    if (plan.m, plan.batch) != (m, B):
        raise ValueError("plan for m %d, batch %d given for m %d, batch %d"
                         % (plan.m, plan.batch, m, B))
    out = torch.empty(B, dtype=torch.float32, device=A.device)
    with torch.cuda.device(A.device):
        code = _lib().cg_chol_logdet(A.data_ptr(), out.data_ptr(), B, m, plan.warps, plan.groups,
                                     plan.smem, plan.grid, torch.cuda.current_stream().cuda_stream)
    check_launch(code, "chol_logdet")
    counters.launched("chol_logdet")
    return out


def chol_logdet_cuda(A):
    """log det of (batch, m, m) SPD matrices, non-positive pivots deflated.

    A CUDA tensor must be f32 and is handled by the kernel (or this raises),
    under the cached ``k3_plan`` of its shape and card; a CPU tensor goes
    through the plain version.
    """
    if A.ndim != 3 or A.shape[-1] != A.shape[-2]:
        raise ValueError("expected (batch, m, m), got %s" % (tuple(A.shape),))
    if not A.is_cuda:
        return chol_logdet_plain(A)
    if A.dtype != torch.float32:
        raise TypeError("the CUDA kernel takes float32, got %s" % A.dtype)
    B, m, _ = A.shape
    if not chol_logdet_fits(m):
        raise ValueError("m = %d is past the kernel's limit of %d" % (m, K3_MAX_M))
    A = A.contiguous()
    if B == 0:
        return torch.empty(0, dtype=torch.float32, device=A.device)
    return _launch(A, _plan(m, B, A.device.index))
