"""Data parallelism over processes — the port's counterpart of
``coulombgas_tpu/parallel/mesh.py``.

The JAX package writes every step once over the *global* batch, jits it with
the batch axis split over a one-axis device mesh, and lets XLA insert the
all-reduces.  The port runs one process per GPU (``torch.distributed``); each
rank holds a contiguous share of the global batch, in rank order, and the
code reduces by hand wherever the JAX code takes a batch mean before the end
of an epoch: the REINFORCE clip window (``train/loss.py``) and the epoch's
accumulators (``main_torch.py``).  Parameters are broadcast from rank 0 at
start, and every SR solve's update is rank 0's (``replicate_update``, the one
place that rule lives); Adam keeps the replicas equal by doing the same
arithmetic on the same reduced gradients.

=====================================  ======================================
JAX package                            here
=====================================  ======================================
``make_mesh(devices, num_devices)``    ``make_mesh(init_method, rank,
                                       world_size, device)``: the default
                                       process group (NCCL where every rank
                                       has a card of its own, gloo on the
                                       CPU or where ranks share a card), this
                                       rank, the world size, the local device
``batch_spec`` / ``replicated_spec``   none: a tensor lives on one rank's
                                       device; there is no global array to
                                       annotate.  What is sharded is what
                                       ``shard_batch`` cut, what is
                                       replicated is what ``replicate`` sent
``shard_batch(pytree, mesh)``          ``shard_batch(x)``: this rank's
                                       contiguous slice of axis 0
``replicate(pytree, mesh)``            ``replicate(tree)``: rank 0's values
                                       copied into every rank's tensors;
                                       ``replicate_update``: rank 0's SR
                                       update and diagnostics
``host_gather(pytree)``                ``host_gather(x)``: axis 0 of every
                                       rank, in rank order, as numpy on rank 0
(XLA's all-reduces)                    ``all_reduce_mean(tree)``: the
                                       mean over the ranks of a list or dict
                                       of tensors, flattened into one buffer;
                                       ``window_mean``: a microbatch chunk's
                                       means over the ranks holding it,
                                       weighted by their walkers, in the
                                       groups of ``window_groups``
=====================================  ======================================

With no process group every function is the identity and the world size is
1, so a one-process run is the run it was before this module existed.
"""

from __future__ import annotations

import datetime
import socket
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "current", "destroy", "barrier", "shard_batch",
           "replicate", "replicate_update", "host_gather", "all_reduce_mean",
           "broadcast_object", "window_groups", "window_mean", "wait_for_rank0", "release",
           "TIMEOUT"]

# A rank may wait this long in a collective or for the rendezvous store.  A
# wait with no bound (the other ranks' while rank 0 pretrains) goes through
# ``wait_for_rank0``; a wedged device is the hang watchdog's to catch
# (``--hang_timeout``).
TIMEOUT = datetime.timedelta(hours=2)
_KEY = "coulombgas_mesh/"


@dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel group."""

    rank: int = 0
    world_size: int = 1
    device: torch.device | None = None
    backend: str | None = None  # None: no process group


_MESH = Mesh()
_STORE = None  # the rendezvous store, which rank 0 hosts


def current() -> Mesh:
    """The mesh of ``make_mesh``, or world size 1 without a process group."""
    return _MESH


def make_mesh(init_method: str, rank: int, world_size: int, device) -> Mesh:
    """Join the process group as ``rank`` of ``world_size``.

    ``init_method`` is ``tcp://host:port`` (rank 0 listens there) or
    ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``, and ``RANK`` and
    ``WORLD_SIZE`` where ``rank`` / ``world_size`` are -1, as ``torchrun``
    sets them).  ``device`` is this rank's device; a CUDA device becomes the
    current one before anything is allocated.  The ranks first tell each
    other which card they hold: NCCL refuses two ranks on one card, so the
    group takes NCCL only where every rank has its own, gloo otherwise (and
    always on the CPU).
    """
    global _MESH, _STORE
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    store, rank, world_size = next(dist.rendezvous(init_method, rank, world_size,
                                                   timeout=TIMEOUT))
    store.set_timeout(TIMEOUT)
    backend = "gloo"
    if device.type == "cuda":
        card = "%s/%s" % (socket.gethostname(), torch.cuda.get_device_properties(device).uuid)
        store.set(_KEY + "card/%d" % rank, card)
        cards = [store.get(_KEY + "card/%d" % r).decode() for r in range(world_size)]
        if len(set(cards)) == world_size:
            backend = "nccl"
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            timeout=TIMEOUT)
    _MESH = Mesh(dist.get_rank(), dist.get_world_size(), device, backend)
    _STORE = store
    return _MESH


def destroy() -> None:
    """Leave the process group (a no-op without one)."""
    global _MESH, _STORE
    if _MESH.backend is not None:
        dist.destroy_process_group()
    _MESH, _STORE = Mesh(), None


def release(name: str) -> None:
    """Rank 0's signal that ends the other ranks' ``wait_for_rank0(name)``
    (a no-op on the other ranks and without a group)."""
    if _MESH.world_size > 1 and _MESH.rank == 0:
        _STORE.set(_KEY + name, "1")


def wait_for_rank0(name: str, poll: float = 1.0) -> None:
    """Block this rank until rank 0 calls ``release(name)``, with no time
    bound: rank 0's work before it (the free-fermion pretraining) may take
    longer than any collective's ``TIMEOUT``.  The store is polled, and rank
    0 hosts it, so a rank 0 that dies ends the wait with an error.  Returns
    at once on rank 0 and without a group."""
    if _MESH.world_size == 1 or _MESH.rank == 0:
        return
    while not _STORE.check([_KEY + name]):
        time.sleep(poll)


def barrier() -> None:
    if _MESH.world_size > 1:
        if _MESH.backend == "nccl":
            dist.barrier(device_ids=[_MESH.device.index])
        else:
            dist.barrier()


def _to_comm(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the device the backend works on: host tensors for gloo (its
    CUDA support covers some collectives only), the rank's card for NCCL."""
    if _MESH.backend == "nccl":
        return t.to(_MESH.device)
    return t.cpu()


def shard_batch(x):
    """This rank's contiguous slice of axis 0 of a global batch (a tensor or
    numpy array), in rank order."""
    world, rank = _MESH.world_size, _MESH.rank
    if world == 1:
        return x
    if x.shape[0] % world:
        raise ValueError("batch %d is not divisible by the world size %d" % (x.shape[0], world))
    share = x.shape[0] // world
    return x[rank * share:(rank + 1) * share]


def _leaves(tree) -> list:
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    raise TypeError("not a tensor, list, tuple or dict: %r" % type(tree))


def _rebuild(tree, it):
    if torch.is_tensor(tree):
        return next(it)
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    return type(tree)(_rebuild(v, it) for v in tree)


def all_reduce_mean(tree):
    """The mean over the ranks of every tensor in ``tree`` (a tensor, or
    lists, tuples and dicts of them), reduced as one flat buffer per dtype
    (the float64 solve's Fisher blocks beside float32 gradients).  Returns
    new tensors in the same structure; the inputs are left as they were.
    The identity with one rank."""
    size = _MESH.world_size
    if size == 1:
        return tree
    leaves = _leaves(tree)
    out = [None] * len(leaves)
    for dtype in dict.fromkeys(leaf.dtype for leaf in leaves):
        group = [i for i, leaf in enumerate(leaves) if leaf.dtype == dtype]
        buf = _to_comm(torch.cat([leaves[i].detach().reshape(-1) for i in group]))
        dist.all_reduce(buf, op=dist.ReduceOp.SUM)
        buf = (buf / size).to(leaves[group[0]].device)
        at = 0
        for i in group:
            out[i] = buf[at:at + leaves[i].numel()].view(leaves[i].shape)
            at += leaves[i].numel()
    return _rebuild(tree, iter(out))


@torch.no_grad()
def replicate(tree, src: int = 0):
    """Copy rank ``src``'s values into every rank's tensors of ``tree`` (in
    place; parameters too), one broadcast per dtype.  Returns ``tree``."""
    if _MESH.world_size == 1:
        return tree
    leaves = _leaves(tree)
    for dtype in dict.fromkeys(leaf.dtype for leaf in leaves):
        group = [leaf for leaf in leaves if leaf.dtype == dtype]
        buf = _to_comm(torch.cat([leaf.detach().reshape(-1) for leaf in group]))
        dist.broadcast(buf, src=src)
        at = 0
        for leaf in group:
            leaf.copy_(buf[at:at + leaf.numel()].view(leaf.shape))
            at += leaf.numel()
    return tree


@torch.no_grad()
def replicate_update(upd_van: torch.Tensor, upd_flow: torch.Tensor, *stats: dict):
    """Rank 0's SR update on every rank: independent solves may differ in the
    last bits, and the replicas must not.  The raveled updates are copied in
    place; each dict of ``stats`` (the solve's observables or diagnostics,
    floats or 0-dim tensors) comes back with rank 0's values, of the kinds it
    had.  One broadcast per dtype; the identity with one rank.  Returns the
    tuple of dicts."""
    if _MESH.world_size == 1:
        return stats
    keys = [(i, k) for i, s in enumerate(stats) for k in s]
    vals = torch.tensor([float(stats[i][k]) for i, k in keys], dtype=torch.float64,
                        device=upd_van.device)
    replicate([upd_van, upd_flow, vals])
    out = tuple(dict(s) for s in stats)
    for (i, k), v in zip(keys, vals.tolist()):
        was = stats[i][k]
        out[i][k] = torch.tensor(v, dtype=was.dtype, device=was.device) if torch.is_tensor(was) else v
    return out


def host_gather(x: torch.Tensor):
    """Axis 0 of ``x`` from every rank, concatenated in rank order, as a numpy
    array on rank 0 and None on the others (every rank must call it).  The
    shapes must agree across ranks."""
    if _MESH.world_size == 1:
        return x.detach().cpu().numpy()
    t = _to_comm(x.detach().contiguous())
    if _MESH.backend == "nccl":
        out = t.new_empty((_MESH.world_size * t.shape[0],) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t)
        return out.cpu().numpy() if _MESH.rank == 0 else None
    parts = [torch.empty_like(t) for _ in range(_MESH.world_size)] if _MESH.rank == 0 else None
    dist.gather(t, parts, dst=0)
    return torch.cat(parts).numpy() if _MESH.rank == 0 else None


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s picklable ``obj`` on every rank."""
    if _MESH.world_size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def window_groups(layout) -> list:
    """This rank's pieces of the microbatch chunks of ``layout``
    (``train.train.chunk_layout``), in chunk order, as ``(start, stop,
    group)``: ``start:stop`` within this rank's share, ``group`` None where
    this rank holds the whole chunk, else the process group of the ranks
    that hold it (the default group where that is every rank).  The groups
    of different chunks may overlap, so every rank creates every group of
    several ranks, in chunk order: every rank must call this, with the same
    layout, before the first collective over any of them."""
    groups, out = {}, []
    for chunk in layout:
        ranks = tuple(r for r, _, _ in chunk)
        group = None
        if len(ranks) > 1:
            if ranks not in groups:
                groups[ranks] = (dist.group.WORLD if len(ranks) == _MESH.world_size
                                 else dist.new_group(list(ranks)))
            group = groups[ranks]
        out += [(start, stop, group) for r, start, stop in chunk if r == _MESH.rank]
    return out


def window_mean(ts, group, count: int) -> list:
    """Means over every walker of a chunk held by the ranks of ``group``, of
    0-dim tensors ``ts`` that each rank gives as means over its ``count``
    walkers of it: one all-reduce of the count-weighted sums and the counts,
    so that unequal pieces weigh as their walkers do.  Every rank of the
    group gets the same bits."""
    like = ts[0]
    buf = torch.stack([t.detach() * count for t in ts]
                      + [torch.full((), float(count), dtype=like.dtype, device=like.device)])
    buf = _to_comm(buf)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    buf = buf.to(like.device)
    return list((buf[:-1] / buf[-1]).unbind())
