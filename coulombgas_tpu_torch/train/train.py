"""Training steps: joint sampling, gradient accumulation, update.

Counterpart of ``coulombgas_tpu/train/train.py``:

  * ``sample_step``   — VAN occupation draws + Metropolis coordinates,
  * ``accumulate``    — observables, REINFORCE gradients and mean scores
                        (+ Fisher terms under stochastic reconfiguration),
                        summed into an explicit accumulator,
  * ``apply_update``  — accumulator normalization, baseline correction, and
                        the optimizer step (a ``torch.optim`` optimizer, or
                        the hybrid-SR solve followed by ``p += update``).
"""

from __future__ import annotations

import contextlib

import torch

from ..io.convert import ravel_params, unravel_like
from ..ops import counters
from ..optim.sr import HybridFisherSR, add_fishers_, fisher_blocks, quantum_score_mean
from ..parallel import mesh
from ..sampling.mcmc import mcmc
from ..utils.profiling import annotate

__all__ = ["make_sample_step", "sample_graph", "sample_graph_blocker", "graph_key",
           "make_accumulate_and_apply", "accumulate_graph", "accumulate_graph_blocker",
           "accumulate_graph_key", "init_accumulators", "apply_raveled_update", "chunk_layout",
           "reduce_accumulators", "DATA_KEYS", "FISHER_KEYS"]

DATA_KEYS = ("F_mean", "F2_mean", "E_mean", "E2_mean", "K_mean",
             "K2_mean", "V_mean", "V2_mean", "S_mean", "S2_mean")
# the Fisher payload of stochastic reconfiguration, beside them under ``sr``
FISHER_KEYS = ("classical_fisher", "quantum_fisher", "quantum_score_mean")


# How this process's sample steps ran: CUDA graphs captured, their replays,
# and steps run eagerly where a graph is not safe (``sample_graph_blocker``).
sample_graph = {"captures": 0, "replays": 0, "eager": 0}


def sample_graph_blocker(logp, device) -> str:
    """Why the sample step runs eagerly for walkers on ``device`` with the
    Metropolis log-density ``logp``; '' where it replays as one CUDA graph:
    on CUDA, with a log-density that marks itself ``graph_safe`` (every
    launch on the current stream, no host read: ``make_logp_fast``'s)."""
    device = torch.device(device)
    if device.type != "cuda":
        return "walkers on the %s" % device.type
    if not getattr(logp, "graph_safe", False):
        return "the log-density is not marked graph-safe"
    return ""


# How this process's accumulate pieces ran: the SR piece's graph part (all
# that reads no clip window) captured as a CUDA graph, its replays, and pieces
# run eagerly where a graph is not safe (``accumulate_graph_blocker``).
accumulate_graph = {"captures": 0, "replays": 0, "eager": 0}


def accumulate_graph_blocker(observable_and_lossfn, sr_opt, device) -> str:
    """Why an accumulate piece of walkers on ``device`` runs eagerly; '' where
    its graph part replays as one CUDA graph: on CUDA, on the SR route (the
    Adam route differentiates its loss closures), with a derivative engine
    that marks itself ``graph_safe`` (``make_loss``'s ``observable_and_lossfn``
    carries the mark of ``make_logpsi_grad_laplacian_analytic``'s)."""
    device = torch.device(device)
    if device.type != "cuda":
        return "walkers on the %s" % device.type
    if sr_opt is None:
        return "no SR: the loss closures are differentiated"
    if not getattr(observable_and_lossfn, "graph_safe", False):
        return "the Laplacian engine is not marked graph-safe"
    return ""


_capture_streams = {}  # one capture stream a device: every capture shares its workspace


def _capture(fn, inputs, generator):
    """Capture ``fn(*inputs)`` as one CUDA graph on the device's capture
    stream, with ``generator`` (where given) registered, so that a replay
    draws from its state at that moment and advances it as the eager call
    would (``set_state`` between replays holds).  ``inputs[0]`` is on the
    device.  Returns (graph, its static outputs, the kernels a replay runs).
    The capture stream's cuBLAS workspace and the static outputs stay
    allocated; the graph's pool keeps the call's intermediates."""
    device = inputs[0].device
    if device not in _capture_streams:
        _capture_streams[device] = torch.cuda.Stream(device)
    side = _capture_streams[device]
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    if generator is not None:
        graph.register_generator_state(generator)
    with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
        out = fn(*inputs)
    graph.instantiate()
    return graph, out, counters.graph_launches(graph)


def accumulate_graph_key(van, flow, state_indices, x, generator, v) -> tuple:
    """What a captured accumulate piece holds for: ``graph_key``'s, the
    occupations' shape and dtype, and whether the probe is handed in (else
    the graph draws it from ``generator``)."""
    return graph_key(van, flow, x, generator) + (tuple(state_indices.shape),
                                                 state_indices.dtype, v is None)


@contextlib.contextmanager
def _capturable_linalg():
    """``torch.linalg`` on cuSOLVER and cuBLAS inside the block: the default
    backend takes MAGMA's batched LU for complex matrices (``inv_ex``,
    ``slogdet``), which cannot be captured in a CUDA graph."""
    before = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(before)


def graph_key(van, flow, x, generator) -> tuple:
    """What a captured sample step holds for: the walkers' shape, dtype and
    device, the generator, and the storage of every parameter, which the
    replays read in place (an optimizer step, ``apply_raveled_update`` and
    ``load_state_dict`` keep it)."""
    return (tuple(x.shape), x.dtype, x.device, generator,
            tuple(p.data_ptr() for p in van.parameters()),
            tuple(p.data_ptr() for p in flow.parameters()))


def make_sample_step(sampler, logp, mc_steps: int, mc_stddev, L, batch: int):
    """Joint sampling of occupations (exact) and coordinates (MCMC).

    Returns ``sample_step(van, flow, x, generator) -> (state_indices, x,
    accept_rate)``; coordinates are wrapped back into [0, L).  ``generator``
    lives on the walkers' device and serves both samplers.

    Where ``sample_graph_blocker`` finds nothing against it, the whole step
    (the VAN's decodes and draws, the Metropolis sweeps, the wrap) is
    captured as one CUDA graph at the first call of a ``graph_key`` and
    replayed at the next ones: the same launches from the same generator
    state, so the same numbers as the eager step (``_capture``).  A
    capturing call runs and returns the eager step, which warms up what the
    capture reads, then captures; a replay returns copies of the graph's
    outputs.
    """

    def step(van, flow, x, generator):
        state_indices = sampler(van, generator, batch)
        x, accept_rate = mcmc(
            lambda xx: logp(xx, flow, state_indices), x, generator, mc_steps, mc_stddev)
        x = x - L * torch.floor(x / L)
        return state_indices, x, accept_rate

    captured = {}  # key, graph, static walkers and outputs, kernels a replay runs

    def capture(van, flow, x, generator, key):
        out = step(van, flow, x, generator)
        captured.clear()  # the previous graph and its memory pool go first
        static_x = x.clone()
        graph, static_out, launches = _capture(
            lambda xx: step(van, flow, xx, generator), (static_x,), generator)
        captured.update(key=key, graph=graph, x=static_x, out=static_out, launches=launches)
        sample_graph["captures"] += 1
        return out

    @torch.no_grad()
    def sample_step(van, flow, x, generator):
        if sample_graph_blocker(logp, x.device):
            sample_graph["eager"] += 1
            return step(van, flow, x, generator)
        key = graph_key(van, flow, x, generator)
        with torch.cuda.device(x.device):
            if captured.get("key") != key:
                return capture(van, flow, x, generator, key)
            captured["x"].copy_(x)
            captured["graph"].replay()
            counters.replayed(captured["launches"])
            sample_graph["replays"] += 1
            return tuple(t.clone() for t in captured["out"])

    return sample_step


@torch.no_grad()
def apply_raveled_update(van, flow, upd_van, upd_flow):
    """``p += update`` for raveled update vectors (JAX parameter order)."""
    for module, upd in ((van, upd_van), (flow, upd_flow)):
        for p, u in zip(module.parameters(), unravel_like(upd, module)):
            p.add_(u.to(p.dtype))


def _zeros_like_params(module):
    return [torch.zeros_like(p) for p in module.parameters()]


def init_accumulators(van, flow, sr: bool = False, fisher_dtype=None):
    """Zero accumulators for one epoch of gradient accumulation.  Gradients
    and scores are lists in the order of ``module.parameters()``.  With ``sr``
    the Fisher payload is added: ``classical_fisher`` (P_van, P_van),
    ``quantum_fisher`` (P_flow, P_flow) and ``quantum_score_mean`` (2, P_flow)
    [Re, Im], rows and columns in the JAX package's raveled parameter order
    (``io.convert.ravel_order``).  The two Fisher blocks are of
    ``fisher_dtype`` (default: the parameters' dtype)."""
    p = next(flow.parameters())
    acc = {
        "data": {k: torch.zeros((), dtype=p.dtype, device=p.device) for k in DATA_KEYS},
        "grads": (_zeros_like_params(van), _zeros_like_params(flow)),
        "classical_score": _zeros_like_params(van),
        "quantum_score": _zeros_like_params(flow),
    }
    if sr:
        p_van = sum(q.numel() for q in van.parameters())
        p_flow = sum(q.numel() for q in flow.parameters())
        acc["classical_fisher"] = p.new_zeros(p_van, p_van, dtype=fisher_dtype)
        acc["quantum_fisher"] = p.new_zeros(p_flow, p_flow, dtype=fisher_dtype)
        acc["quantum_score_mean"] = p.new_zeros(2, p_flow)
    return acc


def chunk_layout(batch: int, microbatch: int | None, world_size: int) -> list[tuple]:
    """The JAX package's microbatch chunks of the global batch, and which
    ranks hold them.

    The JAX package cuts the *global* batch of ``batch`` walkers into chunks
    of ``microbatch`` whatever the mesh (``coulombgas_tpu/train/train.py:
    accumulate``), each with its own clip window; no microbatch, or one at
    least the batch, is one chunk.  Rank r of ``world_size`` holds walkers
    [r B / W, (r + 1) B / W).  Returns one tuple per chunk, in chunk order,
    of ``(rank, start, stop)`` for each rank holding a piece of it, with
    ``start:stop`` the piece's walkers within that rank's share.  Raises
    ``ValueError`` for what ``main.py`` refuses: a batch the ranks cannot
    share equally (``main.py:330``) and a microbatch that does not divide
    the batch (the JAX accumulate's assert).
    """
    if batch % world_size:
        raise ValueError("batch (%d) must be divisible by the number of devices (%d)"
                         % (batch, world_size))
    size = batch if microbatch is None or microbatch >= batch else microbatch
    if batch % size:
        raise ValueError("--microbatch %d must divide the batch of %d walkers"
                         % (microbatch, batch))
    local = batch // world_size
    chunks = []
    for c0 in range(0, batch, size):
        c1 = c0 + size
        chunks.append(tuple((r, max(c0, r * local) - r * local, min(c1, (r + 1) * local) - r * local)
                            for r in range(c0 // local, (c1 - 1) // local + 1)))
    return chunks


def reduce_accumulators(acc, accept_sum: float = 0.0, leave_out=()):
    """An epoch's accumulators and summed accept rate averaged over the
    ranks, in one all-reduce: each rank's are means over its equal share of
    the global batch, so the result is the global batch's, the Fisher
    moments raw (the quantum block is centred in the solve, after this).
    Entries named in ``leave_out`` (a stale epoch's classical Fisher, which
    the apply does not read) stay as they are.  The identity with one rank.
    Returns (accumulators, accept sum)."""
    if mesh.current().world_size == 1:
        return acc, accept_sum
    some = {k: v for k, v in acc.items() if k not in leave_out}
    like = acc["data"]["F_mean"]
    accept = torch.tensor(accept_sum, dtype=like.dtype, device=like.device)
    out = mesh.all_reduce_mean({"acc": some, "accept": accept})
    return dict(acc, **out["acc"]), float(out["accept"])


def make_accumulate_and_apply(observable_and_lossfn, acc_steps: int, pieces=None,
                              sr_opt: HybridFisherSR | None = None, fisher_dtype=None):
    """Build (accumulate, apply_update) for one training epoch.

    Per-step gradients and scores are accumulated, then normalized by
    acc_steps, baseline-corrected (grad_van -= F_mean * score_van,
    grad_flow -= E_mean * score_flow) and handed to the optimizer: the
    ``torch.optim`` optimizer given to ``apply_update``, or, with ``sr_opt``
    (``optim.sr.hybrid_fisher_sr``), the hybrid Fisher solve.  Under SR the
    REINFORCE gradients and mean scores are exact contractions of the
    per-sample score matrices that the Fisher needs anyway (the clipped
    weights are constants of the loss closures), so no loss gradient is taken.

    ``pieces`` bounds the memory of the autograd graphs: the batch given to
    ``accumulate`` (under data parallelism, this rank's share) is processed
    piece by piece, in the global batch's microbatch chunks
    (``parallel.mesh.window_groups(chunk_layout(batch, microbatch,
    world_size))``): ``(start, stop, group)`` in chunk order, ``group`` None
    where the chunk lies inside this process, else the process group of the
    ranks holding it, over which the chunk's REINFORCE clip window is
    reduced (``train/loss.py``).  Each piece weighs ``(stop - start) /
    share``, so that the ranks' mean (``reduce_accumulators``) is the global
    batch's; where the microbatch divides the share this is ``1 / chunks``.
    None: the whole batch is one piece, with one clip window.  Every rank
    applies rank 0's SR update and diagnostics (``mesh.replicate_update``).

    ``fisher_dtype`` (float64 for the float64 solve, ``optim.host_sr``): the
    Fisher blocks are formed from the scores and summed over the rounds in
    that precision, in place (``optim.sr.add_fishers_``); accumulators made
    in another (``init_accumulators`` without it) are cast at their first
    round.  None: formed and summed in the scores' precision.

    An SR piece is a graph part and an eager tail.  The graph part reads the
    piece's occupations, walkers and probe (or draws the probe from
    ``generator``) and gives the observables, the per-walker F and E
    (``observable_and_lossfn.observables``), the score matrices and their
    means; the tail reduces the clip window over ``group``
    (``.clip_window``), contracts the scores with the clipped weights and
    forms or adds the Fisher blocks.  Where ``accumulate_graph_blocker``
    finds nothing against it, the graph part is captured as one CUDA graph
    at the first piece of a key (``accumulate_graph_key``), which runs
    eagerly, and replayed at the next ones, from static copies of the
    inputs; pieces of another size get a graph of their own, and a key that
    changes drops its size's graph first (``accumulate.graphs``).  A
    replay's outputs are the graph's own, which the tail reads before the
    next replay.  The graph part's first piece and its capture take
    ``torch.linalg`` on cuSOLVER (``_capturable_linalg``).
    """

    def _grad_pair(lossfn, params):
        """Gradients of (loss, mean score) with one forward pass."""
        loss, score = lossfn()
        g_loss = torch.autograd.grad(loss, params, retain_graph=True)
        g_score = torch.autograd.grad(score, params)
        return list(g_loss), list(g_score)

    use_sr = sr_opt is not None

    @torch.no_grad()
    def _observe(van, flow, state_indices, x, generator, v):
        """An SR piece's graph part: (observables, Floc, Eloc, S_c, S_q, the
        mean of S_c, the mean of S_q as [Re, Im])."""
        data, Floc, Eloc = observable_and_lossfn.observables(
            van, flow, state_indices, x, generator, v)
        s_c, s_q = sr_opt.scores(van, flow, state_indices, x)
        return data, Floc, Eloc, s_c, s_q, s_c.mean(dim=0), quantum_score_mean(s_q)

    graphs = {}  # piece size -> key, graph, static inputs and outputs, kernels a replay runs

    def _observe_graphed(van, flow, state_indices, x, generator, v):
        key = accumulate_graph_key(van, flow, state_indices, x, generator, v)
        size = x.shape[0]
        slot = graphs.get(size)
        if slot is not None and slot["key"] == key:
            for dst, src in zip(slot["inputs"], (state_indices, x, v)):
                if src is not None:
                    dst.copy_(src)
            slot["graph"].replay()
            counters.replayed(slot["launches"])
            accumulate_graph["replays"] += 1
            return slot["out"]
        graphs.pop(size, None)  # the old graph and its memory pool go first
        with _capturable_linalg():
            out = _observe(van, flow, state_indices, x, generator, v)
            inputs = tuple(None if t is None else t.clone() for t in (state_indices, x, v))
            graph, static_out, launches = _capture(
                lambda si, xx, vv: _observe(van, flow, si, xx, generator, vv), inputs, generator)
        graphs[size] = dict(key=key, graph=graph, inputs=inputs, out=static_out,
                            launches=launches)
        accumulate_graph["captures"] += 1
        return out

    @torch.no_grad()
    def _sr_tail(van, flow, observed, group):
        """An SR piece's eager tail: the clip window, the REINFORCE gradients
        as contractions of the scores with the clipped weights, the Fisher
        blocks."""
        data, Floc, Eloc, s_c, s_q, score_c, qsm = observed
        Floc_clipped, Ec = observable_and_lossfn.clip_window(data, Floc, Eloc, group)
        batch = s_c.shape[0]
        grad_van = s_c.T @ Floc_clipped / batch
        # 2 Re mean(S_q conj(Eloc)), in real arithmetic
        grad_flow = 2.0 * (s_q.real.T @ Ec.real + s_q.imag.T @ Ec.imag) / batch
        if fisher_dtype is None:
            with annotate("sr.fisher"):
                cf, qf = fisher_blocks(s_c, s_q)
            fishers = {"classical_fisher": cf, "quantum_fisher": qf}
        else:  # their Grams are added into the accumulators (_add)
            fishers = {"scores": (s_c, s_q)}
        return {
            "data": data,
            "grads": (unravel_like(grad_van, van), unravel_like(grad_flow, flow)),
            "classical_score": unravel_like(score_c, van),
            "quantum_score": unravel_like(2.0 * qsm[0], flow),
            **fishers, "quantum_score_mean": qsm,
        }

    def _one_batch(van, flow, state_indices, x, generator, v, group):
        eager = accumulate_graph_blocker(observable_and_lossfn, sr_opt, x.device)
        if eager:
            accumulate_graph["eager"] += 1
        if use_sr:
            if eager:
                observed = _observe(van, flow, state_indices, x, generator, v)
            else:
                with torch.cuda.device(x.device):
                    observed = _observe_graphed(van, flow, state_indices, x, generator, v)
            return _sr_tail(van, flow, observed, group)
        data, classical_lossfn, quantum_lossfn, _ = observable_and_lossfn(
            van, flow, state_indices, x, generator, v, group=group)
        grad_van, classical_score = _grad_pair(classical_lossfn, list(van.parameters()))
        grad_flow, quantum_score = _grad_pair(quantum_lossfn, list(flow.parameters()))
        return {
            "data": data,
            "grads": (grad_van, grad_flow),
            "classical_score": classical_score,
            "quantum_score": quantum_score,
        }

    def _add(acc, contrib, weight=1.0):
        for k in acc["data"]:
            acc["data"][k] += weight * contrib["data"][k]
        pairs = [(acc["grads"][0], contrib["grads"][0]),
                 (acc["grads"][1], contrib["grads"][1]),
                 (acc["classical_score"], contrib["classical_score"]),
                 (acc["quantum_score"], contrib["quantum_score"])]
        for dst, src in pairs:
            for a, b in zip(dst, src):
                a.add_(b, alpha=weight)
        if use_sr:
            with annotate("sr.fisher"):
                if fisher_dtype is None:
                    for k in FISHER_KEYS:
                        acc[k].add_(contrib[k], alpha=weight)
                else:
                    for k in ("classical_fisher", "quantum_fisher"):
                        if acc[k].dtype != fisher_dtype:
                            acc[k] = acc[k].to(fisher_dtype)
                    add_fishers_(acc["classical_fisher"], acc["quantum_fisher"],
                                 *contrib["scores"], weight)
                    acc["quantum_score_mean"].add_(contrib["quantum_score_mean"], alpha=weight)
        return acc

    def accumulate(van, flow, state_indices, x, generator, acc, v=None):
        """Add one batch's contribution to ``acc`` (in place) and return it."""
        batch = x.shape[0]
        if pieces is None:
            return _add(acc, _one_batch(van, flow, state_indices, x, generator, v, None))
        if batch != pieces[-1][1]:
            raise ValueError("accumulate was given %d walkers; its pieces cut %d"
                             % (batch, pieces[-1][1]))
        if len(pieces) == 1:  # the whole share is one piece
            return _add(acc, _one_batch(van, flow, state_indices, x, generator, v, pieces[0][2]))
        for start, stop, group in pieces:
            sl = slice(start, stop)
            contrib = _one_batch(van, flow, state_indices[sl], x[sl], generator,
                                 None if v is None else v[sl], group)
            _add(acc, contrib, (stop - start) / batch)
        return acc

    accumulate.graphs = graphs

    @torch.no_grad()
    def apply_update(van, flow, optimizer, acc, trust_scale=1.0):
        """Normalize, baseline-correct and update the parameters in place.

        Without SR, ``optimizer`` is the ``torch.optim`` optimizer that holds
        the parameters of ``van`` and ``flow``.  With SR it is not used (pass
        ``None``): the hybrid Fisher solve gives the update and ``p += update``
        applies it; ``trust_scale`` scales the trust radius ``max_norm`` (an
        update tripwire's escalation factor), and the solve's diagnostics come
        back as ``diag_*`` entries.  Returns the epoch's observables as 0-dim
        tensors."""
        data = {k: val / acc_steps for k, val in acc["data"].items()}
        grads = []
        for grad, scores, base in (
            (acc["grads"][0], acc["classical_score"], data["F_mean"]),
            (acc["grads"][1], acc["quantum_score"], data["E_mean"]),
        ):
            # REINFORCE baseline correction (base is normalized already)
            grads.append([(g - base * s) / acc_steps for g, s in zip(grad, scores)])
        if use_sr:
            fishers = tuple(acc[k] / acc_steps for k in FISHER_KEYS)
            raveled = (ravel_params(van, grads[0]), ravel_params(flow, grads[1]))
            (upd_van, upd_flow), diag = sr_opt.update(raveled, None, fishers,
                                                      max_norm_scale=trust_scale)
            diag, = mesh.replicate_update(upd_van, upd_flow, diag)
            apply_raveled_update(van, flow, upd_van, upd_flow)
            return dict(data, **{"diag_" + k: val for k, val in diag.items()})
        for module, grad in zip((van, flow), grads):
            for p, g in zip(module.parameters(), grad):
                p.grad = g
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return data

    return accumulate, apply_update
