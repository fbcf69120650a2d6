"""The SR accumulate split into a graph part and an eager tail, and the
choice between a CUDA graph and the eager piece (CPU only; the graph itself is
checked on the card by ``chip_smoke.py``'s ``accumulate_graph`` phase).

The graph part (observables, per-walker F and E, scores and their means) and
the eager tail (the clip window, the score contractions, the Fisher blocks)
must give the accumulators of the SR accumulate as it ran before the split,
bit for bit; ``make_loss``'s two parts composed must give
``observable_and_lossfn``.  What the graph part reads must be on the device
once: the momenta tables and the Ewald mesh; the Slater inverse keeps
``linalg.inv``'s refusal of a singular matrix without a host read.
"""

import numpy as np
import pytest
import torch

from coulombgas_tpu_torch.io.convert import unravel_like
from coulombgas_tpu_torch.models.ferminet import (
    FermiNetConfig, ferminet_apply, init_ferminet_params,
)
from coulombgas_tpu_torch.models.ferminet_jac import ferminet_apply_and_jac, ferminet_apply_jac_lap
from coulombgas_tpu_torch.models.transformer import TransformerConfig, init_transformer_params
from coulombgas_tpu_torch.optim.sr import (
    add_fishers_, fishers_from_scores, hybrid_fisher_sr, quantum_score_mean,
)
from coulombgas_tpu_torch.parallel import mesh
from coulombgas_tpu_torch.physics import ewald
from coulombgas_tpu_torch.physics.orbitals import sp_orbitals, twist_sort
from coulombgas_tpu_torch.sampling.autoregressive import (
    make_autoregressive_sampler, make_classical_score,
)
from coulombgas_tpu_torch.train.loss import make_loss
from coulombgas_tpu_torch.train.train import (
    FISHER_KEYS, accumulate_graph, accumulate_graph_blocker, accumulate_graph_key,
    chunk_layout, init_accumulators, make_accumulate_and_apply,
)
from coulombgas_tpu_torch.wavefunction.fast_laplacian import (
    SINGULAR, make_logpsi_grad_laplacian_analytic,
)
from coulombgas_tpu_torch.wavefunction.logpsi import (
    make_logpsi, make_logpsi_fast, make_logpsi_grad_laplacian, make_quantum_score, momenta_table,
)

torch.set_num_threads(1)

N, DIM, EMAX, BATCH = 7, 2, 4, 8
RS, KAPPA, GMAX, BETA = 5.0, 6.0, 5, 1 / (4 * 0.15)
L = float(np.sqrt(np.pi * N))


def _engine(sp, **kw):
    """The analytic engine as ``main_torch.py`` builds it for --hutchinson,
    with ``kw`` in place of its defaults."""
    kw = {"flow_jac_lap": ferminet_apply_jac_lap, "flow_jac": ferminet_apply_and_jac,
          "hutchinson": True, **kw}
    return make_logpsi_grad_laplacian_analytic(sp, L, kw.pop("flow_jac_lap"),
                                               flow_apply=ferminet_apply, **kw)


@pytest.fixture(scope="module")
def stack():
    sp, _ = sp_orbitals(DIM, EMAX)
    sp = twist_sort(sp, np.full(DIM, 0.25))[0][::-1].copy()
    M = sp.shape[0]
    gen = torch.Generator().manual_seed(5)
    van = init_transformer_params(TransformerConfig(M, 1, 8, 2, 12), DIM, gen,
                                  torch.float64, "cpu")
    with torch.no_grad():  # the default init is tiny: let the attention matter
        for p in van.parameters():
            p.mul_(8.0)
    flow = init_ferminet_params(FermiNetConfig(2, 6, 5, L, 0.1), DIM, gen, torch.float64, "cpu")
    sampler, log_prob = make_autoregressive_sampler(sp, N, M)
    si = sampler(van, gen, BATCH)
    x = L * torch.rand(BATCH, N, DIM, generator=gen, dtype=torch.float64)
    v = torch.randn(BATCH, N, DIM, generator=gen, dtype=torch.float64)
    logpsi = make_logpsi_fast(ferminet_apply_and_jac, sp, L)
    G = ewald.kpoints(DIM, GMAX)
    Vconst = N * RS / L * ewald.madelung(DIM, KAPPA, G)
    loss = make_loss(log_prob, logpsi, _engine(sp), KAPPA, G, L, RS, Vconst, BETA)
    sr_opt = hybrid_fisher_sr(make_classical_score(log_prob), make_quantum_score(logpsi),
                              1e-3, 1e-3)
    return dict(sp=sp, van=van, flow=flow, si=si, x=x, v=v, G=G, loss=loss, sr_opt=sr_opt,
                log_prob=log_prob, logpsi=logpsi, Vconst=Vconst)


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(p, q) for p, q in zip(a, b))
    return torch.equal(a, b)


def _pieces(count):
    return None if count == 1 else mesh.window_groups(chunk_layout(BATCH, BATCH // count, 1))


def _parent_accumulate(s, fisher_dtype, count, generator, v):
    """The SR accumulate as it ran before the split: ``observable_and_lossfn``
    (observables and clip window in one call), then the scores, the
    contractions and the Fisher payload, added as ``_add`` adds them."""
    van, flow = s["van"], s["flow"]
    acc = init_accumulators(van, flow, sr=True, fisher_dtype=fisher_dtype)
    pieces = [(0, BATCH, None)] if count == 1 else _pieces(count)
    for start, stop, group in pieces:
        sl = slice(start, stop)
        weight = 1.0 if count == 1 else (stop - start) / BATCH
        data, _, _, aux = s["loss"](van, flow, s["si"][sl], s["x"][sl], generator,
                                    None if v is None else v[sl], group=group)
        with torch.no_grad():
            s_c, s_q = s["sr_opt"].scores(van, flow, s["si"][sl], s["x"][sl])
            batch = s_c.shape[0]
            grad_van = s_c.T @ aux["Floc_clipped"] / batch
            Ec = aux["Eloc_clipped"]
            grad_flow = 2.0 * (s_q.real.T @ Ec.real + s_q.imag.T @ Ec.imag) / batch
            for k in acc["data"]:
                acc["data"][k] += weight * data[k]
            if fisher_dtype is None:
                cf, qf, qsm = fishers_from_scores(s_c, s_q)
                acc["classical_fisher"].add_(cf, alpha=weight)
                acc["quantum_fisher"].add_(qf, alpha=weight)
            else:
                qsm = quantum_score_mean(s_q)
                add_fishers_(acc["classical_fisher"], acc["quantum_fisher"], s_c, s_q, weight)
            acc["quantum_score_mean"].add_(qsm, alpha=weight)
            for dst, src, module in ((acc["grads"][0], grad_van, van),
                                     (acc["grads"][1], grad_flow, flow),
                                     (acc["classical_score"], s_c.mean(dim=0), van),
                                     (acc["quantum_score"], 2.0 * qsm[0], flow)):
                for a, b in zip(dst, unravel_like(src, module)):
                    a.add_(b, alpha=weight)
    return acc


def _accumulate(s, fisher_dtype, count, generator, v, sr=True):
    accumulate, _ = make_accumulate_and_apply(
        s["loss"], 1, pieces=_pieces(count), sr_opt=s["sr_opt"] if sr else None,
        fisher_dtype=fisher_dtype)
    acc = init_accumulators(s["van"], s["flow"], sr=sr, fisher_dtype=fisher_dtype)
    return accumulate(s["van"], s["flow"], s["si"], s["x"], generator, acc, v)


@pytest.mark.parametrize("count", [1, 2], ids=["one_piece", "two_pieces"])
@pytest.mark.parametrize("fisher_dtype", [None, torch.float64],
                         ids=["fisher_scores_dtype", "fisher_f64"])
@pytest.mark.parametrize("probe", ["handed_in", "drawn"])
def test_split_sr_piece_gives_the_parent_accumulators_bit_for_bit(stack, count, fisher_dtype,
                                                                  probe):
    v = stack["v"] if probe == "handed_in" else None
    gen_a, gen_b = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    before = dict(accumulate_graph)
    got = _accumulate(stack, fisher_dtype, count, gen_a, v)
    assert accumulate_graph == dict(before, eager=before["eager"] + count)
    want = _parent_accumulate(stack, fisher_dtype, count, gen_b, v)
    assert torch.equal(gen_a.get_state(), gen_b.get_state())
    for k in ("data", "grads", "classical_score", "quantum_score", *FISHER_KEYS):
        assert _equal(got[k], want[k]), k
    assert got["classical_fisher"].dtype == (fisher_dtype or torch.float64)


def test_observables_and_clip_window_compose_to_observable_and_lossfn(stack):
    loss, van, flow = stack["loss"], stack["van"], stack["flow"]
    si, x, v = stack["si"], stack["x"], stack["v"]
    data, classical_lossfn, quantum_lossfn, aux = loss(van, flow, si, x, None, v)
    obs, Floc, Eloc = loss.observables(van, flow, si, x, None, v)
    Fc, Ec = loss.clip_window(obs, Floc, Eloc)
    assert _equal(obs, data)
    assert torch.equal(Fc, aux["Floc_clipped"]) and torch.equal(Ec, aux["Eloc_clipped"])
    # the Adam route's accumulators: the loss closures' gradients, as before
    before = dict(accumulate_graph)
    acc = _accumulate(stack, None, 2, None, v, sr=False)
    assert accumulate_graph == dict(before, eager=before["eager"] + 2)
    assert all(torch.isfinite(g).all() for g in acc["grads"][0] + acc["grads"][1])


def test_blocker_reasons(stack):
    loss, sr_opt = stack["loss"], stack["sr_opt"]
    cuda = torch.device("cuda")
    assert loss.graph_safe
    assert accumulate_graph_blocker(loss, sr_opt, cuda) == ""
    assert accumulate_graph_blocker(loss, sr_opt, "cpu") == "walkers on the cpu"
    assert (accumulate_graph_blocker(loss, None, cuda)
            == "no SR: the loss closures are differentiated")
    args = (stack["log_prob"], stack["logpsi"])
    consts = (KAPPA, stack["G"], L, RS, stack["Vconst"], BETA)
    sp = stack["sp"]
    for engine in (_engine(sp, hutchinson=False),  # the exact Laplacian
                   _engine(sp, flow_jac=None, flow_jac_lap=None),  # --slow_logp
                   _engine(sp, flow_jac_lap_batched=ferminet_apply_jac_lap),  # --acc_d2_kernel
                   make_logpsi_grad_laplacian(stack["logpsi"], hutchinson=True)):  # generic AD
        unsafe = make_loss(*args, engine, *consts)
        assert not unsafe.graph_safe
        assert (accumulate_graph_blocker(unsafe, sr_opt, cuda)
                == "the Laplacian engine is not marked graph-safe")


def test_key_follows_storage_piece_size_and_probe(stack):
    van, flow, si, x, v = stack["van"], stack["flow"], stack["si"], stack["x"], stack["v"]
    gen = torch.Generator()
    key = accumulate_graph_key(van, flow, si, x, gen, v)
    assert accumulate_graph_key(van, flow, si.clone(), x.clone(), gen, v.clone()) == key
    assert accumulate_graph_key(van, flow, si[:4], x[:4], gen, v[:4]) != key
    assert accumulate_graph_key(van, flow, si, x, gen, None) != key
    assert accumulate_graph_key(van, flow, si, x, torch.Generator(), v) != key
    p = next(flow.parameters())
    old = p.data
    kept = old.clone()
    try:
        with torch.no_grad():
            p.add_(1.0)  # an optimizer step keeps the storage
        assert accumulate_graph_key(van, flow, si, x, gen, v) == key
        p.data = old.clone()  # new storage: a graph would read the old one
        assert accumulate_graph_key(van, flow, si, x, gen, v) != key
    finally:
        p.data = old
        old.copy_(kept)


def test_device_tables_equal_the_host_arrays(stack):
    sp, x = stack["sp"], stack["x"]
    table = momenta_table(sp)
    # made first inside the scores' transforms: the cached tensor is a plain one
    w = torch.ones(sp.shape, dtype=torch.float64)
    torch.func.vmap(torch.func.jacrev(lambda w, q: (table(q) * w).sum() * q.sum()),
                    in_dims=(None, 0))(w, x)
    t = table(x)
    assert not torch._C._functorch.is_functorch_wrapped_tensor(t)
    assert table(x) is t and torch.equal(t, torch.as_tensor(sp, dtype=torch.float64))
    assert table(x.float()).dtype == torch.float32
    G = stack["G"]
    mesh_t = torch.as_tensor(G, dtype=x.dtype)
    for fn in (ewald.ewald_sum, ewald.ewald_sum_pairs):
        assert torch.equal(fn(x / L, KAPPA, mesh_t), fn(x / L, KAPPA, G))
    assert torch.equal(ewald.potential_energy(x, KAPPA, mesh_t, L, RS),
                       ewald.potential_energy(x, KAPPA, G, L, RS))
    # the generic engine's tables too: the same log Psi whatever made them first
    slow = make_logpsi(ferminet_apply, sp, L)
    assert torch.equal(slow(x, stack["flow"], stack["si"]),
                       make_logpsi(ferminet_apply, sp, L)(x, stack["flow"], stack["si"]))


def test_inverse_with_device_check_gives_inv(stack):
    gen = torch.Generator().manual_seed(2)
    D = torch.complex(torch.randn(4, N, N, generator=gen, dtype=torch.float64),
                      torch.randn(4, N, N, generator=gen, dtype=torch.float64))
    M, info = torch.linalg.inv_ex(D)
    assert torch.equal(info, torch.zeros_like(info))
    assert torch.equal(M, torch.linalg.inv(D))
    # a walker's flowed particles all on one spot: its Slater matrix's rows
    # are equal, and the elimination's multipliers of 1 zero them exactly
    def coincident(flow, x):
        u, J, lap_u = ferminet_apply_jac_lap(flow, x)
        u = u.clone()
        u[3] = u[3, :1]
        return u, J, lap_u

    engine = _engine(stack["sp"], flow_jac_lap=coincident)
    with pytest.raises(RuntimeError, match=SINGULAR):
        engine(stack["x"], stack["flow"], stack["si"], None, stack["v"])
    with pytest.raises(torch.linalg.LinAlgError):
        torch.linalg.inv(D.index_fill(1, torch.tensor([1]), 0))
