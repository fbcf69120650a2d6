"""The Fisher blocks of the float64 SR solve (``--sr_solver host64``) are
formed from the scores and summed over the rounds in float64.

Scores whose columns are nearly collinear and of large norm, as the n = 57
VAN's are, give a float32 Gram that is indefinite after damping: the float64
solve of such a sum falls from Cholesky to LU and takes a step far from the
float64 one.  Formed and summed in float64 the sum stays positive definite.
The float32 routes (``plain``, ``refined``, ``chol``) keep their float32
formula bit for bit.  Torch only, on the CPU, with the scores handed to
``make_accumulate_and_apply`` through a stand-in of the SR scores function.
"""

import argparse

import pytest
import torch

from coulombgas_tpu_torch.ops import counters
from coulombgas_tpu_torch.optim.host_sr import host_hybrid_apply
from coulombgas_tpu_torch.optim.sr import HybridFisherSR
from coulombgas_tpu_torch.train.train import init_accumulators, make_accumulate_and_apply
from main_torch import fisher_dtype

B, P_VAN, P_FLOW, ROUNDS = 512, 96, 24, 4
DAMPING, MAX_NORM = 1e-3, 1e-3


class _Leaf(torch.nn.Module):
    def __init__(self, size):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(size, dtype=torch.float32))


def _collinear(gen, cols, dtype=torch.float32):
    """(B, cols) scores: one direction of norm ~300 a column, a few % apart,
    under noise of 0.05."""
    u = torch.randn(B, 1, generator=gen, dtype=torch.float64)
    a = 1 + 0.01 * torch.randn(1, cols, generator=gen, dtype=torch.float64)
    return (300 * u * a + 0.05 * torch.randn(B, cols, generator=gen,
                                             dtype=torch.float64)).to(dtype)


def _rounds(seed=7):
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(ROUNDS):
        s_c = _collinear(gen, P_VAN)
        s_q = torch.complex(_collinear(gen, P_FLOW), 0.1 * _collinear(gen, P_FLOW))
        F = torch.randn(B, generator=gen, dtype=torch.float64).float()
        E = torch.randn(B, generator=gen, dtype=torch.float64).float()
        out.append((s_c, s_q, F, E))
    return out


def _accumulate(rounds, dtype, acc=None):
    """The accumulators of ``make_accumulate_and_apply`` over ``rounds``,
    with the Fisher blocks in ``dtype`` (None: the float32 routes), into
    ``acc`` (default: ``init_accumulators``'s, made in ``dtype``)."""
    van, flow = _Leaf(P_VAN), _Leaf(P_FLOW)
    it = iter(rounds)
    current = {}

    def observables(van, flow, si, x, gen, v):
        s_c, s_q, F, E = next(it)
        current.update(s_c=s_c, s_q=s_q)
        data = {k: torch.zeros((), dtype=torch.float32) for k in
                ("F_mean", "F2_mean", "E_mean", "E2_mean", "K_mean", "K2_mean", "V_mean",
                 "V2_mean", "S_mean", "S2_mean")}
        data["F_mean"] = F.mean()
        data["E_mean"] = E.mean()
        return data, F, torch.complex(E, torch.zeros_like(E))

    def loss(van, flow, si, x, gen, v, group=None):
        raise AssertionError("the SR route takes the loss's two parts")

    # the weights as they come: no clipping
    loss.observables, loss.clip_window = observables, lambda data, F, E, group: (F, E)

    sr_opt = HybridFisherSR(None, None, None,
                            scores=lambda van, flow, si, x: (current["s_c"], current["s_q"]))
    accumulate, _ = make_accumulate_and_apply(loss, ROUNDS, sr_opt=sr_opt, fisher_dtype=dtype)
    if acc is None:
        acc = init_accumulators(van, flow, sr=True, fisher_dtype=dtype)
    x = torch.zeros(B, 1, 1)
    for _ in rounds:
        acc = accumulate(van, flow, None, x, None, acc)
    return acc, van, flow


def _float64_truth(rounds):
    """The same accumulators from the float32 scores in float64 arithmetic."""
    acc, van, flow = _accumulate(rounds, torch.float64)
    s_c = torch.cat([r[0] for r in rounds]).double()
    s_q = torch.cat([r[1] for r in rounds]).to(torch.complex128)
    acc["classical_fisher"] = s_c.T @ s_c / B
    acc["quantum_fisher"] = (s_q.real.T @ s_q.real + s_q.imag.T @ s_q.imag) / B
    return acc, van, flow


def _step(acc, van, flow):
    upd_van, upd_flow, _, _ = host_hybrid_apply(acc, ROUNDS, DAMPING, MAX_NORM, van=van,
                                                flow=flow)
    return upd_van, upd_flow


def _least_eigenvalue(fisher):
    M = fisher.double() / ROUNDS
    return float(torch.linalg.eigvalsh(M + DAMPING * torch.eye(M.shape[0],
                                                               dtype=M.dtype))[0])


def test_float32_sum_is_indefinite_and_its_step_far_off():
    rounds = _rounds()
    acc32, van, flow = _accumulate(rounds, None)
    assert acc32["classical_fisher"].dtype == torch.float32
    assert _least_eigenvalue(acc32["classical_fisher"]) < 0
    truth = _step(*_float64_truth(rounds))[0]
    counters.reset()
    got = _step(acc32, van, flow)[0]
    assert counters.events["sr.lu_fallbacks"] >= 1
    ratio = float(got.norm() / truth.norm())
    assert ratio > 2 or ratio < 0.5, ratio


def test_host64_step_agrees_with_float64_without_lu():
    rounds = _rounds()
    acc, van, flow = _accumulate(rounds, torch.float64)
    assert acc["classical_fisher"].dtype == torch.float64
    assert _least_eigenvalue(acc["classical_fisher"]) > 0
    truth = _step(*_float64_truth(rounds))
    counters.reset()
    got = _step(acc, van, flow)
    assert counters.events["sr.lu_fallbacks"] == 0
    assert counters.spans["sr.solve"]["calls"] == 1
    for g, t in zip(got, truth):
        assert float((g - t).norm() / t.norm()) < 1e-6


def test_host64_sum_over_rounds_is_one_float64_gram():
    rounds = _rounds(seed=11)
    acc, _, _ = _accumulate(rounds, torch.float64)
    s_c = torch.cat([r[0] for r in rounds]).double()
    s_q = torch.cat([r[1] for r in rounds]).to(torch.complex128)
    whole_c = s_c.T @ s_c / (ROUNDS * B)
    whole_q = (s_q.real.T @ s_q.real + s_q.imag.T @ s_q.imag) / (ROUNDS * B)
    for got, want in ((acc["classical_fisher"], whole_c), (acc["quantum_fisher"], whole_q)):
        assert float((got / ROUNDS - want).norm() / want.norm()) < 1e-12


def test_accumulators_made_in_float32_are_cast_at_the_first_round():
    rounds = _rounds(seed=3)
    want, _, _ = _accumulate(rounds, torch.float64)
    made = init_accumulators(_Leaf(P_VAN), _Leaf(P_FLOW), sr=True)
    assert made["classical_fisher"].dtype == torch.float32
    got, _, _ = _accumulate(rounds, torch.float64, acc=made)
    for k in ("classical_fisher", "quantum_fisher"):
        assert got[k].dtype == torch.float64
        assert torch.equal(got[k], want[k])


@pytest.mark.parametrize("solver", ["plain", "refined", "chol"])
def test_float32_routes_keep_their_formula_bit_for_bit(solver):
    args = argparse.Namespace(sr=True, sr_solver=solver)
    assert fisher_dtype(args) is None
    assert fisher_dtype(argparse.Namespace(sr=True, sr_solver="host64")) == torch.float64
    rounds = _rounds(seed=5)
    acc, _, _ = _accumulate(rounds, fisher_dtype(args))
    cf = torch.zeros(P_VAN, P_VAN)
    qf = torch.zeros(P_FLOW, P_FLOW)
    for s_c, s_q, _, _ in rounds:
        cf.add_(s_c.T @ s_c / B, alpha=1.0)
        qf.add_((s_q.real.T @ s_q.real + s_q.imag.T @ s_q.imag) / B, alpha=1.0)
    assert acc["classical_fisher"].dtype == torch.float32
    assert torch.equal(acc["classical_fisher"], cf)
    assert torch.equal(acc["quantum_fisher"], qf)
