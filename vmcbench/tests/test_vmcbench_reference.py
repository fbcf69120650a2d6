"""The reference against the port's plain CPU path at n 7, float64, on
random parameters: the VAN's log p, the flow with its Jacobian and
Laplacian, log Psi, its coordinate gradient and Laplacian (exact and
Hutchinson), and the Ewald potential."""

import math

import numpy as np
import pytest
import torch

from reference import model

from coulombgas_tpu_torch.models.ferminet import FermiNetConfig, init_ferminet_params
from coulombgas_tpu_torch.models.ferminet_jac import ferminet_apply_jac_lap
from coulombgas_tpu_torch.models.ferminet import ferminet_apply
from coulombgas_tpu_torch.models.transformer import TransformerConfig, init_transformer_params
from coulombgas_tpu_torch.physics.ewald import kpoints, potential_energy
from coulombgas_tpu_torch.physics.orbitals import sp_orbitals, twist_sort
from coulombgas_tpu_torch.sampling.autoregressive import make_autoregressive_sampler
from coulombgas_tpu_torch.wavefunction.fast_laplacian import (
    make_logpsi_grad_laplacian_analytic,
)
from coulombgas_tpu_torch.wavefunction.logpsi import make_logpsi

N, DIM, EMAX, B = 7, 2, 9, 6
F64 = torch.float64


@pytest.fixture(scope="module")
def setup():
    gen = torch.Generator().manual_seed(5)
    L = math.sqrt(math.pi * N)
    sp, _ = sp_orbitals(DIM, EMAX)
    tw = twist_sort(sp, np.array([0.25, 0.25]))[0][::-1].copy()
    M = len(sp)
    van = init_transformer_params(TransformerConfig(M, 2, 16, 4, 32), DIM, gen, F64, "cpu")
    flow = init_ferminet_params(FermiNetConfig(2, 16, 16, L, init_stddev=0.1), DIM, gen, F64,
                                "cpu")
    with torch.no_grad():
        for p in [*van.parameters(), *flow.parameters()]:
            p.add_(0.05 * torch.randn(p.shape, generator=gen, dtype=F64))
    sampler, log_prob = make_autoregressive_sampler(tw, N, M)
    states = sampler(van, torch.Generator().manual_seed(3), B)
    x = L * torch.rand(B, N, DIM, generator=gen, dtype=F64)
    Pv = {k: v.detach() for k, v in van.named_parameters()}
    Pf = {k: v.detach() for k, v in flow.named_parameters()}
    table = torch.as_tensor(model.twisted_momenta(DIM, EMAX, [0.25, 0.25]), dtype=F64)
    return dict(L=L, tw=tw, van=van, flow=flow, log_prob=log_prob, states=states, x=x, Pv=Pv,
                Pf=Pf, table=table, k=2 * math.pi / L * table[states])


def test_momenta_match(setup):
    np.testing.assert_array_equal(model.twisted_momenta(DIM, EMAX, [0.25, 0.25]), setup["tw"])


def test_van_log_prob(setup):
    s = setup
    ref = model.van_log_prob(s["Pv"], s["table"], s["states"], 2, 4)
    torch.testing.assert_close(ref, s["log_prob"](s["van"], s["states"]), rtol=1e-12, atol=1e-12)


def test_flow_and_jacobian(setup):
    s = setup
    z, J, lap = model.flow_jac(s["Pf"], s["x"], 2, s["L"], lap=True)
    z0, J0, lap0 = ferminet_apply_jac_lap(s["flow"], s["x"])
    for a, b in ((z, z0), (J, J0), (lap, lap0)):
        torch.testing.assert_close(a, b, rtol=1e-11, atol=1e-11)
    torch.testing.assert_close(model.flow_apply(s["Pf"], s["x"], 2, s["L"]),
                               ferminet_apply(s["flow"], s["x"]), rtol=1e-12, atol=1e-12)


def test_logpsi(setup):
    s = setup
    port = make_logpsi(ferminet_apply, s["tw"], s["L"])(s["x"], s["flow"], s["states"])
    ref = model.logpsi(s["Pf"], s["x"], s["k"], 2, s["L"])
    torch.testing.assert_close(ref[:, 0], port[:, 0], rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(torch.remainder(ref[:, 1] - port[:, 1] + math.pi, 2 * math.pi),
                               torch.full((B,), math.pi, dtype=F64), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("hutchinson", [False, True])
def test_grad_laplacian(setup, hutchinson):
    s = setup
    v = torch.randn(B, N, DIM, generator=torch.Generator().manual_seed(9), dtype=F64)
    port = make_logpsi_grad_laplacian_analytic(s["tw"], s["L"], ferminet_apply_jac_lap,
                                               hutchinson=hutchinson)
    g0, l0 = port(s["x"], s["flow"], s["states"], None, v)
    g, lap = model.grad_laplacian(s["Pf"], s["x"], s["k"], 2, s["L"], v if hutchinson else None)
    torch.testing.assert_close(g, g0, rtol=1e-9, atol=1e-9)
    torch.testing.assert_close(lap, l0, rtol=1e-9, atol=1e-9)


def test_exact_laplacian_columns_agree(setup):
    s = setup
    _, one = model.ljd_grad_lap(s["Pf"], s["x"], 2, s["L"], columns=1)
    _, many = model.ljd_grad_lap(s["Pf"], s["x"], 2, s["L"], columns=5)
    torch.testing.assert_close(one, many, rtol=1e-12, atol=1e-12)


def test_potential(setup):
    s = setup
    G = kpoints(DIM, 5)
    np.testing.assert_array_equal(model.kpoints(DIM, 5), G)
    torch.testing.assert_close(model.potential(s["x"], 10, G, s["L"], 1.0),
                               potential_energy(s["x"], 10, G, s["L"], 1.0),
                               rtol=1e-12, atol=1e-12)
