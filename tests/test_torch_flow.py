"""The port's FermiNet flow and its analytic Jacobian against the JAX package.

Same numpy inputs and parameters through both; f64 on the CPU, so plain
algebra agrees to 1e-10.  The plain version of the flow kernel
(``flow_u_jac_plain``) is additionally held against the Pallas kernel run in
interpret mode in f32, at the JAX tests' own tolerance (atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import coulombgas_tpu as cg
from coulombgas_tpu.ops.pallas_flow_jac import flow_u_jac_pallas
from coulombgas_tpu_torch.models.ferminet import (
    FermiNetConfig, ferminet_apply, init_ferminet_params, softplus,
)
from coulombgas_tpu_torch.models.ferminet_jac import (
    ferminet_apply_and_jac, ferminet_apply_and_jac_d2, ferminet_apply_jac_lap,
    ferminet_apply_jac_lap_d2, select_flow_jac,
)
from coulombgas_tpu_torch.ops import counters, cuda_flow_jac

from _torch_helpers import box, flow_pair, t

# depth 1 needs spsize == dim: the reference adds the first layer's output to
# the (n, dim) zero stream
CASES = [(1, 2, 2, 6, 5), (2, 2, 8, 6, 6), (3, 2, 6, 8, 5), (2, 3, 8, 8, 4)]


def _x(n, dim, batch=4, seed=1, dtype=np.float64):
    return np.random.default_rng(seed).uniform(0, box(n, dim), (batch, n, dim)).astype(dtype)


@pytest.mark.parametrize("depth,dim,spsize,tpsize,n", CASES)
def test_ferminet_apply_matches_jax(depth, dim, spsize, tpsize, n):
    cfg, params, flow = flow_pair(depth, spsize, tpsize, n, dim)
    x = _x(n, dim)
    ref = jax.jit(jax.vmap(lambda q: cg.ferminet_apply(params, cfg, q)))(jnp.asarray(x))
    with torch.no_grad():
        got = ferminet_apply(flow, t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-10)
    # the module's forward is the same function, and takes one walker too
    with torch.no_grad():
        np.testing.assert_allclose(flow(t(x[0])).numpy(), np.asarray(ref[0]),
                                   rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("depth,dim,spsize,tpsize,n", CASES)
def test_apply_and_jac_matches_jax(depth, dim, spsize, tpsize, n):
    """u and J element by element: log det(J^T J) is blind to a permutation of
    J's rows or columns, the analytic Laplacian is not."""
    cfg, params, flow = flow_pair(depth, spsize, tpsize, n, dim)
    x = _x(n, dim)
    u_ref, J_ref = jax.jit(jax.vmap(lambda q: cg.ferminet_apply_and_jac(params, cfg, q)))(jnp.asarray(x))
    with torch.no_grad():
        u, J = ferminet_apply_and_jac(flow, t(x))
    assert J.shape == (x.shape[0], n * dim, n * dim)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_ref), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(J.numpy(), np.asarray(J_ref), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("depth,dim,spsize,tpsize,n", CASES[1:3])
def test_jac_matches_autograd(depth, dim, spsize, tpsize, n):
    _, _, flow = flow_pair(depth, spsize, tpsize, n, dim)
    x = t(_x(n, dim, batch=1)[0])
    J_ad = torch.autograd.functional.jacobian(
        lambda q: ferminet_apply(flow, q.reshape(n, dim)).reshape(-1), x.reshape(-1))
    with torch.no_grad():
        _, J = ferminet_apply_and_jac(flow, x)
    np.testing.assert_allclose(J.numpy(), J_ad.numpy(), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("depth,dim,spsize,tpsize,n", CASES)
def test_apply_jac_lap_matches_jax(depth, dim, spsize, tpsize, n):
    cfg, params, flow = flow_pair(depth, spsize, tpsize, n, dim)
    x = _x(n, dim)
    ref = jax.jit(jax.vmap(lambda q: cg.ferminet_apply_jac_lap(params, cfg, q)))(jnp.asarray(x))
    with torch.no_grad():
        got = ferminet_apply_jac_lap(flow, t(x))
    assert got[2].shape == (x.shape[0], n * dim)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("depth,dim,n", [(2, 2, 7), (3, 2, 5), (2, 3, 6)])
def test_plain_version_matches_pallas_kernel_interpret(depth, dim, n):
    """The kernel's plain version against the TPU kernel itself (interpret
    mode, f32): atol 1e-5, as in tests/test_flow_jac_pallas.py."""
    cfg, params, flow = flow_pair(depth, 16, 16, n, dim, dtype=np.float32, stddev=0.05)
    x = _x(n, dim, batch=9, dtype=np.float32)
    u_t, J_t = flow_u_jac_pallas(params, cfg, jnp.asarray(x), interpret=True)
    u, J = cuda_flow_jac.flow_u_jac_cuda(flow, t(x))  # CPU tensor: the plain version
    np.testing.assert_allclose(u.numpy(), np.moveaxis(np.asarray(u_t), -1, 0), atol=1e-5)
    np.testing.assert_allclose(J.numpy(), np.moveaxis(np.asarray(J_t), -1, 0), atol=1e-5)


def test_wrapper_takes_plain_version_only_for_cpu_tensors():
    _, _, flow = flow_pair(2, 8, 8, 5, 2)
    x = t(_x(5, 2))
    before = dict(counters.launches)
    u, J = cuda_flow_jac.flow_u_jac_cuda(flow, x)
    assert counters.launches == before  # no kernel was launched
    assert not u.requires_grad and not J.requires_grad
    with torch.no_grad():
        u_p, J_p = cuda_flow_jac.flow_u_jac_plain(flow, x)
    assert torch.equal(u, u_p) and torch.equal(J, J_p)
    with pytest.raises(ValueError):
        cuda_flow_jac.flow_u_jac_cuda(flow, x[0])


def test_packed_parameters_follow_the_kernel_layout():
    for depth, dim, S, T in [(1, 2, 2, 6), (2, 2, 16, 16), (3, 3, 8, 12), (4, 2, 16, 8)]:
        flow = init_ferminet_params(FermiNetConfig(depth, S, T, 3.0), dim,
                                    torch.Generator().manual_seed(0), device="cpu")
        packed = cuda_flow_jac.pack_flow_params(flow)
        assert packed.dtype == torch.float32
        assert packed.numel() == sum(p.numel() for p in flow.parameters())
        assert torch.equal(packed[: flow.sp[0].w.numel()], flow.sp[0].w.detach().reshape(-1))
        assert torch.equal(packed[-dim:], flow.final.b.detach())


def test_softplus_has_no_threshold_switch():
    x = torch.tensor([-50.0, -1.0, 0.0, 1.0, 25.0, 50.0], dtype=torch.float64)
    ref = np.asarray(jax.nn.softplus(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(softplus(x).numpy(), ref, rtol=1e-14, atol=0)
    # torch's own softplus returns x above its threshold of 20
    assert softplus(x)[4] != x[4]


def test_select_flow_jac():
    cfg = FermiNetConfig(2, 8, 8, 3.0)
    assert select_flow_jac(cfg, "auto") == (ferminet_apply_and_jac, ferminet_apply_jac_lap)
    assert select_flow_jac(cfg, "carried") == select_flow_jac(cfg, "auto")
    assert select_flow_jac(cfg, "d2") == (ferminet_apply_and_jac_d2, ferminet_apply_jac_lap_d2)
    with pytest.raises(ValueError):  # the closed form is exact for depth 2 only
        select_flow_jac(FermiNetConfig(3, 8, 8, 3.0), "d2")
    with pytest.raises(ValueError):
        select_flow_jac(cfg, "other")


def test_flow_equivariances():
    """Translation and permutation equivariance, lattice compatibility."""
    _, _, flow = flow_pair(2, 8, 8, 6, 2)
    L = flow.cfg.L
    x = t(_x(6, 2, batch=1)[0])
    with torch.no_grad():
        z = ferminet_apply(flow, x)
        a = torch.tensor([0.3, -1.1], dtype=torch.float64)
        np.testing.assert_allclose(ferminet_apply(flow, x + a).numpy(), (z + a).numpy(), atol=1e-12)
        R = torch.tensor([[1.0, 0.0], [0, 0], [0, -2.0], [0, 0], [3.0, 1.0], [0, 0]], dtype=torch.float64)
        np.testing.assert_allclose(ferminet_apply(flow, x + R * L).numpy(), (z + R * L).numpy(), atol=1e-10)
        perm = torch.tensor([3, 0, 5, 1, 4, 2])
        np.testing.assert_allclose(ferminet_apply(flow, x[perm]).numpy(), z[perm].numpy(), atol=1e-12)
