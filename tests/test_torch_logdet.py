"""The port's log-determinant module and the plain versions of its two
log-det kernels against the JAX package.

f64 on the CPU: plain algebra to 1e-10, through log-dets and second
derivatives to 1e-8.  The plain versions are also held against the Pallas
kernels in interpret mode (f32) at the JAX tests' own tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coulombgas_tpu.ops import logdet as jl
from coulombgas_tpu.ops.pallas_fused_logp import fused_logp_pallas
from coulombgas_tpu.ops.pallas_logdet import chol_logdet_pallas
from coulombgas_tpu_torch.ops import counters, cuda_fused_logp, cuda_logdet
from coulombgas_tpu_torch.ops import logdet as tl

from _torch_helpers import t


def _spd(rng, batch, m, dtype=np.float64):
    M = rng.normal(size=(batch, m, m))
    return (M @ M.transpose(0, 2, 1) + 0.5 * np.eye(m)).astype(dtype)


def test_pivot_floor_is_the_reference_value():
    assert tl.PIVOT_FLOOR == jl.PIVOT_FLOOR == 1e-30


@pytest.mark.parametrize("m", [1, 4, 12])
def test_chol_logdet_ref_matches_jax_and_slogdet(m):
    A = _spd(np.random.default_rng(m), 5, m)
    got = tl.chol_logdet_ref(t(A)).numpy()
    np.testing.assert_allclose(got, np.asarray(jl.chol_logdet_ref(jnp.asarray(A))),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got, np.linalg.slogdet(A)[1], rtol=1e-10, atol=1e-10)


def test_chol_logdet_deflates_singular_input_like_jax():
    """Singular input -> finite, strongly negative, identical to the
    reference (torch.linalg.cholesky would raise here)."""
    rng = np.random.default_rng(3)
    A = _spd(rng, 4, 6)
    A[0] = 0.0                      # every pivot deflated
    A[1][:, 2] = 0.0
    A[1][2, :] = 0.0                # one zero pivot
    v = rng.normal(size=(6, 2))
    A[2] = v @ v.T                  # rank 2
    got = tl.chol_logdet_ref(t(A)).numpy()
    ref = np.asarray(jl.chol_logdet_ref(jnp.asarray(A)))
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got[[0, 1, 3]], ref[[0, 1, 3]], rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got[0], 6 * np.log(1e-30), rtol=1e-12)
    # the rank-2 matrix: which of the roundoff-sized pivots fall under the
    # floor may differ, both answers are far below any regular log-det
    assert got[2] < -100 and ref[2] < -100
    with pytest.raises(Exception):
        torch.linalg.cholesky(t(A[0]))


@pytest.mark.parametrize("dtype,m,route", [
    (torch.float32, 58, "kernel"), (torch.float32, cuda_logdet.K3_MAX_M + 1, "plain"),
    (torch.float64, 58, "plain"), (torch.float16, 58, "plain"),
])
def test_chol_logdet_dispatches_a_cuda_matrix_as_the_jax_package_does(monkeypatch, dtype, m,
                                                                       route):
    """A CUDA matrix goes to the kernel for f32 within its size limit, as the
    JAX dispatcher takes its kernel for f32 only, and to the plain elimination
    on its own device otherwise (the wrappers stubbed: no card here)."""
    from types import SimpleNamespace

    monkeypatch.setattr(cuda_logdet, "chol_logdet_cuda", lambda A: "kernel")
    monkeypatch.setattr(tl, "chol_logdet_ref", lambda A: "plain")
    A = SimpleNamespace(dtype=dtype, device=torch.device("cuda"), shape=(3, m, m))
    assert tl.chol_logdet(A) == route


def test_chol_logdet_single_takes_batch_dimensions():
    A = _spd(np.random.default_rng(0), 6, 5)
    one = tl.chol_logdet_single(t(A[0]))
    assert one.shape == ()
    many = tl.chol_logdet_single(t(A).reshape(2, 3, 5, 5))
    assert many.shape == (2, 3)
    np.testing.assert_allclose(many.reshape(-1).numpy(), np.linalg.slogdet(A)[1], rtol=1e-10)
    np.testing.assert_allclose(float(one), float(jl.chol_logdet_single(jnp.asarray(A[0]))), rtol=1e-12)


def test_gj_inverse_matches_jax_real_and_complex():
    rng = np.random.default_rng(5)
    A = _spd(rng, 3, 7)
    got = tl.gj_inverse_single(t(A)).numpy()
    ref = np.stack([np.asarray(jl.gj_inverse_single(jnp.asarray(a))) for a in A])
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got, np.linalg.inv(A), rtol=1e-8, atol=1e-10)
    D = rng.normal(size=(6, 6)) + 1j * rng.normal(size=(6, 6))
    H = D.conj().T @ D + 0.3 * np.eye(6)
    got = tl.gj_inverse_single(t(H)).numpy()
    np.testing.assert_allclose(got, np.asarray(jl.gj_inverse_single(jnp.asarray(H))),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got, np.linalg.inv(H), rtol=1e-8, atol=1e-10)


def test_logdet_spd_value_gradient_and_hvp_match_jax():
    """Value, gradient and Hessian-vector product of x -> logdet(J(x) J(x)^T)
    — the way the Hutchinson Laplacian uses it — against jax.grad and
    jvp-of-grad through the reference's custom rule."""
    rng = np.random.default_rng(7)
    m = 6
    B0 = rng.normal(size=(m, m)) + 3 * np.eye(m)
    T3 = 0.3 * rng.normal(size=(m, m, 4))
    x0 = rng.normal(size=4)
    v = rng.normal(size=4)

    def f_jax(x):
        J = jnp.asarray(B0) + jnp.sin(jnp.asarray(T3) @ x)
        return jl.logdet_spd_single(J @ J.T)

    val_ref = f_jax(jnp.asarray(x0))
    g_ref, hvp_ref = jax.jvp(jax.grad(f_jax), (jnp.asarray(x0),), (jnp.asarray(v),))

    x = t(x0).requires_grad_(True)
    J = t(B0) + torch.sin(t(T3) @ x)
    val = tl.logdet_spd_single(J @ J.T)
    (g,) = torch.autograd.grad(val, x, create_graph=True)
    (hvp,) = torch.autograd.grad((g * t(v)).sum(), x)
    np.testing.assert_allclose(float(val.detach()), float(val_ref), rtol=1e-10)
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(g_ref), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(hvp.numpy(), np.asarray(hvp_ref), rtol=1e-8, atol=1e-8)


def test_logdet_spd_batched_gradient_is_the_inverse():
    A = _spd(np.random.default_rng(9), 4, 5)
    At = t(A).requires_grad_(True)
    tl.logdet_spd_single(At).sum().backward()
    np.testing.assert_allclose(At.grad.numpy(), np.linalg.inv(A), rtol=1e-8, atol=1e-10)
    # and it agrees with autograd through the elimination itself
    Bt = t(A).requires_grad_(True)
    tl.chol_logdet_single(Bt).sum().backward()
    sym = 0.5 * (Bt.grad + Bt.grad.transpose(-1, -2))
    np.testing.assert_allclose(sym.numpy(), At.grad.numpy(), rtol=1e-8, atol=1e-10)


def test_gram_forms_match_jax():
    rng = np.random.default_rng(11)
    Dr, Di = rng.normal(size=(2, 4, 5, 5))
    got = tl.planewave_gram_embed(t(Dr), t(Di)).numpy()
    ref = np.asarray(jl.planewave_gram_embed(jnp.asarray(Dr), jnp.asarray(Di)))
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-10)
    J = rng.normal(size=(4, 6, 6)) + 2 * np.eye(6)
    np.testing.assert_allclose(tl.gram_logabsdet(t(J)).numpy(), np.linalg.slogdet(J)[1],
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(tl.gram_logabsdet(t(J)).numpy(),
                               np.asarray(jl.gram_logabsdet(jnp.asarray(J), use_pallas=False)),
                               rtol=1e-10, atol=1e-10)


def test_chol_logdet_kernel_plain_version_matches_pallas_interpret():
    """K3's plain version against the TPU kernel in interpret mode, f32, with
    a singular matrix in the batch (tolerances of tests/test_logdet.py)."""
    rng = np.random.default_rng(13)
    A = _spd(rng, 9, 10, np.float32)
    A[4] = 0.0
    ref = np.asarray(chol_logdet_pallas(jnp.asarray(A), interpret=True))
    before = dict(counters.launches)
    got = tl.chol_logdet(t(A)).numpy()  # the dispatcher; CPU tensor: plain version
    assert counters.launches == before
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    assert np.isfinite(got[4]) and got[4] < -600
    assert cuda_logdet.chol_logdet_plain is tl.chol_logdet_ref
    with pytest.raises(ValueError):
        cuda_logdet.chol_logdet_cuda(t(A)[0])


def _tail_inputs(rng, batch, n, dim, dtype):
    L = 3.7
    u = rng.uniform(0, L, (batch, n, dim)).astype(dtype)
    idx = np.stack([rng.permutation(4 * n)[:n] for _ in range(batch)])
    grid = np.stack(np.meshgrid(*[np.arange(-2, 3)] * dim), -1).reshape(-1, dim)[: 4 * n]
    kvec = (2 * np.pi / L * (grid[idx] + 0.25)).astype(dtype)
    J = (np.eye(n * dim) + 0.2 * rng.normal(size=(batch, n * dim, n * dim))).astype(dtype)
    return L, u, kvec, J


@pytest.mark.parametrize("dim,n", [(2, 5), (3, 4)])
def test_fused_logp_plain_matches_slogdet_oracle(dim, n):
    L, u, kvec, J = _tail_inputs(np.random.default_rng(dim), 6, n, dim, np.float64)
    D = L ** (-dim / 2) * np.exp(1j * np.einsum("bnd,bmd->bnm", u, kvec))
    ref = 2 * np.linalg.slogdet(D)[1] + np.linalg.slogdet(J)[1]
    got = cuda_fused_logp.fused_logp_cuda(t(u), t(kvec), t(J), L).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("dim,n", [(2, 5), (3, 4)])
def test_fused_logp_plain_matches_pallas_interpret(dim, n):
    """K2's plain version against the TPU kernel in interpret mode, f32:
    atol 5e-3 as in tests/test_fused_logp.py.  The last two walkers are
    singular.  A zero J deflates every pivot exactly: finite and strongly
    negative in both.  Two equal rows of u leave a roundoff-sized pivot in
    f32: finite and below every regular walker in both."""
    L, u, kvec, J = _tail_inputs(np.random.default_rng(10 + dim), 8, n, dim, np.float32)
    u[-2, 1] = u[-2, 0]
    J[-1] = 0.0
    ref = np.asarray(fused_logp_pallas(jnp.asarray(u), jnp.asarray(kvec), jnp.asarray(J), L,
                                       interpret=True))
    before = dict(counters.launches)
    got = cuda_fused_logp.fused_logp_cuda(t(u), t(kvec), t(J), L).numpy()
    assert counters.launches == before
    np.testing.assert_allclose(got[:-2], ref[:-2], rtol=0, atol=5e-3)
    assert np.all(np.isfinite(got)) and np.all(np.isfinite(ref))
    assert got[-2] < got[:-2].min() and ref[-2] < ref[:-2].min()
    np.testing.assert_allclose(got[-1], ref[-1], rtol=1e-5)
    assert got[-1] < -30 * n * dim


def test_fused_logp_wrapper_checks_shapes():
    L, u, kvec, J = _tail_inputs(np.random.default_rng(0), 3, 4, 2, np.float64)
    with pytest.raises(ValueError):
        cuda_fused_logp.fused_logp_cuda(t(u), t(kvec), t(J)[:, :-1], L)
    with pytest.raises(ValueError):
        cuda_fused_logp.fused_logp_cuda(t(u), t(kvec)[:, :-1], t(J), L)
    with pytest.raises(ValueError):
        cuda_logdet.chol_logdet_cuda(t(J)[:, :-1])
