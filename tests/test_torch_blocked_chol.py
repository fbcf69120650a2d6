"""The blocked, deflating elimination order of the fused log-density kernel
(``csrc/chol_blocked.cuh``, K2) as a numpy model, against the one-step-at-a-time
eliminations it replaces: the port's ``chol_logdet_ref``, the plain Hermitian
elimination ``cuda_fused_logp._herm_chol_logdet`` and the JAX package's
``chol_logdet_ref``, all f64 on the CPU; and, for the whole log-density with
its Hermitian Gram, the JAX package's Pallas kernel in interpret mode (f32).

The model follows the kernel step for step: panels of ``nb`` columns; inside a
panel the columns are eliminated one after the other over all rows below; a
pivot below the floor adds log(PIVOT_FLOOR), zeroes its column below the
diagonal and gets the inverse pivot 0; then the trailing block takes the
rank-``nb`` product sum_k (A[r][k] / d_k) conj(A[c][k]) at once.  Reordering
the same updates changes only roundoff, so the model agrees with the
references to 1e-9 where no pivot is near the floor, and exactly where a zero
row and column deflate a pivot.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coulombgas_tpu.ops import logdet as jl
from coulombgas_tpu.ops.pallas_fused_logp import fused_logp_pallas
from coulombgas_tpu_torch.ops import cuda_fused_logp
from coulombgas_tpu_torch.ops import logdet as tl

FLOOR = tl.PIVOT_FLOOR
NBS = (1, 4, 8, 16)
MS = (29, 58, 114)


def blocked_chol_logdet(A, nb):
    """log det of one real symmetric or complex Hermitian matrix, deflating,
    in the kernel's blocked order."""
    A = np.array(A, copy=True)
    m = A.shape[0]
    ld = 0.0
    for k0 in range(0, m, nb):
        k1 = min(k0 + nb, m)
        invd = np.zeros(k1 - k0)
        for k in range(k0, k1):  # the panel, column by column
            d = A[k, k].real
            if d < FLOOR:
                ld += math.log(FLOOR)
                A[k + 1:, k] = 0
                continue
            ld += math.log(d)
            invd[k - k0] = 1.0 / d
            col = A[k + 1:, k] * invd[k - k0]
            for c in range(k + 1, k1):  # rows r >= c of the panel's later columns
                A[c:, c] -= col[c - k - 1:] * np.conj(A[c, k])
        if k1 < m:  # the rank-nb trailing product
            U = A[k1:, k0:k1] * invd
            A[k1:, k1:] -= U @ np.conj(A[k1:, k0:k1]).T
    return ld


def _spd(rng, m, complex_=False):
    X = rng.normal(size=(m, m + 3))
    if complex_:
        X = X + 1j * rng.normal(size=(m, m + 3))
    return X @ np.conj(X).T / m + 0.1 * np.eye(m)


def _zero(A, cols):
    A = A.copy()
    for c in cols:
        A[c, :] = 0
        A[:, c] = 0
    return A


def _references(As, complex_):
    """Each reference's log det of the stack As (f64 / complex128)."""
    if complex_:
        return [cuda_fused_logp._herm_chol_logdet(torch.from_numpy(As)).numpy()]
    return [tl.chol_logdet_ref(torch.from_numpy(As)).numpy(),
            np.asarray(jl.chol_logdet_ref(jnp.asarray(As)))]


def _cases(m, nb, complex_, seed):
    """Well-conditioned matrices; the same with one zero row and column at the
    first, the middle and the last column of the second panel (so each is
    deflated after a full panel of updates); and the zero matrix, where every
    pivot deflates."""
    rng = np.random.default_rng(seed)
    A = _spd(rng, m, complex_)
    p0 = nb if 2 * nb <= m else 0
    out = [A, _spd(rng, m, complex_)]
    out += [_zero(A, [p0 + off]) for off in sorted({0, nb // 2, nb - 1})]
    out.append(_zero(A, [p0, p0 + nb - 1]) if nb > 1 else _zero(A, [p0, p0 + 2]))
    out.append(np.zeros_like(A))
    return np.stack(out)


@pytest.mark.parametrize("complex_", [False, True], ids=["real", "hermitian"])
@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("nb", NBS)
def test_blocked_order_matches_the_one_step_eliminations(nb, m, complex_):
    As = _cases(m, nb, complex_, seed=100 * nb + m)
    got = np.array([blocked_chol_logdet(A, nb) for A in As])
    for ref in _references(As, complex_):
        np.testing.assert_allclose(got, ref, rtol=1e-11, atol=1e-9)
    # deflation is exact: a zero row and column costs log(FLOOR) and leaves
    # the rest of the matrix's log det as it was without that row and column
    offs = sorted({0, nb // 2, nb - 1})
    p0 = nb if 2 * nb <= m else 0
    for case, cols in zip(As[2:2 + len(offs)], [[p0 + o] for o in offs]):
        keep = [i for i in range(m) if i not in cols]
        sub = case[np.ix_(keep, keep)]
        want = np.linalg.slogdet(sub)[1] + len(cols) * math.log(FLOOR)
        assert abs(blocked_chol_logdet(case, nb) - want) < 1e-8
    assert got[-1] == pytest.approx(m * math.log(FLOOR), rel=1e-14)


@pytest.mark.parametrize("nb", [8])
def test_fused_logp_plain_equals_the_blocked_model(nb):
    """The plain fused log-density (the CPU path of the kernel's wrapper), the
    two blocked eliminations of its Grams and the JAX package's Pallas kernel
    in interpret mode, on one walker with a deflated column of J in the
    middle of a panel.  The Pallas kernel is f32: atol 5e-3, as in
    tests/test_fused_logp.py."""
    rng = np.random.default_rng(7)
    n, dim = 13, 2
    L = math.sqrt(math.pi * n)
    u = rng.uniform(0, L, (1, n, dim))
    k = 2 * math.pi / L * rng.integers(-3, 4, (1, n, dim)).astype(float)
    k[0, :, 0] += np.arange(n)  # distinct momenta: D is regular
    J = np.eye(n * dim)[None] + 0.3 * rng.normal(size=(1, n * dim, n * dim))
    J[0, :, nb + nb // 2] = 0
    D = L ** (-dim / 2) * np.exp(1j * u[0] @ k[0].T)
    want = (blocked_chol_logdet(np.conj(D).T @ D, nb)
            + 0.5 * blocked_chol_logdet(J[0].T @ J[0], nb))
    got = cuda_fused_logp.fused_logp_plain(*(torch.from_numpy(a) for a in (u, k, J)), L)
    assert float(got[0]) == pytest.approx(want, abs=1e-9)
    ref = fused_logp_pallas(*(jnp.asarray(a, jnp.float32) for a in (u, k, J)), L, interpret=True)
    assert float(np.asarray(ref)[0]) == pytest.approx(want, abs=5e-3)
