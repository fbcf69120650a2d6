"""Numpy pieces shared by the models of the warp-per-row flow kernels
(``csrc/flow_d2.cu``: K5 and K6; ``csrc/flow_large.cu``: K4), as
``csrc/flow_pair.cuh`` shares them between the kernels: the fixed-order
shuffle trees over a warp's lanes, the pair features a lane makes in
registers, and the kernels' packed weight order."""

import numpy as np
import torch

WARP = 32


def _sigmoid(v):
    return 1.0 / (1.0 + np.exp(-v))


def _softplus(v):
    return np.logaddexp(v, 0.0)


def _pow2(v):
    return 1 << max(0, int(v - 1).bit_length())


def _tree(a):
    """The kernel's warp reduction of V values a lane, a (32, V) with V a
    power of two <= 32: halving rounds at lane offsets 16, 8, ... (a lane
    with the offset's bit keeps the upper half of its values and adds the
    partner's upper half; the other the lower halves), then butterfly rounds
    over the remaining offsets.  Returns (32,): lane L holds the sum over
    the lanes of value L >> (5 - log2 V)."""
    a = np.array(a, dtype=np.float64)
    lane = np.arange(WARP)
    o = 16
    while a.shape[1] > 1:
        h = a.shape[1] // 2
        hi = (lane & o) != 0
        keep = np.where(hi[:, None], a[:, h:], a[:, :h])
        send = np.where(hi[:, None], a[:, :h], a[:, h:])
        a = keep + send[lane ^ o]
        o //= 2
    a = a[:, 0]
    while o >= 1:
        a = a + a[lane ^ o]
        o //= 2
    return a


def _tree_sums(a, V=None):
    """The sums of a (32, v) by ``_tree`` over V >= v values (zero-padded;
    by default v rounded up to a power of two), read from the lanes that
    hold them."""
    v = a.shape[1]
    V = V or _pow2(v)
    held = _tree(np.pad(a, ((0, 0), (0, V - v))))
    return held[::WARP // V][:v]


def _butterfly(a):
    """xor-butterfly sum of one value a lane (32,): every lane gets it."""
    lane = np.arange(WARP)
    for o in (16, 8, 4, 2, 1):
        a = a + a[lane ^ o]
    return a[0]


def _packed(flow):
    """The flow's weights in the kernels' packed order, f64."""
    parts = []
    for lin in [*flow.sp, *flow.tp, flow.final]:
        parts += [lin.w.detach().reshape(-1), lin.b.detach().reshape(-1)]
    return torch.cat(parts).double().numpy()


def _unpack(p, dim, S, T):
    C0, off, out = 2 * dim + 1, 0, []
    for rows, cols in ((2 * dim + C0, S), (2 * S + T, S), (C0, T), (S, dim)):
        out.append(p[off:off + rows * cols].reshape(rows, cols))
        off += rows * cols
        out.append(p[off:off + cols])
        off += cols
    assert off == p.size
    return out


def _pair(x, i, L_, k1, k2, Lbox):
    """Features of the pairs (i, j), j = the lanes' columns: e (32, C0), the
    A0 entries alpha, beta, gamma (32, dim) and hd (32,) = sum_a d^2 d / d r_a^2
    (with 1 / d taken as 1 where d = 0, as the plain versions do); zero for
    j == i and for a lane without a pair."""
    n, dim = x.shape
    j = np.minimum(L_, n - 1)
    r = x[i] - x[j]
    r = r - Lbox * np.rint(r / Lbox)  # the features have period L in r
    s1, c1 = np.sin(k1 * r), np.cos(k1 * r)
    c2, s2 = 1.0 - 2.0 * s1 * s1, 2.0 * s1 * c1
    self_ = (L_ == i)[:, None]
    d = np.where(self_[:, 0], 0.0, np.sqrt((s1 * s1).sum(1)))
    safe = np.where(d > 0, d, 1.0)
    gam = np.where(self_, 0.0, k1 * s1 * c1 / safe[:, None])
    hd = k1 * k1 * ((c2 / safe[:, None]).sum(1) - ((s1 * c1) ** 2).sum(1) / safe**3)
    e = np.concatenate([c2, s2, d[:, None]], axis=1)
    alpha = np.where(self_, 0.0, -k2 * s2)
    beta = np.where(self_, 0.0, k2 * c2)
    valid = (L_ < n)[:, None]
    hd = np.where(self_[:, 0], 0.0, hd) * valid[:, 0]
    return e * valid, alpha * valid, beta * valid, gam * valid, hd
