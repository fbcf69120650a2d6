"""Exponentially-weighted moving statistics of logged observables.

The port's copy of ``coulombgas_tpu/analysis/ewm.py`` (capability parity
with reference analysis/ewm.py:4-17).  Implemented directly
(numpy recursion) rather than through pandas, with the same bias-corrected
("adjust=False, bias=True") semantics:

    m_t = (1-a) m_{t-1} + a x_t,        m_0 = x_0
    v_t = (1-a)(v_{t-1} + a (x_t - m_{t-1})^2),   v_0 = 0
"""

from __future__ import annotations

import numpy as np

__all__ = ["running_average"]


def running_average(data, alpha):
    """EWM mean and (biased) variance of a 1-D series; returns two arrays."""
    data = np.asarray(data, dtype=float)
    mean = np.empty_like(data)
    var = np.empty_like(data)
    m, v = data[0], 0.0
    mean[0], var[0] = m, v
    for t in range(1, data.size):
        delta = data[t] - m
        v = (1 - alpha) * (v + alpha * delta**2)
        m = m + alpha * delta
        mean[t], var[t] = m, v
    return mean, var
