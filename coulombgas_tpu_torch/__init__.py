"""coulombgas_tpu_torch: the PyTorch/CUDA port of coulombgas_tpu.

Finite-temperature variational Monte Carlo of the uniform electron gas: a
causal-transformer autoregressive network over momentum occupations, a
FermiNet backflow feeding a plane-wave Slater determinant, Metropolis
sampling of coordinates, REINFORCE observables and gradients, and a hybrid
Fisher (stochastic-reconfiguration) update.  Module names follow the JAX
package; the Metropolis log-density and the flow's Jacobian and Laplacian run
on hand-written CUDA kernels (``csrc/``, wrapped in ``ops/cuda_*.py``).
"""

from . import config  # noqa: F401  (importing it sets the TF32 policy)

__version__ = "0.1.0"
