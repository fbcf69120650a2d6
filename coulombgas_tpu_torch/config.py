"""Precision and device policy of the PyTorch/CUDA port.

  * on the CPU (tests, oracles):  float64 / complex128,
  * on the GPU (production):      float32 / complex64,

and every entry point runs on ``cuda`` unless the caller asks for the CPU.
Asking for CUDA where there is none raises: nothing in the port moves work
to the CPU on its own.

TF32 is switched off here, once, for matmuls and cuDNN: the Gram matrices of
the log-determinants and the flow layers lose about three decimal digits in
TF32, which shows as a logp error of order 0.1 against the f64 oracle.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["Precision", "F32", "F64", "default_precision", "resolve_device",
           "complex_dtype"]

# True-f32 matrix products everywhere (see module docstring).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclass(frozen=True)
class Precision:
    """Dtype bundle used across the port."""

    real: torch.dtype
    complex: torch.dtype

    @property
    def is_x64(self) -> bool:
        return self.real == torch.float64


F32 = Precision(real=torch.float32, complex=torch.complex64)
F64 = Precision(real=torch.float64, complex=torch.complex128)


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA.  Raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (or --cpu) to run on the CPU"
        )
    return dev


def default_precision(device=None) -> Precision:
    """f64 on the CPU, f32 on the GPU."""
    return F64 if resolve_device(device).type == "cpu" else F32


def complex_dtype(real_dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if real_dtype == torch.float64 else torch.complex64
