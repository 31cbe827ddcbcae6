"""Nonlinearities of the quantized layers (``fqss_tpu/nn/nonlin.py``).

ReLU, PReLU (one learnable slope, torch's init 0.25), the sigmoid, tanh,
the exact (erf) GELU (and its derivative, :func:`gelu_grad`) and the GLU. LeakyReLU, the one kind of the JAX
module not used by a ported model, raises ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

SQRT_HALF = float(np.float32(np.sqrt(0.5)))
TWO_OVER_SQRT_PI = float(np.float32(2.0 / np.sqrt(np.pi)))  # erfc'(z) = -(2 / sqrt(pi)) exp(-z^2)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=False)`` operation for operation: ``0.5 x erfc(-x sqrt(1/2))``. The kernels'
    GELU epilogues (K5, K4) compute the same expression with CUDA's ``erfcf``, which PyTorch's ``erfc`` calls on the
    card."""
    return (0.5 * x) * torch.special.erfc(-x * SQRT_HALF)


def gelu_grad(x: torch.Tensor) -> torch.Tensor:
    """d gelu(x) / dx as JAX's autodiff of :func:`gelu` computes it for a unit cotangent, operation for operation:
    with ``d = -x sqrt(1/2)``, ``0.5 erfc(d) - ((-(2 / sqrt(pi)) (0.5 x)) exp(-d^2)) sqrt(1/2)``. K5-bwd's GELU
    route (``csrc/fake_quant.cuh:gelu_with_grad``) computes the same expression with CUDA's ``erfcf`` and ``expf``."""
    d = -x * SQRT_HALF
    q = ((-TWO_OVER_SQRT_PI * (0.5 * x)) * torch.exp(-(d * d))) * SQRT_HALF
    return -q + 0.5 * torch.special.erfc(d)


def glu(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """``a * sigmoid(b)`` of the two halves of ``dim``: the channels of an NCT/NCHW tensor (JAX splits its last
    axis, the same channels)."""
    a, b = x.chunk(2, dim=dim)
    return a * torch.sigmoid(b)


class Nl(nn.Module):
    """Named nonlinearity; ``kind=None``/"identity" is a no-op. The GLU halves the channels (axis 1)."""

    def __init__(self, kind: str | None = None):
        super().__init__()
        self.kind = (kind or "identity").lower()
        if self.kind == "prelu":
            self.alpha = nn.Parameter(torch.full((1,), 0.25))
        elif self.kind not in ("identity", "none", "relu", "sigmoid", "tanh", "gelu", "glu"):
            raise NotImplementedError(f"nonlinearity {kind!r} is not ported yet (ROADMAP.md, queue 1)")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "relu":
            return F.relu(x)
        if self.kind == "prelu":
            return F.prelu(x, self.alpha)
        if self.kind == "sigmoid":
            return torch.sigmoid(x)
        if self.kind == "tanh":
            return torch.tanh(x)
        if self.kind == "gelu":
            return gelu(x)
        if self.kind == "glu":
            return glu(x)
        return x
