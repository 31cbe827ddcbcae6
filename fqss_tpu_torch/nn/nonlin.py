"""Nonlinearities of the quantized layers (``fqss_tpu/nn/nonlin.py``).

The ConvTasNet slice needs ReLU and PReLU (one learnable slope, torch's
init 0.25); the other kinds of the JAX module come with later slices.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Nl(nn.Module):
    """Named nonlinearity; ``kind=None``/"identity" is a no-op."""

    def __init__(self, kind: str | None = None):
        super().__init__()
        self.kind = (kind or "identity").lower()
        if self.kind == "prelu":
            self.alpha = nn.Parameter(torch.full((1,), 0.25))
        elif self.kind not in ("identity", "none", "relu"):
            raise NotImplementedError(f"nonlinearity {kind!r} is not ported yet (ROADMAP.md, queue 1)")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "relu":
            return F.relu(x)
        if self.kind == "prelu":
            return F.prelu(x, self.alpha)
        return x
