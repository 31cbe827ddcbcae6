"""Straight-through-estimator (STE) primitives (``fqss_tpu/quant/ste.py``).

Each op computes a non-differentiable value in the forward pass and lets the
gradient through (optionally rescaled) in the backward pass, written as
``x + (f(x) - x).detach()`` like the JAX package's ``stop_gradient`` form.
The forward values equal ``f(x)`` bit for bit: ``f(x) - x`` is exact for
rounding and flooring in float32 (the two operands lie within a factor of
two of each other, or one is zero), so adding ``x`` back gives ``f(x)``.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def round_ste(x: Tensor) -> Tensor:
    """Round half to even forward (``torch.round``, like ``jnp.round``), identity gradient."""
    return x + (torch.round(x) - x).detach()


def floor_ste(x: Tensor) -> Tensor:
    """Floor forward, identity gradient."""
    return x + (torch.floor(x) - x).detach()


def grad_sign(x: Tensor, scale: float | Tensor = 1.0) -> Tensor:
    """sign(x) forward; the gradient of ``scale * x`` backward."""
    x_scaled = x * scale
    return x_scaled + (torch.sign(x) - x_scaled).detach()


def grad_scale(x: Tensor, scale: float | Tensor) -> Tensor:
    """Identity forward (up to the rounding of ``x*s + (x - x*s)``); gradient times ``scale``.

    Used for the LSQ-style step-size gradient rescaling of ``scale_grad``.
    """
    x_scaled = x * scale
    return x_scaled + (x - x_scaled).detach()


def clip_ste(x: Tensor, min_val: float | Tensor = -1.0, max_val: float | Tensor = 1.0) -> Tensor:
    """Clip forward, identity gradient."""
    return x + (torch.clamp(x, min_val, max_val) - x).detach()
