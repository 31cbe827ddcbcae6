"""Fake-quantization grids, forward only (``fqss_tpu/quant/fake_quant.py``).

Plain PyTorch versions of the integer grids the whole framework must match.
Rounding is ``torch.round`` (half to even, like ``jnp.round``).

Every division by the grid size goes through :func:`true_div`. On CUDA,
PyTorch divides by a Python number as a multiplication by its reciprocal,
which can differ from IEEE division by one ulp; the CUDA kernels and these
plain versions both use IEEE division so that they agree bit for bit, and
agree with the eager JAX functions bit for bit.

XLA makes the reciprocal rewrite under ``jit``, so a jitted JAX model can
sit one ulp of the step size away from this grid. That ulp matters: the
one-shot weight observer sets each channel's range at its extreme weight,
which then lies exactly on a half-step tie (±127.5 steps), and the ulp
decides whether it rounds to -128 or -127. It is the source of the
differences between the port and the jitted JAX model that the parity tests
allow for.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def qrange(n_bits: int, sign: bool) -> tuple[int, int]:
    """Integer grid limits: signed -> [-2^(n-1), 2^(n-1)-1], unsigned [0, 2^n-1]."""
    if sign:
        return -(2 ** (n_bits - 1)), 2 ** (n_bits - 1) - 1
    return 0, 2**n_bits - 1


def true_div(a: Tensor, q: float) -> Tensor:
    """``a / q`` as IEEE division on every device (see the module note)."""
    return a / torch.full_like(a, float(q))


def linear_fake_quant(
    x: Tensor,
    min_range: Tensor,
    max_range: Tensor,
    n_bits: int,
    sym: bool = False,
) -> Tensor:
    """Linear fake quantization, forward (reference qat_quant.py:125-147).

    sym=True : symmetric signed grid from per-channel max-abs (the weight
               quantizers' grid). Ranges broadcast against x.
    sym=False: uniform asymmetric grid, zero-point = min_range.
    """
    if sym:
        qmin, qmax = qrange(n_bits, True)
        max_abs = torch.maximum(min_range.abs(), max_range.abs())
        delta = true_div(2.0 * max_abs, 2**n_bits - 1)
        return delta * torch.round(x / delta).clamp(qmin, qmax)
    qmax = 2**n_bits - 1
    delta = true_div(max_range - min_range, qmax)
    return delta * torch.round((x - min_range) / delta).clamp(0, qmax) + min_range


def splitter_quantize(x: Tensor, threshold: float | Tensor = 1.0, n_bits: int = 8, sign: bool = True) -> Tensor:
    """Floor-based uniform quantizer of the input splitter (reference process.py:10-14).

    delta = threshold / 2^(n_bits - sign); y = clip(floor(x/delta), Qmin, Qmax) * delta.
    """
    delta = threshold / (2 ** (n_bits - int(sign)))
    min_val = -(2 ** (n_bits - int(sign))) if sign else 0
    max_val = 2 ** (n_bits - int(sign)) - 1
    return torch.floor(x / delta).clamp(min_val, max_val) * delta
