"""Fake-quantization grids (``fqss_tpu/quant/fake_quant.py``).

Plain PyTorch versions of the integer grids the whole framework must match.
Rounding is ``torch.round`` (half to even, like ``jnp.round``).

:func:`linear_fake_quant` is differentiable with the JAX package's rules:
rounding passes the gradient straight through (:func:`round_ste`), and the
clip to the integer window is ``minimum(maximum(X, lo), hi)`` with tensor
bounds, whose gradient is 1 inside, 0 outside and 0.5 exactly at a bound
(torch's ``maximum``/``minimum`` split a tie evenly, as JAX's do;
``torch.clamp`` would pass all of it).

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

import math

import torch

from fqss_tpu_torch.quant.ste import grad_scale, round_ste

Tensor = torch.Tensor


def qrange(n_bits: int, sign: bool) -> tuple[int, int]:
    """Integer grid limits: signed -> [-2^(n-1), 2^(n-1)-1], unsigned [0, 2^n-1]."""
    if sign:
        return -(2 ** (n_bits - 1)), 2 ** (n_bits - 1) - 1
    return 0, 2**n_bits - 1


def true_div(a: Tensor, q: float) -> Tensor:
    """``a / q`` as IEEE division on every device (see the module note)."""
    return a / torch.full_like(a, float(q))


def act_scale(x: Tensor, n_bits: int, scale_grad: bool) -> float:
    """The LSQ factor 1/sqrt(Q·C) of the uniform grid, C = ``x.shape[1]`` (NCT); 1 without scale_grad."""
    return 1.0 / math.sqrt((2**n_bits - 1) * x.shape[1]) if scale_grad else 1.0


def weight_scale(channels: int, n_bits: int, scale_grad: bool) -> float:
    """The LSQ factor of the symmetric grid, with the signed Qmax as the reference takes it."""
    return 1.0 / math.sqrt((2 ** (n_bits - 1) - 1) * channels) if scale_grad else 1.0


def clip_tie(x: Tensor, lo: float, hi: float) -> Tensor:
    """``clip(x, lo, hi)`` whose gradient is 0.5 exactly at a bound (``jnp.clip``'s rule)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def linear_fake_quant(
    x: Tensor,
    min_range: Tensor,
    max_range: Tensor,
    n_bits: int,
    sym: bool = False,
    scale_grad: bool = False,
) -> Tensor:
    """Linear fake quantization with STE (reference qat_quant.py:125-147).

    sym=True : symmetric signed grid from per-channel max-abs (the weight
               quantizers' grid). Ranges broadcast against x.
    sym=False: uniform asymmetric grid, zero-point = min_range.

    ``scale_grad`` rescales the step size's gradient by 1/sqrt(Qmax * C)
    (LSQ). C is the number of range elements for ``sym``, and the channel
    count ``x.shape[1]`` of an NCT activation otherwise (JAX counts
    ``x.shape[-1]`` of its NTC layout: the same channels).

    Where no gradient is taken, rounding and clipping are plain
    ``torch.round`` and ``clamp``: the same values, without the STE's extra
    passes over ``x``.
    """
    if torch.is_grad_enabled() and (x.requires_grad or min_range.requires_grad or max_range.requires_grad):
        rnd, clip = round_ste, clip_tie
    else:
        rnd, clip = torch.round, torch.clamp
    if sym:
        qmin, qmax = qrange(n_bits, True)
        max_abs = torch.maximum(min_range.abs(), max_range.abs())
        delta = true_div(2.0 * max_abs, 2**n_bits - 1)
        if scale_grad:
            delta = grad_scale(delta, weight_scale(max_abs.numel(), n_bits, True))
        return delta * clip(rnd(x / delta), qmin, qmax)
    qmax = 2**n_bits - 1
    delta = true_div(max_range - min_range, qmax)
    if scale_grad:
        delta = grad_scale(delta, act_scale(x, n_bits, True))
    return delta * clip(rnd((x - min_range) / delta), 0, qmax) + min_range


def splitter_quantize(x: Tensor, threshold: float | Tensor = 1.0, n_bits: int = 8, sign: bool = True) -> Tensor:
    """Floor-based uniform quantizer of the input splitter (reference process.py:10-14).

    delta = threshold / 2^(n_bits - sign); y = clip(floor(x/delta), Qmin, Qmax) * delta.
    """
    delta = threshold / (2 ** (n_bits - int(sign)))
    min_val = -(2 ** (n_bits - int(sign))) if sign else 0
    max_val = 2 ** (n_bits - int(sign)) - 1
    return torch.floor(x / delta).clamp(min_val, max_val) * delta
