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

from fqss_tpu_torch.quant.ste import grad_scale, grad_sign, round_ste

Tensor = torch.Tensor


def qrange(n_bits: int, sign: bool) -> tuple[int, int]:
    """Integer grid limits: signed -> [-2^(n-1), 2^(n-1)-1], unsigned [0, 2^n-1]."""
    if sign:
        return -(2 ** (n_bits - 1)), 2 ** (n_bits - 1) - 1
    return 0, 2**n_bits - 1


def bf16_round(x: Tensor) -> Tensor:
    """A float32 tensor's values rounded to bfloat16 (to nearest, ties to even, as ``astype(bfloat16)``), kept in
    float32: a bf16 operand of a float32 sum. The product of two such values is exact in float32."""
    return x.to(torch.bfloat16).float()


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


def mulaw_fake_quant(x: Tensor, min_range: Tensor, max_range: Tensor, mu: Tensor, n_bits: int,
                     scale_grad: bool = False) -> Tensor:
    """Mu-law companded fake quantization (reference qat_quant.py:150-164; ``fqss_tpu/quant/fake_quant.py:
    mulaw_fake_quant``): normalise by ``max(|mn|, |mx|)``, compress, the uniform grid on [-1, 1], expand.

    The signs pass their gradients straight through (:func:`grad_sign`), and ``mu`` is learnable. The inner grid is
    the per-tensor uniform grid with the ranges (-1, 1), K1's function: on a CUDA tensor it runs on K1 and K1-bwd
    (:func:`fqss_tpu_torch.ops.fake_quant.act_fake_quant`); the compress and expand steps are plain PyTorch, as JAX
    leaves them to XLA, each operation in float32 as JAX's but ``log1p`` and ``pow``, which are taken in float64 and
    rounded once (:func:`_exact32`): each device's float32 ``log1p`` and ``pow`` round their last bits otherwise, and
    so the card and the CPU give the same grid values."""
    from fqss_tpu_torch.ops.fake_quant import act_fake_quant  # that module imports this one

    max_abs = torch.maximum(min_range.abs(), max_range.abs())
    x_norm = x / max_abs
    x_mu = grad_sign(x_norm) * _exact32(torch.log1p, mu * x_norm.abs()) / _exact32(torch.log1p, mu)
    one = torch.ones(1, device=x.device)
    x_mu_q = act_fake_quant(x_mu.contiguous(), -one, one, n_bits, scale_grad)
    y_norm = grad_sign(x_mu_q) * (_exact32(torch.pow, 1.0 + mu, x_mu_q.abs()) - 1.0) / mu
    return y_norm * max_abs


def _exact32(fn, *args: Tensor) -> Tensor:
    """``fn`` of float32 tensors taken in float64 and rounded to float32: the float32 value of the exact result (but
    where float64's own rounding lands on a float32 tie), the same on every device. Differentiable."""
    return fn(*(a.double() for a in args)).float()


def fix_range_to_include_zero(range_min: Tensor, range_max: Tensor, n_bits: int) -> tuple[Tensor, Tensor]:
    """Shift (min, max) so that zero lands exactly on the integer grid (reference qat_quant.py:110-122).

    A range that straddles zero has its min snapped to a multiple of the step; a one-sided range is clamped at zero
    on that side."""
    min_positive = range_min > 0
    max_negative = range_max < 0
    mid_range = (~min_positive & ~max_negative).to(range_min.dtype)
    min_positive, max_negative = min_positive.to(range_min.dtype), max_negative.to(range_min.dtype)
    scale = (range_max - range_min) / (2**n_bits - 1)
    min_adj = scale * torch.round(range_min / scale)
    max_adj = range_max - range_min + min_adj
    return min_adj * mid_range + max_negative * range_min, max_adj * mid_range + min_positive * range_max


def torch_fake_quantize_per_tensor(x: Tensor, scale: float, zero_point: int, quant_min: int,
                                   quant_max: int) -> Tensor:
    """A frozen per-tensor grid replayed (reference qat_quant.py:38-53): ``torch.fake_quantize_per_tensor_affine``,
    ``(clamp(round(x / scale) + zp, qmin, qmax) - zp) * scale``, rounding half to even."""
    return torch.fake_quantize_per_tensor_affine(x, float(scale), int(zero_point), int(quant_min), int(quant_max))


def torch_fake_quantize_per_channel(x: Tensor, scales: Tensor, zero_points: Tensor, axis: int, quant_min: int,
                                    quant_max: int) -> Tensor:
    """A frozen per-channel grid replayed (reference qat_quant.py:15-35): ``torch.fake_quantize_per_channel_affine``
    along ``axis``."""
    return torch.fake_quantize_per_channel_affine(x, torch.as_tensor(scales, dtype=torch.float32),
                                                  torch.as_tensor(zero_points, dtype=torch.int32), axis,
                                                  int(quant_min), int(quant_max))
