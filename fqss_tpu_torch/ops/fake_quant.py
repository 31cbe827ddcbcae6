"""Fake-quant kernels: wrappers, autograd Functions, plain versions and launch counters.

The CUDA kernels in ``csrc/fake_quant.cu`` replace the TPU kernels of the
quantizer hot path, forward and backward:

* :func:`act_fake_quant` — per-tensor uniform grid; the forward and the
  backward (``_act_fq_bwd``) of
  ``fqss_tpu/ops/pallas_qat.py:act_fake_quant_train``. :func:`fake_quant` is
  the same forward kernel under the entry point of
  ``fqss_tpu/ops/pallas_quant.py:fake_quant_pallas``.
* :func:`weight_fake_quant` — per-channel symmetric grid on any channel
  axis; the forward and the backward (``_w_bwd_impl``) of
  ``fqss_tpu/ops/pallas_qat.py:weight_fake_quant_train``.

When a gradient is needed, each wrapper runs through a
``torch.autograd.Function`` whose forward is the forward kernel and whose
backward is the backward kernel. Its gradients are the JAX package's
analytic ones (``pallas_qat.py:11-27``): the straight-through estimate with
0.5 at a clip bound, and the LSQ range gradients scaled by ``scale_grad``.

A CUDA tensor launches the kernel, or the wrapper raises: there is no
fallback. A CPU tensor goes to the plain PyTorch version beside each kernel
(:func:`act_fake_quant_ref`, :func:`weight_fake_quant_ref`,
:func:`act_fake_quant_bwd_ref`, :func:`weight_fake_quant_bwd_ref`). On the
card the kernels equal them bit for bit, except for the range gradients,
which are sums taken in another order. ``LAUNCHES`` counts the wrappers'
kernel launches, one per call, so a run can show that it went through the
kernels.
"""

from __future__ import annotations

import math

import torch

from fqss_tpu_torch.ops import _build
from fqss_tpu_torch.quant.fake_quant import act_scale, linear_fake_quant, qrange, true_div, weight_scale

Tensor = torch.Tensor

LAUNCHES = {"act": 0, "weight": 0, "act_bwd": 0, "weight_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def act_fake_quant_ref(x: Tensor, min_range: Tensor, max_range: Tensor, n_bits: int = 8) -> Tensor:
    """Plain version: ``linear_fake_quant(x, mn, mx, n_bits, sym=False)``."""
    return linear_fake_quant(x, min_range, max_range, n_bits, sym=False)


def _keepdims(r: Tensor, ndim: int, ch_axis: int) -> Tensor:
    shape = [1] * ndim
    shape[ch_axis] = r.numel()
    return r.reshape(shape)


def weight_fake_quant_ref(w: Tensor, min_range: Tensor, max_range: Tensor, n_bits: int = 8,
                          ch_axis: int = 0) -> Tensor:
    """Plain version: per-channel symmetric signed grid along ``ch_axis``.

    The ranges may be ``[C]`` or the keepdims layout (C at ``ch_axis``)."""
    ch_axis %= w.ndim
    mn = _keepdims(min_range, w.ndim, ch_axis)
    mx = _keepdims(max_range, w.ndim, ch_axis)
    return linear_fake_quant(w, mn, mx, n_bits, sym=True)


def _tie_mask(X: Tensor, lo: float, hi: float) -> Tensor:
    """The clip's gradient mask (``pallas_qat.py:_tie_mask``): 1 inside, 0.5 at a bound, 0 outside."""
    inside = ((X > lo) & (X < hi)).to(X.dtype)
    tie = ((X == lo) | (X == hi)).to(X.dtype)
    return inside + 0.5 * tie


def act_bwd_terms(x: Tensor, g: Tensor, min_range: Tensor, max_range: Tensor, n_bits: int,
                  s: float) -> tuple[Tensor, Tensor, Tensor]:
    """``dx`` and the elementwise terms whose sums are ``dmn`` and ``dmx`` (``_act_bwd_kernel``)."""
    q = 2**n_bits - 1
    delta = true_div(max_range - min_range, q)
    u = (x - min_range) / delta
    X = torch.round(u)
    m = _tie_mask(X, 0, q)
    t = true_div(X.clamp(0, q) - m * u, q)
    return g * m, g * (1.0 - m - s * t), g * s * t


def act_fake_quant_bwd_ref(x: Tensor, g: Tensor, min_range: Tensor, max_range: Tensor, n_bits: int = 8,
                           s: float = 1.0) -> tuple[Tensor, Tensor, Tensor]:
    """Plain backward of :func:`act_fake_quant`: ``(dx, dmn, dmx)`` for the cotangent ``g``.

    ``s`` is the ``scale_grad`` factor (1 without it)."""
    dx, p_mn, p_mx = act_bwd_terms(x, g, min_range, max_range, n_bits, s)
    return dx, p_mn.sum().reshape(min_range.shape), p_mx.sum().reshape(max_range.shape)


def weight_bwd_terms(w: Tensor, g: Tensor, min_range: Tensor, max_range: Tensor, n_bits: int,
                     ch_axis: int) -> tuple[Tensor, Tensor]:
    """``dw`` and the elementwise terms whose per-channel sums are ``dd`` (``_w_bwd_kernel``)."""
    ch_axis %= w.ndim
    qmin, qmax = qrange(n_bits, True)
    max_abs = torch.maximum(_keepdims(min_range, w.ndim, ch_axis).abs(),
                            _keepdims(max_range, w.ndim, ch_axis).abs())
    delta = true_div(2.0 * max_abs, 2**n_bits - 1)
    u = w / delta
    X = torch.round(u)
    m = _tie_mask(X, qmin, qmax)
    return g * m, g * (X.clamp(qmin, qmax) - m * u)


def route_range_grad(dd: Tensor, min_range: Tensor, max_range: Tensor, n_bits: int,
                     s: float) -> tuple[Tensor, Tensor]:
    """``dmax = s·2/Q·dd`` given to mn or mx by ``|mn|`` vs ``|mx|`` (0.5 each at a tie), times the sign.

    The VJP of ``max(|mn|, |mx|)``, as ``pallas_qat.py:316-326`` writes it."""
    dmax = dd.reshape(min_range.shape) * (s * 2.0 / (2**n_bits - 1))
    amn, amx = min_range.abs(), max_range.abs()
    w_mn = torch.where(amn > amx, 1.0, torch.where(amn == amx, 0.5, 0.0)) * torch.sign(min_range)
    w_mx = torch.where(amx > amn, 1.0, torch.where(amn == amx, 0.5, 0.0)) * torch.sign(max_range)
    return dmax * w_mn, dmax * w_mx


def weight_fake_quant_bwd_ref(w: Tensor, g: Tensor, min_range: Tensor, max_range: Tensor, n_bits: int = 8,
                              s: float = 1.0, ch_axis: int = 0) -> tuple[Tensor, Tensor, Tensor]:
    """Plain backward of :func:`weight_fake_quant`: ``(dw, dmn, dmx)``, ranges in their own shape."""
    ch_axis %= w.ndim
    dw, terms = weight_bwd_terms(w, g, min_range, max_range, n_bits, ch_axis)
    dd = terms.sum(tuple(i for i in range(w.ndim) if i != ch_axis))
    return (dw, *route_range_grad(dd, min_range, max_range, n_bits, s))


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------


def _check_cuda(name: str, x: Tensor, *others: Tensor) -> None:
    for t in (x, *others):
        if t.device != x.device:
            raise ValueError(f"{name}: all tensors must be on {x.device}, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")


def _check_device(name: str, x: Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x.device}")


def _launch(name: str, fn, device: torch.device, *args) -> None:
    """Call a kernel's C entry on ``device``'s current stream; raise on a launch error."""
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def _check_act_ranges(name: str, min_range: Tensor, max_range: Tensor) -> None:
    if min_range.numel() != 1 or max_range.numel() != 1:
        raise ValueError(f"{name}: ranges must hold one element each")


def _check_weight_ranges(name: str, w: Tensor, min_range: Tensor, max_range: Tensor, ch_axis: int) -> None:
    channels = w.shape[ch_axis]
    for r in (min_range, max_range):
        if r.numel() != channels or r.shape not in ((channels,), _keepdims(r, w.ndim, ch_axis).shape):
            raise ValueError(
                f"{name}: ranges of shape {tuple(r.shape)} do not hold one value for each "
                f"of the {channels} channels on axis {ch_axis} of {tuple(w.shape)}"
            )


def _act_forward(x: Tensor, min_range: Tensor, max_range: Tensor, n_bits: int) -> Tensor:
    if x.device.type == "cpu":
        return act_fake_quant_ref(x, min_range, max_range, n_bits)
    _check_cuda("act_fake_quant", x, min_range, max_range)
    _check_act_ranges("act_fake_quant", min_range, max_range)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    _launch("act_fake_quant", _build.library().fqss_act_fake_quant, x.device,
            x.data_ptr(), min_range.data_ptr(), max_range.data_ptr(), y.data_ptr(), x.numel(), n_bits)
    LAUNCHES["act"] += 1
    return y


def act_fake_quant_bwd(x: Tensor, g: Tensor, min_range: Tensor, max_range: Tensor, n_bits: int = 8,
                       s: float = 1.0) -> tuple[Tensor, Tensor, Tensor]:
    """Backward of :func:`act_fake_quant` for the cotangent ``g``: ``(dx, dmn, dmx)``.

    A two-pass CUDA kernel (elementwise pass with per-block partial sums,
    then one block that sums them), one launch on the counter; the plain
    version on the CPU. ``s`` is the ``scale_grad`` factor."""
    _check_device("act_fake_quant backward", x)
    if x.device.type == "cpu":
        return act_fake_quant_bwd_ref(x, g, min_range, max_range, n_bits, s)
    _check_cuda("act_fake_quant backward", x, g, min_range, max_range)
    _check_act_ranges("act_fake_quant backward", min_range, max_range)
    dx = torch.empty_like(x)
    sums = torch.zeros(2, device=x.device)
    if x.numel():
        lib = _build.library()
        partials = torch.empty(lib.fqss_act_bwd_blocks(x.numel()), 2, device=x.device)
        _launch("act_fake_quant backward", lib.fqss_act_fake_quant_bwd, x.device,
                x.data_ptr(), g.data_ptr(), min_range.data_ptr(), max_range.data_ptr(), dx.data_ptr(),
                partials.data_ptr(), sums.data_ptr(), x.numel(), n_bits, s)
        LAUNCHES["act_bwd"] += 1
    return dx, sums[0:1].reshape(min_range.shape), sums[1:2].reshape(max_range.shape)


def _weight_forward(w: Tensor, min_range: Tensor, max_range: Tensor, n_bits: int, ch_axis: int) -> Tensor:
    if w.device.type == "cpu":
        return weight_fake_quant_ref(w, min_range, max_range, n_bits, ch_axis)
    _check_cuda("weight_fake_quant", w, min_range, max_range)
    _check_weight_ranges("weight_fake_quant", w, min_range, max_range, ch_axis)
    y = torch.empty_like(w)
    if w.numel() == 0:
        return y
    _launch("weight_fake_quant", _build.library().fqss_weight_fake_quant, w.device,
            w.data_ptr(), min_range.data_ptr(), max_range.data_ptr(), y.data_ptr(),
            w.numel(), w.shape[ch_axis], math.prod(w.shape[ch_axis + 1:]), n_bits)
    LAUNCHES["weight"] += 1
    return y


def weight_fake_quant_bwd(w: Tensor, g: Tensor, min_range: Tensor, max_range: Tensor, n_bits: int = 8,
                          s: float = 1.0, ch_axis: int = 0) -> tuple[Tensor, Tensor, Tensor]:
    """Backward of :func:`weight_fake_quant` for the cotangent ``g``: ``(dw, dmn, dmx)``.

    The CUDA kernel (one block per channel), or the plain version on the CPU."""
    _check_device("weight_fake_quant backward", w)
    ch_axis %= w.ndim
    if w.device.type == "cpu":
        return weight_fake_quant_bwd_ref(w, g, min_range, max_range, n_bits, s, ch_axis)
    _check_cuda("weight_fake_quant backward", w, g, min_range, max_range)
    _check_weight_ranges("weight_fake_quant backward", w, min_range, max_range, ch_axis)
    dw, dmn, dmx = torch.empty_like(w), torch.zeros_like(min_range), torch.zeros_like(max_range)
    if w.numel():
        _launch("weight_fake_quant backward", _build.library().fqss_weight_fake_quant_bwd, w.device,
                w.data_ptr(), g.data_ptr(), min_range.data_ptr(), max_range.data_ptr(), dw.data_ptr(),
                dmn.data_ptr(), dmx.data_ptr(), w.shape[ch_axis], math.prod(w.shape[:ch_axis]),
                math.prod(w.shape[ch_axis + 1:]), n_bits, s * 2.0 / (2**n_bits - 1))
        LAUNCHES["weight_bwd"] += 1
    return dw, dmn, dmx


class _ActFakeQuant(torch.autograd.Function):
    """Forward and backward kernels of the per-tensor uniform grid (``act_fake_quant_train``'s VJP)."""

    @staticmethod
    def forward(ctx, x, min_range, max_range, n_bits, s):
        ctx.n_bits, ctx.s = n_bits, s
        # Copies of the ranges: ActQuantizer's observer writes them in place
        # after this call, and the backward needs the values it quantized with.
        ctx.save_for_backward(x, min_range.detach().clone(), max_range.detach().clone())
        return _act_forward(x, min_range, max_range, n_bits)

    @staticmethod
    def backward(ctx, g):
        x, mn, mx = ctx.saved_tensors
        return (*act_fake_quant_bwd(x, g.contiguous(), mn, mx, ctx.n_bits, ctx.s), None, None)


class _WeightFakeQuant(torch.autograd.Function):
    """Forward and backward kernels of the per-channel grid (``weight_fake_quant_train``'s VJP)."""

    @staticmethod
    def forward(ctx, w, min_range, max_range, n_bits, s, ch_axis):
        ctx.n_bits, ctx.s, ctx.ch_axis = n_bits, s, ch_axis
        ctx.save_for_backward(w, min_range.detach().clone(), max_range.detach().clone())
        return _weight_forward(w, min_range, max_range, n_bits, ch_axis)

    @staticmethod
    def backward(ctx, g):
        w, mn, mx = ctx.saved_tensors
        return (*weight_fake_quant_bwd(w, g.contiguous(), mn, mx, ctx.n_bits, ctx.s, ctx.ch_axis), None, None, None)


def _needs_grad(*tensors: Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def act_fake_quant(x: Tensor, min_range: Tensor, max_range: Tensor, n_bits: int = 8,
                   scale_grad: bool = False) -> Tensor:
    """Per-tensor uniform fake-quant ``d·clip(round((x−mn)/d), 0, Q) + mn``, differentiable.

    ``min_range``/``max_range``: one-element float32 tensors on x's device,
    as ActQuantizer stores them. The kernels read them on the device, so the
    call never waits for the card. ``scale_grad`` scales the ranges'
    gradients by 1/sqrt(Q·C), C = ``x.shape[1]`` (NCT channels)."""
    _check_device("act_fake_quant", x)
    if _needs_grad(x, min_range, max_range):
        return _ActFakeQuant.apply(x, min_range, max_range, n_bits, act_scale(x, n_bits, scale_grad))
    return _act_forward(x, min_range, max_range, n_bits)


def fake_quant(x: Tensor, min_range: Tensor, max_range: Tensor, n_bits: int = 8) -> Tensor:
    """Entry point of ``fake_quant_pallas``: the same kernel as :func:`act_fake_quant`."""
    return act_fake_quant(x, min_range, max_range, n_bits)


def weight_fake_quant(w: Tensor, min_range: Tensor, max_range: Tensor, n_bits: int = 8, ch_axis: int = 0,
                      scale_grad: bool = False) -> Tensor:
    """Per-channel symmetric fake-quant ``d_c·clip(round(w/d_c), −2^(b−1), 2^(b−1)−1)``, differentiable.

    ``min_range``/``max_range``: C elements, flat ``[C]`` or the keepdims
    layout with C at ``ch_axis``, as WeightQuantizer stores them."""
    _check_device("weight_fake_quant", w)
    ch_axis %= w.ndim
    if _needs_grad(w, min_range, max_range):
        s = weight_scale(w.shape[ch_axis], n_bits, scale_grad)
        return _WeightFakeQuant.apply(w, min_range, max_range, n_bits, s, ch_axis)
    return _weight_forward(w, min_range, max_range, n_bits, ch_axis)
