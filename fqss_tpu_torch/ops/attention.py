"""Fused attention core: wrapper, autograd Function, plain version and launch counter.

The CUDA kernel in ``csrc/attention.cu`` (K8) replaces the TPU kernel of the
dual-path transformers' attention, ``fqss_tpu/ops/pallas_attention.py``
(``fused_attention``, ``_attn_kernel``)::

    heads = softmax(qs @ k^T) @ v                       # [BH, Lq, d]
    out   = act_fake_quant(heads, mn, mx, n_bits)       # when quantize is set

``qs`` is the query heads already scaled by 1/sqrt(d) and div-quantized,
``k`` and ``v`` ``[BH, Lk, d]``, all float32; ``mn``/``mx`` the one-element
range of the head quantizer, read on the device. The logits never reach
device memory. Unlike the TPU kernel, which pads d and Lk to 128 lanes and
is gated to ``32 <= d``, ``L >= 128`` (a TPU profitability rule), the kernel
takes any ``L >= 1`` and any ``d <= 128``: on the card every attention core
that the module computes this way goes through it, DPTNet's ``d = 16``
heads and the Sepformer's short inter-chunk sequences included.

A CUDA tensor launches the kernel, or the wrapper raises: there is no
fallback. A CPU tensor takes the plain version :func:`fused_attention_ref`
(``torch.matmul``, ``torch.softmax``, ``torch.matmul``, then
``act_fake_quant_ref``: the composition of ``_attention_xla``). When a
gradient is needed the call runs through a ``torch.autograd.Function`` whose
backward differentiates the plain version on the saved inputs, as JAX's
``custom_vjp`` rematerialises ``_attention_xla``. ``LAUNCHES["attention"]``
counts the kernel's launches.
"""

from __future__ import annotations

import torch

from fqss_tpu_torch.ops import _build
from fqss_tpu_torch.ops.fake_quant import _check_device, _needs_grad, act_fake_quant_ref

Tensor = torch.Tensor

LAUNCHES = {"attention": 0}


def reset_launches() -> None:
    LAUNCHES["attention"] = 0


def fused_attention_ref(qs: Tensor, k: Tensor, v: Tensor, min_range: Tensor | None = None,
                        max_range: Tensor | None = None, n_bits: int = 8, quantize: bool = True) -> Tensor:
    """Plain version: ``softmax(qs @ k^T) @ v``, then the head grid when ``quantize``."""
    heads = torch.matmul(torch.softmax(torch.matmul(qs, k.transpose(-1, -2)), dim=-1), v)
    return act_fake_quant_ref(heads, min_range, max_range, n_bits) if quantize else heads


def _check(qs: Tensor, k: Tensor, v: Tensor, min_range: Tensor | None, max_range: Tensor | None,
           quantize: bool) -> None:
    """Hold the operands to what the kernel takes, on every device."""
    if qs.ndim != 3 or k.ndim != 3 or k.shape != v.shape or k.shape[0] != qs.shape[0] or k.shape[2] != qs.shape[2]:
        raise ValueError(f"fused_attention: qs [BH, Lq, d] and k, v [BH, Lk, d] expected, got {tuple(qs.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if k.shape[1] == 0:
        raise ValueError("fused_attention: no keys (Lk = 0)")
    ranges = (("min_range", min_range), ("max_range", max_range)) if quantize else ()
    for name, r in ranges:
        if r is None or r.numel() != 1:
            raise ValueError(f"fused_attention: quantize needs a one-element {name}")
    for name, t in (("qs", qs), ("k", k), ("v", v), *ranges):
        if t.device != qs.device:
            raise ValueError(f"fused_attention: {name} is on {t.device}, qs on {qs.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"fused_attention: the kernel takes float32, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"fused_attention: the kernel takes contiguous tensors ({name} is not)")


def _forward(qs: Tensor, k: Tensor, v: Tensor, min_range: Tensor | None, max_range: Tensor | None, n_bits: int,
             quantize: bool) -> Tensor:
    if qs.device.type == "cpu":
        with torch.no_grad():
            return fused_attention_ref(qs, k, v, min_range, max_range, n_bits, quantize)
    out = torch.empty_like(qs)
    if out.numel() == 0:
        return out
    lib = _build.library()
    d = qs.shape[2]
    if d > lib.fqss_attention_max_dim():
        raise ValueError(f"fused_attention: head width {d} exceeds the kernel's {lib.fqss_attention_max_dim()}")
    with torch.cuda.device(qs.device):
        rc = lib.fqss_fused_attention(
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), min_range.data_ptr() if quantize else None,
            max_range.data_ptr() if quantize else None, out.data_ptr(), qs.shape[0], qs.shape[1], k.shape[1], d,
            int(quantize), n_bits, torch.cuda.current_stream(qs.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_attention: CUDA launch failed with error {rc}")
    LAUNCHES["attention"] += 1
    return out


class _FusedAttention(torch.autograd.Function):
    """The kernel forward, and the plain composition's gradient (``pallas_attention.py:_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, qs, k, v, min_range, max_range, n_bits, quantize):
        ctx.n_bits, ctx.quantize = n_bits, quantize
        # Copies of the ranges: an observer may write them in place after this call.
        ranges = (min_range.detach().clone(), max_range.detach().clone()) if quantize else (None, None)
        ctx.save_for_backward(qs, k, v, *ranges)
        return _forward(qs, k, v, min_range, max_range, n_bits, quantize)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        wanted = [i for i, t in enumerate(saved) if t is not None and ctx.needs_input_grad[i]]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(i in wanted) if t is not None else None for i, t in enumerate(saved)]
            out = fused_attention_ref(*inputs, ctx.n_bits, ctx.quantize)
            grads = torch.autograd.grad(out, [inputs[i] for i in wanted], g)
        result = [None] * 5
        for i, gi in zip(wanted, grads):
            result[i] = gi
        return (*result, None, None)


def fused_attention(qs: Tensor, k: Tensor, v: Tensor, min_range: Tensor | None = None,
                    max_range: Tensor | None = None, n_bits: int = 8, quantize: bool = True) -> Tensor:
    """``softmax(qs @ k^T) @ v`` over ``[BH, L, d]``, with the head grid ``(min_range, max_range)`` applied in
    the kernel's epilogue when ``quantize`` (the ranges are then required); differentiable."""
    _check_device("fused_attention", qs)
    _check(qs, k, v, min_range, max_range, quantize)
    tensors = (qs, k, v, *((min_range, max_range) if quantize else ()))
    if _needs_grad(*tensors):
        return _FusedAttention.apply(qs, k, v, min_range, max_range, n_bits, quantize)
    return _forward(qs, k, v, min_range, max_range, n_bits, quantize)
