"""Fake-quant kernels: wrappers, plain versions and launch counters.

The CUDA kernels in ``csrc/fake_quant.cu`` replace the TPU kernels of the
quantizer hot path:

* :func:`act_fake_quant` — per-tensor uniform grid; the forward of
  ``fqss_tpu/ops/pallas_qat.py:act_fake_quant_train``. :func:`fake_quant`
  is the same kernel under the entry point of
  ``fqss_tpu/ops/pallas_quant.py:fake_quant_pallas``.
* :func:`weight_fake_quant` — per-channel symmetric grid on any channel
  axis; the forward of ``fqss_tpu/ops/pallas_qat.py:weight_fake_quant_train``.

A CUDA tensor launches the kernel, or the wrapper raises: there is no
fallback. A CPU tensor goes to the plain PyTorch version beside it
(:func:`act_fake_quant_ref`, :func:`weight_fake_quant_ref`), which the
kernels match bit for bit on the card. ``LAUNCHES`` counts kernel launches,
one per launch, so a run can show that it went through the kernels.

Forward only: the backward kernels arrive with the training slice, so a
CUDA call that would need a gradient raises.
"""

from __future__ import annotations

import math

import torch

from fqss_tpu_torch.ops import _build
from fqss_tpu_torch.quant.fake_quant import linear_fake_quant

Tensor = torch.Tensor

LAUNCHES = {"act": 0, "weight": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def _check_cuda(name: str, x: Tensor, *ranges: Tensor) -> None:
    for t in (x, *ranges):
        if t.device != x.device:
            raise ValueError(f"{name}: all tensors must be on {x.device}, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *ranges)):
        raise RuntimeError(
            f"{name}: the CUDA kernel is forward only; run under torch.no_grad() or "
            "torch.inference_mode() (backward kernels come with the training slice, ROADMAP.md)"
        )


def _launch(name: str, fn, device: torch.device, *args) -> None:
    """Call a kernel's C entry on ``device``'s current stream; raise on a launch error."""
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def act_fake_quant(x: Tensor, min_range: Tensor, max_range: Tensor, n_bits: int = 8) -> Tensor:
    """Per-tensor uniform fake-quant ``d·clip(round((x−mn)/d), 0, Q) + mn``.

    ``min_range``/``max_range``: one-element float32 tensors on x's device,
    as ActQuantizer stores them. The kernel reads them on the device, so the
    call never waits for the card."""
    if x.device.type == "cpu":
        return act_fake_quant_ref(x, min_range, max_range, n_bits)
    if not x.is_cuda:
        raise ValueError(f"act_fake_quant: no kernel for device {x.device}")
    _check_cuda("act_fake_quant", x, min_range, max_range)
    if min_range.numel() != 1 or max_range.numel() != 1:
        raise ValueError("act_fake_quant: ranges must hold one element each")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    _launch("act_fake_quant", _build.library().fqss_act_fake_quant, x.device,
            x.data_ptr(), min_range.data_ptr(), max_range.data_ptr(), y.data_ptr(), x.numel(), n_bits)
    LAUNCHES["act"] += 1
    return y


def fake_quant(x: Tensor, min_range: Tensor, max_range: Tensor, n_bits: int = 8) -> Tensor:
    """Entry point of ``fake_quant_pallas``: the same kernel as :func:`act_fake_quant`."""
    return act_fake_quant(x, min_range, max_range, n_bits)


def weight_fake_quant(w: Tensor, min_range: Tensor, max_range: Tensor, n_bits: int = 8,
                      ch_axis: int = 0) -> Tensor:
    """Per-channel symmetric fake-quant ``d_c·clip(round(w/d_c), −2^(b−1), 2^(b−1)−1)``.

    ``min_range``/``max_range``: C elements, flat ``[C]`` or the keepdims
    layout with C at ``ch_axis``, as WeightQuantizer stores them."""
    if w.device.type == "cpu":
        return weight_fake_quant_ref(w, min_range, max_range, n_bits, ch_axis)
    if not w.is_cuda:
        raise ValueError(f"weight_fake_quant: no kernel for device {w.device}")
    _check_cuda("weight_fake_quant", w, min_range, max_range)
    ch_axis %= w.ndim
    channels = w.shape[ch_axis]
    for r in (min_range, max_range):
        if r.numel() != channels or r.shape not in ((channels,), _keepdims(r, w.ndim, ch_axis).shape):
            raise ValueError(
                f"weight_fake_quant: ranges of shape {tuple(r.shape)} do not hold one value for each "
                f"of the {channels} channels on axis {ch_axis} of {tuple(w.shape)}"
            )
    y = torch.empty_like(w)
    if w.numel() == 0:
        return y
    inner = math.prod(w.shape[ch_axis + 1:])
    _launch("weight_fake_quant", _build.library().fqss_weight_fake_quant, w.device,
            w.data_ptr(), min_range.data_ptr(), max_range.data_ptr(), y.data_ptr(),
            w.numel(), channels, inner, n_bits)
    LAUNCHES["weight"] += 1
    return y
