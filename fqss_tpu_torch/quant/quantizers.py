"""Learned fake-quantizer modules (``fqss_tpu/quant/quantizers.py``).

Each quantizer keeps its learned ranges as parameters (the JAX ``qparams``
collection) and its observer counter as a buffer (``qstats``):

* :class:`ActQuantizer` — per-tensor uniform grid. For its first
  ``max_observations`` calls in ``train()`` mode it tracks the batch min/max
  with an EMA (alpha = 0.9) and returns the input unquantized; afterwards it
  fake-quantizes with the ranges.
* :class:`WeightQuantizer` — per-channel symmetric grid. A one-shot observer
  captures the per-channel min/max on the first ``train()`` call, which
  returns the float weights once.

State is written only in ``train()`` mode, and under ``torch.no_grad()``.
In ``eval()`` mode a quantizer still inside its observer window returns its
input and writes nothing, as a JAX call without mutable collections does
(``fqss_tpu/quant/quantizers.py:21-24``). The window test stays on the
device (``torch.where`` on the counter): no call waits for the card.

The quantize op itself is :mod:`fqss_tpu_torch.ops.fake_quant`: CUDA
kernels forward and backward on CUDA tensors, the plain versions on CPU
tensors. A layer that fuses its quantizers into its own kernel
(``QDense``, :mod:`fqss_tpu_torch.ops.qat_dense`) takes the window test
from :meth:`observing`, hands the flag and the ranges to the kernel, and
calls :meth:`observe` for the writes: the same values and the same state
writes, still without a wait for the card. Gradients reach the input and, with ``gradient_based``, the ranges,
with the JAX package's rules; ``scale_grad`` (LSQ step-size scaling) is off
by default, as on the JAX ConvTasNet path.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from fqss_tpu_torch.ops.fake_quant import act_fake_quant, weight_fake_quant

Tensor = torch.Tensor


class ActQuantizer(nn.Module):
    """Per-tensor learned activation fake-quantizer (``kind='linear'``).

    Matches GradientActivationFakeQuantize (qat_quant.py:206-242).
    """

    ALPHA = 0.9  # EMA weight of the old range (qat_quant.py:227-242)

    def __init__(self, n_bits: int = 8, gradient_based: bool = True, observer: bool = True,
                 max_observations: int = 50, scale_grad: bool = False):
        super().__init__()
        self.n_bits = n_bits
        self.scale_grad = scale_grad
        self.observer = observer
        self.max_observations = max_observations
        self.min_range = nn.Parameter(torch.full((1,), -0.5), requires_grad=gradient_based)
        self.max_range = nn.Parameter(torch.full((1,), 0.5), requires_grad=gradient_based)
        self.register_buffer("n_iter", torch.zeros((), dtype=torch.int32))

    def observing(self) -> Tensor | None:
        """The device-resident window test (``n_iter < max_observations``), or None without an observer."""
        return self.n_iter < self.max_observations if self.observer else None

    def observe(self, x: Tensor, observing: Tensor | None) -> None:
        """The observer's EMA write of ``x``'s min/max and the counter step, in ``train()`` mode only.

        ``observing`` is :meth:`observing` taken before the quantize call. Only
        the values of ``x`` where ``observing`` holds are kept, so a fused caller
        may pass its output, which is ``x`` unquantized there."""
        if observing is None or not self.training:
            return
        with torch.no_grad():
            a = self.ALPHA
            new_min = a * self.min_range + (1.0 - a) * x.min().reshape(1)
            new_max = a * self.max_range + (1.0 - a) * x.max().reshape(1)
            self.min_range.copy_(torch.where(observing, new_min, self.min_range))
            self.max_range.copy_(torch.where(observing, new_max, self.max_range))
            self.n_iter.add_(observing.to(torch.int32))

    def forward(self, x: Tensor) -> Tensor:
        # Quantize with the ranges as they are before the observer's write
        # below, as the JAX module does.
        y = act_fake_quant(x, self.min_range, self.max_range, self.n_bits, self.scale_grad)
        observing = self.observing()
        if observing is None:
            return y
        self.observe(x, observing)
        return torch.where(observing, x, y)


class WeightQuantizer(nn.Module):
    """Per-channel symmetric learned weight fake-quantizer.

    Matches GradientWeightFakeQuantize (qat_quant.py:350-381). ``weight_shape``
    is the torch-layout shape of the weight; ``ch_axis`` its channel axis
    (0 for conv weights ``[Cout, Cin/g, k]``, 1 for transposed-conv weights
    ``[Cin, Cout, k]``). The ranges keep the keepdims layout.
    """

    def __init__(self, weight_shape: Sequence[int], n_bits: int = 8, ch_axis: int = 0,
                 gradient_based: bool = True, observer: bool = True, scale_grad: bool = False):
        super().__init__()
        self.n_bits = n_bits
        self.scale_grad = scale_grad
        self.ch_axis = ch_axis
        self.observer = observer
        shape = [1] * len(weight_shape)
        shape[ch_axis] = weight_shape[ch_axis]
        self.reduce_dims = tuple(i for i in range(len(weight_shape)) if i != ch_axis)
        self.min_range = nn.Parameter(torch.full(shape, -0.5), requires_grad=gradient_based)
        self.max_range = nn.Parameter(torch.full(shape, 0.5), requires_grad=gradient_based)
        self.register_buffer("observed", torch.zeros((), dtype=torch.bool))

    def observing(self) -> Tensor | None:
        """The device-resident flag ``~observed``, or None without an observer."""
        return ~self.observed if self.observer else None

    def observe(self, w: Tensor, observing: Tensor | None) -> None:
        """The one-shot observer: in ``train()`` mode, where ``observing``, the ranges become ``w``'s per-channel
        min/max, before the quantize call that uses them."""
        if observing is None or not self.training:
            return
        with torch.no_grad():
            self.min_range.copy_(torch.where(observing, w.amin(self.reduce_dims, keepdim=True), self.min_range))
            self.max_range.copy_(torch.where(observing, w.amax(self.reduce_dims, keepdim=True), self.max_range))
            self.observed.fill_(True)

    def forward(self, w: Tensor) -> Tensor:
        observing = self.observing()
        self.observe(w, observing)
        y = weight_fake_quant(w, self.min_range, self.max_range, self.n_bits, self.ch_axis, self.scale_grad)
        return y if observing is None else torch.where(observing, w, y)
