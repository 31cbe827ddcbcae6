"""Quantized primitive layers (``fqss_tpu/nn/layers.py``), NCT layout.

Each layer is the fused block op -> [nonlinearity] -> act-fake-quant,
configured from a :class:`~fqss_tpu_torch.quant.QuantSpec`; with
``q.qat=False`` the same module is the float teacher. Submodule and
parameter names follow the JAX modules (``weight_fake_quantize``,
``activation_fake_quantize``, ``norm``, ``nl``) so that
:func:`fqss_tpu_torch.models.convert.convtasnet_from_jax` maps one tree onto
the other.

The convolutions themselves are PyTorch's (``F.conv1d``): the JAX package
computes them outside any Pallas kernel too.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from fqss_tpu_torch.nn.nonlin import Nl
from fqss_tpu_torch.quant.quantizers import ActQuantizer, WeightQuantizer
from fqss_tpu_torch.quant.spec import FLOAT, QuantSpec

Tensor = torch.Tensor


def uniform_(t: Tensor, bound: float, generator: torch.Generator | None) -> Tensor:
    """U(-bound, bound) in place: torch's kaiming_uniform(a=sqrt(5)) layer init."""
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def make_act_quantizer(q: QuantSpec, *, enabled: bool | None = None, n_bits: int | None = None,
                       nl_quant: bool = False) -> ActQuantizer | None:
    """The post-op activation quantizer, or None when disabled (qat_layers.py:49-59)."""
    on = q.act_quant if enabled is None else enabled
    if not (q.qat and on):
        return None
    if nl_quant or q.act_quantizer != "linear":
        kind = "mu-law" if nl_quant else q.act_quantizer
        raise NotImplementedError(f"the {kind} activation quantizer is not ported yet (ROADMAP.md, queue 1)")
    return ActQuantizer(
        n_bits=q.act_n_bits if n_bits is None else n_bits,
        gradient_based=q.gradient_based,
        observer=q.observer,
        max_observations=q.max_observations,
    )


def make_weight_quantizer(q: QuantSpec, weight_shape, ch_axis: int) -> WeightQuantizer | None:
    if not (q.qat and q.weight_quant):
        return None
    return WeightQuantizer(weight_shape, n_bits=q.weight_n_bits, ch_axis=ch_axis,
                           gradient_based=q.gradient_based, observer=q.observer)


def _quantize(aq: ActQuantizer | None, y: Tensor) -> Tensor:
    return aq(y) if aq is not None else y


class QConv1d(nn.Module):
    """Fused fake-quant Conv1d [+NL] [+act-quant].

    Covers Conv1dQ / Conv1dNlQ (qat_layers.py:124-258); the GroupNorm-fused
    variant comes with the slices that use it.
    Input/output: [B, C, T]; weight [Cout, Cin/groups, k], quantized per
    out-channel (axis 0).
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, groups: int = 1, use_bias: bool = True,
                 nl: str | None = None, q: QuantSpec = FLOAT, act_quant: bool | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.stride, self.padding, self.dilation, self.groups = stride, padding, dilation, groups
        wshape = (out_channels, in_channels // groups, kernel_size)
        bound = 1.0 / math.sqrt((in_channels // groups) * kernel_size)
        self.weight = nn.Parameter(uniform_(torch.empty(wshape), bound, generator))
        self.bias = nn.Parameter(uniform_(torch.empty(out_channels), bound, generator)) if use_bias else None
        self.weight_fake_quantize = make_weight_quantizer(q, wshape, ch_axis=0)
        self.nl = Nl(nl) if nl else None
        self.activation_fake_quantize = make_act_quantizer(q, enabled=act_quant)

    def forward(self, x: Tensor) -> Tensor:
        w = self.weight
        if self.weight_fake_quantize is not None:
            w = self.weight_fake_quantize(w)
        y = F.conv1d(x, w, self.bias, self.stride, self.padding, self.dilation, self.groups)
        if self.nl is not None:
            y = self.nl(y)
        return _quantize(self.activation_fake_quantize, y)


class QGroupNorm(nn.Module):
    """GroupNorm -> act-quant (GroupNormQ, qat_layers.py:438-452).

    flax's GroupNorm (the JAX reference) takes the variance as E[x²]−E[x]²;
    ``F.group_norm`` need not round the same way on every device, and a
    difference in the last bit can move a value across a rounding tie of the
    next quantizer: a reason the parity tests allow one-LSB flips.
    """

    def __init__(self, num_groups: int, num_channels: int, epsilon: float = 1e-5, q: QuantSpec = FLOAT):
        super().__init__()
        self.norm = nn.GroupNorm(num_groups, num_channels, eps=epsilon)
        self.activation_fake_quantize = make_act_quantizer(q)

    def forward(self, x: Tensor) -> Tensor:
        return _quantize(self.activation_fake_quantize, self.norm(x))


class QNl(nn.Module):
    """Nonlinearity -> act-quant (NlQ, qat_layers.py:511-518)."""

    def __init__(self, kind: str, q: QuantSpec = FLOAT):
        super().__init__()
        self.nl = Nl(kind)
        self.activation_fake_quantize = make_act_quantizer(q)

    def forward(self, x: Tensor) -> Tensor:
        return _quantize(self.activation_fake_quantize, self.nl(x))


class QAdd(nn.Module):
    """add -> act-quant (AddQ, qat_layers.py:62-71)."""

    def __init__(self, q: QuantSpec = FLOAT):
        super().__init__()
        self.activation_fake_quantize = make_act_quantizer(q)

    def forward(self, x1: Tensor, x2: Tensor) -> Tensor:
        return _quantize(self.activation_fake_quantize, x1 + x2)


class QMul(nn.Module):
    """mul -> act-quant (MulQ, qat_layers.py:86-101)."""

    def __init__(self, q: QuantSpec = FLOAT):
        super().__init__()
        self.activation_fake_quantize = make_act_quantizer(q)

    def forward(self, x1: Tensor, x2: Tensor) -> Tensor:
        return _quantize(self.activation_fake_quantize, x1 * x2)
