"""Quantized primitive layers (``fqss_tpu/nn/layers.py``), NCT layout.

Each layer is the fused block op -> [nonlinearity] -> act-fake-quant,
configured from a :class:`~fqss_tpu_torch.quant.QuantSpec`; with
``q.qat=False`` the same module is the float teacher. Submodule and
parameter names follow the JAX modules (``weight_fake_quantize``,
``activation_fake_quantize``, ``norm``, ``nl``) so that
:mod:`fqss_tpu_torch.models.convert` maps one tree onto the other. Weights
are in torch's layout (``[out, in(, k)]``, quantized per out-channel on
axis 0). A layer whose weight quantizers are other than one
``weight_fake_quantize`` of its ``weight`` maps each quantizer's name to
its parameter's in a class attribute ``WEIGHT_QUANTIZERS``, for
:func:`fqss_tpu_torch.serve.fold.fold_quantized_weights`.

The convolutions are PyTorch's (``F.conv1d``, ``F.conv2d`` and their
transposes, NCT/NCHW, weights in torch's layout): the JAX package computes
them outside any Pallas kernel too, except that a bias-free 1x1 ``QConv1d``
without a nonlinearity runs its forward through the fused kernel K3
(``ops/qmatmul.py``) where no gradient is needed. ``QDense`` runs its
product, its GELU where it has one, and both of its grids through the fused
kernel K5 (``ops/qat_dense.py``).

Under ``QuantSpec.compute_dtype="bfloat16"`` every product's operands are
rounded to bfloat16 and its sums stay float32 (:func:`mxu_operands`, JAX's
``mxu_operands`` with ``preferred_element_type=float32``): ``F.conv1d`` on
the rounded operands, and K3 and K5 on their bf16 routes, which round as
they load. Only serving is ported: a bf16 forward that needs a gradient
raises ``NotImplementedError``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from fqss_tpu_torch.nn.nonlin import Nl
from fqss_tpu_torch.ops.fake_quant import _needs_grad, refuse_bf16_grad
from fqss_tpu_torch.ops.qat_dense import qat_dense
from fqss_tpu_torch.ops.qmatmul import qmatmul
from fqss_tpu_torch.parallel import tp
from fqss_tpu_torch.quant.fake_quant import bf16_round, weight_scale
from fqss_tpu_torch.quant.quantizers import ActQuantizer, MseActQuantizer, WeightQuantizer
from fqss_tpu_torch.quant.spec import FLOAT, QuantSpec

Tensor = torch.Tensor


def uniform_(t: Tensor, bound: float, generator: torch.Generator | None) -> Tensor:
    """U(-bound, bound) in place: torch's kaiming_uniform(a=sqrt(5)) layer init."""
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def mxu_operands(q: QuantSpec, x: Tensor, w: Tensor) -> tuple[Tensor, Tensor]:
    """A product's operands in the spec's compute type (``fqss_tpu/nn/layers.py:mxu_operands``): under bf16 both
    rounded to bfloat16 and held in float32, so that the float32 product of the two sums exact products, as JAX's
    bf16 product with ``preferred_element_type=float32`` does; under float32 untouched. Grid math stays float32,
    before this. Raises ``NotImplementedError`` where a bf16 product would need a gradient."""
    if not q.bf16:
        return x, w
    refuse_bf16_grad(x, w)
    return bf16_round(x), bf16_round(w)


def make_act_quantizer(q: QuantSpec, *, enabled: bool | None = None, n_bits: int | None = None,
                       nl_quant: bool = False) -> ActQuantizer | None:
    """The post-op activation quantizer, or None when disabled (qat_layers.py:49-59; ``fqss_tpu/nn/layers.py:
    make_act_quantizer``): the mu-law one where ``nl_quant`` (the ``inout_nl_quant`` sites), the MSE-calibrated one
    under ``act_quantizer: mse``, else the linear one (any other value, as in JAX)."""
    on = q.act_quant if enabled is None else enabled
    if not (q.qat and on):
        return None
    kwargs = dict(n_bits=q.act_n_bits if n_bits is None else n_bits, gradient_based=q.gradient_based,
                  observer=q.observer, max_observations=q.max_observations)
    if nl_quant:
        return ActQuantizer(kind="mulaw", **kwargs)
    if q.act_quantizer == "mse":
        return MseActQuantizer(**kwargs)
    return ActQuantizer(**kwargs)


def make_weight_quantizer(q: QuantSpec, weight_shape, ch_axis: int) -> WeightQuantizer | None:
    if not (q.qat and q.weight_quant):
        return None
    return WeightQuantizer(weight_shape, n_bits=q.weight_n_bits, ch_axis=ch_axis,
                           gradient_based=q.gradient_based, observer=q.observer)


def _quantize(aq: ActQuantizer | None, y: Tensor) -> Tensor:
    return aq(y) if aq is not None else y


def _epilogue(layer: nn.Module, y: Tensor) -> Tensor:
    """A convolution's [GroupNorm ->] [nonlinearity ->] act-quant, each where the layer has it."""
    norm = getattr(layer, "norm", None)
    if norm is not None:
        y = norm(y)
    if layer.nl is not None:
        y = layer.nl(y)
    return _quantize(layer.activation_fake_quantize, y)


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


class QConv1d(nn.Module):
    """Fused fake-quant Conv1d [+NL] [+act-quant].

    Covers Conv1dQ / Conv1dNlQ / Conv1dGnNlQ (qat_layers.py:124-258): with
    ``norm_groups`` a GroupNorm (``norm``, epsilon 1e-5) between the bias
    and the nonlinearity (HTDemucs's DConv).
    Input/output: [B, C, T]; weight [Cout, Cin/groups, k], quantized per
    out-channel (axis 0).

    Two routes compute the same function. A layer that computes exactly
    K3's, ``act_fq(weight_fq(w) @ x)`` (k = 1, one group, stride 1, no
    padding, no bias, no nonlinearity: DPTNet's ``BN``, the Sepformer
    masker's ``conv1d``), runs its forward as one call of
    :func:`fqss_tpu_torch.ops.qmatmul.qmatmul` (the fused kernel on the card,
    its plain version on the CPU) whenever no gradient is needed: gradients
    are off, or neither the input nor a parameter requires one. The
    quantizers' window flags and ranges go to the kernel, their state writes
    are :meth:`ActQuantizer.observe` and :meth:`WeightQuantizer.observe`, as
    in ``QDense``; inside a model's weight pass the weight comes on its grid
    from the pass and K3's weight grid stays off. With a gradient, and for
    every other layer, the forward
    is the composition of the weight quantizer, ``F.conv1d``, the
    nonlinearity and the act quantizer, whose kernels have backward kernels:
    JAX's K3 has no VJP, so training takes this route.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, groups: int = 1, use_bias: bool = True,
                 nl: str | None = None, q: QuantSpec = FLOAT, act_quant: bool | None = None,
                 generator: torch.Generator | None = None, norm_groups: int | None = None):
        super().__init__()
        self.q = q
        self.stride, self.padding, self.dilation, self.groups = stride, padding, dilation, groups
        wshape = (out_channels, in_channels // groups, kernel_size)
        bound = 1.0 / math.sqrt((in_channels // groups) * kernel_size)
        self.weight = nn.Parameter(uniform_(torch.empty(wshape), bound, generator))
        self.bias = nn.Parameter(uniform_(torch.empty(out_channels), bound, generator)) if use_bias else None
        self.weight_fake_quantize = make_weight_quantizer(q, wshape, ch_axis=0)
        self.norm = nn.GroupNorm(norm_groups, out_channels, eps=1e-5) if norm_groups is not None else None
        self.nl = Nl(nl) if nl else None
        self.activation_fake_quantize = make_act_quantizer(q, enabled=act_quant)
        self.fused = (kernel_size == 1 and groups == 1 and stride == 1 and padding == 0 and not use_bias
                      and nl is None and norm_groups is None)

    def forward(self, x: Tensor) -> Tensor:
        if self.fused and not _needs_grad(x, *self.parameters()):
            return self._qmatmul(x)
        w = self.weight
        if self.weight_fake_quantize is not None:
            w = self.weight_fake_quantize(w)
        xc, wc = mxu_operands(self.q, x, w)
        y = F.conv1d(xc, wc, self.bias, self.stride, self.padding, self.dilation, self.groups)
        return _epilogue(self, y)

    def _qmatmul(self, x: Tensor) -> Tensor:
        """The forward through K3: both grids, their window flags and the observers' writes, as ``QDense``."""
        wq, aq = self.weight_fake_quantize, self.activation_fake_quantize
        w = self.weight
        w_args, a_args, w_observing, a_observing = {}, {}, None, None
        grouped = wq.grouped(w) if wq is not None else None
        if grouped is not None:  # the model's weight pass put the weight on its grid: K3's weight grid stays off
            w = grouped
        elif wq is not None:
            w_observing = wq.observing()
            wq.observe(self.weight, w_observing)
            w_args = dict(w_mn=wq.min_range, w_mx=wq.max_range, w_bits=wq.n_bits)
        w = w.reshape(w.shape[0], -1)
        if aq is not None:
            a_observing = aq.observing()
            a_args = dict(a_mn=aq.min_range, a_mx=aq.max_range, a_bits=aq.n_bits)
        y = qmatmul(x.contiguous(), w, w_observing=w_observing, a_observing=a_observing, bf16=self.q.bf16, **w_args,
                    **a_args)
        if aq is not None:
            aq.observe(y, a_observing)
        return y


class QConv2d(nn.Module):
    """Fused fake-quant Conv2d [+GroupNorm] [+NL] [+act-quant] (qat_layers.py:156-293; ``fqss_tpu/nn/layers.py:
    QConv2d``). NCHW; weight [Cout, Cin, kh, kw], quantized per out-channel (axis 0). ``F.conv2d``, as JAX
    computes its convolution with ``lax.conv`` outside any Pallas kernel; under bf16 on rounded operands."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int | tuple[int, int],
                 stride: int | tuple[int, int] = 1, padding: int | tuple[int, int] = 0, use_bias: bool = True,
                 nl: str | None = None, norm_groups: int | None = None, q: QuantSpec = FLOAT,
                 act_quant: bool | None = None, generator: torch.Generator | None = None):
        super().__init__()
        k = _pair(kernel_size)
        self.q = q
        self.stride, self.padding = _pair(stride), _pair(padding)
        wshape = (out_channels, in_channels, *k)
        bound = 1.0 / math.sqrt(in_channels * k[0] * k[1])
        self.weight = nn.Parameter(uniform_(torch.empty(wshape), bound, generator))
        self.bias = nn.Parameter(uniform_(torch.empty(out_channels), bound, generator)) if use_bias else None
        self.weight_fake_quantize = make_weight_quantizer(q, wshape, ch_axis=0)
        self.norm = nn.GroupNorm(norm_groups, out_channels, eps=1e-5) if norm_groups is not None else None
        self.nl = Nl(nl) if nl else None
        self.activation_fake_quantize = make_act_quantizer(q, enabled=act_quant)

    def forward(self, x: Tensor) -> Tensor:
        w = self.weight
        if self.weight_fake_quantize is not None:
            w = self.weight_fake_quantize(w)
        xc, wc = mxu_operands(self.q, x, w)
        return _epilogue(self, F.conv2d(xc, wc, self.bias, self.stride, self.padding))


class QConvTranspose1d(nn.Module):
    """Fake-quant ConvTranspose1d [+NL] [+act-quant] (qat_layers.py:296-327; ``fqss_tpu/nn/layers.py:
    QConvTranspose1d``, without padding). NCT; weight [Cin, Cout, k] (torch's layout; JAX's kernel is ``(k, Cin,
    Cout)``), quantized per out-channel (axis 1). ``F.conv_transpose1d`` is JAX's kernel-flipped, input-dilated
    conv."""

    _conv = staticmethod(F.conv_transpose1d)

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=1, use_bias: bool = True,
                 nl: str | None = None, q: QuantSpec = FLOAT, act_quant: bool | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        k = tuple(kernel_size) if isinstance(kernel_size, (tuple, list)) else (kernel_size,)
        self.q, self.stride = q, stride
        wshape = (in_channels, out_channels, *k)
        bound = 1.0 / math.sqrt(out_channels * math.prod(k))
        self.weight = nn.Parameter(uniform_(torch.empty(wshape), bound, generator))
        self.bias = nn.Parameter(uniform_(torch.empty(out_channels), bound, generator)) if use_bias else None
        self.weight_fake_quantize = make_weight_quantizer(q, wshape, ch_axis=1)
        self.nl = Nl(nl) if nl else None
        self.activation_fake_quantize = make_act_quantizer(q, enabled=act_quant)

    def forward(self, x: Tensor) -> Tensor:
        w = self.weight
        if self.weight_fake_quantize is not None:
            w = self.weight_fake_quantize(w)
        xc, wc = mxu_operands(self.q, x, w)
        return _epilogue(self, self._conv(xc, wc, self.bias, self.stride))


class QConvTranspose2d(QConvTranspose1d):
    """Fake-quant ConvTranspose2d [+NL] [+act-quant] (qat_layers.py:330-435; ``fqss_tpu/nn/layers.py:
    QConvTranspose2d``, without padding): ``QConvTranspose1d`` in NCHW, weight [Cin, Cout, kh, kw] (JAX's kernel is
    ``(kh, kw, Cin, Cout)``), quantized per out-channel (axis 1)."""

    _conv = staticmethod(F.conv_transpose2d)


class QGroupNorm(nn.Module):
    """GroupNorm -> act-quant (GroupNormQ, qat_layers.py:438-452).

    Channels on axis 1 (NCT), or on the last axis with ``channels_last``
    (the JAX layer's layout, which the Sepformer's segments ``[B, K, S, F]``
    keep): the groups' statistics do not depend on the layout, the
    per-channel affine does. flax's GroupNorm (the JAX reference) takes the
    variance as E[x²]−E[x]²; ``F.group_norm`` need not round the same way on
    every device, and a difference in the last bit can move a value across a
    rounding tie of the next quantizer: a reason the parity tests allow
    one-LSB flips.
    """

    def __init__(self, num_groups: int, num_channels: int, epsilon: float = 1e-5, q: QuantSpec = FLOAT,
                 channels_last: bool = False):
        super().__init__()
        self.channels_last = channels_last
        self.norm = nn.GroupNorm(num_groups, num_channels, eps=epsilon)
        self.activation_fake_quantize = make_act_quantizer(q)

    def forward(self, x: Tensor) -> Tensor:
        if self.channels_last:  # the quantizer kernel takes contiguous tensors
            y = self.norm(x.movedim(-1, 1)).movedim(1, -1).contiguous()
        else:
            y = self.norm(x)
        return _quantize(self.activation_fake_quantize, y)


class QDense(nn.Module):
    """Fake-quant Linear with bias [-> GELU] -> act-quant (LinearQ/LinearNlQ, qat_layers.py:521-568).

    The JAX ``QDense`` with its bias and act-quant as the spec says, and no
    nonlinearity (DPTNet, the Sepformer) or ``nl="gelu"`` (HTDemucs's
    transformer FFN), the exact GELU between the bias and the act grid.

    Over the last axis: ``[..., in] -> [..., out]``. Weight ``[out, in]``
    quantized per out-channel (axis 0; the JAX kernel is its transpose,
    quantized on axis 1). The weight grid, the product, the bias add and the
    act grid are one call of :func:`fqss_tpu_torch.ops.qat_dense.qat_dense`:
    the fused kernel K5 and its backward K5-bwd on the card, their plain
    versions (the same composition, ``jnp.dot(x, w) + b`` between the
    grids) on the CPU. The quantizer modules stay in the tree, by their JAX
    names, and keep their observers: their window flags and ranges go to the
    kernel, and their state writes are :meth:`ActQuantizer.observe` and
    :meth:`WeightQuantizer.observe`. Inside a model's weight pass
    (:func:`fqss_tpu_torch.quant.quantizers.weight_pass`) the weight comes on
    its grid from the pass's grouped call, and K5 runs with its weight grid
    off, as for the folded model; its weight gradient goes back through the
    pass's grouped backward. An MSE act quantizer hands the kernel "not
    calibrated" as its flag, and observes the kernel's output, which is the
    unquantized value until it is calibrated. No layer that fuses its act
    grid takes a mu-law quantizer: only the I/O layers make one, and they run
    it as a module.

    Under tensor parallelism (``parallel/tp.py``: ``tp`` set by
    :func:`~fqss_tpu_torch.parallel.tp.shard_model_tp`, the weight pass
    required) a column-parallel layer holds its rows of the weight and bias
    and runs K5 as it is on them, its input through
    :func:`~fqss_tpu_torch.parallel.tp.copy_to_tp` (each output channel is
    whole on its rank, so its per-channel weight grid is local); a
    row-parallel layer holds its columns of the weight and runs K5's core on
    them with the bias and both grids off (no epilogue on a partial sum),
    sums the partial products over tp
    (:func:`~fqss_tpu_torch.parallel.tp.reduce_from_tp`), then adds the bias
    and applies the act quantizer as a module (K1, its STE mask at the summed
    pre-activation in the backward).
    """

    TP_LAYER = "dense"

    def __init__(self, in_features: int, features: int, q: QuantSpec = FLOAT,
                 generator: torch.Generator | None = None, nl: str | None = None):
        super().__init__()
        if nl not in (None, "gelu"):
            raise NotImplementedError(f"QDense(nl={nl!r}): K5's epilogue has the GELU only")
        self.q, self.gelu, self.features = q, nl == "gelu", features
        self.tp: tp.Shard | None = None
        bound = 1.0 / math.sqrt(in_features)
        self.weight = nn.Parameter(uniform_(torch.empty(features, in_features), bound, generator))
        self.bias = nn.Parameter(uniform_(torch.empty(features), bound, generator))
        self.weight_fake_quantize = make_weight_quantizer(q, (features, in_features), ch_axis=0)
        self.activation_fake_quantize = make_act_quantizer(q)

    def forward(self, x: Tensor) -> Tensor:
        wq, aq = self.weight_fake_quantize, self.activation_fake_quantize
        w, w_args, a_args, w_observing, a_observing = self.weight, {}, {}, None, None
        grouped = wq.grouped(w) if wq is not None else None
        if self.tp is not None:
            if wq is not None and grouped is None:
                wq.refuse_shard()  # a shard's weight grid is its model's weight pass's
            if self.tp.kind == tp.ROW:
                return self._row_parallel(x, w if grouped is None else grouped)
            x = tp.copy_to_tp(x, self.tp)
        if grouped is not None:  # the model's weight pass put the weight on its grid: K5's weight grid stays off
            w = grouped
        elif wq is not None:
            w_observing = wq.observing()
            wq.observe(self.weight, w_observing)  # the one-shot observer writes the ranges this call uses
            w_args = dict(w_mn=wq.min_range, w_mx=wq.max_range, w_bits=wq.n_bits,
                          w_s=weight_scale(self.weight.shape[0], wq.n_bits, wq.scale_grad))
        if aq is not None:
            a_observing = aq.observing()
            a_args = dict(a_mn=aq.min_range, a_mx=aq.max_range, a_bits=aq.n_bits,
                          a_s=1.0 / math.sqrt((2**aq.n_bits - 1) * self.features) if aq.scale_grad else 1.0)
        y = qat_dense(x.reshape(-1, x.shape[-1]).contiguous(), w, self.bias, w_observing=w_observing,
                      a_observing=a_observing, bf16=self.q.bf16, gelu=self.gelu, **w_args, **a_args)
        if aq is not None:
            aq.observe(y, a_observing)  # inside the window y is the pre-activation (after the GELU)
        return y.reshape(*x.shape[:-1], y.shape[-1])

    def _row_parallel(self, x: Tensor, w: Tensor) -> Tensor:
        """The row-parallel route (class note): K5's core on this rank's columns, the sum over tp, the bias, the
        act quantizer."""
        if self.gelu:
            raise NotImplementedError("QDense: a row-parallel layer has no GELU (its epilogue needs the whole sum)")
        zero = torch.zeros(self.features, device=x.device)
        y = qat_dense(x.reshape(-1, x.shape[-1]).contiguous(), w, zero, bf16=self.q.bf16)
        y = _quantize(self.activation_fake_quantize, tp.reduce_from_tp(y, self.tp) + self.bias)
        return y.reshape(*x.shape[:-1], y.shape[-1])


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm`` over one axis (the last, or ``dim``), with its arithmetic.

    flax takes the variance as E[x²] − E[x]² (clipped at 0) and scales the
    centred input by ``rsqrt(var + eps) * scale``; ``F.layer_norm`` takes a
    Welford variance instead, whose last bits differ and move values across
    the next quantizer's rounding ties. ``dim=1`` normalises the channels of
    an NCT tensor, which are the last axis of the JAX layer's NTC input.
    """

    def __init__(self, features: int, epsilon: float = 1e-5, dim: int = -1):
        super().__init__()
        self.epsilon, self.dim = epsilon, dim
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: Tensor) -> Tensor:
        d = self.dim
        mu = x.mean(d, keepdim=True)
        var = torch.clamp_min((x * x).mean(d, keepdim=True) - mu * mu, 0.0)
        weight, bias = self.weight, self.bias
        if d % x.ndim != x.ndim - 1:  # the affine's features on axis d
            shape = [-1 if i == d % x.ndim else 1 for i in range(x.ndim)]
            weight, bias = weight.view(shape), bias.view(shape)
        return (x - mu) * (torch.rsqrt(var + self.epsilon) * weight) + bias


class QLayerNorm(nn.Module):
    """LayerNorm over the last axis (or ``dim``) -> act-quant (LayerNormQ, qat_layers.py:455-469)."""

    def __init__(self, features: int, epsilon: float = 1e-5, q: QuantSpec = FLOAT, dim: int = -1):
        super().__init__()
        self.norm = LayerNorm(features, epsilon, dim)
        self.activation_fake_quantize = make_act_quantizer(q)

    def forward(self, x: Tensor) -> Tensor:
        return _quantize(self.activation_fake_quantize, self.norm(x))


class BatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` over the channels of axis 1 (NCT/NCHW; JAX's last axis), with its arithmetic: the
    batch statistics over every other axis, the variance as E[x²] − E[x]² (clipped at 0); in training the running
    statistics move by ``momentum r + (1 - momentum) batch`` (the biased variance), with ``use_running_average`` the
    running ones normalise; ``(x - mean) * (rsqrt(var + eps) * weight) + bias``. The running statistics are buffers
    (``running_mean``, ``running_var``; JAX's ``batch_stats`` ``mean``/``var``), kept in ``train()`` mode only."""

    def __init__(self, features: int, epsilon: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.epsilon, self.momentum = epsilon, momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: Tensor, use_running_average: bool = True) -> Tensor:
        shape = [-1 if i == 1 else 1 for i in range(x.ndim)]
        if use_running_average:
            mean, var = self.running_mean, self.running_var
        else:
            dims = [i for i in range(x.ndim) if i != 1]
            mean = x.mean(dims)
            var = torch.clamp_min((x * x).mean(dims) - mean * mean, 0.0)
            if self.training:
                with torch.no_grad():
                    self.running_mean.copy_(self.momentum * self.running_mean + (1 - self.momentum) * mean)
                    self.running_var.copy_(self.momentum * self.running_var + (1 - self.momentum) * var)
        return (x - mean.view(shape)) * (torch.rsqrt(var + self.epsilon) * self.weight).view(shape) + \
            self.bias.view(shape)


class QBatchNorm(nn.Module):
    """BatchNorm -> act-quant (BatchNormQ, qat_layers.py:472-486; ``fqss_tpu/nn/layers.py:QBatchNorm``). No model of
    either package uses it. ``forward(x, use_running_average=True)``: pass False to normalise by the batch's
    statistics (and, in ``train()`` mode, move the running ones)."""

    def __init__(self, features: int, epsilon: float = 1e-5, momentum: float = 0.9, q: QuantSpec = FLOAT,
                 act_n_bits: int | None = None):
        super().__init__()
        self.norm = BatchNorm(features, epsilon, momentum)
        self.activation_fake_quantize = make_act_quantizer(q, n_bits=act_n_bits)

    def forward(self, x: Tensor, use_running_average: bool = True) -> Tensor:
        return _quantize(self.activation_fake_quantize, self.norm(x, use_running_average))


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


def mark_replicated(*modules: nn.Module) -> None:
    """Mark every act quantizer in ``modules`` as observing a constant, the same on every data-parallel rank (a
    positional embedding, an embedding table's rows): it observes this rank's values alone
    (``ActQuantizer.replicated``)."""
    for module in modules:
        for m in module.modules():
            if isinstance(m, ActQuantizer):
                m.replicated = True


class QConst(nn.Module):
    """Identity -> act-quant: a constant's quant point (ConstQ, qat_layers.py:116-121; the Sepformer's
    positional encoding). ``replicated``: the input is a constant, the same on every data-parallel rank, which the
    observer sees once (``ActQuantizer.replicated``)."""

    def __init__(self, q: QuantSpec = FLOAT, replicated: bool = False):
        super().__init__()
        self.activation_fake_quantize = make_act_quantizer(q)
        if replicated:
            mark_replicated(self)

    def forward(self, x: Tensor) -> Tensor:
        return _quantize(self.activation_fake_quantize, x)
