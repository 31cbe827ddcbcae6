"""Model I/O layers: splitter encoder and combiner decoder (``fqss_tpu/nn/io_layers.py``).

Encoder: [in-quant] -> Conv1d [-> NL] -> act-quant, on the splitter-widened
input. Decoders (ConvTranspose1d for ConvTasNet, the Sepformer and
HTDemucs's time branch, ConvTranspose2d for HTDemucs's frequency branch,
Linear for DPTNet and ConvTasNet-music) -> out-quant; with ``n_combiner >= 2`` a chain of
residual-error blocks re-encodes the quantized output, quantizes the latent
residual ``Y - Y_q`` and decodes it (shared decoder weights, or the block's
own with ``train_res_dec``) into more output planes, stacked
``[n_combiner, ...]`` for the combiner.

Under bf16 compute each product's operands are rounded where JAX rounds
them (``fqss_tpu/nn/io_layers.py``: the transposed convolutions and the
dense products, through :func:`~fqss_tpu_torch.nn.layers.mxu_operands`);
the encoders' convolutions are ``QConv1d``'s.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from fqss_tpu_torch.nn.layers import (
    QConv1d,
    QConv2d,
    _pair,
    make_act_quantizer,
    make_weight_quantizer,
    mxu_operands,
    uniform_,
)
from fqss_tpu_torch.quant.spec import FLOAT, QuantSpec

Tensor = torch.Tensor


def expand_encoder_kernel(kernel: Tensor, n_splitter: int, generator: torch.Generator | None = None,
                          lsb_init: str = "gauss") -> Tensor:
    """Widen a float encoder weight ``[Cout, Cin, k]`` (or a 2-D one, ``[Cout, Cin, kh, kw]``) to ``n_splitter *
    Cin`` input channels.

    The new channel groups (the LSB-plane inputs) are initialised per
    ``lsb_init``:

    * ``"gauss"`` — for input channel c of group n, Gaussian noise with the
      mean of the original channel's weights and their (population) std to
      the power n, the reference's scheme (qat_layers.py:1009-1026). The
      numbers come from ``generator`` and differ from ``jax.random``'s.
    * ``"zeros"`` — zero LSB groups: the widened encoder computes exactly
      the float model's encoder on the MSB plane.
    """
    if n_splitter < 2:
        return kernel
    groups = [kernel]
    for n in range(1, n_splitter):
        if lsb_init == "zeros":
            groups.append(torch.zeros_like(kernel))
            continue
        block = []
        for c in range(kernel.shape[1]):
            w = kernel[:, c]
            noise = torch.randn(w.shape, generator=generator, dtype=w.dtype, device=w.device)
            block.append(w.mean() + noise * w.std(correction=0) ** n)
        groups.append(torch.stack(block, dim=1))
    return torch.cat(groups, dim=1)


class QConv1dEncoder(nn.Module):
    """[in-quant] -> Conv1d (no bias) [-> NL] -> act-quant (Conv1dEncoderQ, qat_layers.py:993-1046).

    Expects the splitter-widened input [B, n_splitter * audio_channels, T].
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 nl: str | None = None, q: QuantSpec = FLOAT, generator: torch.Generator | None = None):
        super().__init__()
        self.in_quantizer = make_act_quantizer(q, enabled=q.in_quant, n_bits=q.in_act_n_bits,
                                               nl_quant=q.inout_nl_quant)
        self.conv = QConv1d(in_channels, out_channels, kernel_size, stride=stride, use_bias=False, nl=nl, q=q,
                            generator=generator)

    def forward(self, x: Tensor) -> Tensor:
        if self.in_quantizer is not None:
            x = self.in_quantizer(x)
        return self.conv(x)


class _ResidualErrorBlock1d(nn.Module):
    """Combiner residual block for ConvTranspose1d decoders
    (ResidualErrorBlock, qat_layers.py:1105-1231).

    forward(Y, y_q, w_decoder): re-encode the quantized decoder output y_q
    with a Conv1d, quantize the latent residual Y - Y_q, and decode it with
    the shared (already quantized) decoder weight, or with ``train_res_dec``
    with a residual decoder of its own: ``residual_decoder_weight``
    ``[Cin, Cout, k]`` (JAX's ``residual_decoder_kernel``), quantized per
    out-channel (axis 1) by ``weight_fake_quantize_dec``
    (``fqss_tpu/nn/io_layers.py:185-193``).
    """

    WEIGHT_QUANTIZERS = {"weight_fake_quantize_dec": "residual_decoder_weight"}

    def __init__(self, latent_features: int, out_features: int, kernel_size: int, stride: int,
                 q: QuantSpec = FLOAT, generator: torch.Generator | None = None, use_bias: bool = False):
        super().__init__()
        self.q, self.stride = q, stride
        self.residual_encoder = QConv1d(out_features, latent_features, kernel_size, stride=stride,
                                        use_bias=use_bias, q=q, act_quant=False, generator=generator)
        self.activation_fake_quantize = make_act_quantizer(q)
        if q.train_res_dec:
            wshape = (latent_features, out_features, kernel_size)
            bound = 1.0 / math.sqrt(out_features * kernel_size)
            self.residual_decoder_weight = nn.Parameter(uniform_(torch.empty(wshape), bound, generator))
            self.weight_fake_quantize_dec = make_weight_quantizer(q, wshape, ch_axis=1)
        else:
            self.residual_decoder_weight = self.weight_fake_quantize_dec = None

    def forward(self, Y: Tensor, y_q: Tensor, w_decoder: Tensor) -> Tensor:
        Y1 = Y - self.residual_encoder(y_q)
        if self.activation_fake_quantize is not None:
            Y1 = self.activation_fake_quantize(Y1)
        if self.residual_decoder_weight is not None:
            w_decoder = self.residual_decoder_weight
            if self.weight_fake_quantize_dec is not None:
                w_decoder = self.weight_fake_quantize_dec(w_decoder)
        return F.conv_transpose1d(*mxu_operands(self.q, Y1, w_decoder), stride=self.stride)


class QConvTr1dDecoder(nn.Module):
    """ConvTranspose1d decoder [+ bias] -> out-quant [+ combiner residual planes]
    (ConvTr1dDecoderQ, qat_layers.py:1305-1361).

    Input [B, Cin, M]; weight [Cin, Cout, k], quantized per out-channel
    (axis 1). Returns [B, Cout, L] when n_combiner == 1, else
    [n_combiner, B, Cout, L]. ``use_bias`` (HTDemucs's last time decoder)
    gives the decoder and the combiner's residual encoder a bias each.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 q: QuantSpec = FLOAT, generator: torch.Generator | None = None, use_bias: bool = False):
        super().__init__()
        self.q, self.stride = q, stride
        self.n_combiner = q.n_combiner
        wshape = (in_channels, out_channels, kernel_size)
        bound = 1.0 / math.sqrt(out_channels * kernel_size)
        self.weight = nn.Parameter(uniform_(torch.empty(wshape), bound, generator))
        self.bias = nn.Parameter(uniform_(torch.empty(out_channels), bound, generator)) if use_bias else None
        self.weight_fake_quantize = make_weight_quantizer(q, wshape, ch_axis=1)
        self.activation_fake_quantize = make_act_quantizer(q, enabled=q.out_quant, n_bits=q.out_act_n_bits,
                                                           nl_quant=q.inout_nl_quant)
        if q.n_combiner > 1:
            self.residual_error_block = _ResidualErrorBlock1d(in_channels, out_channels, kernel_size, stride,
                                                              q=q, generator=generator, use_bias=use_bias)
            self.activation_fake_quantize_residual = make_act_quantizer(q, enabled=q.out_quant,
                                                                        n_bits=q.out_act_n_bits)

    def forward(self, x: Tensor) -> Tensor:
        w_decoder = self.weight
        if self.weight_fake_quantize is not None:
            w_decoder = self.weight_fake_quantize(w_decoder)
        x0 = F.conv_transpose1d(*mxu_operands(self.q, x, w_decoder), self.bias, stride=self.stride)
        out_q = self.activation_fake_quantize
        y = out_q(x0) if out_q is not None else x0
        if self.n_combiner == 1:
            return y
        res_out_q = self.activation_fake_quantize_residual
        outs = [y]
        for _ in range(1, self.n_combiner):
            x = self.residual_error_block(x, y, w_decoder)
            y = res_out_q(x) if res_out_q is not None else x
            outs.append(y)
        return torch.stack(outs)


class _ResidualErrorBlock2d(nn.Module):
    """Combiner residual block for ConvTranspose2d decoders (ResidualErrorBlock, qat_layers.py:1147-1169,
    1203-1217; ``fqss_tpu/nn/io_layers.py:_ResidualErrorBlock2d``). NCHW.

    forward(Y, y_q, w_decoder): re-encode the quantized decoder output with a
    Conv2d, quantize the latent residual ``Y - Y_q``, and decode it with the
    shared (already quantized) decoder weight, or with ``train_res_dec`` with
    a residual decoder of its own, ``residual_decoder_weight`` ``[Cin, Cout,
    kh, kw]`` quantized per out-channel (axis 1) by
    ``weight_fake_quantize_dec``, and its own bias ``residual_decoder_bias``
    where the decoder has one.
    """

    WEIGHT_QUANTIZERS = {"weight_fake_quantize_dec": "residual_decoder_weight"}

    def __init__(self, latent_features: int, out_features: int, kernel_size: tuple[int, int],
                 stride: tuple[int, int], use_bias: bool = True, q: QuantSpec = FLOAT,
                 generator: torch.Generator | None = None):
        super().__init__()
        kh, kw = kernel_size
        self.q, self.stride = q, stride
        self.residual_encoder = QConv2d(out_features, latent_features, kernel_size, stride=stride,
                                        use_bias=use_bias, q=q, act_quant=False, generator=generator)
        self.activation_fake_quantize = make_act_quantizer(q)
        self.residual_decoder_weight = self.residual_decoder_bias = self.weight_fake_quantize_dec = None
        if q.train_res_dec:
            wshape = (latent_features, out_features, kh, kw)
            bound = 1.0 / math.sqrt(out_features * kh * kw)
            self.residual_decoder_weight = nn.Parameter(uniform_(torch.empty(wshape), bound, generator))
            if use_bias:
                self.residual_decoder_bias = nn.Parameter(uniform_(torch.empty(out_features), bound, generator))
            self.weight_fake_quantize_dec = make_weight_quantizer(q, wshape, ch_axis=1)

    def forward(self, Y: Tensor, y_q: Tensor, w_decoder: Tensor) -> Tensor:
        Y1 = Y - self.residual_encoder(y_q)
        if self.activation_fake_quantize is not None:
            Y1 = self.activation_fake_quantize(Y1)
        if self.residual_decoder_weight is not None:
            w_decoder = self.residual_decoder_weight
            if self.weight_fake_quantize_dec is not None:
                w_decoder = self.weight_fake_quantize_dec(w_decoder)
        return F.conv_transpose2d(*mxu_operands(self.q, Y1, w_decoder), self.residual_decoder_bias,
                                  stride=self.stride)


class QConvTr2dDecoder(nn.Module):
    """ConvTranspose2d decoder [+ bias] -> out-quant [+ combiner planes] (ConvTr2dDecoderQ,
    qat_layers.py:1364-1421; ``fqss_tpu/nn/io_layers.py:QConvTr2dDecoder``). NCHW.

    Input [B, Cin, H, W]; weight [Cin, Cout, kh, kw] (JAX's kernel is ``(kh, kw, Cin, Cout)``), quantized per
    out-channel (axis 1). Returns [B, Cout, H', W'] or [n_combiner, B, Cout, H', W'].
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int | tuple[int, int],
                 stride: int | tuple[int, int], use_bias: bool = True, q: QuantSpec = FLOAT,
                 generator: torch.Generator | None = None):
        super().__init__()
        k, self.stride = _pair(kernel_size), _pair(stride)
        self.q, self.n_combiner = q, q.n_combiner
        wshape = (in_channels, out_channels, *k)
        bound = 1.0 / math.sqrt(out_channels * k[0] * k[1])
        self.weight = nn.Parameter(uniform_(torch.empty(wshape), bound, generator))
        self.bias = nn.Parameter(uniform_(torch.empty(out_channels), bound, generator)) if use_bias else None
        self.weight_fake_quantize = make_weight_quantizer(q, wshape, ch_axis=1)
        self.activation_fake_quantize = make_act_quantizer(q, enabled=q.out_quant, n_bits=q.out_act_n_bits,
                                                           nl_quant=q.inout_nl_quant)
        if q.n_combiner > 1:
            self.residual_error_block = _ResidualErrorBlock2d(in_channels, out_channels, k, self.stride,
                                                              use_bias=use_bias, q=q, generator=generator)
            self.activation_fake_quantize_residual = make_act_quantizer(q, enabled=q.out_quant,
                                                                        n_bits=q.out_act_n_bits)

    def forward(self, x: Tensor) -> Tensor:
        w_decoder = self.weight
        if self.weight_fake_quantize is not None:
            w_decoder = self.weight_fake_quantize(w_decoder)
        x0 = F.conv_transpose2d(*mxu_operands(self.q, x, w_decoder), self.bias, stride=self.stride)
        out_q = self.activation_fake_quantize
        y = out_q(x0) if out_q is not None else x0
        if self.n_combiner == 1:
            return y
        res_out_q = self.activation_fake_quantize_residual
        outs = [y]
        for _ in range(1, self.n_combiner):
            x = self.residual_error_block(x, y, w_decoder)
            y = res_out_q(x) if res_out_q is not None else x
            outs.append(y)
        return torch.stack(outs)


class _ResidualErrorBlockDense(nn.Module):
    """Combiner residual block for Linear decoders (qat_layers.py:1110-1121, 1179-1187).

    forward(Y, y_q, w_decoder): re-encode the quantized decoder output y_q
    ``[..., out]`` with a Linear to the latent width, quantize the latent
    residual Y - Y_q, and decode it with the shared (already quantized)
    decoder weight ``[out, latent]``.
    """

    WEIGHT_QUANTIZERS = {"weight_fake_quantize": "residual_encoder_weight"}

    def __init__(self, latent_features: int, out_features: int, use_bias: bool = True, q: QuantSpec = FLOAT,
                 generator: torch.Generator | None = None):
        super().__init__()
        if q.train_res_dec:
            raise NotImplementedError("train_res_dec is not ported yet (ROADMAP.md, queue 1)")
        self.q = q
        bound = 1.0 / math.sqrt(out_features)
        wshape = (latent_features, out_features)
        self.residual_encoder_weight = nn.Parameter(uniform_(torch.empty(wshape), bound, generator))
        self.residual_encoder_bias = (nn.Parameter(uniform_(torch.empty(latent_features), bound, generator))
                                      if use_bias else None)
        self.weight_fake_quantize = make_weight_quantizer(q, wshape, ch_axis=0)
        self.activation_fake_quantize = make_act_quantizer(q)

    def forward(self, Y: Tensor, y_q: Tensor, w_decoder: Tensor) -> Tensor:
        w_enc = self.residual_encoder_weight
        if self.weight_fake_quantize is not None:
            w_enc = self.weight_fake_quantize(w_enc)
        yc, wc = mxu_operands(self.q, y_q, w_enc)
        Y_q = torch.matmul(yc, wc.t())
        if self.residual_encoder_bias is not None:
            Y_q = Y_q + self.residual_encoder_bias
        Y1 = Y - Y_q
        if self.activation_fake_quantize is not None:
            Y1 = self.activation_fake_quantize(Y1)
        Y1c, wdc = mxu_operands(self.q, Y1, w_decoder)
        return torch.matmul(Y1c, wdc.t())


class QLinearDecoder(nn.Module):
    """Linear decoder (over the last axis) -> out-quant [+ combiner planes]
    (LinearDecoderQ, qat_layers.py:1256-1302).

    Input [..., Cin]; weight [F, Cin], quantized per out-channel (axis 0).
    Returns [..., F] when n_combiner == 1, else [n_combiner, ..., F].
    """

    def __init__(self, in_features: int, features: int, use_bias: bool = False, q: QuantSpec = FLOAT,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.q, self.n_combiner = q, q.n_combiner
        bound = 1.0 / math.sqrt(in_features)
        self.weight = nn.Parameter(uniform_(torch.empty(features, in_features), bound, generator))
        self.bias = nn.Parameter(uniform_(torch.empty(features), bound, generator)) if use_bias else None
        self.weight_fake_quantize = make_weight_quantizer(q, (features, in_features), ch_axis=0)
        self.activation_fake_quantize = make_act_quantizer(q, enabled=q.out_quant, n_bits=q.out_act_n_bits,
                                                           nl_quant=q.inout_nl_quant)
        if q.n_combiner > 1:
            self.residual_error_block = _ResidualErrorBlockDense(in_features, features, use_bias=use_bias, q=q,
                                                                 generator=generator)
            self.activation_fake_quantize_residual = make_act_quantizer(q, enabled=q.out_quant,
                                                                        n_bits=q.out_act_n_bits)

    def forward(self, x: Tensor) -> Tensor:
        w_decoder = self.weight
        if self.weight_fake_quantize is not None:
            w_decoder = self.weight_fake_quantize(w_decoder)
        xc, wc = mxu_operands(self.q, x, w_decoder)
        x0 = torch.matmul(xc, wc.t())
        if self.bias is not None:
            x0 = x0 + self.bias
        out_q = self.activation_fake_quantize
        y = out_q(x0) if out_q is not None else x0
        if self.n_combiner == 1:
            return y
        res_out_q = self.activation_fake_quantize_residual
        outs = [y]
        for _ in range(1, self.n_combiner):
            x = self.residual_error_block(x, y, w_decoder)
            y = res_out_q(x) if res_out_q is not None else x
            outs.append(y)
        return torch.stack(outs)
