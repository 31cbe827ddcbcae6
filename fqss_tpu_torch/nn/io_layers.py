"""Model I/O layers: splitter encoder and combiner decoder (``fqss_tpu/nn/io_layers.py``).

Encoder: [in-quant] -> Conv1d -> act-quant, on the splitter-widened input.
Decoder: ConvTranspose1d -> out-quant; with ``n_combiner >= 2`` a chain of
residual-error blocks re-encodes the quantized output, quantizes the latent
residual ``Y - Y_q`` and decodes it (shared decoder weights) into more
output planes, stacked ``[n_combiner, ...]`` for the combiner.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from fqss_tpu_torch.nn.layers import QConv1d, make_act_quantizer, make_weight_quantizer, uniform_
from fqss_tpu_torch.quant.spec import FLOAT, QuantSpec

Tensor = torch.Tensor


def expand_encoder_kernel(kernel: Tensor, n_splitter: int, generator: torch.Generator | None = None,
                          lsb_init: str = "gauss") -> Tensor:
    """Widen a float encoder weight ``[Cout, Cin, k]`` to ``n_splitter * Cin`` input channels.

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
    """[in-quant] -> Conv1d (no bias) -> act-quant (Conv1dEncoderQ, qat_layers.py:993-1046).

    Expects the splitter-widened input [B, n_splitter * audio_channels, T].
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 q: QuantSpec = FLOAT, generator: torch.Generator | None = None):
        super().__init__()
        self.in_quantizer = make_act_quantizer(q, enabled=q.in_quant, n_bits=q.in_act_n_bits,
                                               nl_quant=q.inout_nl_quant)
        self.conv = QConv1d(in_channels, out_channels, kernel_size, stride=stride, use_bias=False, q=q,
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
    the shared (already quantized) decoder weight.
    """

    def __init__(self, latent_features: int, out_features: int, kernel_size: int, stride: int,
                 q: QuantSpec = FLOAT, generator: torch.Generator | None = None):
        super().__init__()
        if q.train_res_dec:
            raise NotImplementedError("train_res_dec is not ported yet (ROADMAP.md, queue 1)")
        self.stride = stride
        self.residual_encoder = QConv1d(out_features, latent_features, kernel_size, stride=stride,
                                        use_bias=False, q=q, act_quant=False, generator=generator)
        self.activation_fake_quantize = make_act_quantizer(q)

    def forward(self, Y: Tensor, y_q: Tensor, w_decoder: Tensor) -> Tensor:
        Y1 = Y - self.residual_encoder(y_q)
        if self.activation_fake_quantize is not None:
            Y1 = self.activation_fake_quantize(Y1)
        return F.conv_transpose1d(Y1, w_decoder, stride=self.stride)


class QConvTr1dDecoder(nn.Module):
    """ConvTranspose1d decoder (no bias) -> out-quant [+ combiner residual planes]
    (ConvTr1dDecoderQ, qat_layers.py:1305-1361).

    Input [B, Cin, M]; weight [Cin, Cout, k], quantized per out-channel
    (axis 1). Returns [B, Cout, L] when n_combiner == 1, else
    [n_combiner, B, Cout, L].
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 q: QuantSpec = FLOAT, generator: torch.Generator | None = None):
        super().__init__()
        self.stride = stride
        self.n_combiner = q.n_combiner
        wshape = (in_channels, out_channels, kernel_size)
        bound = 1.0 / math.sqrt(out_channels * kernel_size)
        self.weight = nn.Parameter(uniform_(torch.empty(wshape), bound, generator))
        self.weight_fake_quantize = make_weight_quantizer(q, wshape, ch_axis=1)
        self.activation_fake_quantize = make_act_quantizer(q, enabled=q.out_quant, n_bits=q.out_act_n_bits,
                                                           nl_quant=q.inout_nl_quant)
        if q.n_combiner > 1:
            self.residual_error_block = _ResidualErrorBlock1d(in_channels, out_channels, kernel_size, stride,
                                                              q=q, generator=generator)
            self.activation_fake_quantize_residual = make_act_quantizer(q, enabled=q.out_quant,
                                                                        n_bits=q.out_act_n_bits)

    def forward(self, x: Tensor) -> Tensor:
        w_decoder = self.weight
        if self.weight_fake_quantize is not None:
            w_decoder = self.weight_fake_quantize(w_decoder)
        x0 = F.conv_transpose1d(x, w_decoder, stride=self.stride)
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
