"""ConvTasNet (speech) with declarative fake-quantization (``fqss_tpu/models/convtasnet.py``).

A 1-D conv encoder, a TCN mask network (n_repeats x n_blocks dilated
depthwise conv blocks with GroupNorm/PReLU and residual + skip 1x1 convs),
mask multiplication and a ConvTranspose1d decoder, wrapped by the FQSS input
splitter and output combiner. The quant points are those of the JAX model:
Conv+PReLU -> quant, GroupNorm -> quant, res/skip conv -> quant, skip-add ->
quant, mask PReLU -> quant, mask conv + act -> quant, mask-mul -> quant, and
the encoder/decoder as splitter/combiner I/O layers.

Waveforms enter and leave as [B, T] / [B, S, T]; inside, activations are
NCT. Submodule names equal the JAX scopes (``masker.tcn_0_0.conv_in`` ...).
"""

from __future__ import annotations

import torch
from torch import nn

from fqss_tpu_torch.nn.io_layers import QConv1dEncoder, QConvTr1dDecoder
from fqss_tpu_torch.nn.layers import QAdd, QConv1d, QGroupNorm, QMul, QNl
from fqss_tpu_torch.quant.quantizers import weight_pass
from fqss_tpu_torch.quant.spec import FLOAT, QuantSpec
from fqss_tpu_torch.separation.splitter import postprocess, preprocess

Tensor = torch.Tensor

EPS = 1e-8  # convtasnetq.py:8


class ConvBlock(nn.Module):
    """TCN block (convtasnetq.py:11-42): 1x1 conv+PReLU -> gLN -> dilated
    depthwise conv+PReLU -> gLN -> residual & skip 1x1 convs."""

    def __init__(self, io_channels: int, hidden_channels: int, kernel_size: int, padding: int,
                 dilation: int = 1, q: QuantSpec = FLOAT, generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.conv_in = QConv1d(io_channels, hidden_channels, 1, nl="prelu", q=q, generator=g)
        self.norm_in = QGroupNorm(1, hidden_channels, epsilon=EPS, q=q)
        self.conv_dw = QConv1d(hidden_channels, hidden_channels, kernel_size, padding=padding,
                               dilation=dilation, groups=hidden_channels, nl="prelu", q=q, generator=g)
        self.norm_dw = QGroupNorm(1, hidden_channels, epsilon=EPS, q=q)
        self.res_conv = QConv1d(hidden_channels, io_channels, 1, q=q, generator=g)
        self.skip_conv = QConv1d(hidden_channels, io_channels, 1, q=q, generator=g)
        self.add = QAdd(q=q)

    def forward(self, x: Tensor) -> tuple[Tensor, Tensor]:
        f = self.norm_in(self.conv_in(x))
        f = self.norm_dw(self.conv_dw(f))
        return self.add(x, self.res_conv(f)), self.skip_conv(f)


class MaskGenerator(nn.Module):
    """TCN separation module (convtasnetq.py:45-115). [B, F, M] -> [B, S, F, M]."""

    def __init__(self, input_dim: int, n_srcs: int, kernel_size: int, num_feats: int, num_hidden: int,
                 num_layers: int, num_stacks: int, msk_activate: str, q: QuantSpec = FLOAT,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.input_dim, self.n_srcs = input_dim, n_srcs
        self.bottleneck_norm = QGroupNorm(1, input_dim, epsilon=EPS, q=q)
        self.bottleneck_conv = QConv1d(input_dim, num_feats, 1, q=q, generator=g)
        self.blocks = []
        for s in range(num_stacks):
            for layer in range(num_layers):
                multi = 2**layer
                block = ConvBlock(num_feats, num_hidden, kernel_size, padding=multi, dilation=multi, q=q,
                                  generator=g)
                self.add_module(f"tcn_{s}_{layer}", block)
                self.blocks.append(block)
        self.skip_adds = []
        for idx in range(len(self.blocks) - 1):
            add = QAdd(q=q)
            self.add_module(f"skip_add_{idx}", add)
            self.skip_adds.append(add)
        self.mask_prelu = QNl("prelu", q=q)
        self.mask_conv = QConv1d(num_feats, input_dim * n_srcs, 1, nl=msk_activate, q=q, generator=g)

    def forward(self, x: Tensor) -> Tensor:
        feats = self.bottleneck_conv(self.bottleneck_norm(x))
        output = None
        for i, block in enumerate(self.blocks):
            feats, skip = block(feats)
            output = skip if output is None else self.skip_adds[i - 1](output, skip)
        output = self.mask_conv(self.mask_prelu(output))
        b, _, m = output.shape
        return output.reshape(b, self.n_srcs, self.input_dim, m)


class ConvTasNet(nn.Module):
    """Conv-TasNet QAT model (convtasnetq.py:118-223).

    forward: [B, T] (or [B, C, T]) mixture -> [B, S, T] separations.
    ``generator`` seeds the weight init; ranges start at the quantizers'
    defaults until an observer pass or a loaded state sets them.
    """

    def __init__(self, n_srcs: int = 1, kernel_size: int = 32, stride: int = 16, n_filters: int = 512,
                 mask_kernel_size: int = 3, bn_chan: int = 128, hid_chan: int = 512, n_blocks: int = 8,
                 n_repeats: int = 3, mask_act: str = "relu", q: QuantSpec = FLOAT,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.n_srcs, self.n_filters, self.q = n_srcs, n_filters, q
        self.encoder = QConv1dEncoder(q.n_splitter, n_filters, kernel_size, stride=stride, q=q,
                                      generator=generator)
        self.masker = MaskGenerator(n_filters, n_srcs, mask_kernel_size, bn_chan, hid_chan, n_blocks, n_repeats,
                                    mask_act, q=q, generator=generator)
        self.mul = QMul(q=q)
        self.decoder = QConvTr1dDecoder(n_filters, 1, kernel_size, stride=stride, q=q, generator=generator)

    def forward(self, x: Tensor) -> Tensor:
        with weight_pass(self):  # every weight quantizer in one grouped call, forward and backward
            x = preprocess(x, n_splitter=self.q.n_splitter)  # [B, n_splitter*C, T]
            batch_size = x.shape[0]
            feats = self.encoder(x)  # [B, F, M]
            mask = self.masker(feats)  # [B, S, F, M]
            masked = self.mul(mask, feats[:, None])
            masked = masked.reshape(batch_size * self.n_srcs, self.n_filters, -1)
            out_decoder = self.decoder(masked)  # [(n_comb,) B*S, 1, L]
            length = out_decoder.shape[-1]
            planes = out_decoder.reshape(self.q.n_combiner, batch_size, self.n_srcs, 1, length)
            return postprocess(planes, n_combiner=self.q.n_combiner)
