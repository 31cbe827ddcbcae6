"""ConvTasNet-music (stereo, 4-stem MUSDB) with declarative fake-quantization
(``fqss_tpu/models/convtasnet_music.py``).

A stereo Conv1d+ReLU encoder (kernel 20, stride 10), a TCN mask network of
n_repeats x n_blocks depthwise-separable conv blocks behind a channel-wise
LayerNorm and a bottleneck, and a Linear decoder producing
``audio_channels * kernel_size`` samples a frame, recombined by
overlap-and-add. The splitter runs with ``normalize=False``
(convtasnetq_music.py:220-221). The quant points are those of the JAX
model: the encoder and decoder as splitter/combiner I/O layers; in each
block the 1x1 conv+PReLU, the gLN and the residual add; in each
depthwise-separable conv the depthwise conv+PReLU, the gLN and the
pointwise conv; the masker's LayerNorm, bottleneck and mask conv+activation;
the mask multiplication.

Waveforms enter as ``[B, audio_channels, T]`` and leave as
``[B, n_sources, audio_channels, T']``; inside, activations are NCT where
JAX's are NTC, so the masker's LayerNorm normalises axis 1 (the filters,
JAX's last axis) with flax's arithmetic. The bias-free ``bottleneck`` and
``pointwise`` 1x1 convs take the fused kernel K3 where no gradient is
needed. Submodule names equal the JAX scopes (``separator.tcn_0_0.dsconv.
pointwise`` ...).
"""

from __future__ import annotations

import torch
from torch import nn

from fqss_tpu_torch.models.dptnet import overlap_and_add
from fqss_tpu_torch.nn.io_layers import QConv1dEncoder, QLinearDecoder
from fqss_tpu_torch.nn.layers import QAdd, QConv1d, QGroupNorm, QLayerNorm, QMul
from fqss_tpu_torch.quant.quantizers import weight_pass
from fqss_tpu_torch.quant.spec import FLOAT, QuantSpec
from fqss_tpu_torch.separation.splitter import postprocess, preprocess

Tensor = torch.Tensor

EPS = 1e-8

SOURCES = ("drums", "bass", "other", "vocals")


class DepthwiseSeparableConv(nn.Module):
    """depthwise conv+PReLU -> gLN -> pointwise conv (convtasnetq_music.py:141-175). [B, H, K] -> [B, out, K]."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, padding: int, dilation: int,
                 q: QuantSpec = FLOAT, generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.depthwise = QConv1d(in_channels, in_channels, kernel_size, padding=padding, dilation=dilation,
                                 groups=in_channels, use_bias=False, nl="prelu", q=q, generator=g)
        self.norm = QGroupNorm(1, in_channels, epsilon=EPS, q=q)
        self.pointwise = QConv1d(in_channels, out_channels, 1, use_bias=False, q=q, generator=g)

    def forward(self, x: Tensor) -> Tensor:
        return self.pointwise(self.norm(self.depthwise(x)))


class ConvBlock(nn.Module):
    """1x1 conv+PReLU -> gLN -> depthwise-separable conv -> + residual (convtasnetq_music.py:110-138)."""

    def __init__(self, in_channels: int, hidden_channels: int, kernel_size: int, padding: int, dilation: int,
                 q: QuantSpec = FLOAT, generator: torch.Generator | None = None):
        super().__init__()
        self.conv1x1 = QConv1d(in_channels, hidden_channels, 1, use_bias=False, nl="prelu", q=q, generator=generator)
        self.norm = QGroupNorm(1, hidden_channels, epsilon=EPS, q=q)
        self.dsconv = DepthwiseSeparableConv(hidden_channels, in_channels, kernel_size, padding, dilation, q=q,
                                             generator=generator)
        self.add = QAdd(q=q)

    def forward(self, x: Tensor) -> Tensor:
        return self.add(self.dsconv(self.norm(self.conv1x1(x))), x)


class MaskGenerator(nn.Module):
    """cLN -> bottleneck -> TCN -> mask conv+act (convtasnetq_music.py:53-107). [B, N, K] -> [B, C, N, K]."""

    def __init__(self, n_filters: int, bn_chan: int, hid_chan: int, conv_kernel: int, n_blocks: int,
                 n_repeats: int, n_srcs: int, mask_act: str = "relu", q: QuantSpec = FLOAT,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.n_srcs, self.n_filters = n_srcs, n_filters
        self.layer_norm = QLayerNorm(n_filters, epsilon=EPS, q=q, dim=1)  # over the filters, JAX's last axis
        self.bottleneck = QConv1d(n_filters, bn_chan, 1, use_bias=False, q=q, generator=g)
        self.blocks = []
        for r in range(n_repeats):
            for xi in range(n_blocks):
                dilation = 2**xi
                block = ConvBlock(bn_chan, hid_chan, conv_kernel, (conv_kernel - 1) * dilation // 2, dilation, q=q,
                                  generator=g)
                self.add_module(f"tcn_{r}_{xi}", block)
                self.blocks.append(block)
        self.mask_conv = QConv1d(bn_chan, n_srcs * n_filters, 1, use_bias=False, nl=mask_act, q=q, generator=g)

    def forward(self, x: Tensor) -> Tensor:
        y = self.bottleneck(self.layer_norm(x))
        for block in self.blocks:
            y = block(y)
        mask = self.mask_conv(y)  # [B, C*N, K]
        return mask.reshape(mask.shape[0], self.n_srcs, self.n_filters, mask.shape[-1])


class ConvTasNetMusic(nn.Module):
    """ConvTasNet music QAT model (convtasnetq_music.py:178-267).

    forward: ``[B, audio_channels, T]`` -> ``[B, n_sources, audio_channels, (K-1)*stride + kernel_size]``
    with ``K = (T - kernel_size) // stride + 1`` frames. ``generator`` seeds the weight init; ranges start at
    the quantizers' defaults until an observer pass or a loaded state sets them.
    """

    def __init__(self, sources: tuple[str, ...] = SOURCES, audio_channels: int = 2, n_filters: int = 256,
                 kernel_size: int = 20, stride: int = 10, bn_chan: int = 256, hid_chan: int = 512,
                 conv_kernel: int = 3, n_blocks: int = 10, n_repeats: int = 4, mask_act: str = "relu",
                 q: QuantSpec = FLOAT, generator: torch.Generator | None = None):
        super().__init__()
        self.sources, self.q = tuple(sources), q
        self.n_srcs, self.audio_channels, self.n_filters = len(self.sources), audio_channels, n_filters
        self.kernel_size, self.stride = kernel_size, stride
        self.n_blocks, self.n_repeats, self.mask_act = n_blocks, n_repeats, mask_act
        self.encoder = QConv1dEncoder(q.n_splitter * audio_channels, n_filters, kernel_size, stride=stride, nl="relu",
                                      q=q, generator=generator)
        self.separator = MaskGenerator(n_filters, bn_chan, hid_chan, conv_kernel, n_blocks, n_repeats, self.n_srcs,
                                       mask_act, q=q, generator=generator)
        self.mul = QMul(q=q)
        self.decoder = QLinearDecoder(n_filters, audio_channels * kernel_size, use_bias=False, q=q,
                                      generator=generator)

    def forward(self, x: Tensor) -> Tensor:
        with weight_pass(self):  # every weight quantizer in one grouped call, forward and backward
            x = preprocess(x, n_splitter=self.q.n_splitter, normalize=False)  # [B, n_split*ac, T]
            b = x.shape[0]
            feats = self.encoder(x)  # [B, N, K]
            mask = self.separator(feats)  # [B, C, N, K]
            # the decoder is a Linear over the filters: frames before filters, JAX's layout
            masked = self.mul(mask, feats[:, None]).transpose(-1, -2).contiguous()  # [B, C, K, N]
            dec = self.decoder(masked)  # [(n_comb,) B, C, K, ac*kernel]
            k = dec.shape[-2]
            dec = dec.reshape(self.q.n_combiner, b, self.n_srcs, k, self.audio_channels, self.kernel_size)
            out = overlap_and_add(dec.transpose(3, 4), self.stride)  # [n_comb, B, C, ac, T']
            return postprocess(out, n_combiner=self.q.n_combiner)
