"""Sepformer with declarative fake-quantization (``fqss_tpu/models/sepformer.py``).

A conv encoder (ReLU), a chunked dual-path transformer masker (intra- and
inter-chunk TransformerBlocks of pre-norm layers, a sinusoidal positional
encoding added through a quantized constant), a gated tanh x sigmoid mask
head, and a ConvTranspose1d decoder whose combiner trains its own residual
decoder (reference: quantization/qat/models/sepformerq.py:13-527). The quant
points are those of the JAX model: per transformer layer the norms, the
attention and the two feed-forward linears with their ReLU (the residual
adds inside a layer are not quant points); per TransformerBlock the final
norm, the positional-encoding constant and its add; per DualPathBlock the
intra/inter GroupNorms and residual adds; the mask head's convs, PReLU,
gates and product.

Waveforms enter and leave as [B, T] / [B, S, T]. The encoder, the masker's
first and last convolutions and the decoder run NCT (``[B, F, M]``); the
segments are channels-last ``[B, K, S, F]`` (K = chunk length, S = number of
50%-overlap chunks) and the transformer layers batch-first ``[B', L, F]``,
as in JAX, so the dual-path GroupNorms normalise channels-last. Every
quantizer input is contiguous, which the CUDA kernels require. Submodule
names equal the JAX scopes (``masker.dp_0.intra_transformer_block.layer_3.mha...``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from fqss_tpu_torch.models.dptnet import merge_segments, split_segments
from fqss_tpu_torch.nn.attention import QMultiheadAttention
from fqss_tpu_torch.nn.io_layers import QConv1dEncoder, QConvTr1dDecoder
from fqss_tpu_torch.nn.layers import QAdd, QConst, QConv1d, QDense, QGroupNorm, QLayerNorm, QMul, QNl
from fqss_tpu_torch.quant.quantizers import weight_pass
from fqss_tpu_torch.quant.spec import FLOAT, QuantSpec
from fqss_tpu_torch.separation.splitter import postprocess, preprocess

Tensor = torch.Tensor

EPS_T = 1e-6  # the transformer layers' LayerNorms
EPS = 1e-8  # the GroupNorms


def sinusoidal_pe(max_len: int, d_model: int) -> np.ndarray:
    """Absolute sinusoidal positional encoding ``[max_len, d_model]`` (sepformerq.py:13-37), as JAX computes it."""
    pe = np.zeros((max_len, d_model), np.float32)
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    den = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * -(math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(pos * den)
    pe[:, 1::2] = np.cos(pos * den)
    return pe


class TransformerLayer(nn.Module):
    """Pre-norm transformer layer (sepformerq.py:50-95). ``[B', L, F] -> [B', L, F]``."""

    # Under tensor parallelism the modules between the column-parallel ffn_in and the row-parallel ffn_out, whose
    # input tp shards (parallel/tp.py)
    TP_SHARDED_BETWEEN = ("ffn_relu",)

    def __init__(self, n_filters: int, n_ffn: int, n_heads: int, q: QuantSpec = FLOAT,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.norm1 = QLayerNorm(n_filters, EPS_T, q=q)
        self.mha = QMultiheadAttention(n_filters, n_heads, q=q, generator=g)
        self.norm2 = QLayerNorm(n_filters, EPS_T, q=q)
        self.ffn_in = QDense(n_filters, n_ffn, q=q, generator=g)
        self.ffn_relu = QNl("relu", q=q)
        self.ffn_out = QDense(n_ffn, n_filters, q=q, generator=g)

    def forward(self, x: Tensor) -> Tensor:
        x_norm1 = self.norm1(x)
        x = x + self.mha(x_norm1, x_norm1, x_norm1)  # residual adds are not quant points here (faithful)
        return x + self.ffn_out(self.ffn_relu(self.ffn_in(self.norm2(x))))


class TransformerBlock(nn.Module):
    """Positional encoding, a stack of layers and a final norm (sepformerq.py:98-123). ``[B', L, F]``."""

    def __init__(self, n_filters: int, n_heads: int, n_ffn: int, num_layers: int = 8, max_len: int = 2500,
                 q: QuantSpec = FLOAT, generator: torch.Generator | None = None):
        super().__init__()
        self.register_buffer("pe", torch.from_numpy(sinusoidal_pe(max_len, n_filters)), persistent=False)
        self.pos_const = QConst(q=q, replicated=True)
        self.pos_add = QAdd(q=q)
        self.layers = []
        for i in range(num_layers):
            layer = TransformerLayer(n_filters, n_ffn, n_heads, q=q, generator=generator)
            self.add_module(f"layer_{i}", layer)
            self.layers.append(layer)
        self.norm = QLayerNorm(n_filters, EPS_T, q=q)

    def forward(self, x: Tensor) -> Tensor:
        x = self.pos_add(x, self.pos_const(self.pe[None, : x.shape[1]]))
        for layer in self.layers:
            x = layer(x)
        return self.norm(x)


class DualPathBlock(nn.Module):
    """Intra/inter chunked transformers with norms and residuals (sepformerq.py:126-175). ``[B, K, S, F]``."""

    def __init__(self, n_filters: int, n_heads: int, n_ffn: int, num_layers: int = 8, q: QuantSpec = FLOAT,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.intra_transformer_block = TransformerBlock(n_filters, n_heads, n_ffn, num_layers, q=q, generator=g)
        self.intra_norm = QGroupNorm(1, n_filters, EPS, q=q, channels_last=True)
        self.intra_add = QAdd(q=q)
        self.inter_transformer_block = TransformerBlock(n_filters, n_heads, n_ffn, num_layers, q=q, generator=g)
        self.inter_norm = QGroupNorm(1, n_filters, EPS, q=q, channels_last=True)
        self.inter_add = QAdd(q=q)

    def forward(self, x: Tensor) -> Tensor:
        b, k, s, f = x.shape
        # intra: over K, batched on the chunks (a copy: the strided view would reach the quantizers)
        intra = self.intra_transformer_block(x.transpose(1, 2).reshape(b * s, k, f).contiguous())
        intra = self.intra_norm(intra.reshape(b, s, k, f).transpose(1, 2))
        intra = self.intra_add(intra, x)
        # inter: over S, batched on the position in the chunk
        inter = self.inter_transformer_block(intra.reshape(b * k, s, f)).reshape(b, k, s, f)
        return self.inter_add(self.inter_norm(inter), intra)


class MaskGenerator(nn.Module):
    """Chunked dual-path masker (sepformerq.py:178-339). ``[B, F, M] -> [B, n_srcs, F, M]``."""

    def __init__(self, n_srcs: int, n_filters: int, n_repeats: int = 2, n_heads: int = 8, chunk_size: int = 250,
                 n_ffn: int = 1024, n_layers: int = 8, q: QuantSpec = FLOAT,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.n_srcs, self.n_filters, self.chunk_size = n_srcs, n_filters, chunk_size
        self.norm = QGroupNorm(1, n_filters, EPS, q=q)
        self.conv1d = QConv1d(n_filters, n_filters, 1, use_bias=False, q=q, generator=g)
        self.blocks = []
        for i in range(n_repeats):
            block = DualPathBlock(n_filters, n_heads, n_ffn, n_layers, q=q, generator=g)
            self.add_module(f"dp_{i}", block)
            self.blocks.append(block)
        self.prelu = QNl("prelu", q=q)
        # the reference's 1x1 Conv2d over channels-last segments: a dense layer
        self.conv2d = QDense(n_filters, n_srcs * n_filters, q=q, generator=g)
        self.net_out = QConv1d(n_filters, n_filters, 1, nl="tanh", q=q, generator=g)
        self.net_gate = QConv1d(n_filters, n_filters, 1, nl="sigmoid", q=q, generator=g)
        self.mul = QMul(q=q)
        self.end_conv = QConv1d(n_filters, n_filters, 1, use_bias=False, nl="relu", q=q, generator=g)

    def forward(self, x: Tensor) -> Tensor:
        b, f, spk = x.shape[0], self.n_filters, self.n_srcs
        xc = self.conv1d(self.norm(x))  # [B, F, M]
        segs, gap = split_segments(xc.transpose(1, 2), self.chunk_size)  # [B, K, S, F]
        segs = segs.contiguous()
        for block in self.blocks:
            segs = block(segs)
        y = self.conv2d(self.prelu(segs))  # [B, K, S, spk * F]
        k, s = y.shape[1], y.shape[2]
        y = y.reshape(b, k, s, spk, f).permute(0, 3, 1, 2, 4).reshape(b * spk, k, s, f)
        y = merge_segments(y, gap, torch.add).transpose(1, 2)  # [B * spk, F, M]; the sum is not a quant point
        y = self.end_conv(self.mul(self.net_out(y), self.net_gate(y)))
        return y.reshape(b, spk, f, -1)


class Sepformer(nn.Module):
    """Sepformer QAT model (sepformerq.py:342-439). ``[B, T]`` -> ``[B, S, T]``.

    With ``q.qat`` and ``n_combiner >= 2`` the combiner trains its residual
    decoder: ``train_res_dec`` is forced on, as JAX's ``__post_init__`` does
    (sepformerq.py:501). ``generator`` seeds the weight init.
    """

    def __init__(self, n_srcs: int = 1, kernel_size: int = 16, stride: int = 8, n_filters: int = 256,
                 n_repeats: int = 2, n_heads: int = 8, chunk_size: int = 250, n_ffn: int = 1024, n_layers: int = 8,
                 q: QuantSpec = FLOAT, generator: torch.Generator | None = None):
        super().__init__()
        if q.qat and q.n_combiner >= 2 and not q.train_res_dec:
            q = dataclasses.replace(q, train_res_dec=True)
        g = generator
        self.n_srcs, self.n_filters, self.n_heads, self.q = n_srcs, n_filters, n_heads, q
        self.n_repeats, self.n_layers = n_repeats, n_layers
        self.encoder = QConv1dEncoder(q.n_splitter, n_filters, kernel_size, stride=stride, nl="relu", q=q,
                                      generator=g)
        self.masker = MaskGenerator(n_srcs, n_filters, n_repeats, n_heads, chunk_size, n_ffn, n_layers, q=q,
                                    generator=g)
        self.mul = QMul(q=q)
        self.decoder = QConvTr1dDecoder(n_filters, 1, kernel_size, stride=stride, q=q, generator=g)

    def forward(self, x: Tensor) -> Tensor:
        with weight_pass(self):  # every weight quantizer in one grouped call, forward and backward
            x = preprocess(x, n_splitter=self.q.n_splitter)  # [B, C', T]
            b = x.shape[0]
            feats = self.encoder(x)  # [B, F, M]
            masked = self.mul(self.masker(feats), feats[:, None])  # [B, S, F, M]
            out = self.decoder(masked.reshape(b * self.n_srcs, self.n_filters, -1))  # [(n_comb,) B * S, 1, L]
            return postprocess(out.reshape(self.q.n_combiner, b, self.n_srcs, 1, -1), n_combiner=self.q.n_combiner)
