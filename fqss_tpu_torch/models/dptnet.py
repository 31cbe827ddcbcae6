"""DPTNet (dual-path transformer) with declarative fake-quantization (``fqss_tpu/models/dptnet.py``).

A conv encoder (kernel W, 50% overlap, ReLU), a dual-path transformer
separator (``layer`` x row/col transformer blocks whose feed-forward is a
BiLSTM: the DPTNet "improved transformer"), a gated tanh x sigmoid output, a
1x1 mask conv, and a Linear decoder followed by overlap-and-add, wrapped by
the FQSS input splitter and output combiner (reference:
quantization/qat/models/dptnetq.py:60-478). The quant points are those of
the JAX model; the ReLU between the LSTM and the linear layer is not one
(dptnetq.py:94).

Waveforms enter and leave as [B, T] / [B, S, T]. The convolutions run NCT
([B, C, L]); the separator's segments are channels-last ``[B, K, S, N]``
(K = segment length, S = number of 50%-overlap chunks), and its
transformer layers batch-first ``[B', L, N]``, as in JAX. Submodule names
equal the JAX scopes (``separator.DPT.row_0.lstm.fw.w_ih`` ...).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from fqss_tpu_torch.nn.attention import QMultiheadAttention
from fqss_tpu_torch.nn.io_layers import QConv1dEncoder, QLinearDecoder
from fqss_tpu_torch.nn.layers import QAdd, QConv1d, QDense, QGroupNorm, QLayerNorm, QMul, QNl
from fqss_tpu_torch.nn.lstm import QLSTM
from fqss_tpu_torch.quant.quantizers import weight_pass
from fqss_tpu_torch.quant.spec import FLOAT, QuantSpec
from fqss_tpu_torch.separation.splitter import postprocess, preprocess

Tensor = torch.Tensor

EPS = 1e-8


def overlap_and_add(signal: Tensor, step: int) -> Tensor:
    """OLA of framed signal ``[..., F, W] -> [..., (F-1)*step + W]`` (dptnetq.py:17-58).

    Each of the ``W / gcd(W, step)`` sub-frame positions is one strided add of
    all frames: no scatter and no atomics, so every run gives the same bits."""
    *outer, frames, frame_len = signal.shape
    sub = math.gcd(frame_len, step)
    subframes, substep = frame_len // sub, step // sub
    out_len = step * (frames - 1) + frame_len
    sig = signal.reshape(*outer, frames, subframes, sub)
    out = signal.new_zeros(*outer, out_len // sub, sub)
    for j in range(subframes):
        out[..., j : j + (frames - 1) * substep + 1 : substep, :] += sig[..., j, :]
    return out.reshape(*outer, out_len)


def split_segments(x: Tensor, segment_size: int) -> tuple[Tensor, int]:
    """``[B, T, N] -> ([B, K, S, N], rest)`` with 50% overlap (dptnetq.py:232-259)."""
    b, t, n = x.shape
    stride = segment_size // 2
    rest = segment_size - (stride + t % segment_size) % segment_size
    x = F.pad(x, (0, 0, stride, stride + rest))
    seg1 = x[:, :-stride].reshape(b, -1, segment_size, n)
    seg2 = x[:, stride:].reshape(b, -1, segment_size, n)
    segs = torch.stack([seg1, seg2], dim=2).reshape(b, -1, segment_size, n)  # [B, S, K, N]
    return segs.transpose(1, 2), rest  # [B, K, S, N]


def merge_segments(x: Tensor, rest: int, add_fn) -> Tensor:
    """``[B, K, S, N] -> [B, T, N]``, the inverse OLA (dptnetq.py:261-276)."""
    b, k, s, n = x.shape
    stride = k // 2
    xt = x.transpose(1, 2).reshape(b, -1, 2 * k, n)  # [B, S/2, 2K, N]
    x1 = xt[:, :, :k].reshape(b, -1, n)[:, stride:]
    x2 = xt[:, :, k:].reshape(b, -1, n)[:, :-stride]
    out = add_fn(x1, x2)
    return out[:, :-rest] if rest > 0 else out


class ImprovedTransformerLayer(nn.Module):
    """DPTNet transformer block: MHA + LSTM feed-forward (dptnetq.py:60-97). [B', L, E] -> [B', L, E]."""

    def __init__(self, d_model: int, nhead: int, hidden_size: int, q: QuantSpec = FLOAT,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.self_attn = QMultiheadAttention(d_model, nhead, q=q, generator=g)
        self.add_norm1 = QAdd(q=q)
        self.norm1 = QLayerNorm(d_model, q=q)
        self.lstm = QLSTM(d_model, hidden_size, bidirectional=True, mode=q.lstm_mode, q=q, generator=g)
        self.linear = QDense(2 * hidden_size, d_model, q=q, generator=g)
        self.add_norm2 = QAdd(q=q)
        self.norm2 = QLayerNorm(d_model, q=q)

    def forward(self, src: Tensor) -> Tensor:
        src = self.norm1(self.add_norm1(src, self.self_attn(src, src, src)))
        y = F.relu(self.lstm(src))  # not a quant point (dptnetq.py:94)
        return self.norm2(self.add_norm2(src, self.linear(y)))


class DPT(nn.Module):
    """Dual-path transformer over segments ``[B, K, S, N]`` (dptnetq.py:159-209) -> ``[B, K, S, output_size]``."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int, num_layers: int,
                 q: QuantSpec = FLOAT, generator: torch.Generator | None = None):
        super().__init__()
        self.rows, self.cols = [], []
        for i in range(num_layers):
            for side, layers in (("row", self.rows), ("col", self.cols)):
                layer = ImprovedTransformerLayer(input_size, 4, hidden_size, q=q, generator=generator)
                self.add_module(f"{side}_{i}", layer)
                layers.append(layer)
        self.out_prelu = QNl("prelu", q=q)
        # the reference's 1x1 Conv2d: a dense layer over channels-last segments
        self.out_conv = QDense(input_size, output_size, q=q, generator=generator)

    def forward(self, x: Tensor) -> Tensor:
        b, k, s, n = x.shape
        out = x
        for row, col in zip(self.rows, self.cols):
            # row: within each segment (over K), batched over the chunks. (At batch 1 the reshape is a strided
            # view; the quantizer kernels take contiguous tensors.)
            out = row(out.transpose(1, 2).reshape(b * s, k, n).contiguous()).reshape(b, s, k, n).transpose(1, 2)
            # col: across the segments (over S), batched over the positions in a segment
            out = col(out.reshape(b * k, s, n).contiguous()).reshape(b, k, s, n)
        return self.out_conv(self.out_prelu(out))


class BFModule(nn.Module):
    """Bottleneck + DPT + gated output (dptnetq.py:281-309). [B, E, L] -> [B, nspk, N, L]."""

    def __init__(self, input_dim: int, feature_dim: int, hidden_dim: int, num_spk: int, layer: int,
                 segment_size: int, q: QuantSpec = FLOAT, generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.feature_dim, self.num_spk, self.segment_size = feature_dim, num_spk, segment_size
        self.BN = QConv1d(input_dim, feature_dim, 1, use_bias=False, q=q, generator=g)
        self.DPT = DPT(feature_dim, hidden_dim, feature_dim * num_spk, layer, q=q, generator=g)
        self.add = QAdd(q=q)
        self.output = QConv1d(feature_dim, feature_dim, 1, nl="tanh", q=q, generator=g)
        self.output_gate = QConv1d(feature_dim, feature_dim, 1, nl="sigmoid", q=q, generator=g)
        self.mul = QMul(q=q)

    def forward(self, x: Tensor) -> Tensor:
        b, n, spk = x.shape[0], self.feature_dim, self.num_spk
        segs, rest = split_segments(self.BN(x).transpose(1, 2), self.segment_size)  # [B, K, S, N]
        out = self.DPT(segs)
        k, s = out.shape[1], out.shape[2]
        out = out.reshape(b, k, s, spk, n).permute(0, 3, 1, 2, 4).reshape(b * spk, k, s, n)
        merged = merge_segments(out, rest, self.add).transpose(1, 2)  # [B*nspk, N, L]
        bf = self.mul(self.output(merged), self.output_gate(merged))
        return bf.reshape(b, spk, n, -1)


class DPTNet(nn.Module):
    """DPTNet QAT model (dptnetq.py:311-409). ``[B, T]`` (or ``[B, C, T]``) -> ``[B, S, T]``.

    ``generator`` seeds the weight init; ranges start at the quantizers'
    defaults until an observer pass or a loaded state sets them.
    """

    def __init__(self, n_srcs: int = 2, kernel_size: int = 2, enc_dim: int = 256, feature_dim: int = 64,
                 hidden_dim: int = 128, layer: int = 6, segment_size: int = 250, q: QuantSpec = FLOAT,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.n_srcs, self.kernel_size, self.enc_dim, self.feature_dim = n_srcs, kernel_size, enc_dim, feature_dim
        self.hidden_dim, self.layer, self.q = hidden_dim, layer, q
        self.encoder = QConv1dEncoder(q.n_splitter, enc_dim, kernel_size, stride=kernel_size // 2, nl="relu", q=q,
                                      generator=g)
        self.enc_LN = QGroupNorm(1, enc_dim, epsilon=EPS, q=q)
        self.separator = BFModule(enc_dim, feature_dim, hidden_dim, n_srcs, layer, segment_size, q=q, generator=g)
        self.mask_conv1x1 = QConv1d(feature_dim, enc_dim, 1, use_bias=False, nl="relu", q=q, generator=g)
        self.mul = QMul(q=q)
        self.decoder = QLinearDecoder(enc_dim, kernel_size, use_bias=False, q=q, generator=g)

    def forward(self, x: Tensor) -> Tensor:
        with weight_pass(self):  # every weight quantizer in one grouped call, forward and backward
            x = preprocess(x, n_splitter=self.q.n_splitter)  # [B, C', T]
            b = x.shape[0]
            mixture_w = self.encoder(x)  # [B, E, L]
            score = self.separator(self.enc_LN(mixture_w))  # [B, nspk, N, L]
            length = score.shape[-1]
            mask = self.mask_conv1x1(score.reshape(b * self.n_srcs, self.feature_dim, length))
            source_w = self.mul(mixture_w[:, None], mask.reshape(b, self.n_srcs, self.enc_dim, length))
            est = self.decoder(source_w.transpose(-1, -2).contiguous())  # [(n_comb,) B, nspk, L, W]
            est = overlap_and_add(est.reshape(self.q.n_combiner, b, self.n_srcs, length, self.kernel_size),
                                  self.kernel_size // 2)
            return postprocess(est.reshape(self.q.n_combiner, b, self.n_srcs, 1, -1), n_combiner=self.q.n_combiner)
