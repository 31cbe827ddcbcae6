"""Demucs-family building blocks with declarative fake-quantization (``fqss_tpu/models/demucs_blocks.py``).

LayerScale, the DConv dilated residual branch, ScaledEmbedding, the reflect
pad with demucs's short-input branch, and the hybrid HEncLayer/HDecLayer of
HTDemucs's time (1-D) and frequency (2-D) branches. The legacy HDemucs
inserts of the JAX module (``BLSTM``, ``LocalState``) are not ported: they
are off in HTDemucs.

Layouts: time tensors are ``[B, C, T]``; frequency tensors ``[B, C, Fr, T]``
(NCHW, the frequency axis is the conv height), where JAX's are ``[B, T, C]``
and ``[B, Fr, T, C]``. Quantization sites, names and order are the JAX
modules' (htdemucsq.py:1157-1242): conv+GELU fused, rewrite+GLU fused, in
DConv conv+GroupNorm+GELU, conv+GroupNorm+GLU, the LayerScale mul and the
add; the decoders' skip adds. Every convolution is a quantized layer of
:mod:`fqss_tpu_torch.nn.layers` (``F.conv1d``/``conv2d`` and their
transposes, as JAX computes them with ``lax.conv`` outside Pallas), with the
act grids on K1 and the weight grids in the model's grouped K2 call.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from fqss_tpu_torch.nn.io_layers import QConvTr1dDecoder, QConvTr2dDecoder
from fqss_tpu_torch.nn.layers import (
    QAdd,
    QConv1d,
    QConv2d,
    QConvTranspose1d,
    QConvTranspose2d,
    QMul,
    make_act_quantizer,
    make_weight_quantizer,
    mark_replicated,
)
from fqss_tpu_torch.ops.stft import reflect_pad
from fqss_tpu_torch.quant.spec import FLOAT, QuantSpec

Tensor = torch.Tensor


def pad1d_reflect(x: Tensor, padding_left: int, padding_right: int) -> Tensor:
    """Reflect pad of the last axis, zero-extended first where the input is too short to reflect (hdemucsq.py:25-42,
    ``pad1d``)."""
    length = x.shape[-1]
    max_pad = max(padding_left, padding_right)
    if length <= max_pad:
        extra = max_pad - length + 1
        extra_right = min(padding_right, extra)
        extra_left = extra - extra_right
        x = F.pad(x, (extra_left, extra_right))
        padding_left -= extra_left
        padding_right -= extra_right
    return reflect_pad(x, padding_left, padding_right)


class QLayerScale(nn.Module):
    """LayerScale [Touvron 2021] with a quantized mul (demucsq.py:19-39): ``x * scale`` with ``scale [C]`` on axis
    ``dim`` (1 for NCT, -1 for the transformer's ``[B, L, C]``, JAX's ``_QLayerScaleLast``)."""

    def __init__(self, channels: int, init: float = 0.0, q: QuantSpec = FLOAT, dim: int = 1):
        super().__init__()
        self.dim = dim
        self.scale = nn.Parameter(torch.full((channels,), float(init)))
        self.mul = QMul(q=q)

    def forward(self, x: Tensor) -> Tensor:
        scale = self.scale
        if self.dim % x.ndim != x.ndim - 1:
            scale = scale.view([-1 if i == self.dim % x.ndim else 1 for i in range(x.ndim)])
        return self.mul(x, scale)


class DConv(nn.Module):
    """Dilated residual branch (demucsq.py:110-182), ``[N, C, T]``: per depth layer, conv (k 3, dilation 2^d) +
    GroupNorm(1) + GELU, 1x1 conv + GroupNorm(1) + GLU, LayerScale, added residually."""

    def __init__(self, channels: int, compress: float = 8, depth: int = 2, init: float = 1e-3, q: QuantSpec = FLOAT,
                 generator: torch.Generator | None = None):
        super().__init__()
        hidden = int(channels / compress)
        self.depth = depth
        for d in range(depth):
            dilation = 2**d
            self.add_module(f"layer_{d}_conv", QConv1d(channels, hidden, 3, dilation=dilation, padding=dilation,
                                                       norm_groups=1, nl="gelu", q=q, generator=generator))
            self.add_module(f"layer_{d}_mix", QConv1d(hidden, 2 * channels, 1, norm_groups=1, nl="glu", q=q,
                                                      generator=generator))
            self.add_module(f"layer_{d}_scale", QLayerScale(channels, init, q=q))
            self.add_module(f"add_{d}", QAdd(q=q))

    def forward(self, x: Tensor) -> Tensor:
        for d in range(self.depth):
            m = self._modules
            y = m[f"layer_{d}_scale"](m[f"layer_{d}_mix"](m[f"layer_{d}_conv"](x)))
            x = m[f"add_{d}"](x, y)
        return x


class ScaledEmbedding(nn.Module):
    """Embedding with its learning rate boosted by ``scale``, optionally smoothed (hdemucsq.py:45-69): the table
    ``embedding [num, features]`` on its weight grid (per row, axis 0), the lookup on an act grid, then the quantized
    mul by ``scale`` (htdemucsq.py:1204-1205)."""

    WEIGHT_QUANTIZERS = {"weight_fake_quantize": "embedding"}

    def __init__(self, num_embeddings: int, features: int, scale: float = 10.0, smooth: bool = True,
                 q: QuantSpec = FLOAT, generator: torch.Generator | None = None):
        super().__init__()
        self.scale = float(scale)
        w = torch.randn(num_embeddings, features, generator=generator)
        if smooth:
            w = torch.cumsum(w, dim=0) / torch.sqrt(torch.arange(1, num_embeddings + 1, dtype=torch.float32))[:, None]
        self.embedding = nn.Parameter(w / self.scale)
        self.weight_fake_quantize = make_weight_quantizer(q, (num_embeddings, features), ch_axis=0)
        self.activation_fake_quantize = make_act_quantizer(q)
        self.mul = QMul(q=q)
        mark_replicated(self)  # the table's rows, the same on every data-parallel rank

    def forward(self, idx: Tensor) -> Tensor:
        table = self.embedding
        if self.weight_fake_quantize is not None:
            table = self.weight_fake_quantize(table)
        out = table[idx]
        if self.activation_fake_quantize is not None:
            out = self.activation_fake_quantize(out)
        return self.mul(out, self.scale)


def _to_rows(y: Tensor) -> Tensor:
    """``[B, C, Fr, T]`` -> ``[B Fr, C, T]``: each frequency row a sequence, as JAX's ``[B Fr, T, C]``."""
    b, c, fr, t = y.shape
    return y.transpose(1, 2).reshape(b * fr, c, t).contiguous()  # at batch 1 the reshape is a strided view


def _from_rows(y: Tensor, b: int) -> Tensor:
    n, c, t = y.shape
    return y.reshape(b, n // b, c, t).transpose(1, 2).contiguous()


class HEncLayer(nn.Module):
    """Hybrid encoder layer of the time (``freq=False``, ``[B, C, T]``) or frequency (``[B, C, Fr, T]``) branch
    (hdemucsq.py:72-162): [in-quant,] stride-padded (time), strided conv + GELU, [GroupNorm,] DConv (per frequency
    row), 1 + 2 context conv + GLU."""

    def __init__(self, chin: int, chout: int, kernel_size: int = 8, stride: int = 4, freq: bool = True,
                 norm: bool = False, norm_groups: int = 4, context: int = 0, dconv_depth: int = 2,
                 dconv_comp: float = 8, dconv_init: float = 1e-3, q: QuantSpec = FLOAT, is_input_layer: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.freq, self.stride = freq, stride
        pad = kernel_size // 4
        ng = norm_groups if norm else None
        self.in_quantizer = (make_act_quantizer(q, enabled=q.in_quant, n_bits=q.in_act_n_bits,
                                                nl_quant=q.inout_nl_quant) if is_input_layer else None)
        if freq:
            self.conv = QConv2d(chin, chout, (kernel_size, 1), stride=(stride, 1), padding=(pad, 0), nl="gelu", q=q,
                                generator=g)
        else:
            self.conv = QConv1d(chin, chout, kernel_size, stride=stride, padding=pad, nl="gelu", q=q, generator=g)
        # flax's GroupNorm epsilon (1e-6); off with the default norm_starts
        self.norm1 = nn.GroupNorm(norm_groups, chout, eps=1e-6) if norm else None
        self.dconv = DConv(chout, dconv_comp, dconv_depth, dconv_init, q=q, generator=g)
        k = 1 + 2 * context
        layer = QConv2d if freq else QConv1d
        self.rewrite = layer(chout, 2 * chout, k, padding=context, nl="glu", norm_groups=ng, q=q, generator=g)

    def forward(self, x: Tensor) -> Tensor:
        if self.in_quantizer is not None:
            x = self.in_quantizer(x)
        if not self.freq and x.shape[-1] % self.stride:  # the time length to a multiple of the stride
            x = F.pad(x, (0, self.stride - x.shape[-1] % self.stride))
        y = self.conv(x)
        if self.norm1 is not None:
            y = self.norm1(y)
        y = _from_rows(self.dconv(_to_rows(y)), y.shape[0]) if self.freq else self.dconv(y)
        return self.rewrite(y)


class HDecLayer(nn.Module):
    """Hybrid decoder layer (hdemucsq.py:259-347): skip add, 3 x 3 (or 3) conv + GLU, transposed conv + GELU, the
    stride padding trimmed. ``last``: the combiner decoder in the transposed conv's place (replace_decoderq,
    htdemucsq.py:1184-1194), whose residual decoder trains where ``train_res_dec`` (the last frequency decoder)."""

    def __init__(self, chin: int, chout: int, last: bool = False, kernel_size: int = 8, stride: int = 4,
                 freq: bool = True, norm: bool = False, norm_groups: int = 4, context: int = 1,
                 train_res_dec: bool = False, q: QuantSpec = FLOAT, generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.freq, self.pad = freq, kernel_size // 4
        ng = norm_groups if norm else None
        self.add = QAdd(q=q)
        k = 1 + 2 * context
        layer = QConv2d if freq else QConv1d
        self.rewrite = layer(chin, 2 * chin, k, padding=context, nl="glu", norm_groups=ng, q=q, generator=g)
        if last:
            dec_q = dataclasses.replace(q, train_res_dec=train_res_dec and q.qat)
            if freq:
                self.conv_tr = QConvTr2dDecoder(chin, chout, (kernel_size, 1), (stride, 1), use_bias=True, q=dec_q,
                                                generator=g)
            else:
                self.conv_tr = QConvTr1dDecoder(chin, chout, kernel_size, stride, q=dec_q, generator=g,
                                                use_bias=True)
        elif freq:
            self.conv_tr = QConvTranspose2d(chin, chout, (kernel_size, 1), (stride, 1), nl="gelu", q=q, generator=g)
        else:
            self.conv_tr = QConvTranspose1d(chin, chout, kernel_size, stride, nl="gelu", q=q, generator=g)

    def forward(self, x: Tensor, skip: Tensor, length: int) -> Tensor:
        z = self.conv_tr(self.rewrite(self.add(x, skip)))
        p = self.pad
        if self.freq:
            return z[..., p:-p, :] if p else z  # the frequency axis, of 4-D and stacked 5-D outputs alike
        return z[..., p : p + length]

