"""Demucs-family building blocks with declarative fake-quantization (``fqss_tpu/models/demucs_blocks.py``).

LayerScale, the DConv dilated residual branch with the legacy HDemucs
inserts (``BLSTM``, ``LocalState``), ScaledEmbedding, the reflect pad with
demucs's short-input branch, :func:`rescale_params`, and the hybrid
HEncLayer/HDecLayer of the time (1-D) and frequency (2-D) branches, with the
options HTDemucs leaves at their defaults and the legacy HDemucs sets
(``empty``, ``inject``, ``pad``, ``gelu``, ``tr_bias``, ``context_freq``).

Layouts: time tensors are ``[B, C, T]``; frequency tensors ``[B, C, Fr, T]``
(NCHW, the frequency axis is the conv height), where JAX's are ``[B, T, C]``
and ``[B, Fr, T, C]``. Quantization sites, names and order are the JAX
modules' (htdemucsq.py:1157-1242): conv+GELU fused, rewrite+GLU fused, in
DConv conv+GroupNorm+GELU, conv+GroupNorm+GLU, the LayerScale mul and the
add; the decoders' skip adds. Every convolution is a quantized layer of
:mod:`fqss_tpu_torch.nn.layers` (``F.conv1d``/``conv2d`` and their
transposes, as JAX computes them with ``lax.conv`` outside Pallas), with the
act grids on K1 and the weight grids in the model's grouped K2 call. The
BLSTM's recurrences are K7 and its dense layers K5; LocalState's attention
is ``torch.matmul`` and a softmax, as JAX computes it outside any Pallas
kernel (its additive decay and its -100 diagonal are not K8's function).
"""

from __future__ import annotations

import dataclasses
import math

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
    QDense,
    QMul,
    make_act_quantizer,
    make_weight_quantizer,
    mark_replicated,
)
from fqss_tpu_torch.nn.lstm import QLSTM
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


class BLSTM(nn.Module):
    """Chunked BiLSTM with overlap framing (demucsq.py:42-91; ``fqss_tpu/models/demucs_blocks.py:BLSTM``), ``[N, C,
    T]`` -> ``[N, C, T]`` (``dim`` channels). The sequence goes to the LSTMs as a contiguous ``[N, T, C]``; where T >
    ``max_steps`` it is cut into 50%-overlapping frames of ``max_steps`` (zero-padded at the end), each frame a row
    of the LSTMs. ``layers`` bidirectional ``QLSTM``s (mode ``q.lstm_mode``; K7 on the card) with a ``QDense``
    ``proj_k`` (K5) between them, then the ``QDense`` ``linear``; the frames are stitched back by their centres (frame
    0 keeps ``[:-limit]``, the middle ones ``[limit:-limit]``, the last ``[limit:]``, ``limit = stride // 2``), cut
    to T, and with ``skip`` the input added (``add``)."""

    def __init__(self, dim: int, layers: int = 1, max_steps: int | None = None, skip: bool = False,
                 q: QuantSpec = FLOAT, generator: torch.Generator | None = None):
        super().__init__()
        self.layers, self.max_steps, self.dim = layers, max_steps, dim
        for layer in range(layers):
            self.add_module(f"lstm_{layer}", QLSTM(dim, dim, bidirectional=True, mode=q.lstm_mode, q=q,
                                                   generator=generator))
            if layer < layers - 1:
                self.add_module(f"proj_{layer}", QDense(2 * dim, dim, q=q, generator=generator))
        self.linear = QDense(2 * dim, dim, q=q, generator=generator)
        self.add = QAdd(q=q) if skip else None

    def forward(self, x: Tensor) -> Tensor:
        n, c, t = x.shape
        h = x.transpose(1, 2).contiguous()  # [N, T, C]
        framed = self.max_steps is not None and t > self.max_steps
        if framed:
            width = self.max_steps
            stride = width // 2
            nframes = max(0, (t - width + stride - 1) // stride) + 1
            h = F.pad(h, (0, 0, 0, (nframes - 1) * stride + width - t))
            h = h.unfold(1, width, stride).transpose(2, 3).reshape(n * nframes, width, c).contiguous()
        m = self._modules
        for layer in range(self.layers):
            h = m[f"lstm_{layer}"](h)
            if layer < self.layers - 1:
                h = m[f"proj_{layer}"](h)
        h = self.linear(h)
        if framed:
            frames = h.reshape(n, nframes, width, self.dim)
            limit = stride // 2
            out = [frames[:, 0, :-limit], *(frames[:, k, limit:-limit] for k in range(1, nframes - 1)),
                   frames[:, nframes - 1, limit:]]
            h = torch.cat(out, dim=1)[:, :t]
        h = h.transpose(1, 2).contiguous()
        return self.add(h, x) if self.add is not None else h


class LocalState(nn.Module):
    """Decaying local attention (demucsq.py:185-244; ``fqss_tpu/models/demucs_blocks.py:LocalState``), ``[N, C, T]``:
    1x1 ``query``/``key``/``content`` convs (and ``query_decay``, ``heads x ndecay`` channels), each with its weight
    grid and no act grid; the logits ``key_t . query_s / sqrt(d)`` of each head, plus the decay ``-k |t - s| /
    sqrt(ndecay)`` weighted by ``sigmoid(query_decay) / 2`` over k = 1..ndecay, the diagonal set to -100, the softmax
    over t (the key index), then ``x + proj(result)``. Channel ``h d + i`` is head h's feature i, as JAX's
    ``reshape(b, t, h, d)``."""

    def __init__(self, channels: int, heads: int = 4, ndecay: int = 4, q: QuantSpec = FLOAT,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.heads, self.ndecay = heads, ndecay

        def conv(cout: int) -> QConv1d:
            return QConv1d(channels, cout, 1, q=q, act_quant=False, generator=generator)

        self.query, self.key = conv(channels), conv(channels)
        self.query_decay = conv(heads * ndecay) if ndecay else None
        self.content, self.proj = conv(channels), conv(channels)

    def forward(self, x: Tensor) -> Tensor:
        n, c, t = x.shape
        h = self.heads
        d = c // h
        queries = self.query(x).view(n, h, d, t)
        keys = self.key(x).view(n, h, d, t)
        dots = torch.matmul(keys.transpose(2, 3), queries) / math.sqrt(d)  # [N, h, t, s]
        if self.ndecay:
            decay_q = torch.sigmoid(self.query_decay(x).view(n, h, self.ndecay, t)) / 2.0
            pos = torch.arange(t, device=x.device)
            delta = (pos[:, None] - pos[None, :]).abs().to(x.dtype)
            decays = torch.arange(1, self.ndecay + 1, device=x.device, dtype=x.dtype)
            decay_kernel = -decays[:, None, None] * delta[None] / math.sqrt(self.ndecay)  # [ndecay, t, s]
            dots = dots + torch.einsum("fts,nhfs->nhts", decay_kernel, decay_q)
        dots = dots.masked_fill(torch.eye(t, dtype=torch.bool, device=x.device), -100.0)
        weights = torch.softmax(dots, dim=2)
        result = torch.matmul(self.content(x).view(n, h, d, t), weights).reshape(n, c, t)
        return x + self.proj(result)


def rescale_params(state: dict[str, Tensor], reference: float = 0.1) -> dict[str, Tensor]:
    """Demucs's rescaling init (demucsq.py:94-107 rescale_module; ``fqss_tpu/models/demucs_blocks.py:
    rescale_params``) on a port state dict: every conv and dense kernel (a ``weight`` of two axes or more: a norm's
    and an embedding's are not kernels in JAX's tree, which names them ``scale`` and ``embedding``), and its scope's
    ``bias``, divided by ``sqrt(std(kernel) / reference)`` (the population std; 1 where it is 0). Returns a new
    dict; apply once after init, before training."""
    out = dict(state)
    for key, w in state.items():
        scope, _, name = key.rpartition(".")
        if name != "weight" or w.ndim < 2:
            continue
        std = w.std(correction=0)
        scale = torch.where(std > 0, torch.sqrt(std / reference), torch.ones_like(std))
        out[key] = w / scale
        bias = f"{scope}.bias" if scope else "bias"
        if bias in state:
            out[bias] = state[bias] / scale
    return out


class DConv(nn.Module):
    """Dilated residual branch (demucsq.py:110-182), ``[N, C, T]``: per depth layer, conv (k 3, dilation 2^d) +
    GroupNorm(1) + GELU, [``BLSTM`` (2 layers, frames of 200 steps, skip) ->] [``LocalState`` ->] 1x1 conv +
    GroupNorm(1) + GLU, LayerScale, added residually. The two inserts are the legacy HDemucs's deep layers
    (``lstm``/``attn``; demucsq.py:160-176, quant plan hdemucsq.py:889-903)."""

    def __init__(self, channels: int, compress: float = 8, depth: int = 2, init: float = 1e-3, q: QuantSpec = FLOAT,
                 generator: torch.Generator | None = None, lstm: bool = False, attn: bool = False):
        super().__init__()
        hidden = int(channels / compress)
        self.depth = depth
        for d in range(depth):
            dilation = 2**d
            self.add_module(f"layer_{d}_conv", QConv1d(channels, hidden, 3, dilation=dilation, padding=dilation,
                                                       norm_groups=1, nl="gelu", q=q, generator=generator))
            if lstm:
                self.add_module(f"layer_{d}_lstm", BLSTM(hidden, layers=2, max_steps=200, skip=True, q=q,
                                                         generator=generator))
            if attn:
                self.add_module(f"layer_{d}_attn", LocalState(hidden, q=q, generator=generator))
            self.add_module(f"layer_{d}_mix", QConv1d(hidden, 2 * channels, 1, norm_groups=1, nl="glu", q=q,
                                                      generator=generator))
            self.add_module(f"layer_{d}_scale", QLayerScale(channels, init, q=q))
            self.add_module(f"add_{d}", QAdd(q=q))

    def forward(self, x: Tensor) -> Tensor:
        m = self._modules
        for d in range(self.depth):
            y = m[f"layer_{d}_conv"](x)
            for insert in (f"layer_{d}_lstm", f"layer_{d}_attn"):
                if insert in m:
                    y = m[insert](y)
            y = m[f"layer_{d}_scale"](m[f"layer_{d}_mix"](y))
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
    (hdemucsq.py:72-162): [in-quant,] stride-padded (time), strided conv + GELU, [+ ``inject``,] [GroupNorm,] DConv
    (per frequency row), 1 + 2 context conv + GLU.

    The legacy HDemucs's options (``fqss_tpu/models/demucs_blocks.py:HEncLayer``): ``empty``, the bare conv with its
    act grid and no GELU, and nothing after it; ``pad=False``, no padding of the conv; ``dconv_lstm``/``dconv_attn``,
    DConv's inserts. ``forward(x, inject)``: the time branch ``[B, C, T]`` added after the
    conv (a plain add), broadcast over the unit frequency axis (dim 2) of a frequency layer's output."""

    def __init__(self, chin: int, chout: int, kernel_size: int = 8, stride: int = 4, freq: bool = True,
                 norm: bool = False, norm_groups: int = 4, context: int = 0, dconv_depth: int = 2,
                 dconv_comp: float = 8, dconv_init: float = 1e-3, q: QuantSpec = FLOAT, is_input_layer: bool = False,
                 generator: torch.Generator | None = None, empty: bool = False, pad: bool = True,
                 dconv_lstm: bool = False, dconv_attn: bool = False):
        super().__init__()
        g = generator
        self.freq, self.stride, self.empty = freq, stride, empty
        pad = kernel_size // 4 if pad else 0
        ng = norm_groups if norm else None
        self.in_quantizer = (make_act_quantizer(q, enabled=q.in_quant, n_bits=q.in_act_n_bits,
                                                nl_quant=q.inout_nl_quant) if is_input_layer else None)
        nl = None if empty else "gelu"
        if freq:
            self.conv = QConv2d(chin, chout, (kernel_size, 1), stride=(stride, 1), padding=(pad, 0), nl=nl, q=q,
                                generator=g)
        else:
            self.conv = QConv1d(chin, chout, kernel_size, stride=stride, padding=pad, nl=nl, q=q, generator=g)
        if empty:
            return
        # flax's GroupNorm epsilon (1e-6); off with HTDemucs's default norm_starts
        self.norm1 = nn.GroupNorm(norm_groups, chout, eps=1e-6) if norm else None
        self.dconv = DConv(chout, dconv_comp, dconv_depth, dconv_init, q=q, generator=g, lstm=dconv_lstm,
                           attn=dconv_attn)
        k = 1 + 2 * context
        layer = QConv2d if freq else QConv1d
        self.rewrite = layer(chout, 2 * chout, k, padding=context, nl="glu", norm_groups=ng, q=q, generator=g)

    def forward(self, x: Tensor, inject: Tensor | None = None) -> Tensor:
        if self.in_quantizer is not None:
            x = self.in_quantizer(x)
        if not self.freq and x.shape[-1] % self.stride:  # the time length to a multiple of the stride
            x = F.pad(x, (0, self.stride - x.shape[-1] % self.stride))
        y = self.conv(x)
        if self.empty:
            return y
        if inject is not None:
            y = y + (inject[:, :, None] if inject.ndim == 3 and y.ndim == 4 else inject)
        if self.norm1 is not None:
            y = self.norm1(y)
        y = _from_rows(self.dconv(_to_rows(y)), y.shape[0]) if self.freq else self.dconv(y)
        return self.rewrite(y)


class HDecLayer(nn.Module):
    """Hybrid decoder layer (hdemucsq.py:259-347): skip add, 3 x 3 (or 3) conv + GLU, transposed conv + GELU, the
    stride padding trimmed. ``last``: the combiner decoder in the transposed conv's place (replace_decoderq,
    htdemucsq.py:1184-1194), whose residual decoder trains where ``train_res_dec`` (the last frequency decoder).

    The legacy HDemucs's options (``fqss_tpu/models/demucs_blocks.py:HDecLayer``): ``empty``, no skip add and no
    rewrite; ``pad=False``, nothing trimmed; ``gelu=False`` and ``tr_bias=False``, a MultiWrap band's transposed conv
    (the band merge adds the bias and the GELU); ``context_freq=False``, a rewrite kernel of ``(1, 1 + 2 context)``,
    over time only. :meth:`pair` returns the output and the transposed conv's input (JAX's ``(z, pre)``)."""

    def __init__(self, chin: int, chout: int, last: bool = False, kernel_size: int = 8, stride: int = 4,
                 freq: bool = True, norm: bool = False, norm_groups: int = 4, context: int = 1,
                 train_res_dec: bool = False, q: QuantSpec = FLOAT, generator: torch.Generator | None = None,
                 empty: bool = False, pad: bool = True, gelu: bool = True,
                 tr_bias: bool = True, context_freq: bool = True):
        super().__init__()
        g = generator
        self.freq, self.pad = freq, kernel_size // 4 if pad else 0
        ng = norm_groups if norm else None
        self.add = None if empty else QAdd(q=q)
        self.rewrite = None
        if not empty:
            k = 1 + 2 * context
            if not freq:
                self.rewrite = QConv1d(chin, 2 * chin, k, padding=context, nl="glu", norm_groups=ng, q=q, generator=g)
            else:
                ksz, pd = (k, context) if context_freq else ((1, k), (0, context))
                self.rewrite = QConv2d(chin, 2 * chin, ksz, padding=pd, nl="glu", norm_groups=ng, q=q, generator=g)
        if last:
            dec_q = dataclasses.replace(q, train_res_dec=train_res_dec and q.qat)
            if freq:
                self.conv_tr = QConvTr2dDecoder(chin, chout, (kernel_size, 1), (stride, 1), use_bias=True, q=dec_q,
                                                generator=g)
            else:
                self.conv_tr = QConvTr1dDecoder(chin, chout, kernel_size, stride, q=dec_q, generator=g,
                                                use_bias=True)
        else:
            nl = "gelu" if gelu else None
            if freq:
                self.conv_tr = QConvTranspose2d(chin, chout, (kernel_size, 1), (stride, 1), nl=nl, use_bias=tr_bias,
                                                q=q, generator=g)
            else:
                self.conv_tr = QConvTranspose1d(chin, chout, kernel_size, stride, nl=nl, use_bias=tr_bias, q=q,
                                                generator=g)

    def forward(self, x: Tensor, skip: Tensor | None, length: int | None) -> Tensor:
        return self.pair(x, skip, length)[0]

    def pair(self, x: Tensor, skip: Tensor | None, length: int | None) -> tuple[Tensor, Tensor]:
        """(the output, the transposed conv's input)."""
        if self.add is not None:
            x = self.add(x, skip)
        y = self.rewrite(x) if self.rewrite is not None else x
        z = self.conv_tr(y)
        p = self.pad
        if self.freq:
            return (z[..., p:-p, :] if p else z), y  # the frequency axis, of 4-D and stacked 5-D outputs alike
        return z[..., p : p + length], y
