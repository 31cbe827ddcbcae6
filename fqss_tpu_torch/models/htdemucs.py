"""HTDemucs (Hybrid Transformer Demucs) with declarative fake-quantization (``fqss_tpu/models/htdemucs.py``).

A spectrogram branch (HEncLayer/HDecLayer 2-D convs over frequency) beside
a waveform branch (1-D layers), coupled by a cross-domain transformer:
alternating per-branch self-attention layers and cross-attention layers
between the branches, sinusoidal 1-D/2-D embeddings, LayerScale, norm-first
with a GroupNorm ``norm_out``; complex-as-channels (CaC) masking, and an
iSTFT whose output adds to the time branch. The freq branch splits the
normalised CaC spectrogram (``normalize=True``), the time branch the
normalised waveform (``normalize=False``); the combiner's planes come from
the two last decoders, the frequency one with a trained residual decoder
(htdemucsq.py:1027-1028, 1194). Submodule names are the JAX scopes.

Layouts: the waveform ``[B, C, T]``, the frequency branch ``[B, C, Fr, T]``
(JAX: ``[B, T, C]``, ``[B, Fr, T, C]``); the transformer's tokens
``[B, L, C]`` in JAX's order, the spectrogram's ``(t fr)``: token
``t Fr + f``. On the card the attention core is K8 (d = 48 heads on its
D = 64 instantiation, cross-attention with Lq != Lk), the FFN linears K5
(``linear1`` with its GELU epilogue), every act grid K1 and every weight
grid one grouped K2 launch (the model's weight pass); the convolutions,
norms, STFT and iSTFT are PyTorch's, as JAX leaves them to XLA.

``forward(mix, train=True)``: ``[B, audio_channels, T]`` ->
``[B, n_sources, audio_channels, T]``. With ``train=False`` an input shorter
than ``segment * samplerate`` is right-padded to it and the output cut back
(use_train_segment, htdemucsq.py:997-1007), as evaluation runs it.
``transformer_override``: a callable ``(x [B, C, Fr, T1], xt [B, C, T2]) ->
(x, xt)`` in place of the channel samplers and the transformer (the int8
engine's hook).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from fqss_tpu_torch.models.demucs_blocks import HDecLayer, HEncLayer, QLayerScale, ScaledEmbedding, pad1d_reflect
from fqss_tpu_torch.nn.attention import QMultiheadAttention
from fqss_tpu_torch.nn.layers import QAdd, QConst, QConv1d, QDense, QLayerNorm, QMul
from fqss_tpu_torch.ops.stft import ispectro, spectro
from fqss_tpu_torch.quant.quantizers import weight_pass
from fqss_tpu_torch.quant.spec import FLOAT, QuantSpec
from fqss_tpu_torch.separation.splitter import postprocess, preprocess

Tensor = torch.Tensor

SOURCES = ("drums", "bass", "other", "vocals")
EPS = 1e-5  # QLayerNorm / _GroupNormT epsilon


def create_sin_embedding(length: int, dim: int, max_period: float = 10000.0) -> np.ndarray:
    """1-D sin embedding ``[length, 1, dim]`` (htdemucsq.py:27-40), the JAX package's numpy expression."""
    pos = np.arange(length, dtype=np.float32).reshape(-1, 1, 1)
    half = dim // 2
    adim = np.arange(half, dtype=np.float32).reshape(1, 1, -1)
    phase = pos / (max_period ** (adim / (half - 1)))
    return np.concatenate([np.cos(phase), np.sin(phase)], axis=-1).astype(np.float32)


def create_2d_sin_embedding(d_model: int, height: int, width: int, max_period: float = 10000.0) -> np.ndarray:
    """2-D sin embedding ``[1, d_model, H, W]`` (htdemucsq.py:43-76), the JAX package's numpy expression."""
    if d_model % 4 != 0:
        raise ValueError("2d sin embedding needs d_model % 4 == 0")
    pe = np.zeros((d_model, height, width), np.float32)
    half = d_model // 2
    div = np.exp(np.arange(0.0, half, 2, dtype=np.float32) * -(math.log(max_period) / half))
    pos_w = np.arange(width, dtype=np.float32)[:, None]
    pos_h = np.arange(height, dtype=np.float32)[:, None]
    pe[0:half:2] = np.sin(pos_w * div).T[:, None, :].repeat(height, 1)
    pe[1:half:2] = np.cos(pos_w * div).T[:, None, :].repeat(height, 1)
    pe[half::2] = np.sin(pos_h * div).T[:, :, None].repeat(width, 2)
    pe[half + 1 :: 2] = np.cos(pos_h * div).T[:, :, None].repeat(width, 2)
    return pe[None]


def tokens_2d(x: Tensor) -> Tensor:
    """``[B, C, Fr, T]`` -> the ``(t fr)`` tokens ``[B, T Fr, C]`` (htdemucs.py:184)."""
    b, c, fr, t = x.shape
    return x.permute(0, 3, 2, 1).reshape(b, t * fr, c).contiguous()  # at Fr 1 the reshape is a strided view


def untokens_2d(x: Tensor, fr: int) -> Tensor:
    """The inverse of :func:`tokens_2d`."""
    b, n, c = x.shape
    return x.reshape(b, n // fr, fr, c).permute(0, 3, 2, 1).contiguous()


class GroupNorm1(nn.Module):
    """flax's ``GroupNorm(num_groups=1)`` of ``[B, L, C]``: statistics over all but the batch axis, the variance as
    E[x²] − E[x]² (clipped at 0), the affine on the last axis."""

    def __init__(self, features: int, epsilon: float = EPS):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: Tensor) -> Tensor:
        dims = tuple(range(1, x.ndim))
        mu = x.mean(dims, keepdim=True)
        var = torch.clamp_min((x * x).mean(dims, keepdim=True) - mu * mu, 0.0)
        return (x - mu) * (torch.rsqrt(var + self.epsilon) * self.weight) + self.bias


class GroupNormT(nn.Module):
    """MyGroupNorm (htdemucsq.py:124-135): :class:`GroupNorm1` then a quantized Const site."""

    def __init__(self, features: int, q: QuantSpec = FLOAT):
        super().__init__()
        self.norm = GroupNorm1(features)
        self.const = QConst(q=q)

    def forward(self, x: Tensor) -> Tensor:
        return self.const(self.norm(x))


class _TransformerLayer(nn.Module):
    """The feed-forward half of both layer kinds: norm -> linear1 + GELU -> linear2 -> LayerScale -> add ->
    norm_out."""

    def _ffn(self, x: Tensor, norm: nn.Module) -> Tensor:
        h = self.linear2(self.linear1(norm(x)))
        x = self.add_norm2(x, self.gamma_2(h))
        return self.norm_out(x)

    def _build_ffn(self, d_model: int, dim_feedforward: int, q: QuantSpec, generator) -> None:
        self.linear1 = QDense(d_model, dim_feedforward, q=q, generator=generator, nl="gelu")
        self.linear2 = QDense(dim_feedforward, d_model, q=q, generator=generator)
        self.gamma_2 = QLayerScale(d_model, 1e-4, q=q, dim=-1)
        self.add_norm2 = QAdd(q=q)
        self.norm_out = GroupNormT(d_model, q=q)


class SelfAttnLayer(_TransformerLayer):
    """MyTransformerEncoderLayer (htdemucsq.py:138-217): norm-first, LayerScale, GELU FFN, GroupNorm norm_out.
    ``[B, L, C]``."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, q: QuantSpec = FLOAT,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.norm1 = QLayerNorm(d_model, EPS, q=q)
        self.self_attn = QMultiheadAttention(d_model, nhead, q=q, generator=generator)
        self.gamma_1 = QLayerScale(d_model, 1e-4, q=q, dim=-1)
        self.add_norm1 = QAdd(q=q)
        self.norm2 = QLayerNorm(d_model, EPS, q=q)
        self._build_ffn(d_model, dim_feedforward, q, generator)

    def forward(self, x: Tensor) -> Tensor:
        h = self.norm1(x)
        x = self.add_norm1(x, self.gamma_1(self.self_attn(h, h, h)))
        return self._ffn(x, self.norm2)


class CrossAttnLayer(_TransformerLayer):
    """CrossTransformerEncoderLayer (htdemucsq.py:220-328): queries ``[B, T, C]`` attend to keys ``[B, S, C]``."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, q: QuantSpec = FLOAT,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.norm1 = QLayerNorm(d_model, EPS, q=q)
        self.norm2 = QLayerNorm(d_model, EPS, q=q)
        self.cross_attn = QMultiheadAttention(d_model, nhead, q=q, generator=generator)
        self.gamma_1 = QLayerScale(d_model, 1e-4, q=q, dim=-1)
        self.add_norm1 = QAdd(q=q)
        self.norm3 = QLayerNorm(d_model, EPS, q=q)
        self._build_ffn(d_model, dim_feedforward, q, generator)

    def forward(self, qx: Tensor, kx: Tensor) -> Tensor:
        hq, hk = self.norm1(qx), self.norm2(kx)
        x = self.add_norm1(qx, self.gamma_1(self.cross_attn(hq, hk, hk)))
        return self._ffn(x, self.norm3)


class CrossTransformerEncoder(nn.Module):
    """Cross-domain transformer (htdemucsq.py:331-523) over the spectrogram's tokens and the waveform's:
    ``(x [B, C, Fr, T1], xt [B, C, T2]) -> (x, xt)``. Layer ``idx`` is a self-attention pair (one layer a branch)
    for even ``idx``, a cross-attention pair for odd (``cross_first=False``)."""

    def __init__(self, dim: int, num_heads: int = 8, num_layers: int = 5, hidden_scale: float = 4.0,
                 max_period: float = 10000.0, weight_pos_embed: float = 1.0, q: QuantSpec = FLOAT,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.max_period, self.weight_pos_embed = max_period, weight_pos_embed
        self.const_pos_emb_2d = QConst(q=q)
        self.norm_in = QLayerNorm(dim, EPS, q=q)
        self.add_x = QAdd(q=q)
        self.const_pos_emb = QConst(q=q)
        self.norm_in_t = QLayerNorm(dim, EPS, q=q)
        self.add_xt = QAdd(q=q)
        hidden = int(dim * hidden_scale)
        self.layers = []
        for idx in range(num_layers):
            kind = SelfAttnLayer if idx % 2 == 0 else CrossAttnLayer
            pair = (kind(dim, num_heads, hidden, q=q, generator=generator),
                    kind(dim, num_heads, hidden, q=q, generator=generator))
            self.add_module(f"layer_{idx}", pair[0])
            self.add_module(f"layer_t_{idx}", pair[1])
            self.layers.append(pair)
        self._pos: dict = {}

    def _embedding(self, kind: str, shape: tuple, device: torch.device) -> Tensor:
        """The positional embedding as a token tensor on ``device``, made once per shape and device."""
        key = (kind, shape, device)
        if key not in self._pos:
            if kind == "2d":
                c, fr, t1 = shape
                pe = create_2d_sin_embedding(c, fr, t1, self.max_period).transpose(0, 3, 2, 1).reshape(1, t1 * fr, c)
            else:
                t2, c = shape
                pe = create_sin_embedding(t2, c, self.max_period).transpose(1, 0, 2)
            with torch.inference_mode(False):  # a normal tensor, reusable outside the call that made it
                self._pos[key] = torch.from_numpy(np.ascontiguousarray(pe)).to(device)
        return self._pos[key]

    def forward(self, x: Tensor, xt: Tensor) -> tuple[Tensor, Tensor]:
        _, c, fr, t1 = x.shape
        pos2d = self.const_pos_emb_2d(self._embedding("2d", (c, fr, t1), x.device))
        x = self.add_x(self.norm_in(tokens_2d(x)), self.weight_pos_embed * pos2d)
        pos = self.const_pos_emb(self._embedding("1d", (xt.shape[-1], c), xt.device))
        xt = self.add_xt(self.norm_in_t(xt.transpose(1, 2).contiguous()), self.weight_pos_embed * pos)
        for idx, (layer, layer_t) in enumerate(self.layers):
            if idx % 2 == 0:
                x, xt = layer(x), layer_t(xt)
            else:
                x, xt = layer(x, xt), layer_t(xt, x)
        return untokens_2d(x, fr), xt.transpose(1, 2).contiguous()


class HTDemucs(nn.Module):
    """HTDemucs QAT model (htdemucsq.py:532-1151). ``generator`` seeds the weight init; the ranges start at the
    quantizers' defaults until an observer pass or a loaded state sets them."""

    def __init__(self, sources: tuple[str, ...] = SOURCES, audio_channels: int = 2, channels: int = 48,
                 growth: int = 2, nfft: int = 4096, depth: int = 4, kernel_size: int = 8, stride: int = 4,
                 context: int = 1, context_enc: int = 0, norm_starts: int = 4, norm_groups: int = 4,
                 dconv_depth: int = 2, dconv_comp: float = 8, dconv_init: float = 1e-3, freq_emb_weight: float = 0.2,
                 emb_scale: float = 10, emb_smooth: bool = True, t_layers: int = 5, t_heads: int = 8,
                 t_hidden_scale: float = 4.0, bottom_channels: int = 0, samplerate: int = 44100, segment: float = 10,
                 q: QuantSpec = FLOAT, generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.sources, self.q = tuple(sources), q
        self.n_srcs, self.audio_channels, self.nfft, self.depth = len(self.sources), audio_channels, nfft, depth
        self.samplerate, self.segment = samplerate, segment
        self.t_layers, self.t_heads, self.bottom_channels = t_layers, t_heads, bottom_channels
        self.dconv_depth = dconv_depth
        self.freq_emb_weight = freq_emb_weight
        self.transformer_override = None
        chin_t = audio_channels * q.n_splitter
        chin_f = 2 * audio_channels * q.n_splitter  # complex as channels
        chout = channels
        self.enc_channels = []
        self.encoders, self.tencoders, self.decoders, self.tdecoders = [], [], [], []
        for idx in range(depth):
            kw = dict(kernel_size=kernel_size, stride=stride, norm=idx >= norm_starts, norm_groups=norm_groups,
                      context=context_enc, dconv_depth=dconv_depth, dconv_comp=dconv_comp, dconv_init=dconv_init,
                      q=q, is_input_layer=idx == 0, generator=g)
            self.enc_channels.append(chout)
            self.tencoders.append(HEncLayer(chin_t, chout, freq=False, **kw))
            self.encoders.append(HEncLayer(chin_f, chout, freq=True, **kw))
            self.add_module(f"tencoder_{idx}", self.tencoders[-1])
            self.add_module(f"encoder_{idx}", self.encoders[-1])
            if idx == 0 and freq_emb_weight:
                self.freq_emb = ScaledEmbedding(nfft // 2 // stride, chout, scale=emb_scale, smooth=emb_smooth, q=q,
                                                generator=g)
                self.mul_freq = QMul(q=q)
                self.add_freq = QAdd(q=q)
            chin_t = chin_f = chout
            chout = int(growth * chout)
        c_b = self.enc_channels[-1]
        dim = bottom_channels or c_b
        if t_layers > 0:
            if bottom_channels:
                self.channel_upsampler = QConv1d(c_b, bottom_channels, 1, q=q, generator=g)
                self.channel_upsampler_t = QConv1d(c_b, bottom_channels, 1, q=q, generator=g)
            self.crosstransformer = CrossTransformerEncoder(dim, t_heads, t_layers, t_hidden_scale, q=q, generator=g)
            if bottom_channels:
                self.channel_downsampler = QConv1d(bottom_channels, c_b, 1, q=q, generator=g)
                self.channel_downsampler_t = QConv1d(bottom_channels, c_b, 1, q=q, generator=g)
        chin = audio_channels * self.n_srcs
        chin_z = 2 * chin
        for idx in range(depth):
            enc_idx = depth - 1 - idx
            last = enc_idx == 0
            kw = dict(last=last, kernel_size=kernel_size, stride=stride, norm=enc_idx >= norm_starts,
                      norm_groups=norm_groups, context=context, q=q, generator=g)
            chin_dec = self.enc_channels[enc_idx]
            self.decoders.append(HDecLayer(chin_dec, chin_z if last else self.enc_channels[enc_idx - 1], freq=True,
                                           train_res_dec=True, **kw))
            self.tdecoders.append(HDecLayer(chin_dec, chin if last else self.enc_channels[enc_idx - 1], freq=False,
                                            train_res_dec=False, **kw))
            self.add_module(f"decoder_{idx}", self.decoders[-1])
            self.add_module(f"tdecoder_{idx}", self.tdecoders[-1])

    @property
    def hop_length(self) -> int:
        return self.nfft // 4

    def _spec(self, x: Tensor) -> Tensor:
        """STFT with demucs's padding (htdemucsq.py:931-951): complex ``[B, C, nfft / 2, ceil(T / hop)]``."""
        hl = self.hop_length
        le = int(math.ceil(x.shape[-1] / hl))
        pad = hl // 2 * 3
        x = pad1d_reflect(x, pad, pad + le * hl - x.shape[-1])
        z = spectro(x, self.nfft, hl)[..., :-1, :]
        return z[..., 2 : 2 + le]

    def _ispec(self, z: Tensor, length: int) -> Tensor:
        """The inverse of :meth:`_spec` (htdemucsq.py:953-961)."""
        hl = self.hop_length
        z = torch.nn.functional.pad(z, (2, 2, 0, 1))
        pad = hl // 2 * 3
        le = hl * int(math.ceil(length / hl)) + 2 * pad
        return ispectro(z, hl, length=le)[..., pad : pad + length]

    def _magnitude(self, z: Tensor) -> Tensor:
        """CaC: complex ``[B, C, Fr, T]`` -> real ``[B, 2C, Fr, T]``, each channel's real then imaginary part
        (htdemucsq.py:963-972)."""
        b, c, fr, t = z.shape
        return torch.stack([z.real, z.imag], dim=2).reshape(b, 2 * c, fr, t)

    @staticmethod
    def _mask(m: Tensor) -> Tensor:
        """``[B, S, 2C, Fr, T]`` -> complex ``[B, S, C, Fr, T]`` (htdemucsq.py:974-978)."""
        b, s, c2, fr, t = m.shape
        out = m.reshape(b, s, c2 // 2, 2, fr, t)
        return torch.complex(out[:, :, :, 0], out[:, :, :, 1])

    def _transformer(self, x: Tensor, xt: Tensor) -> tuple[Tensor, Tensor]:
        if self.transformer_override is not None:
            return self.transformer_override(x, xt)
        if self.bottom_channels:
            b, c_b, fr, t = x.shape
            x = self.channel_upsampler(x.reshape(b, c_b, fr * t)).reshape(b, -1, fr, t)
            xt = self.channel_upsampler_t(xt)
        x, xt = self.crosstransformer(x, xt)
        if self.bottom_channels:
            x = self.channel_downsampler(x.reshape(b, -1, fr * t)).reshape(b, c_b, fr, t)
            xt = self.channel_downsampler_t(xt)
        return x, xt

    def forward(self, mix: Tensor, train: bool = True) -> Tensor:
        with weight_pass(self):  # every weight quantizer in one grouped call
            return self._forward(mix, train)

    def _forward(self, mix: Tensor, train: bool) -> Tensor:
        q = self.q
        length = mix.shape[-1]
        length_pre_pad = None
        if not train:
            training_length = int(self.segment * self.samplerate)
            if length < training_length:
                length_pre_pad = length
                mix = torch.nn.functional.pad(mix, (0, training_length - length))
                length = training_length

        z = self._spec(mix)
        mag = self._magnitude(z)  # [B, C', Fr, T]
        mean = mag.mean(dim=(1, 2, 3), keepdim=True)
        std = mag.std(dim=(1, 2, 3), keepdim=True, correction=0)
        x = (mag - mean) / (1e-5 + std)
        meant = mix.mean(dim=(1, 2), keepdim=True)
        stdt = mix.std(dim=(1, 2), keepdim=True, correction=0)
        xt = (mix - meant) / (1e-5 + stdt)
        x = preprocess(x, n_splitter=q.n_splitter)
        xt = preprocess(xt, n_splitter=q.n_splitter, normalize=False)
        b, fq, t_spec = x.shape[0], x.shape[-2], x.shape[-1]

        saved, saved_t, lengths, lengths_t = [], [], [], []
        for idx, (enc, tenc) in enumerate(zip(self.encoders, self.tencoders)):
            lengths.append(x.shape[-2])
            lengths_t.append(xt.shape[-1])
            xt = tenc(xt)
            saved_t.append(xt)
            x = enc(x)
            if idx == 0 and self.freq_emb_weight:
                emb = self.freq_emb(torch.arange(x.shape[-2], device=x.device))  # [Fr, C]
                emb = emb.t().contiguous()[None, :, :, None]  # [1, C, Fr, 1]: the grid is per tensor
                x = self.add_freq(x, self.mul_freq(emb, self.freq_emb_weight))
            saved.append(x)

        if self.t_layers > 0:
            x, xt = self._transformer(x, xt)

        for dec, tdec in zip(self.decoders, self.tdecoders):
            x = dec(x, saved.pop(-1), lengths.pop(-1))
            xt = tdec(xt, saved_t.pop(-1), lengths_t.pop(-1))

        n_comb = q.n_combiner
        if n_comb == 1:
            x, xt = x[None], xt[None]
        x = x.reshape(n_comb, b, self.n_srcs, -1, fq, t_spec)
        xt = xt.reshape(n_comb, b, self.n_srcs, -1, xt.shape[-1])
        x = postprocess(x, n_combiner=n_comb) * std[:, None] + mean[:, None]
        xt = postprocess(xt, n_combiner=n_comb) * stdt[:, None] + meant[:, None]
        out = xt[..., :length] + self._ispec(self._mask(x), length)
        return out[..., :length_pre_pad] if length_pre_pad else out
