"""The legacy (pre-transformer) hybrid Demucs with declarative fake-quantization (``fqss_tpu/models/hdemucs.py``).

The JAX factory's ``HDemucsLegacy`` (reference: quantization/qat/models/hdemucsq.py:350-905): a depth-6 hybrid U-Net
whose time branch merges into the frequency branch once the frequency axis collapses (the ``last_freq`` layer,
hdemucsq.py:520-525), optional MultiWrap per-frequency-band replicas of the shallow layers (hdemucsq.py:165-258),
DConv branches that grow a BLSTM and a LocalState at depth (``dconv_lstm``/``dconv_attn``), and an output stage
that is complex-as-channels masking (``cac``), a ratio mask (``wiener_iters < 0``) or the EM Wiener filter over
300-frame windows (hdemucsq.py:661-704). Submodule names are the JAX scopes.

Layouts: the waveform ``[B, C, T]``, the frequency branch ``[B, C, Fr, T]`` (JAX: ``[B, T, C]``,
``[B, Fr, T, C]``); at the merge the unit frequency axis (dim 2) is folded away, and unfolded again at the decoder
that splits the branches. On the card the BLSTMs' recurrences are K7 (H = channels / dconv_comp: 192 on the cluster
route and 384 on the blocks route at the default width), their dense layers K5, every act grid K1 and every weight
grid one grouped K2 launch (the model's weight pass); the convolutions, norms, LocalState's attention, the STFT, the
iSTFT and the Wiener filter are PyTorch's, as JAX leaves them to XLA.

``forward(mix)``: ``[B, audio_channels, T]`` -> ``[B, n_sources, audio_channels, T]``; it takes no ``train``
keyword and pads nothing, as JAX's ``HDemucs.__call__``. As in JAX, the time branch's output is not de-normalised.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fqss_tpu_torch.models.demucs_blocks import HDecLayer, HEncLayer, ScaledEmbedding
from fqss_tpu_torch.models.htdemucs import HTDemucs
from fqss_tpu_torch.nn.layers import QAdd, QMul, mark_replicated
from fqss_tpu_torch.nn.nonlin import gelu
from fqss_tpu_torch.ops.wiener import apply_wiener_windowed
from fqss_tpu_torch.quant.quantizers import weight_pass
from fqss_tpu_torch.quant.spec import FLOAT, QuantSpec
from fqss_tpu_torch.separation.splitter import postprocess, preprocess

Tensor = torch.Tensor

SOURCES = ("drums", "bass", "other", "vocals")


class MultiWrap(nn.Module):
    """Per-frequency-band replicas of one HEnc/HDec layer (hdemucsq.py:165-258), ``band_k`` for each band; the
    frequency axis is dim 2.

    Band edges are the reference's, with Python's ``round`` on ``fr * ratio`` and on the frame count: encoder bands
    overlap by ``kernel - stride`` input rows, zero-padded at the two ends; decoder bands transpose-convolve
    without a bias and overlap-add over ``stride`` rows, the next band's bias taken off the seam (``band_k_bias``),
    ``stride // 2`` rows cut at both ends, then the GELU (not after the last decoder). Identical band weights give
    the unsplit layer. ``layer_kw``: the band layers' keywords (``chin`` included; a decoder's ``last`` is popped:
    its bands are plain transposed convs)."""

    def __init__(self, split_ratios: tuple, is_enc: bool, layer_kw: dict, q: QuantSpec = FLOAT,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(layer_kw)
        self.ratios = [*split_ratios, 1]
        self.is_enc, self.kernel, self.stride = is_enc, kw["kernel_size"], kw["stride"]
        self.last = kw.pop("last", False)
        for k in range(len(self.ratios)):
            if is_enc:
                self.add_module(f"band_{k}", HEncLayer(pad=False, q=q, generator=generator, **kw))
            else:
                self.add_module(f"band_{k}", HDecLayer(pad=False, last=False, gelu=False, tr_bias=False, q=q,
                                                       generator=generator, **kw))
                setattr(self, f"band_{k}_bias", nn.Parameter(torch.zeros(kw["chout"])))

    def forward(self, x: Tensor, skip: Tensor | None = None) -> Tensor | tuple[Tensor, Tensor]:
        return self._encode(x) if self.is_enc else self._decode(x, skip)

    def _encode(self, x: Tensor) -> Tensor:
        kernel, stride = self.kernel, self.stride
        fr = x.shape[2]
        pad = kernel // 4
        start, outs = 0, []
        for k, ratio in enumerate(self.ratios):
            if ratio == 1:
                limit = fr
            else:
                limit = int(round(fr * ratio))
                le = limit - start + (pad if start == 0 else 0)
                frames = round((le - kernel) / stride + 1)
                limit = start + (frames - 1) * stride + kernel - (pad if start == 0 else 0)
            assert 0 < limit - start <= fr, (start, limit, fr)
            y = x[:, :, start:limit]
            y = F.pad(y, (0, 0, pad if start == 0 else 0, pad if ratio == 1 else 0))
            outs.append(self._modules[f"band_{k}"](y))
            start = limit - kernel + stride
        return torch.cat(outs, dim=2)

    def _decode(self, x: Tensor, skip: Tensor) -> tuple[Tensor, Tensor]:
        stride = self.stride
        fr = x.shape[2]
        start, outs, pres = 0, [], []
        for k, ratio in enumerate(self.ratios):
            limit = fr if ratio == 1 else int(round(fr * ratio))
            bias = getattr(self, f"band_{k}_bias").view(-1, 1, 1)
            out, pre = self._modules[f"band_{k}"].pair(x[:, :, start:limit], skip[:, :, start:limit], None)
            out = out + bias
            if outs:
                seam = outs[-1][:, :, -stride:] + (out[:, :, :stride] - bias)
                outs[-1] = torch.cat([outs[-1][:, :, :-stride], seam], dim=2)
                out = out[:, :, stride:]
            if ratio == 1:
                out = out[:, :, : -(stride // 2)]
            if start == 0:
                out = out[:, :, stride // 2 :]
            outs.append(out)
            pres.append(pre)
            start = limit
        z = torch.cat(outs, dim=2)
        return (z if self.last else gelu(z)), pres[-1]


class HDemucs(nn.Module):
    """The legacy hybrid Demucs QAT model (hdemucsq.py:350-834), with JAX's keys and defaults. ``generator`` seeds
    the weight init; the ranges start at the quantizers' defaults until an observer pass or a loaded state sets
    them."""

    def __init__(self, sources: tuple[str, ...] = SOURCES, audio_channels: int = 2, channels: int = 48,
                 growth: int = 2, nfft: int = 4096, depth: int = 6, kernel_size: int = 8, stride: int = 4,
                 time_stride: int = 2, context: int = 1, context_enc: int = 0, norm_starts: int = 4,
                 norm_groups: int = 4, dconv_depth: int = 2, dconv_comp: float = 4, dconv_attn: int = 4,
                 dconv_lstm: int = 4, dconv_init: float = 1e-4, multi_freqs: tuple = (), multi_freqs_depth: int = 2,
                 freq_emb_weight: float = 0.2, emb_scale: float = 10, emb_smooth: bool = True, cac: bool = True,
                 wiener_iters: int = 0, wiener_residual: bool = False, samplerate: int = 44100, segment: float = 10,
                 q: QuantSpec = FLOAT, generator: torch.Generator | None = None):
        super().__init__()
        if multi_freqs and multi_freqs_depth > 0 and q.n_combiner > 1:
            # The band decoders of the last layer take no combiner decoder, and JAX's output stage then transposes a
            # 4-D tensor as a stacked 5-D one, which raises.
            raise ValueError("HDemucsLegacy: multi_freqs needs n_combiner 1 (the band decoders of the last layer "
                             "have no combiner; the JAX forward raises there)")
        g = generator
        self.sources, self.q = tuple(sources), q
        self.n_srcs, self.audio_channels, self.nfft, self.depth = len(self.sources), audio_channels, nfft, depth
        self.kernel_size, self.stride, self.time_stride = kernel_size, stride, time_stride
        self.norm_starts, self.dconv_lstm, self.dconv_attn = norm_starts, dconv_lstm, dconv_attn
        self.multi_freqs, self.multi_freqs_depth = tuple(multi_freqs), multi_freqs_depth
        self.freq_emb_weight, self.cac = freq_emb_weight, cac
        self.wiener_iters, self.wiener_residual = wiener_iters, wiener_residual
        self.samplerate, self.segment = samplerate, segment
        self.plan = self._layer_plan(channels, growth)
        self.n_tenc = sum(1 for cfg in self.plan if cfg["freq"])
        qg = dict(q=q, generator=g)
        enc_common = dict(norm_groups=norm_groups, context=context_enc, dconv_depth=dconv_depth,
                          dconv_comp=dconv_comp, dconv_init=dconv_init)
        for cfg in self.plan:
            idx = cfg["index"]
            if idx < self.n_tenc:
                chin_t = audio_channels * q.n_splitter if idx == 0 else self.plan[idx - 1]["chout"]
                self.add_module(f"tencoder_{idx}", HEncLayer(
                    chin_t, cfg["chout"], kernel_size, stride, freq=False, empty=cfg["last_freq"], norm=cfg["norm"],
                    dconv_lstm=cfg["lstm"], dconv_attn=cfg["attn"], is_input_layer=idx == 0, **enc_common, **qg))
            enc_kw = dict(chin=cfg["chin_z"], chout=cfg["chout_z"], kernel_size=cfg["ker"], stride=cfg["stri"],
                          freq=cfg["freq"], norm=cfg["norm"], dconv_lstm=cfg["lstm"], dconv_attn=cfg["attn"],
                          **enc_common)
            if cfg["multi"]:
                self.add_module(f"encoder_{idx}", MultiWrap(self.multi_freqs, True, enc_kw, **qg))
            else:
                self.add_module(f"encoder_{idx}", HEncLayer(pad=cfg["pad"], is_input_layer=idx == 0, **enc_kw, **qg))
            if idx == 0 and freq_emb_weight:
                self.freq_emb = ScaledEmbedding(cfg["freqs"] // cfg["stri"], cfg["chout_z"], scale=emb_scale,
                                                smooth=emb_smooth, q=q, generator=g)
                self.mul_freq = QMul(q=q)
                mark_replicated(self.mul_freq)  # the embedding times its weight: no batch axis
                self.add_freq = QAdd(q=q)
        for idx in range(depth):
            cfg = self.plan[depth - 1 - idx]
            last = cfg["index"] == 0
            chout_dec = (audio_channels * self.n_srcs * (2 if cac else 1) if last
                         else self.plan[cfg["index"] - 1]["chout_z"])
            dec_kw = dict(chin=cfg["chout_z"], chout=chout_dec, kernel_size=cfg["ker"], stride=cfg["stri"],
                          freq=cfg["freq"], norm=cfg["norm"], context=context,
                          # a multi-wrapped decoder's rewrite spans time only (hdemucsq.py:551-553)
                          context_freq=not cfg["multi"], norm_groups=norm_groups)
            if cfg["multi"]:
                self.add_module(f"decoder_{idx}", MultiWrap(self.multi_freqs, False, {**dec_kw, "last": last}, **qg))
            else:
                self.add_module(f"decoder_{idx}", HDecLayer(pad=cfg["pad"], last=last, **dec_kw, **qg))
            t_idx = cfg["index"]
            if t_idx < self.n_tenc:
                chout_t = audio_channels * self.n_srcs if last else self.plan[t_idx - 1]["chout"]
                self.add_module(f"tdecoder_{idx - (depth - self.n_tenc)}", HDecLayer(
                    cfg["chout"], chout_t, last=last, empty=cfg["last_freq"], kernel_size=kernel_size, stride=stride,
                    freq=False, norm=cfg["norm"], norm_groups=norm_groups, context=context, **qg))

    def _layer_plan(self, channels: int, growth: int) -> list[dict]:
        """The static configuration of each index (hdemucsq.py:508-587; ``HDemucs._layer_plan``)."""
        plan = []
        freqs = self.nfft // 2
        chin = self.audio_channels * self.q.n_splitter
        chin_z = chin * (2 if self.cac else 1)
        chout, chout_z = channels, channels
        for index in range(self.depth):
            freq = freqs > 1
            stri, ker, pad, last_freq = self.stride, self.kernel_size, True, False
            if not freq:
                ker, stri = self.time_stride * 2, self.time_stride
            if freq and freqs <= self.kernel_size:
                ker, pad, last_freq = freqs, False, True
            if last_freq:
                chout_z = max(chout, chout_z)
                chout = chout_z
            plan.append(dict(index=index, freq=freq, ker=ker, stri=stri, pad=pad, last_freq=last_freq,
                             norm=index >= self.norm_starts, lstm=index >= self.dconv_lstm,
                             attn=index >= self.dconv_attn,
                             multi=bool(self.multi_freqs) and index < self.multi_freqs_depth,
                             chin=chin, chin_z=chin_z, chout=chout, chout_z=chout_z, freqs=freqs))
            chin, chin_z = chout, chout_z
            chout, chout_z = int(growth * chout), int(growth * chout_z)
            if freq:
                freqs = 1 if freqs <= self.kernel_size else freqs // self.stride
        return plan

    hop_length = HTDemucs.hop_length  # nfft / 4
    _spec = HTDemucs._spec  # the STFT with demucs's padding (hdemucsq.py:604-629)
    _ispec = HTDemucs._ispec
    _magnitude = HTDemucs._magnitude  # complex as channels
    _mask = staticmethod(HTDemucs._mask)

    def forward(self, mix: Tensor) -> Tensor:
        with weight_pass(self):  # every weight quantizer in one grouped call
            return self._forward(mix)

    def _forward(self, mix: Tensor) -> Tensor:
        q, m = self.q, self._modules
        length, b = mix.shape[-1], mix.shape[0]

        # pre-process (hdemucsq.py:706-735)
        z = self._spec(mix)
        mag = self._magnitude(z) if self.cac else z.abs()
        mean = mag.mean(dim=(1, 2, 3), keepdim=True)
        std = mag.std(dim=(1, 2, 3), keepdim=True, correction=0)
        x = (mag - mean) / (1e-5 + std)
        meant = mix.mean(dim=(1, 2), keepdim=True)
        stdt = mix.std(dim=(1, 2), keepdim=True, correction=0)
        xt = (mix - meant) / (1e-5 + stdt)
        x = preprocess(x, n_splitter=q.n_splitter)
        xt = preprocess(xt, n_splitter=q.n_splitter, normalize=False)
        fq, t_spec = x.shape[-2], x.shape[-1]

        # encoders (hdemucsq.py:772-795)
        saved, saved_t, lengths, lengths_t = [], [], [], []
        for cfg in self.plan:
            idx = cfg["index"]
            lengths.append(x.shape[-1])
            inject = None
            if idx < self.n_tenc:
                lengths_t.append(xt.shape[-1])
                xt = m[f"tencoder_{idx}"](xt)
                if cfg["last_freq"]:
                    inject = xt
                else:
                    saved_t.append(xt)
            if not cfg["freq"] and x.ndim == 4:
                x = x[:, :, 0]  # the branches merged: fold the unit frequency axis
            x = m[f"encoder_{idx}"](x) if cfg["multi"] else m[f"encoder_{idx}"](x, inject)
            if idx == 0 and self.freq_emb_weight:
                emb = self.freq_emb(torch.arange(x.shape[-2], device=x.device))  # [Fr, C]
                emb = emb.t().contiguous()[None, :, :, None]  # [1, C, Fr, 1]: the grid is per tensor
                x = self.add_freq(x, self.mul_freq(emb, self.freq_emb_weight))
            saved.append(x)

        # decoders from zeros (hdemucsq.py:797-819)
        x = torch.zeros_like(x)
        xt = None
        for idx in range(self.depth):
            cfg = self.plan[self.depth - 1 - idx]
            skip = saved.pop(-1)
            if cfg["freq"] and x.ndim == 3:
                x = x[:, :, None]  # the branches split again: unfold the unit frequency axis
            if cfg["multi"]:
                x, pre = m[f"decoder_{idx}"](x, skip)
            else:
                x, pre = m[f"decoder_{idx}"].pair(x, skip, lengths.pop(-1))
            if cfg["index"] < self.n_tenc:
                tdec = m[f"tdecoder_{idx - (self.depth - self.n_tenc)}"]
                length_t = lengths_t.pop(-1)
                if cfg["last_freq"]:
                    assert pre.shape[2] == 1, pre.shape
                    xt = tdec(pre[:, :, 0], None, length_t)
                else:
                    xt = tdec(xt, saved_t.pop(-1), length_t)
        assert not saved and not saved_t and not lengths_t

        # post-process (hdemucsq.py:737-755)
        n_comb = q.n_combiner
        if n_comb == 1:
            x, xt = x[None], xt[None]
        x = x.reshape(n_comb, b, self.n_srcs, -1, fq, t_spec)
        xt = xt.reshape(n_comb, b, self.n_srcs, -1, xt.shape[-1])
        x = postprocess(x, n_combiner=n_comb) * std[:, None] + mean[:, None]
        xt = postprocess(xt, n_combiner=n_comb)
        if self.cac:
            zout = self._mask(x)
        elif self.wiener_iters < 0:  # a ratio mask (hdemucsq.py:672-674)
            zout = z[:, None] / (1e-8 + z[:, None].abs()) * x
        else:  # EM Wiener over 300-frame windows, per batch item (hdemucsq.py:678-704)
            zout = torch.stack([self._wiener(x[i], z[i]) for i in range(b)])
        return xt[..., :length] + self._ispec(zout, length)

    def _wiener(self, mag: Tensor, z: Tensor) -> Tensor:
        """One item's EM Wiener output: magnitudes ``[S, C, F, T]`` and the mixture ``[C, F, T]`` -> complex
        ``[S, C, F, T]``."""
        out = apply_wiener_windowed(mag.permute(2, 3, 1, 0), z.permute(1, 2, 0), self.wiener_iters,
                                    residual=self.wiener_residual)
        return out[..., : self.n_srcs].permute(3, 2, 0, 1)

