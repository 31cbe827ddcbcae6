"""Int8 serving engine for ConvTasNet-music (``fqss_tpu/serve/convtasnet_music_int8.py``).

The construction of :mod:`fqss_tpu_torch.serve.convtasnet_int8` applied to
the music model (``models/convtasnet_music.py``): every 1x1 conv of the TCN
(``bottleneck``, each block's ``conv1x1`` and ``pointwise``, ``mask_conv``)
and the Linear decoder run as int8 products through K4
(:class:`~fqss_tpu_torch.serve.common.Int8Site`: s8 x s8 -> s32 fused with
the dequantization, the PReLU or ReLU and the requantization), with int8
activations between stages, channels last; the encoder and depthwise convs,
the LayerNorm and gLNs, the residual adds, the mask product, the combiner's
dense products and the overlap-add run in float32, or on bf16-rounded
operands with ``compute_dtype="bfloat16"``, as JAX's engine leaves them to
XLA. 83 K4 launches a forward at full width (4 x 10 blocks). The steps and
the host-side constants are the JAX engine's (its LayerNorm takes the
variance as E[(x - mu)^2], not flax's E[x²]−E[x]²).
"""

from __future__ import annotations

import torch

from fqss_tpu_torch.models.convtasnet_music import EPS, ConvTasNetMusic
from fqss_tpu_torch.models.dptnet import overlap_and_add
from fqss_tpu_torch.separation.splitter import postprocess, preprocess
from fqss_tpu_torch.serve.common import (
    Grid,
    Int8Site,
    QAct,
    bf16_round,
    check_8bit_spec,
    conv1d,
    dequant_weight,
    gn1,
    int8_matmul,
    layer_norm,
    prelu,
    quantizer_grid,
    requant,
)
from fqss_tpu_torch.serve.convtasnet_int8 import _alpha, _int8_weight

Tensor = torch.Tensor


class ConvTasNetMusicInt8Engine:
    """Int8 inference engine built from a calibrated port ``ConvTasNetMusic``.

    ``engine(x)``: ``[B, audio_channels, T]`` -> ``[B, n_sources, audio_channels, T']`` on the model's device.
    """

    def __init__(self, model: ConvTasNetMusic, compute_dtype: str = "bfloat16"):
        q = model.q
        if q.n_combiner > 2:
            raise NotImplementedError("combiner chains beyond 2 planes")
        check_8bit_spec(q)
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', got {compute_dtype!r}")
        if model.mask_act not in ("relu", "sigmoid"):
            raise NotImplementedError(f"the int8 engine takes a relu or sigmoid mask, not {model.mask_act!r}")
        self.q, self.model_dims = q, (model.n_srcs, model.n_filters, model.audio_channels, model.kernel_size)
        self.stride = model.stride
        self.bf16 = compute_dtype == "bfloat16"
        dev = next(model.parameters()).device

        def float_weight(weight, wq) -> Tensor:
            w = torch.from_numpy(dequant_weight(weight, wq.min_range, wq.max_range, q.weight_n_bits)).to(dev)
            return bf16_round(w) if self.bf16 else w

        def vec(p) -> Tensor:
            return p.detach().to(dev, torch.float32).clone()

        def site(g_in: Grid, layer, alpha: float = 1.0) -> tuple[Int8Site, Grid]:
            g_out = quantizer_grid(layer.activation_fake_quantize)
            return Int8Site(g_in, _int8_weight(layer, q.weight_n_bits), g_out, alpha, dev), g_out

        enc = model.encoder
        self.g_enc_in = quantizer_grid(enc.in_quantizer, q.in_act_n_bits) if enc.in_quantizer is not None else None
        self.enc_w = float_weight(enc.conv.weight, enc.conv.weight_fake_quantize)
        self.g_enc = quantizer_grid(enc.conv.activation_fake_quantize)

        sep = model.separator
        self.ln = (vec(sep.layer_norm.norm.weight), vec(sep.layer_norm.norm.bias))
        self.g_ln = quantizer_grid(sep.layer_norm.activation_fake_quantize)
        self.bottleneck, g = site(self.g_ln, sep.bottleneck)
        self.blocks = []
        for blk in sep.blocks:
            ds = blk.dsconv
            conv1x1, _ = site(g, blk.conv1x1, _alpha(blk.conv1x1.nl))
            g_n2 = quantizer_grid(ds.norm.activation_fake_quantize)
            pointwise, _ = site(g_n2, ds.pointwise)
            self.blocks.append({
                "conv1x1": conv1x1,
                "n1": (vec(blk.norm.norm.weight), vec(blk.norm.norm.bias)),
                "g_n1": quantizer_grid(blk.norm.activation_fake_quantize),
                "w_dw": float_weight(ds.depthwise.weight, ds.depthwise.weight_fake_quantize),
                "a_dw": _alpha(ds.depthwise.nl), "g_dw": quantizer_grid(ds.depthwise.activation_fake_quantize),
                "n2": (vec(ds.norm.norm.weight), vec(ds.norm.norm.bias)), "g_n2": g_n2,
                "pointwise": pointwise, "g_add": quantizer_grid(blk.add.activation_fake_quantize),
                "padding": ds.depthwise.padding, "dilation": ds.depthwise.dilation,
            })
            g = self.blocks[-1]["g_add"]
        if model.mask_act == "relu":  # ReLU is PReLU with slope 0, in the kernel
            self.mask_site, _ = site(g, sep.mask_conv, 0.0)
            self.mask_w = None
        else:  # the sigmoid is applied outside the kernel, to the dequantized product (as JAX does)
            self.mask_site = None
            self.mask_w = _int8_weight(sep.mask_conv, q.weight_n_bits)
            self.g_mask = quantizer_grid(sep.mask_conv.activation_fake_quantize)
        self.g_mul = quantizer_grid(model.mul.activation_fake_quantize)

        # the Linear decoder as an int8 product of the masked plane (+ the combiner's residual plane, in float)
        dec = model.decoder
        if q.out_quant:
            self.dec_site, _ = site(self.g_mul, dec)
            self.dec_w8 = None
        else:
            self.dec_site, self.dec_w8 = None, _int8_weight(dec, q.weight_n_bits)
        self.dec_w = float_weight(dec.weight, dec.weight_fake_quantize)  # [F, N]
        if q.n_combiner == 2:
            reb = dec.residual_error_block
            self.re_w = float_weight(reb.residual_encoder_weight, reb.weight_fake_quantize)  # [N, F]
            self.re_b = vec(reb.residual_encoder_bias) if reb.residual_encoder_bias is not None else None
            self.g_re = quantizer_grid(reb.activation_fake_quantize)
            self.g_dec_res = (quantizer_grid(dec.activation_fake_quantize_residual, q.out_act_n_bits)
                              if q.out_quant else None)
            # the trained residual decoder (train_res_dec), else the decoder's own weight
            self.res_dec_w = (float_weight(reb.residual_decoder_weight, reb.weight_fake_quantize_dec)
                              if reb.residual_decoder_weight is not None else self.dec_w)

    def __call__(self, x: Tensor) -> Tensor:
        with torch.no_grad():
            return self._forward(x)

    def _dense(self, x: Tensor, w: Tensor) -> Tensor:
        """``x @ w.T`` over the last axis, the operands rounded to bf16 under bf16 (``w`` arrives rounded)."""
        return torch.matmul(bf16_round(x) if self.bf16 else x, w.t())

    def _forward(self, x: Tensor) -> Tensor:
        bf16, q = self.bf16, self.q
        n_srcs, n_filters, ac, kernel = self.model_dims
        x = preprocess(x, n_splitter=q.n_splitter, normalize=False)  # [B, C', T]
        B = x.shape[0]
        if self.g_enc_in is not None:
            x = requant(x, self.g_enc_in).f32
        feats = torch.relu(conv1d(x, self.enc_w, stride=self.stride, bf16=bf16))
        feats_q = requant(feats.transpose(1, 2), self.g_enc)  # [B, K, N]

        h_q = requant(layer_norm(feats_q.f32, *self.ln, EPS), self.g_ln)  # channel-wise, over the filters
        h_q = self.bottleneck(h_q)
        for blk in self.blocks:
            y_q = blk["conv1x1"](h_q)
            y_q = requant(gn1(y_q.f32, *blk["n1"], EPS), blk["g_n1"])
            y = conv1d(y_q.f32.transpose(1, 2), blk["w_dw"], padding=blk["padding"], dilation=blk["dilation"],
                       groups=y_q.Xs.shape[-1], bf16=bf16).transpose(1, 2)
            y_q = requant(prelu(y, blk["a_dw"]), blk["g_dw"])
            y_q = requant(gn1(y_q.f32, *blk["n2"], EPS), blk["g_n2"])
            y_q = blk["pointwise"](y_q)
            h_q = requant(y_q.f32 + h_q.f32, blk["g_add"])

        if self.mask_site is not None:
            mask_q = self.mask_site(h_q)
        else:
            mask_q = requant(torch.sigmoid(int8_matmul(h_q, self.mask_w)), self.g_mask)
        k = mask_q.Xs.shape[1]
        mask = mask_q.f32.reshape(B, k, n_srcs, n_filters).transpose(1, 2)  # [B, C, K, N]
        masked_q = requant(mask * feats_q.f32[:, None], self.g_mul)
        mq = QAct(masked_q.Xs.reshape(B * n_srcs, k, n_filters), self.g_mul)

        y0 = self.dec_site(mq).f32 if self.dec_site is not None else int8_matmul(mq, self.dec_w8)  # [B*C, K, F]
        planes = [y0]
        if q.n_combiner == 2:
            Y_q = self._dense(y0, self.re_w)
            if self.re_b is not None:
                Y_q = Y_q + self.re_b
            Y1 = requant(mq.f32 - Y_q, self.g_re).f32
            dec1 = self._dense(Y1, self.res_dec_w)
            planes.append(requant(dec1, self.g_dec_res).f32 if self.g_dec_res is not None else dec1)
        out = torch.stack(planes).reshape(q.n_combiner, B, n_srcs, k, ac, kernel).transpose(3, 4)
        return postprocess(overlap_and_add(out, self.stride), n_combiner=q.n_combiner)
