"""Int8 serving engine for the FQSS ConvTasNet (``fqss_tpu/serve/convtasnet_int8.py``).

Runs the fake-quantized ConvTasNet forward (``models/convtasnet.py``) with
its 1x1 convolutions as true int8 products: s8 x s8 -> s32 on the tensor
cores, fused with the dequantization, the PReLU and the requantization to
the next layer's grid in one CUDA kernel
(:func:`fqss_tpu_torch.ops.int8_matmul.int8_matmul_requant`, K4). Every
activation between stages is an int8 plane of its 8-bit grid, channels last
([B, T, C], as the JAX engine carries it), so the kernel reads each one as
the ``[B * T, C]`` matrix it takes. The 1x1 convolutions carry ~99% of the
TCN's products; the encoder, depthwise, decoder and combiner convolutions,
the gLNs, the adds and the requantizations between them are PyTorch ops, as
the JAX engine leaves them to XLA.

Why this is exact: after QAT every activation lies on its grid
``delta * X + mn`` and every weight on ``s_w[c] * W`` (``serve/common.py``),
so a 1x1 conv of grid values is an int32 product and a per-channel affine
map; the int32 sum is exact where the fake-quant forward's float32 sum
rounds. The engine follows the JAX engine's Pallas path step by step (its
``corr`` holds the bias), on the same host-side constants, so the two differ
only where a summation order moves a value across a rounding tie.

``compute_dtype`` sets the operands of the non-int8 convolutions:
``"float32"`` for parity, ``"bfloat16"`` as JAX's serving default. JAX
computes a bf16 conv with ``preferred_element_type=float32``: bf16 operands,
float32 sums, a float32 result. PyTorch's bf16 conv returns bf16, so the
port rounds the operands to bf16 and convolves them in float32 (TF32 off),
which is JAX's arithmetic; the products of two bf16 values are exact in
float32. It buys no speed over ``"float32"``.
"""

from __future__ import annotations

import torch

from fqss_tpu_torch.models.convtasnet import EPS, ConvTasNet
from fqss_tpu_torch.separation.splitter import postprocess, preprocess
from fqss_tpu_torch.serve.common import (
    Grid,
    Int8Site,
    Int8Weight,
    bf16_round,
    check_8bit_spec,
    conv1d,
    conv_transpose1d,
    dequant_weight,
    gn1,
    int8_matmul,
    int8_weight,
    prelu,
    quantizer_grid,
    requant,
)

Tensor = torch.Tensor


def _alpha(nl) -> float:
    """The one PReLU slope as a Python float (exactly its float32 value)."""
    return float(nl.alpha.detach().reshape(-1)[0])


def _int8_weight(conv, n_bits: int) -> Int8Weight:
    wq = conv.weight_fake_quantize
    return int8_weight(conv.weight, wq.min_range, wq.max_range, conv.bias, n_bits)


class ConvTasNetInt8Engine:
    """Int8 inference engine built from a calibrated port ``ConvTasNet``.

    Usage::

        engine = ConvTasNetInt8Engine(model)   # host-side preparation, once
        y = engine(x)                          # [B, T] -> [B, S, T] on the model's device

    The constants live on the device of the model's parameters.
    """

    def __init__(self, model: ConvTasNet, compute_dtype: str = "bfloat16"):
        q = model.q
        if q.n_combiner > 2:
            raise NotImplementedError("combiner chains beyond 2 planes (matches the reference configs)")
        check_8bit_spec(q)
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', got {compute_dtype!r}")
        mask_kind = model.masker.mask_conv.nl.kind
        if mask_kind not in ("relu", "sigmoid"):
            raise NotImplementedError(f"the int8 engine takes a relu or sigmoid mask, not {mask_kind!r}")
        self.q, self.n_srcs, self.n_filters = q, model.n_srcs, model.n_filters
        self.stride = model.encoder.conv.stride
        self.bf16 = compute_dtype == "bfloat16"
        dev = next(model.parameters()).device

        def float_weight(weight, wq) -> Tensor:
            w = torch.from_numpy(dequant_weight(weight, wq.min_range, wq.max_range, q.weight_n_bits)).to(dev)
            return bf16_round(w) if self.bf16 else w

        def conv_weight(layer) -> Tensor:
            return float_weight(layer.weight, layer.weight_fake_quantize)

        def vec(p) -> Tensor:
            return p.detach().to(dev, torch.float32).clone()

        def site(g_in: Grid, conv, alpha: float = 1.0) -> tuple[Int8Site, Grid]:
            g_out = quantizer_grid(conv.activation_fake_quantize)
            return Int8Site(g_in, _int8_weight(conv, q.weight_n_bits), g_out, alpha, dev), g_out

        # encoder (float conv; weight fake-quant folded on the host)
        enc = model.encoder
        self.g_enc_in = quantizer_grid(enc.in_quantizer, q.in_act_n_bits) if enc.in_quantizer is not None else None
        self.enc_w = conv_weight(enc.conv)
        self.g_enc = quantizer_grid(enc.conv.activation_fake_quantize)

        # masker
        mk = model.masker
        self.bn_norm = (vec(mk.bottleneck_norm.norm.weight), vec(mk.bottleneck_norm.norm.bias))
        self.g_bn_norm = quantizer_grid(mk.bottleneck_norm.activation_fake_quantize)
        self.bn_conv, g = site(self.g_bn_norm, mk.bottleneck_conv)
        self.blocks = []
        g_skip_sum = None
        for i, blk in enumerate(mk.blocks):
            conv_in, _ = site(g, blk.conv_in, _alpha(blk.conv_in.nl))
            g_ni = quantizer_grid(blk.norm_in.activation_fake_quantize)
            g_nd = quantizer_grid(blk.norm_dw.activation_fake_quantize)
            res, _ = site(g_nd, blk.res_conv)
            skip, _ = site(g_nd, blk.skip_conv)
            g_add = quantizer_grid(blk.add.activation_fake_quantize)
            if i > 0:
                g_skip_sum = quantizer_grid(mk.skip_adds[i - 1].activation_fake_quantize)
            self.blocks.append({
                "conv_in": conv_in,
                "ni": (vec(blk.norm_in.norm.weight), vec(blk.norm_in.norm.bias)), "g_ni": g_ni,
                "w_dw": conv_weight(blk.conv_dw),
                "b_dw": vec(blk.conv_dw.bias) if blk.conv_dw.bias is not None else None,
                "a_dw": _alpha(blk.conv_dw.nl), "g_dw": quantizer_grid(blk.conv_dw.activation_fake_quantize),
                "nd": (vec(blk.norm_dw.norm.weight), vec(blk.norm_dw.norm.bias)), "g_nd": g_nd,
                "res": res, "skip": skip, "g_add": g_add,
                "g_skip_sum": g_skip_sum, "dilation": blk.conv_dw.dilation,
            })
            g = g_add
        self.mask_prelu_alpha = _alpha(mk.mask_prelu.nl)
        self.g_mask_prelu = quantizer_grid(mk.mask_prelu.activation_fake_quantize)
        self.g_mask = quantizer_grid(mk.mask_conv.activation_fake_quantize)
        if mask_kind == "relu":  # ReLU is PReLU with slope 0, in the kernel
            self.mask_site, _ = site(self.g_mask_prelu, mk.mask_conv, 0.0)
            self.mask_w = None
        else:  # the sigmoid is applied outside the kernel, to the dequantized product (as JAX does)
            self.mask_site = None
            self.mask_w = _int8_weight(mk.mask_conv, q.weight_n_bits)
            self.mask_w.on(dev)
        self.g_mul = quantizer_grid(model.mul.activation_fake_quantize)

        # decoder (+ combiner residual plane, with its own trained decoder under train_res_dec)
        dec = model.decoder
        self.dec_w = conv_weight(dec)
        self.g_dec = quantizer_grid(dec.activation_fake_quantize, q.out_act_n_bits) if q.out_quant else None
        if q.n_combiner == 2:
            reb = dec.residual_error_block
            self.re_w = conv_weight(reb.residual_encoder)
            self.g_re = quantizer_grid(reb.activation_fake_quantize)
            self.res_dec_w = (float_weight(reb.residual_decoder_weight, reb.weight_fake_quantize_dec)
                              if reb.residual_decoder_weight is not None else self.dec_w)
            self.g_dec_res = (quantizer_grid(dec.activation_fake_quantize_residual, q.out_act_n_bits)
                              if q.out_quant else None)

    def __call__(self, x: Tensor) -> Tensor:
        with torch.no_grad():
            return self._forward(x)

    def _forward(self, x: Tensor) -> Tensor:
        bf16 = self.bf16
        x = preprocess(x, n_splitter=self.q.n_splitter)  # [B, C', T]
        B = x.shape[0]
        if self.g_enc_in is not None:
            x = requant(x, self.g_enc_in).f32
        feats_q = requant(conv1d(x, self.enc_w, stride=self.stride, bf16=bf16).transpose(1, 2), self.g_enc)  # NTC

        h_q = requant(gn1(feats_q.f32, *self.bn_norm, EPS), self.g_bn_norm)
        h_q = self.bn_conv(h_q)
        skip_sum_q = None
        for blk in self.blocks:
            f_q = blk["conv_in"](h_q)
            f_q = requant(gn1(f_q.f32, *blk["ni"], EPS), blk["g_ni"])
            d = blk["dilation"]
            f = conv1d(f_q.f32.transpose(1, 2), blk["w_dw"], padding=d, dilation=d, groups=f_q.Xs.shape[-1],
                       bf16=bf16).transpose(1, 2)
            if blk["b_dw"] is not None:
                f = f + blk["b_dw"]
            f_q = requant(prelu(f, blk["a_dw"]), blk["g_dw"])
            f_q = requant(gn1(f_q.f32, *blk["nd"], EPS), blk["g_nd"])
            residual_q = blk["res"](f_q)
            skip_q = blk["skip"](f_q)
            h_q = requant(h_q.f32 + residual_q.f32, blk["g_add"])
            skip_sum_q = skip_q if skip_sum_q is None else requant(skip_sum_q.f32 + skip_q.f32, blk["g_skip_sum"])

        o_q = requant(prelu(skip_sum_q.f32, self.mask_prelu_alpha), self.g_mask_prelu)
        if self.mask_site is not None:
            o_q = self.mask_site(o_q)
        else:
            o_q = requant(torch.sigmoid(int8_matmul(o_q, self.mask_w)), self.g_mask)

        # mask multiply: [B, T, S*F] x [B, T, 1, F] -> [B, T, S, F] -> decoder input [B*S, F, T]
        t = o_q.Xs.shape[1]
        mask = o_q.f32.reshape(B, t, self.n_srcs, self.n_filters)
        masked = requant(mask * feats_q.f32[:, :, None], self.g_mul).f32
        masked = masked.permute(0, 2, 3, 1).reshape(B * self.n_srcs, self.n_filters, t)

        x0 = conv_transpose1d(masked, self.dec_w, self.stride, bf16=bf16)  # [B*S, 1, L]
        y = requant(x0, self.g_dec).f32 if self.g_dec is not None else x0
        planes = [y]
        if self.q.n_combiner == 2:
            Y1 = requant(masked - conv1d(y, self.re_w, stride=self.stride, bf16=bf16), self.g_re).f32
            dec = conv_transpose1d(Y1, self.res_dec_w, self.stride, bf16=bf16)
            planes.append(requant(dec, self.g_dec_res).f32 if self.g_dec_res is not None else dec)
        out = torch.stack(planes).reshape(self.q.n_combiner, B, self.n_srcs, 1, -1)
        return postprocess(out, n_combiner=self.q.n_combiner)
