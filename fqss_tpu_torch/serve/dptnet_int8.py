"""Int8 serving engine for the FQSS DPTNet (``fqss_tpu/serve/dptnet_int8.py``).

Runs the fake-quantized DPTNet forward (``models/dptnet.py``) with the
products whose inputs lie on a learned 8-bit grid as true int8 products
through the K4 kernel (:class:`~fqss_tpu_torch.serve.common.Int8Site`:
s8 x s8 -> s32, dequantization, nonlinearity and requantization in one
launch): the MHA in-projection (one launch, its Q, K and V thirds each
requantized to its own grid) and out-projection of every dual-path layer, the separator's bottleneck 1x1, the
DPT's output dense layer, the gated output convs (tanh and sigmoid in the
kernel's epilogue) and the mask 1x1 conv.

It stays in float (float32, or bf16 operands with float32 sums), with
weights folded on the host, where the model's quantizer placement leaves
the inputs OFF the grid, as the JAX engine documents (its lines 11-22):

* the LSTM feed-forward, which runs through the model's own ``QLSTM`` on a
  weight-folded copy, so through the LSTM kernel (K7) in float32, with its
  output quantizer; and the post-LSTM linear (its input is relu of the LSTM's
  grid output, and 0 is not a grid point; dptnetq.py:94 has no quant site
  there);
* the first row layer's in-projection (split_segments' zero padding is off
  the grid until the first add/norm quant site);
* the attention products (the reference's attn/softmax quant sites are
  no-ops);
* the tiny Linear decoder (E -> kernel_size = 2) and its residual block.

Activations between stages are channels-last, as the JAX engine carries
them. The host constants are numpy float32 with the JAX package's
expressions (``serve/common.py``). ``compute_dtype`` sets the operands of
the float products as in :mod:`fqss_tpu_torch.serve.convtasnet_int8`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from fqss_tpu_torch.models.dptnet import EPS, DPTNet, merge_segments, overlap_and_add, split_segments
from fqss_tpu_torch.separation.splitter import postprocess, preprocess
from fqss_tpu_torch.serve.common import (
    Grid,
    Int8Site,
    Int8Weight,
    bf16_round,
    check_8bit_spec,
    conv1d,
    dequant_weight,
    gn1,
    int8_weight,
    layer_norm,
    prelu,
    quantizer_grid,
    requant,
)
from fqss_tpu_torch.serve.fold import fold_quantized_weights

Tensor = torch.Tensor

LN_EPS = 1e-5  # the transformer layers' LayerNorms


class DPTNetInt8Engine:
    """Int8 inference engine built from a calibrated port ``DPTNet``.

    Usage::

        engine = DPTNetInt8Engine(model)   # host-side preparation, once
        y = engine(x)                      # [B, T] -> [B, S, T] on the model's device
    """

    def __init__(self, model: DPTNet, compute_dtype: str = "bfloat16"):
        q = model.q
        if q.n_combiner > 2:
            raise NotImplementedError("combiner chains beyond 2 planes (matches the reference configs)")
        check_8bit_spec(q)
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', got {compute_dtype!r}")
        self.q, self.n_srcs, self.kernel_size = q, model.n_srcs, model.kernel_size
        self.enc_dim, self.feature_dim = model.enc_dim, model.feature_dim
        self.segment_size = model.separator.segment_size
        self.stride = model.encoder.conv.stride
        self.bf16 = compute_dtype == "bfloat16"
        dev = next(model.parameters()).device
        bits = q.weight_n_bits

        def float_weight(weight, wq) -> Tensor:
            w = torch.from_numpy(dequant_weight(weight, wq.min_range, wq.max_range, bits)).to(dev)
            return bf16_round(w) if self.bf16 else w

        def vec(p) -> Tensor | None:
            return None if p is None else p.detach().to(dev, torch.float32).clone()

        def weight8(layer, name: str = "weight", wq_name: str = "weight_fake_quantize", bias=None) -> Int8Weight:
            wq = getattr(layer, wq_name)
            return int8_weight(getattr(layer, name), wq.min_range, wq.max_range, bias, bits)

        def site(g_in: Grid, layer, alpha: float = 1.0, nl: str = "prelu") -> tuple[Int8Site, Grid]:
            g_out = quantizer_grid(layer.activation_fake_quantize)
            return Int8Site(g_in, weight8(layer, bias=layer.bias), g_out, alpha, dev, nl), g_out

        # encoder (float conv, ReLU) and enc_LN
        enc = model.encoder
        self.g_enc_in = quantizer_grid(enc.in_quantizer, q.in_act_n_bits) if enc.in_quantizer is not None else None
        self.enc_w = float_weight(enc.conv.weight, enc.conv.weight_fake_quantize)
        self.g_enc = quantizer_grid(enc.conv.activation_fake_quantize)
        self.ln = (vec(model.enc_LN.norm.weight), vec(model.enc_LN.norm.bias))
        self.g_ln = quantizer_grid(model.enc_LN.activation_fake_quantize)

        sep = model.separator
        self.bn, g_prev = site(self.g_ln, sep.BN)
        # The LSTMs of a weight-folded copy: the recurrence kernel, no weight fake-quant per call.
        folded = fold_quantized_weights(model).separator.DPT
        E = self.feature_dim
        self.layers = []
        for i, (row, col) in enumerate(zip(sep.DPT.rows, sep.DPT.cols)):
            for side, layer, lstm in (("row", row, folded.rows[i].lstm), ("col", col, folded.cols[i].lstm)):
                mha = layer.self_attn
                g_q, g_k, g_v = (quantizer_grid(getattr(mha, f"activation_fake_quantize_{s}")) for s in "qkv")
                w_in = weight8(mha, "in_proj_weight", "weight_fake_quantize_in", mha.in_proj_bias)
                g_head = quantizer_grid(mha.activation_fake_quantize_head)
                g_out = quantizer_grid(mha.activation_fake_quantize)
                entry = {
                    "side": side,
                    "heads": mha.num_heads,
                    "sqrt_d": torch.full((1,), math.sqrt(E // mha.num_heads), device=dev),
                    # row_0's input carries split_segments' off-grid zero padding
                    "on_grid": not (side == "row" and i == 0),
                    "g_q": g_q, "g_k": g_k, "g_v": g_v,
                    "g_div": quantizer_grid(mha.activation_fake_quantize_div),
                    "g_head": g_head,
                    "out_site": Int8Site(g_head, weight8(mha, "out_proj_weight", "weight_fake_quantize_out",
                                                         mha.out_proj_bias), g_out, 1.0, dev),
                    "g_add1": quantizer_grid(layer.add_norm1.activation_fake_quantize),
                    "n1": (vec(layer.norm1.norm.weight), vec(layer.norm1.norm.bias)),
                    "g_norm1": quantizer_grid(layer.norm1.activation_fake_quantize),
                    "lstm": lstm,
                    "w_linear": float_weight(layer.linear.weight, layer.linear.weight_fake_quantize),
                    "b_linear": vec(layer.linear.bias),
                    "g_linear": quantizer_grid(layer.linear.activation_fake_quantize),
                    "g_add2": quantizer_grid(layer.add_norm2.activation_fake_quantize),
                    "n2": (vec(layer.norm2.norm.weight), vec(layer.norm2.norm.bias)),
                    "g_norm2": quantizer_grid(layer.norm2.activation_fake_quantize),
                }
                if entry["on_grid"]:  # the full in-projection in one launch, its thirds on their own grids
                    entry["in_site"] = Int8Site(g_prev, w_in, [g_q, g_k, g_v], 1.0, dev)
                else:
                    entry["w_in"] = float_weight(mha.in_proj_weight, mha.weight_fake_quantize_in)
                    entry["b_in"] = vec(mha.in_proj_bias)
                self.layers.append(entry)
                g_prev = entry["g_norm2"]
        dpt = sep.DPT
        self.prelu_alpha = float(dpt.out_prelu.nl.alpha.detach().reshape(-1)[0])
        self.g_prelu = quantizer_grid(dpt.out_prelu.activation_fake_quantize)
        self.out_conv, _ = site(self.g_prelu, dpt.out_conv)
        self.g_merge = quantizer_grid(sep.add.activation_fake_quantize)
        self.output, _ = site(self.g_merge, sep.output, nl="tanh")
        self.output_gate, _ = site(self.g_merge, sep.output_gate, nl="sigmoid")
        self.g_sep_mul = quantizer_grid(sep.mul.activation_fake_quantize)
        self.mask, _ = site(self.g_sep_mul, model.mask_conv1x1, alpha=0.0)  # ReLU: PReLU with slope 0
        self.g_mul = quantizer_grid(model.mul.activation_fake_quantize)

        # Linear decoder (+ combiner residual plane)
        dec = model.decoder
        self.dec_w = float_weight(dec.weight, dec.weight_fake_quantize)
        self.g_dec = quantizer_grid(dec.activation_fake_quantize, q.out_act_n_bits) if q.out_quant else None
        if q.n_combiner == 2:
            reb = dec.residual_error_block
            self.re_w = float_weight(reb.residual_encoder_weight, reb.weight_fake_quantize)
            self.re_b = vec(reb.residual_encoder_bias)
            self.g_re = quantizer_grid(reb.activation_fake_quantize)
            self.g_dec_res = (quantizer_grid(dec.activation_fake_quantize_residual, q.out_act_n_bits)
                              if q.out_quant else None)
            # the trained residual decoder (train_res_dec), else the decoder's own weight
            self.res_dec_w = (float_weight(reb.residual_decoder_weight, reb.weight_fake_quantize_dec)
                              if reb.residual_decoder_weight is not None else self.dec_w)

    def __call__(self, x: Tensor) -> Tensor:
        with torch.no_grad():
            return self._forward(x)

    # -- float products: bf16 operands (weights rounded at build) or float32, float32 sums ------------------

    def _matmul(self, a: Tensor, b: Tensor) -> Tensor:
        return torch.matmul(bf16_round(a), b) if self.bf16 else torch.matmul(a, b)

    def _bmm(self, a: Tensor, b: Tensor) -> Tensor:
        return torch.matmul(bf16_round(a), bf16_round(b)) if self.bf16 else torch.matmul(a, b)

    # -- the layers -------------------------------------------------------------------------------------------

    def _mha(self, x: Tensor, L: dict, g_in: Grid) -> Tensor:
        """Quantized self-attention of ``x [B', L, E]`` (float32); int8 in-projection when x is on g_in."""
        B_, Lq, E = x.shape
        h = L["heads"]
        d = E // h
        if L["on_grid"]:
            qa = requant(x, g_in)
            Q, K, V = (third.f32 for third in L["in_site"](qa))
        else:
            y3 = self._matmul(x, L["w_in"].t()) + L["b_in"]
            Q = requant(y3[..., :E], L["g_q"]).f32
            K = requant(y3[..., E : 2 * E], L["g_k"]).f32
            V = requant(y3[..., 2 * E :], L["g_v"]).f32
        Qh = requant(Q.reshape(B_, Lq, h, d).transpose(1, 2) / L["sqrt_d"], L["g_div"]).f32
        Kh = K.reshape(B_, Lq, h, d).transpose(1, 2)
        Vh = V.reshape(B_, Lq, h, d).transpose(1, 2)
        attn = torch.softmax(self._bmm(Qh, Kh.transpose(-1, -2)), dim=-1)
        y = self._bmm(attn, Vh).transpose(1, 2).reshape(B_, Lq, E)
        return L["out_site"](requant(y, L["g_head"])).f32

    def _tlayer(self, src: Tensor, L: dict, g_in: Grid) -> Tensor:
        """ImprovedTransformerLayer (models/dptnet.py); float32 in and out."""
        src = requant(src + self._mha(src, L, g_in), L["g_add1"]).f32
        src = requant(layer_norm(src, *L["n1"], LN_EPS), L["g_norm1"]).f32
        y = F.relu(L["lstm"](src))  # not a quant point (dptnetq.py:94): a float linear
        src2 = requant(self._matmul(y, L["w_linear"].t()) + L["b_linear"], L["g_linear"]).f32
        src = requant(src + src2, L["g_add2"]).f32
        return requant(layer_norm(src, *L["n2"], LN_EPS), L["g_norm2"]).f32

    def _forward(self, x: Tensor) -> Tensor:
        q, spk, n, W = self.q, self.n_srcs, self.feature_dim, self.kernel_size
        x = preprocess(x, n_splitter=q.n_splitter)  # [B, C', T]
        B = x.shape[0]
        if self.g_enc_in is not None:
            x = requant(x, self.g_enc_in).f32
        mix_q = requant(F.relu(conv1d(x, self.enc_w, stride=self.stride, bf16=self.bf16)).transpose(1, 2),
                        self.g_enc)  # [B, L, E]
        feats = self.bn(requant(gn1(mix_q.f32, *self.ln, EPS), self.g_ln))  # [B, L, N]

        segs, rest = split_segments(feats.f32, self.segment_size)  # [B, K, S, N]
        b, k, s, _ = segs.shape
        out = segs
        g_prev = self.bn.g_out
        for L in self.layers:
            if L["side"] == "row":
                out = self._tlayer(out.transpose(1, 2).reshape(b * s, k, n), L, g_prev)
                out = out.reshape(b, s, k, n).transpose(1, 2)
            else:
                out = self._tlayer(out.reshape(b * k, s, n), L, g_prev).reshape(b, k, s, n)
            g_prev = L["g_norm2"]

        out = self.out_conv(requant(prelu(out, self.prelu_alpha), self.g_prelu)).f32  # [B, K, S, spk*N]
        out = out.reshape(b, k, s, spk, n).permute(0, 3, 1, 2, 4).reshape(b * spk, k, s, n)
        merged_q = requant(merge_segments(out, rest, lambda u, v: requant(u + v, self.g_merge).f32), self.g_merge)
        bf = requant(self.output(merged_q).f32 * self.output_gate(merged_q).f32, self.g_sep_mul)  # [B*spk, L, N]
        mask = self.mask(bf).f32.reshape(B, spk, -1, self.enc_dim)
        source_w = requant(mix_q.f32[:, None] * mask, self.g_mul).f32  # [B, spk, L, E]

        x0 = self._matmul(source_w, self.dec_w.t())
        y = requant(x0, self.g_dec).f32 if self.g_dec is not None else x0
        planes = [y]
        if q.n_combiner == 2:
            Y_q = self._matmul(y, self.re_w.t())
            if self.re_b is not None:
                Y_q = Y_q + self.re_b
            Y1 = requant(source_w - Y_q, self.g_re).f32
            dec = self._matmul(Y1, self.res_dec_w.t())
            planes.append(requant(dec, self.g_dec_res).f32 if self.g_dec_res is not None else dec)
        est = overlap_and_add(torch.stack(planes).reshape(q.n_combiner, B, spk, -1, W), W // 2)
        return postprocess(est.reshape(q.n_combiner, B, spk, 1, -1), n_combiner=q.n_combiner)
