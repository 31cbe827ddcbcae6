"""Int8 serving engine for the FQSS Sepformer (``fqss_tpu/serve/sepformer_int8.py``).

Runs the fake-quantized Sepformer forward (``models/sepformer.py``) with the
products whose inputs lie on a learned 8-bit grid as true int8 products
through the K4 kernel (:class:`~fqss_tpu_torch.serve.common.Int8Site`:
s8 x s8 -> s32, dequantization, nonlinearity and requantization in one
launch):

* in every transformer layer (2 dual-path blocks x intra/inter x n_layers):
  the attention's in-projection (one launch whose Q, K and V thirds land on
  their own grids), its out-projection, and the two feed-forward linears;
* the masker's bottleneck 1x1 conv, its mask-head Conv2d (a dense layer over
  channels-last segments) and its end 1x1 conv (ReLU in the epilogue).

At 8 x 4 s with the config's 8 layers that is 131 launches a forward.

It stays in float (float32, or bf16 operands with float32 sums), with
weights folded on the host, where the JAX engine leaves it there (its lines
14-22): the attention products (the reference's attn/softmax quant sites
are no-ops, so the probabilities lie on no grid; putting them on K8 is later
work), the norms, the encoder and decoder convolutions and the combiner's
residual block, and the mask head's gate convs, whose input is the
merge_segments sum, off every 8-bit grid.

Activations between stages are channels-last, as the JAX engine carries
them. The host constants are numpy float32 with the JAX package's
expressions (``serve/common.py``). ``compute_dtype`` sets the operands of
the float products as in :mod:`fqss_tpu_torch.serve.convtasnet_int8`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from fqss_tpu_torch.models.dptnet import merge_segments, split_segments
from fqss_tpu_torch.models.sepformer import EPS, EPS_T, Sepformer, sinusoidal_pe
from fqss_tpu_torch.separation.splitter import postprocess, preprocess
from fqss_tpu_torch.serve.common import (
    Grid,
    Int8Site,
    Int8Weight,
    QAct,
    bf16_round,
    check_8bit_spec,
    conv1d,
    conv_transpose1d,
    dequant_weight,
    gn1,
    int8_weight,
    layer_norm,
    prelu,
    quantizer_grid,
    requant,
)

Tensor = torch.Tensor

PE_LEN = 2500  # the TransformerBlocks' positional-encoding table (models/sepformer.py)


class SepformerInt8Engine:
    """Int8 inference engine built from a calibrated port ``Sepformer``.

    Usage::

        engine = SepformerInt8Engine(model)   # host-side preparation, once
        y = engine(x)                         # [B, T] -> [B, S, T] on the model's device
    """

    def __init__(self, model: Sepformer, compute_dtype: str = "bfloat16"):
        q = model.q
        if q.n_combiner > 2:
            raise NotImplementedError("combiner chains beyond 2 planes (matches the reference configs)")
        check_8bit_spec(q)
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', got {compute_dtype!r}")
        self.q, self.n_srcs, self.n_filters, self.n_heads = q, model.n_srcs, model.n_filters, model.n_heads
        self.stride = model.encoder.conv.stride
        self.bf16 = compute_dtype == "bfloat16"
        dev = next(model.parameters()).device
        bits = q.weight_n_bits
        self.pe = torch.from_numpy(sinusoidal_pe(PE_LEN, model.n_filters)).to(dev)
        self.sqrt_d = torch.full((1,), math.sqrt(model.n_filters // model.n_heads), device=dev)

        def float_weight(weight, wq) -> Tensor:
            w = torch.from_numpy(dequant_weight(weight, wq.min_range, wq.max_range, bits)).to(dev)
            return bf16_round(w) if self.bf16 else w

        def vec(p) -> Tensor | None:
            return None if p is None else p.detach().to(dev, torch.float32).clone()

        def norm(layer) -> tuple[Tensor, Tensor]:
            return vec(layer.norm.weight), vec(layer.norm.bias)

        def weight8(layer, name: str = "weight", wq_name: str = "weight_fake_quantize", bias=None) -> Int8Weight:
            wq = getattr(layer, wq_name)
            return int8_weight(getattr(layer, name), wq.min_range, wq.max_range, bias, bits)

        def site(g_in: Grid, layer, alpha: float = 1.0) -> Int8Site:
            return Int8Site(g_in, weight8(layer, bias=layer.bias), quantizer_grid(layer.activation_fake_quantize),
                            alpha, dev)

        def transformer_layer(layer) -> dict:
            mha = layer.mha
            g_n1, g_n2 = (quantizer_grid(n.activation_fake_quantize) for n in (layer.norm1, layer.norm2))
            g_head = quantizer_grid(mha.activation_fake_quantize_head)
            g_relu = quantizer_grid(layer.ffn_relu.activation_fake_quantize)
            return {
                "n1": norm(layer.norm1), "g_n1": g_n1,
                # the full in-projection, its Q, K and V thirds requantized each to its own grid in one launch
                "in_site": Int8Site(g_n1, weight8(mha, "in_proj_weight", "weight_fake_quantize_in", mha.in_proj_bias),
                                    [quantizer_grid(getattr(mha, f"activation_fake_quantize_{s}")) for s in "qkv"],
                                    1.0, dev),
                "g_div": quantizer_grid(mha.activation_fake_quantize_div),
                "g_head": g_head,
                "out_site": Int8Site(g_head, weight8(mha, "out_proj_weight", "weight_fake_quantize_out",
                                                     mha.out_proj_bias),
                                     quantizer_grid(mha.activation_fake_quantize), 1.0, dev),
                "n2": norm(layer.norm2), "g_n2": g_n2,
                "ffn_in": site(g_n2, layer.ffn_in),
                "g_relu": g_relu,
                "ffn_out": site(g_relu, layer.ffn_out),
            }

        # encoder (float conv, ReLU)
        enc = model.encoder
        self.g_enc_in = quantizer_grid(enc.in_quantizer, q.in_act_n_bits) if enc.in_quantizer is not None else None
        self.enc_w = float_weight(enc.conv.weight, enc.conv.weight_fake_quantize)
        self.g_enc = quantizer_grid(enc.conv.activation_fake_quantize)

        # masker
        mk = model.masker
        self.chunk_size = mk.chunk_size
        self.norm, self.g_norm = norm(mk.norm), quantizer_grid(mk.norm.activation_fake_quantize)
        self.bn = site(self.g_norm, mk.conv1d)
        self.blocks = []
        for block in mk.blocks:
            entry = {}
            for side in ("intra", "inter"):
                tb = getattr(block, f"{side}_transformer_block")
                gn = getattr(block, f"{side}_norm")
                entry[side] = {
                    "g_pos_const": quantizer_grid(tb.pos_const.activation_fake_quantize),
                    "g_pos_add": quantizer_grid(tb.pos_add.activation_fake_quantize),
                    "layers": [transformer_layer(layer) for layer in tb.layers],
                    "n": norm(tb.norm), "g_n": quantizer_grid(tb.norm.activation_fake_quantize),
                }
                entry[f"{side}_norm"] = norm(gn)
                entry[f"g_{side}_norm"] = quantizer_grid(gn.activation_fake_quantize)
                entry[f"g_{side}_add"] = quantizer_grid(getattr(block, f"{side}_add").activation_fake_quantize)
            self.blocks.append(entry)
        self.prelu_alpha = float(mk.prelu.nl.alpha.detach().reshape(-1)[0])
        self.g_prelu = quantizer_grid(mk.prelu.activation_fake_quantize)
        self.conv2d = site(self.g_prelu, mk.conv2d)
        # gate convs: their input is the off-grid merge sum -> float, weights folded
        self.gates = [(float_weight(g.weight, g.weight_fake_quantize), vec(g.bias),
                       quantizer_grid(g.activation_fake_quantize)) for g in (mk.net_out, mk.net_gate)]
        self.g_masker_mul = quantizer_grid(mk.mul.activation_fake_quantize)
        self.end_conv = site(self.g_masker_mul, mk.end_conv, alpha=0.0)  # ReLU: PReLU with slope 0
        self.g_mul = quantizer_grid(model.mul.activation_fake_quantize)

        # decoder (+ combiner residual plane, with its own trained decoder under train_res_dec)
        dec = model.decoder
        self.dec_w = float_weight(dec.weight, dec.weight_fake_quantize)
        self.g_dec = quantizer_grid(dec.activation_fake_quantize, q.out_act_n_bits) if q.out_quant else None
        if q.n_combiner == 2:
            reb = dec.residual_error_block
            self.re_w = float_weight(reb.residual_encoder.weight, reb.residual_encoder.weight_fake_quantize)
            self.g_re = quantizer_grid(reb.activation_fake_quantize)
            self.res_dec_w = (float_weight(reb.residual_decoder_weight, reb.weight_fake_quantize_dec)
                              if reb.residual_decoder_weight is not None else self.dec_w)
            self.g_dec_res = (quantizer_grid(dec.activation_fake_quantize_residual, q.out_act_n_bits)
                              if q.out_quant else None)

    def __call__(self, x: Tensor) -> Tensor:
        with torch.no_grad():
            return self._forward(x)

    def _bmm(self, a: Tensor, b: Tensor) -> Tensor:
        """A float product: bf16 operands or float32, float32 sums."""
        return torch.matmul(bf16_round(a), bf16_round(b)) if self.bf16 else torch.matmul(a, b)

    # -- the layers -------------------------------------------------------------------------------------------

    def _mha(self, xn: QAct, L: dict) -> Tensor:
        """Quantized self-attention of ``xn [B', L, E]`` on norm1's grid; the out-projection's grid output."""
        Q, K, V = L["in_site"](xn)
        B_, Lq, E = Q.Xs.shape
        h = self.n_heads
        d = E // h

        def heads(t: Tensor) -> Tensor:
            return t.reshape(B_, Lq, h, d).transpose(1, 2)

        Qh = requant(heads(Q.f32) / self.sqrt_d, L["g_div"]).f32
        attn = torch.softmax(self._bmm(Qh, heads(K.f32).transpose(-1, -2)), dim=-1)
        y = self._bmm(attn, heads(V.f32)).transpose(1, 2).reshape(B_, Lq, E)
        return L["out_site"](requant(y, L["g_head"])).f32  # the head grid commutes with the head merge

    def _tlayer(self, x: Tensor, L: dict) -> Tensor:
        """TransformerLayer (models/sepformer.py); float32 in and out."""
        x = x + self._mha(requant(layer_norm(x, *L["n1"], EPS_T), L["g_n1"]), L)
        y = L["ffn_in"](requant(layer_norm(x, *L["n2"], EPS_T), L["g_n2"]))
        y = L["ffn_out"](requant(F.relu(y.f32), L["g_relu"]))
        return x + y.f32

    def _tblock(self, x: Tensor, tb: dict) -> Tensor:
        pe = requant(self.pe[None, : x.shape[1]], tb["g_pos_const"]).f32
        x = requant(x + pe, tb["g_pos_add"]).f32
        for L in tb["layers"]:
            x = self._tlayer(x, L)
        return requant(layer_norm(x, *tb["n"], EPS_T), tb["g_n"]).f32

    def _forward(self, x: Tensor) -> Tensor:
        q, spk, f = self.q, self.n_srcs, self.n_filters
        x = preprocess(x, n_splitter=q.n_splitter)  # [B, C', T]
        B = x.shape[0]
        if self.g_enc_in is not None:
            x = requant(x, self.g_enc_in).f32
        feats = requant(F.relu(conv1d(x, self.enc_w, stride=self.stride, bf16=self.bf16)).transpose(1, 2),
                        self.g_enc).f32  # [B, M, F]
        xc = self.bn(requant(gn1(feats, *self.norm, EPS), self.g_norm))

        segs, gap = split_segments(xc.f32, self.chunk_size)  # [B, K, S, F]
        b, k, s, _ = segs.shape
        h = segs
        for blk in self.blocks:
            intra = self._tblock(h.transpose(1, 2).reshape(b * s, k, f), blk["intra"])
            intra = intra.reshape(b, s, k, f).transpose(1, 2)
            intra = requant(gn1(intra, *blk["intra_norm"], EPS), blk["g_intra_norm"]).f32
            intra = requant(intra + h, blk["g_intra_add"]).f32
            inter = self._tblock(intra.reshape(b * k, s, f), blk["inter"]).reshape(b, k, s, f)
            inter = requant(gn1(inter, *blk["inter_norm"], EPS), blk["g_inter_norm"]).f32
            h = requant(inter + intra, blk["g_inter_add"]).f32

        y = self.conv2d(requant(prelu(h, self.prelu_alpha), self.g_prelu)).f32  # [B, K, S, spk * F]
        y = y.reshape(b, k, s, spk, f).permute(0, 3, 1, 2, 4).reshape(b * spk, k, s, f)
        y = merge_segments(y, gap, torch.add).transpose(1, 2)  # [B * spk, F, M], off every grid
        gated = []
        for (w, bias, g), nl in zip(self.gates, (torch.tanh, torch.sigmoid)):
            v = conv1d(y, w, bf16=self.bf16)
            gated.append(requant(nl(v + bias[:, None] if bias is not None else v), g).f32)
        y = requant((gated[0] * gated[1]).transpose(1, 2), self.g_masker_mul)  # [B * spk, M, F]
        mask = self.end_conv(y).f32.reshape(B, spk, -1, f)
        masked = requant(mask * feats[:, None], self.g_mul).f32.reshape(B * spk, -1, f).transpose(1, 2)

        x0 = conv_transpose1d(masked, self.dec_w, self.stride, bf16=self.bf16)  # [B * spk, 1, L]
        y0 = requant(x0, self.g_dec).f32 if self.g_dec is not None else x0
        planes = [y0]
        if q.n_combiner == 2:
            Y_q = conv1d(y0, self.re_w, stride=self.stride, bf16=self.bf16)
            Y1 = requant(masked - Y_q, self.g_re).f32
            res = conv_transpose1d(Y1, self.res_dec_w, self.stride, bf16=self.bf16)
            planes.append(requant(res, self.g_dec_res).f32 if self.g_dec_res is not None else res)
        out = torch.stack(planes).reshape(q.n_combiner, B, spk, 1, -1)
        return postprocess(out, n_combiner=q.n_combiner)
