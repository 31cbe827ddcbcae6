"""Partial int8 serving engine for the FQSS HTDemucs (``fqss_tpu/serve/htdemucs_int8.py``).

HTDemucs's products fall in two kinds (htdemucsq.py:532-1242):

* the strided and 2-D convolutions of the two branches, whose inputs are
  not on an 8-bit grid at the conv (GroupNorm and DConv sums come between):
  they stay float (float32, or bf16 operands with float32 sums), with the
  weights folded once on the host (:func:`~fqss_tpu_torch.serve.fold.
  fold_quantized_weights`), bitwise the values the fake-quant forward uses;
* the products whose inputs come straight off a learned activation grid:
  the ``bottom_channels`` 1x1 channel samplers and every projection of the
  cross-domain transformer (the attention's in- and out-projections, the
  two FFN linears of each layer). These run as int8 products through K4
  (:class:`~fqss_tpu_torch.serve.common.Int8Site`: s8 x s8 -> s32,
  dequantization, nonlinearity and requantization in one launch): each
  in-projection one launch whose Q, K and V thirds land on their own grids
  (two where the keys are another branch's: Q, then K and V), the
  out-projection one, ``linear1`` one with the GELU in its epilogue,
  ``linear2`` one. At the config's 5 layers that is 44 launches a forward.

As the JAX engine does, the engine folds the model's weights and runs the
folded model's own forward for the conv branches (STFT, padding, CaC,
iSTFT), swapping only the transformer block through
``HTDemucs.transformer_override`` for the int8 dataflow below: the conv
branches are the fake-quant forward's math by construction. Between the
transformer's stages activations are channels-last and int8
(:class:`~fqss_tpu_torch.serve.common.QAct`). The attention core on the
grid values, which the JAX engine computes as two float products around a
softmax, is K8 (``fused_attention_packed`` with its grid off, then the head
grid), the same function, float32 or its bf16 route. The host constants are
numpy float32 with the JAX package's expressions (``serve/common.py``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from fqss_tpu_torch.models.htdemucs import EPS, HTDemucs, create_2d_sin_embedding, create_sin_embedding
from fqss_tpu_torch.ops.attention import fused_attention_packed
from fqss_tpu_torch.quant.spec import QuantSpec
from fqss_tpu_torch.serve.common import (
    Grid,
    Int8Site,
    QAct,
    check_8bit_spec,
    gn1,
    int8_weight,
    layer_norm,
    quantizer_grid,
    requant,
)
from fqss_tpu_torch.serve.fold import fold_quantized_weights

Tensor = torch.Tensor


def with_compute_dtype(model: torch.nn.Module, compute_dtype: str) -> torch.nn.Module:
    """``model`` with every layer's spec set to ``compute_dtype`` (in place): the operands of its products."""
    for m in model.modules():
        q = m.__dict__.get("q")
        if isinstance(q, QuantSpec):
            m.q = dataclasses.replace(q, compute_dtype=compute_dtype)
    return model


class HTDemucsInt8Engine:
    """Deployable partial-int8 engine built from a calibrated port ``HTDemucs``.

    Usage::

        engine = HTDemucsInt8Engine(model)     # host-side preparation, once
        y = engine(x, train=False)             # [B, C, T] -> [B, S, C, T] on the model's device

    ``compute_dtype`` sets the float products (the folded conv branches and the attention core): ``"float32"``, or
    ``"bfloat16"`` operands with float32 sums.
    """

    def __init__(self, model: HTDemucs, compute_dtype: str = "bfloat16"):
        q = model.q
        check_8bit_spec(q)
        if model.t_layers <= 0:
            raise NotImplementedError("HTDemucs without a transformer: use fold_quantized_weights")
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', got {compute_dtype!r}")
        self.bf16 = compute_dtype == "bfloat16"
        self.heads, self.bottom_channels = model.t_heads, model.bottom_channels
        dev = next(model.parameters()).device
        self.device = dev
        ct = model.crosstransformer
        self.sqrt_d = torch.full((1,), math.sqrt(ct.norm_in.norm.weight.shape[0] // model.t_heads), device=dev)

        self.P = {"norm_in": self._norm(ct.norm_in), "norm_in_t": self._norm(ct.norm_in_t)}
        self.G = {name: quantizer_grid(getattr(ct, name).activation_fake_quantize)
                  for name in ("const_pos_emb_2d", "norm_in", "add_x", "const_pos_emb", "norm_in_t", "add_xt")}
        self.layers = [(self._layer_pack(layer, idx % 2 == 1), self._layer_pack(layer_t, idx % 2 == 1))
                       for idx, (layer, layer_t) in enumerate(ct.layers)]
        if model.bottom_channels:
            for branch, suffix, enc in ((0, "", model.encoders[-1]), (1, "_t", model.tencoders[-1])):
                # the upsampler's input rides the last encoder's (rewrite GLU) grid, the downsampler's the last
                # transformer layer's output grid
                g_in = quantizer_grid(enc.rewrite.activation_fake_quantize)
                up = getattr(model, f"channel_upsampler{suffix}")
                down = getattr(model, f"channel_downsampler{suffix}")
                self.G[f"in_up{suffix}"] = g_in
                self.P[f"up{suffix}"] = self._site(g_in, up.weight, up.weight_fake_quantize, up.bias,
                                                   quantizer_grid(up.activation_fake_quantize))
                self.P[f"down{suffix}"] = self._site(self.layers[-1][branch]["g_out"], down.weight,
                                                     down.weight_fake_quantize, down.bias,
                                                     quantizer_grid(down.activation_fake_quantize))
        serving = with_compute_dtype(fold_quantized_weights(model), compute_dtype)
        serving.transformer_override = self._transformer
        self._serving_model = serving

    # -- host-side preparation ------------------------------------------------------------------------------------

    def _vec(self, p: Tensor | None) -> Tensor | None:
        return None if p is None else p.detach().to(self.device, torch.float32).clone()

    def _norm(self, layer) -> tuple[Tensor, Tensor]:
        return self._vec(layer.norm.weight), self._vec(layer.norm.bias)

    def _site(self, g_in: Grid, weight: Tensor, wq, bias: Tensor | None, g_out, nl: str = "prelu",
              rows: slice = slice(None)) -> Int8Site:
        """K4 on ``weight[rows]`` (its per-row grid), ``bias[rows]``; ``nl="prelu"`` at slope 1 is no
        nonlinearity."""
        w = int8_weight(weight[rows], wq.min_range[rows], wq.max_range[rows], None if bias is None else bias[rows],
                        wq.n_bits)
        return Int8Site(g_in, w, g_out, 1.0, self.device, nl)

    def _layer_pack(self, layer, cross: bool) -> dict:
        """One SelfAttnLayer / CrossAttnLayer (models/htdemucs.py): its norms, grids and K4 sites."""
        mha = layer.cross_attn if cross else layer.self_attn
        ffn_norm = layer.norm3 if cross else layer.norm2
        E = mha.embed_dim
        g_n1 = quantizer_grid(layer.norm1.activation_fake_quantize)
        g_qkv = [quantizer_grid(getattr(mha, f"activation_fake_quantize_{s}")) for s in "qkv"]
        w_in, wq_in, b_in = mha.in_proj_weight, mha.weight_fake_quantize_in, mha.in_proj_bias
        g_head = quantizer_grid(mha.activation_fake_quantize_head)
        g_nf = quantizer_grid(ffn_norm.activation_fake_quantize)
        g_lin1 = quantizer_grid(layer.linear1.activation_fake_quantize)
        lin1, lin2 = layer.linear1, layer.linear2
        L = {
            "n1": self._norm(layer.norm1), "g_n1": g_n1,
            "g_div": quantizer_grid(mha.activation_fake_quantize_div),
            "g_head": g_head,
            "out": self._site(g_head, mha.out_proj_weight, mha.weight_fake_quantize_out, mha.out_proj_bias,
                              quantizer_grid(mha.activation_fake_quantize)),
            "gamma_1": self._vec(layer.gamma_1.scale),
            "g_gamma_1": quantizer_grid(layer.gamma_1.mul.activation_fake_quantize),
            "g_add1": quantizer_grid(layer.add_norm1.activation_fake_quantize),
            "nf": self._norm(ffn_norm), "g_nf": g_nf,
            "lin1": self._site(g_nf, lin1.weight, lin1.weight_fake_quantize, lin1.bias, g_lin1, nl="gelu"),
            "lin2": self._site(g_lin1, lin2.weight, lin2.weight_fake_quantize, lin2.bias,
                               quantizer_grid(lin2.activation_fake_quantize)),
            "gamma_2": self._vec(layer.gamma_2.scale),
            "g_gamma_2": quantizer_grid(layer.gamma_2.mul.activation_fake_quantize),
            "g_add2": quantizer_grid(layer.add_norm2.activation_fake_quantize),
            "n_out": self._norm(layer.norm_out), "g_out": quantizer_grid(layer.norm_out.const.activation_fake_quantize),
        }
        if cross:
            g_n2 = quantizer_grid(layer.norm2.activation_fake_quantize)
            L["n2"], L["g_n2"] = self._norm(layer.norm2), g_n2
            L["q_site"] = self._site(g_n1, w_in, wq_in, b_in, g_qkv[0], rows=slice(0, E))
            L["kv_site"] = self._site(g_n2, w_in, wq_in, b_in, g_qkv[1:], rows=slice(E, 3 * E))
        else:
            L["qkv_site"] = self._site(g_n1, w_in, wq_in, b_in, g_qkv)
        return L

    # -- serving ----------------------------------------------------------------------------------------------------

    def __call__(self, x: Tensor, train: bool = True) -> Tensor:
        with torch.no_grad():
            return self._serving_model(x, train=train)

    def _mha(self, qa: QAct, ka: QAct | None, L: dict) -> Tensor:
        """Quantized attention on grid inputs ``[B, L, E]``, self (``ka`` None) or cross; the out-projection's grid
        values, float32."""
        if ka is None:
            Q, K, V = L["qkv_site"](qa)
        else:
            Q = L["q_site"](qa)
            K, V = L["kv_site"](ka)
        h = self.heads
        Qh = requant(Q.f32 / self.sqrt_d, L["g_div"]).f32.unflatten(-1, (h, -1))  # the div grid is per tensor
        heads = fused_attention_packed(Qh, K.f32.unflatten(-1, (h, -1)), V.f32.unflatten(-1, (h, -1)), quantize=False,
                                       bf16=self.bf16)
        return L["out"](requant(heads, L["g_head"])).f32  # the head grid commutes with the head merge

    def _ffn(self, x: Tensor, L: dict) -> Tensor:
        """norm -> linear1 + GELU -> linear2 -> LayerScale -> residual add."""
        y = L["lin2"](L["lin1"](requant(layer_norm(x, *L["nf"], EPS), L["g_nf"]))).f32
        y = requant(y * L["gamma_2"], L["g_gamma_2"]).f32
        return requant(x + y, L["g_add2"]).f32

    def _layer(self, x: QAct, k: QAct | None, L: dict) -> QAct:
        """SelfAttnLayer (``k`` None) / CrossAttnLayer."""
        xf = x.f32
        hq = requant(layer_norm(xf, *L["n1"], EPS), L["g_n1"])
        hk = None if k is None else requant(layer_norm(k.f32, *L["n2"], EPS), L["g_n2"])
        h = requant(self._mha(hq, hk, L) * L["gamma_1"], L["g_gamma_1"]).f32
        y = self._ffn(requant(xf + h, L["g_add1"]).f32, L)
        return requant(gn1(y, *L["n_out"], EPS), L["g_out"])

    def _transformer(self, x: Tensor, xt: Tensor) -> tuple[Tensor, Tensor]:
        """The override: ``x [B, C, Fr, T1]``, ``xt [B, C, T2]`` -> the same shapes, computed channels-last."""
        P, G = self.P, self.G
        x = x.permute(0, 2, 3, 1)  # JAX's [B, Fr, T1, C]
        xt = xt.transpose(1, 2)  # [B, T2, C]
        b, fr, t1, c_in = x.shape
        if self.bottom_channels:
            x = P["up"](requant(x.reshape(b, fr * t1, c_in), G["in_up"])).f32.reshape(b, fr, t1, -1)
            xt = P["up_t"](requant(xt, G["in_up_t"])).f32
        c = x.shape[-1]
        dev = x.device
        pos2d = create_2d_sin_embedding(c, fr, t1).transpose(0, 3, 2, 1).reshape(1, t1 * fr, c)
        pos2d = requant(torch.from_numpy(np.ascontiguousarray(pos2d)).to(dev), G["const_pos_emb_2d"]).f32
        xs = x.transpose(1, 2).reshape(b, t1 * fr, c)  # (t1 fr) tokens
        xs = requant(layer_norm(xs, *P["norm_in"], EPS), G["norm_in"]).f32
        xs = requant(xs + pos2d, G["add_x"])
        pos = np.ascontiguousarray(create_sin_embedding(xt.shape[1], c).transpose(1, 0, 2))
        pos = requant(torch.from_numpy(pos).to(dev), G["const_pos_emb"]).f32
        xts = requant(layer_norm(xt, *P["norm_in_t"], EPS), G["norm_in_t"]).f32
        xts = requant(xts + pos, G["add_xt"])

        for Lx, Lt in self.layers:
            if "qkv_site" in Lx:
                xs, xts = self._layer(xs, None, Lx), self._layer(xts, None, Lt)
            else:
                xs, xts = self._layer(xs, xts, Lx), self._layer(xts, xs, Lt)

        if self.bottom_channels:
            x_out = P["down"](xs).f32.reshape(b, t1, fr, c_in)
            xt_out = P["down_t"](xts).f32
        else:
            x_out = xs.f32.reshape(b, t1, fr, c)
            xt_out = xts.f32
        return x_out.permute(0, 3, 2, 1).contiguous(), xt_out.transpose(1, 2).contiguous()
