"""Quantized multi-head attention (``fqss_tpu/nn/attention.py``), the JAX package's non-Pallas path.

MultiheadAttentionQ (reference: quantization/qat/qat_layers.py:865-990),
with its quant points where the reference has them: each of Q/K/V goes
through the FULL in-projection (3E outputs), which is fake-quantized before
its third is taken; ``q / sqrt(d)`` is quantized; the merged heads and the
out-projection are quantized. The attention logits and the softmax have
quantizer sites that are no-ops in the reference (``attn - ...`` for
``attn = ...``, qat_layers.py:934,936); ``fix_attn_quant=True`` applies them.

The no-op sites still feed their observers in ``train()`` mode, as the JAX
module evaluates them and discards the result. Where such a quantizer would
write nothing (``eval()`` mode, or no observer) it is not called at all: its
result is thrown away, and at DPTNet's width each call would be a pass over
2 GB of logits.

JAX's gate sends DPTNet's heads (``d = 16``) to XLA, not to its fused Pallas
attention (``pallas_attention.supported``: ``32 <= d``), so the products
and the softmax here are plain PyTorch. Layout: batch-first ``[B, L, E]``;
weights in torch's layout, ``in_proj_weight [3E, E]`` and
``out_proj_weight [E, E]``, quantized per out-channel (axis 0).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from fqss_tpu_torch.nn.layers import make_act_quantizer, make_weight_quantizer, uniform_
from fqss_tpu_torch.quant.spec import FLOAT, QuantSpec

Tensor = torch.Tensor


class QMultiheadAttention(nn.Module):
    """[B, Lq, E] x [B, Lk, E] x [B, Lk, E] -> [B, Lq, E]."""

    WEIGHT_QUANTIZERS = {"weight_fake_quantize_in": "in_proj_weight", "weight_fake_quantize_out": "out_proj_weight"}

    def __init__(self, embed_dim: int, num_heads: int, q: QuantSpec = FLOAT, fix_attn_quant: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        E = embed_dim
        self.embed_dim, self.num_heads, self.fix_attn_quant = E, num_heads, fix_attn_quant
        bound = 1.0 / math.sqrt(E)
        self.in_proj_weight = nn.Parameter(uniform_(torch.empty(3 * E, E), bound, generator))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * E))
        self.out_proj_weight = nn.Parameter(uniform_(torch.empty(E, E), bound, generator))
        self.out_proj_bias = nn.Parameter(torch.zeros(E))
        self.weight_fake_quantize_in = make_weight_quantizer(q, (3 * E, E), ch_axis=0)
        self.weight_fake_quantize_out = make_weight_quantizer(q, (E, E), ch_axis=0)
        for site in ("q", "k", "v", "div", "attn", "softmax", "head"):
            setattr(self, f"activation_fake_quantize_{site}", make_act_quantizer(q))
        self.activation_fake_quantize = make_act_quantizer(q)

    def _site(self, quantizer, x: Tensor) -> Tensor:
        """An attn/softmax site: applied with ``fix_attn_quant``, else only fed to its observer."""
        if quantizer is None:
            return x
        if self.fix_attn_quant:
            return quantizer(x)
        if self.training and quantizer.observer:
            quantizer(x)  # the reference's no-op: evaluated for its observer, result discarded
        return x

    def forward(self, query: Tensor, key: Tensor, value: Tensor) -> Tensor:
        E, h = self.embed_dim, self.num_heads
        d = E // h
        B, Lq, _ = query.shape
        Lk = key.shape[1]
        w_in, w_out = self.in_proj_weight, self.out_proj_weight
        if self.weight_fake_quantize_in is not None:
            w_in, w_out = self.weight_fake_quantize_in(w_in), self.weight_fake_quantize_out(w_out)

        def in_proj(x: Tensor) -> Tensor:
            return torch.matmul(x, w_in.t()) + self.in_proj_bias

        # The full in-projection of each input (self-attention computes the one product once).
        Xq = in_proj(query)
        Xk = Xq if key is query else in_proj(key)
        Xv = Xk if value is key else in_proj(value)
        if self.activation_fake_quantize_q is not None:
            Xq = self.activation_fake_quantize_q(Xq)
            Xk = self.activation_fake_quantize_k(Xk)
            Xv = self.activation_fake_quantize_v(Xv)
        # IEEE division by a one-element tensor: on CUDA PyTorch divides by a Python number through its
        # reciprocal. The per-tensor quantizer gives the same values in [B, L, E] as in JAX's head layout.
        Q = Xq[..., :E] / torch.full((1,), math.sqrt(d), device=Xq.device)
        if self.activation_fake_quantize_div is not None:
            Q = self.activation_fake_quantize_div(Q)
        Qh = Q.reshape(B, Lq, h, d).transpose(1, 2)  # [B, h, Lq, d]
        Kh = Xk[..., E : 2 * E].reshape(B, Lk, h, d).transpose(1, 2)
        Vh = Xv[..., 2 * E :].reshape(B, Lk, h, d).transpose(1, 2)

        attn = self._site(self.activation_fake_quantize_attn, torch.matmul(Qh, Kh.transpose(-1, -2)))
        attn = self._site(self.activation_fake_quantize_softmax, torch.softmax(attn, dim=-1))
        heads = torch.matmul(attn, Vh)  # [B, h, Lq, d]
        if self.activation_fake_quantize_head is not None:
            heads = self.activation_fake_quantize_head(heads)
        y = torch.matmul(heads.transpose(1, 2).reshape(B, Lq, E), w_out.t()) + self.out_proj_bias
        return self.activation_fake_quantize(y) if self.activation_fake_quantize is not None else y
