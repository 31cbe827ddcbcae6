"""Quantized multi-head attention (``fqss_tpu/nn/attention.py``).

MultiheadAttentionQ (reference: quantization/qat/qat_layers.py:865-990),
with its quant points where the reference has them: each of Q/K/V goes
through the FULL in-projection (3E outputs), which is fake-quantized before
its third is taken; ``q / sqrt(d)`` is quantized; the merged heads and the
out-projection are quantized. The attention logits and the softmax have
quantizer sites that are no-ops in the reference (``attn - ...`` for
``attn = ...``, qat_layers.py:934,936); ``fix_attn_quant=True`` applies them.

The core ``softmax(q k^T) v`` and the head quantizer go through
:func:`fqss_tpu_torch.ops.attention.fused_attention_packed` (K8; its plain
version on the CPU) wherever that computes the module's function, as JAX's
``QuantSpec.pallas_attn`` routes them through its Pallas kernel, but for
every shape: K8 takes DPTNet's ``d = 16`` heads and short sequences, which
JAX's TPU gate keeps off its kernel. The routes:

* no head quantizer (the float teacher): K8 with the grid off;
* a linear or MSE head quantizer without an observer (serving): K8 with
  the head grid in its epilogue, the range read on the device (without an
  observer the MSE quantizer is the linear grid of its ranges);
* a head quantizer with an observer: K8 with the grid off, then the
  quantizer module, which keeps its EMA window or its histogram and returns
  the heads unquantized until the window closes or the MSE calibration
  (JAX's default path; JAX's Pallas branch takes only the linear quantizer,
  and would apply the grid inside the window too);
* ``fix_attn_quant=True``: the plain composition, since the logits and the
  softmax are then quantized, which is not K8's function (as in JAX).

The no-op sites still feed their observers in ``train()`` mode, as the JAX
module evaluates them and discards the result: the logits and the softmax
are then computed for them alone. Where such a quantizer would write
nothing (``eval()`` mode, or no observer) it is not called at all.

Layout: batch-first ``[B, L, E]``; weights in torch's layout,
``in_proj_weight [3E, E]`` and ``out_proj_weight [E, E]``, quantized per
out-channel (axis 0). The heads reach K8 as ``[B, L, h, d]`` views of the
in-projection's output (:func:`~fqss_tpu_torch.ops.attention.fused_attention_packed`),
and K8 writes them back as ``[B, Lq, E]`` for the out-projection: no copy of
the head layout is made on that route. The plain composition of
``fix_attn_quant`` and the no-op sites' logits take the contiguous
``[B * h, L, d]`` copies, as JAX's head layout.

The in- and out-projections are K5's core on the card (:func:`~fqss_tpu_torch.ops.qat_dense.qat_dense` with both
grids off and the bias in the epilogue, its bf16 route under bf16), which computes each output row the same whatever
the number of rows: a data-parallel rank's rows are bitwise one process's. The CPU takes ``torch.matmul``.

Under tensor parallelism (``parallel/tp.py``, ``tp`` set by :func:`~fqss_tpu_torch.parallel.tp.shard_model_tp`) the
module holds its ``h / tp`` heads: the in-projection's q, k and v rows of those heads (column-parallel, its inputs
through :func:`~fqss_tpu_torch.parallel.tp.copy_to_tp`), K8 on them, and the out-projection's columns of them
(row-parallel: the product without its bias, summed over tp by
:func:`~fqss_tpu_torch.parallel.tp.reduce_from_tp`, then the bias and the output grid).

Under bf16 compute the module rounds where JAX's default path rounds
(``fqss_tpu/nn/attention.py:68-70, 117, 128, 134``): the in- and
out-projections' operands (:func:`~fqss_tpu_torch.nn.layers.mxu_operands`),
the core through K8's bf16 route (Q and K rounded, the softmax normalised
and then rounded, V rounded), and the same roundings in the plain
composition of ``fix_attn_quant`` and in the no-op sites' logits.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from fqss_tpu_torch.nn.layers import make_act_quantizer, make_weight_quantizer, mxu_operands, uniform_
from fqss_tpu_torch.ops.attention import fused_attention_packed, head_layout, softmax_ref
from fqss_tpu_torch.ops.qat_dense import qat_dense
from fqss_tpu_torch.parallel import tp
from fqss_tpu_torch.quant.quantizers import writes
from fqss_tpu_torch.quant.spec import FLOAT, QuantSpec

Tensor = torch.Tensor


class QMultiheadAttention(nn.Module):
    """[B, Lq, E] x [B, Lk, E] x [B, Lk, E] -> [B, Lq, E]."""

    WEIGHT_QUANTIZERS = {"weight_fake_quantize_in": "in_proj_weight", "weight_fake_quantize_out": "out_proj_weight"}
    TP_LAYER = "attention"

    def __init__(self, embed_dim: int, num_heads: int, q: QuantSpec = FLOAT, fix_attn_quant: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        E = embed_dim
        self.q, self.embed_dim, self.num_heads, self.fix_attn_quant = q, E, num_heads, fix_attn_quant
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
        self.tp: tp.Shard | None = None

    def _project(self, x: Tensor, w: Tensor, b: Tensor | None) -> Tensor:
        """``x [..., K] @ w [N, K]^T`` (``+ b``): K5's core on the card, both grids off (a missing bias is a zero
        one), whose rows do not depend on how many there are; ``torch.matmul`` on the CPU."""
        if not x.is_cuda:
            xc, wc = mxu_operands(self.q, x, w)
            y = torch.matmul(xc, wc.t())
            return y if b is None else y + b
        if b is None:
            b = torch.zeros(w.shape[0], device=x.device)
        y = qat_dense(x.reshape(-1, x.shape[-1]).contiguous(), w, b, bf16=self.q.bf16)
        return y.reshape(*x.shape[:-1], w.shape[0])

    def _feed_noop_sites(self, q: Tensor, k: Tensor) -> None:
        """The reference's no-op attn/softmax sites: evaluated for their observers in ``train()`` mode, the
        results discarded; skipped where they would write nothing."""
        qa, qs = self.activation_fake_quantize_attn, self.activation_fake_quantize_softmax
        if not (writes(self) and any(s is not None and s.observer for s in (qa, qs))):
            return
        with torch.no_grad():
            Qc, Kc = mxu_operands(self.q, head_layout(q), head_layout(k))
            attn = torch.matmul(Qc, Kc.transpose(-1, -2))
            if qa is not None and qa.observer:
                qa(attn)
            if qs is not None and qs.observer:
                qs(self._softmax(attn))

    def _softmax(self, attn: Tensor) -> Tensor:
        """The softmax over the keys; under bf16 with ``jax.nn.softmax``'s arithmetic, whose result is rounded
        next."""
        return softmax_ref(attn) if self.q.bf16 else torch.softmax(attn, dim=-1)

    def _core(self, q: Tensor, k: Tensor, v: Tensor) -> Tensor:
        """The quantized heads ``[B, Lq, E]`` of the ``[B, L, h, d]`` views through K8 (module docstring)."""
        hq, bf16 = self.activation_fake_quantize_head, self.q.bf16
        if hq is None:
            return fused_attention_packed(q, k, v, quantize=False, bf16=bf16)
        if not hq.observer and not hq.scale_grad:
            return fused_attention_packed(q, k, v, hq.min_range, hq.max_range, hq.n_bits, quantize=True, bf16=bf16)
        return hq(fused_attention_packed(q, k, v, quantize=False, bf16=bf16))  # per tensor: the layout does not matter

    def _plain_fixed(self, q: Tensor, k: Tensor, v: Tensor) -> Tensor:
        """``fix_attn_quant``: the logits and the softmax quantized, then the heads ``[B * h, Lq, d]``."""
        qa, qs, hq = (self.activation_fake_quantize_attn, self.activation_fake_quantize_softmax,
                      self.activation_fake_quantize_head)
        Qh, Kh = mxu_operands(self.q, head_layout(q), head_layout(k))
        attn = torch.matmul(Qh, Kh.transpose(-1, -2))
        attn = self._softmax(qa(attn) if qa is not None else attn)
        Ac, Vh = mxu_operands(self.q, qs(attn) if qs is not None else attn, head_layout(v))
        heads = torch.matmul(Ac, Vh)
        return hq(heads) if hq is not None else heads

    def forward(self, query: Tensor, key: Tensor, value: Tensor) -> Tensor:
        shard = self.tp
        parts = 1 if shard is None else shard.size
        E, h = self.embed_dim // parts, self.num_heads // parts  # this rank's share of the heads
        d = self.embed_dim // self.num_heads
        B, Lq, _ = query.shape
        w_in, w_out = self.in_proj_weight, self.out_proj_weight
        if self.weight_fake_quantize_in is not None:
            w_in, w_out = self.weight_fake_quantize_in(w_in), self.weight_fake_quantize_out(w_out)
        self_key, self_value = key is query, value is key
        if shard is not None:  # the column-parallel in-projection's inputs
            query = tp.copy_to_tp(query, shard)
            key = query if self_key else tp.copy_to_tp(key, shard)
            value = key if self_value else tp.copy_to_tp(value, shard)

        # The full in-projection of each input (self-attention computes the one product once).
        Xq = self._project(query, w_in, self.in_proj_bias)
        Xk = Xq if self_key else self._project(key, w_in, self.in_proj_bias)
        Xv = Xk if self_value else self._project(value, w_in, self.in_proj_bias)
        if self.activation_fake_quantize_q is not None:
            Xq = self.activation_fake_quantize_q(Xq)
            Xk = self.activation_fake_quantize_k(Xk)
            Xv = self.activation_fake_quantize_v(Xv)
        # IEEE division by a one-element tensor: on CUDA PyTorch divides by a Python number through its
        # reciprocal. The per-tensor quantizer gives the same values in [B, L, E] as in JAX's head layout.
        Q = Xq[..., :E] / torch.full((1,), math.sqrt(d), device=Xq.device)
        if self.activation_fake_quantize_div is not None:
            Q = self.activation_fake_quantize_div(Q)
        # [B, L, E] -> [B, L, h, d] views: Q's, and the K and V thirds of the in-projections
        q = Q.unflatten(-1, (h, d))
        k = Xk[..., E : 2 * E].unflatten(-1, (h, d))
        v = Xv[..., 2 * E :].unflatten(-1, (h, d))
        if self.fix_attn_quant:
            heads = self._plain_fixed(q, k, v).reshape(B, h, Lq, d).transpose(1, 2).reshape(B, Lq, E)
        else:
            self._feed_noop_sites(q, k)
            heads = self._core(q, k, v)
        if shard is None:
            y = self._project(heads, w_out, self.out_proj_bias)
        else:  # row-parallel: the partial products summed over tp, then the bias
            y = tp.reduce_from_tp(self._project(heads, w_out, None), shard) + self.out_proj_bias
        return self.activation_fake_quantize(y) if self.activation_fake_quantize is not None else y
