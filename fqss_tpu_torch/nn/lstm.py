"""Quantized LSTM (``fqss_tpu/nn/lstm.py``), fused mode.

``QLSTM`` is LSTMQ (reference: quantization/qat/qat_layers.py:571-613): each
direction's weight matrices are fake-quantized per channel, the recurrence
runs in float, and the output is fake-quantized. The input projection
``x @ W_ih + b_ih + b_hh`` of every step is hoisted out of the recurrence
into one ``torch.matmul`` (a plain product, which the JAX package leaves to
XLA); the recurrence itself is the LSTM kernel of
:mod:`fqss_tpu_torch.ops.lstm`: both directions of a bidirectional LSTM in
one launch (``bilstm_sequence``, K7), one direction through
``lstm_sequence`` (K6). The reverse direction runs on the time-flipped
input and its output is flipped back, as in JAX.

Gate order is torch's (i, f, g, o). Input/output ``[B, T, C]``
(batch-first); the bidirectional output is ``[fwd ; bwd]`` on features.
Weights keep the JAX layout, ``w_ih [C, 4H]`` and ``w_hh [H, 4H]``, quantized
per gate column (axis 1), which is the layout the kernel reads.

The ``static`` and ``dynamic`` modes (12 quantizer sites per direction
inside the cell) are not ported yet and raise ``NotImplementedError``;
``fuse_bidir`` is not ported (the kernel covers that case).

Under bf16 compute the input projection's operands are rounded
(``fqss_tpu/nn/lstm.py:102``); the bias adds and the recurrence stay
float32, as JAX's LSTM kernel casts ``ih`` and ``w_hh`` to float32.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from fqss_tpu_torch.nn.layers import make_act_quantizer, make_weight_quantizer, mxu_operands, uniform_
from fqss_tpu_torch.ops.lstm import bilstm_sequence, lstm_sequence
from fqss_tpu_torch.quant.spec import FLOAT, QuantSpec

Tensor = torch.Tensor


class _LSTMDirection(nn.Module):
    """One direction's parameters and weight quantizers; :meth:`project` hoists its input projection."""

    WEIGHT_QUANTIZERS = {"wq_ih": "w_ih", "wq_hh": "w_hh"}

    def __init__(self, input_size: int, hidden_size: int, q: QuantSpec = FLOAT,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.q = q
        G = 4 * hidden_size
        bound = 1.0 / math.sqrt(hidden_size)
        self.w_ih = nn.Parameter(uniform_(torch.empty(input_size, G), bound, generator))
        self.w_hh = nn.Parameter(uniform_(torch.empty(hidden_size, G), bound, generator))
        self.b_ih = nn.Parameter(uniform_(torch.empty(G), bound, generator))
        self.b_hh = nn.Parameter(uniform_(torch.empty(G), bound, generator))
        self.wq_ih = make_weight_quantizer(q, (input_size, G), ch_axis=1)
        self.wq_hh = make_weight_quantizer(q, (hidden_size, G), ch_axis=1)

    def project(self, x: Tensor, reverse: bool) -> tuple[Tensor, Tensor]:
        """``x [B, T, C]`` -> (``ih [T, B, 4H]`` in this direction's scan order, quantized ``w_hh``)."""
        w_ih, w_hh = self.w_ih, self.w_hh
        if self.wq_ih is not None:
            w_ih, w_hh = self.wq_ih(w_ih), self.wq_hh(w_hh)
        xs = x.transpose(0, 1)  # time-major
        if reverse:
            xs = xs.flip(0)
        ih = torch.matmul(*mxu_operands(self.q, xs, w_ih))
        # in place: the two bias adds of ih_all = x @ W_ih + b_ih + b_hh, in JAX's order, without two more
        # copies of the largest tensor of the layer
        return ih.add_(self.b_ih).add_(self.b_hh), w_hh.contiguous()


class QLSTM(nn.Module):
    """Quantized (bi)LSTM -> output act-quant (qat_layers.py:571-613), fused mode. [B, T, C] -> [B, T, D*H]."""

    def __init__(self, input_size: int, hidden_size: int, bidirectional: bool = True, mode: str = "fused",
                 q: QuantSpec = FLOAT, generator: torch.Generator | None = None):
        super().__init__()
        mode = mode if q.qat else "fused"
        if mode != "fused":
            raise NotImplementedError(f"lstm_mode={mode!r} is not ported yet; only 'fused' (ROADMAP.md, queue 1)")
        self.fw = _LSTMDirection(input_size, hidden_size, q, generator)
        self.bw = _LSTMDirection(input_size, hidden_size, q, generator) if bidirectional else None
        self.activation_fake_quantize = make_act_quantizer(q)

    def forward(self, x: Tensor) -> Tensor:
        ih_f, w_f = self.fw.project(x, reverse=False)
        if self.bw is None:
            y = lstm_sequence(ih_f, w_f).transpose(0, 1).contiguous()
        else:
            ih_b, w_b = self.bw.project(x, reverse=True)
            hs_f, hs_b = bilstm_sequence(ih_f, ih_b, w_f, w_b)
            y = torch.cat([hs_f.transpose(0, 1), hs_b.flip(0).transpose(0, 1)], dim=-1)  # [B, T, 2H], contiguous
        return self.activation_fake_quantize(y) if self.activation_fake_quantize is not None else y
