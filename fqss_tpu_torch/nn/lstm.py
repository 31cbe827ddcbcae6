"""Quantized LSTM (``fqss_tpu/nn/lstm.py``): the fused, static and dynamic modes.

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

The ``static`` and ``dynamic`` modes (LSTMQ_static / LSTMQ_dynamic,
qat_layers.py:616-862) put 12 quantizer sites per direction inside the cell
(:data:`~fqss_tpu_torch.ops.lstm.SITES`), where ``q.qat`` and ``q.act_quant``
hold; otherwise the cell has no sites and the mode runs as ``fused``, as in
JAX (a float model always does). ``static``: each direction learns its sites'
ranges, ``site_min``/``site_max`` ``[12]`` (init -0.5/0.5; parameters, with a
gradient where ``gradient_based``), and counts its observed steps in
``site_n_iter``. With ``q.observer`` on, the first 50 steps it sees are float,
each moving the ranges by ``0.9 r + 0.1`` the step's min or max; a call then
quantizes its later steps on the moved ranges. The ranges and the count are
kept in ``train()`` mode only, as JAX writes its mutable collections. The
cell is the LSTM kernel's static route (:func:`~fqss_tpu_torch.ops.lstm.bilstm_static_sequence`):
one launch, two in a call inside the window. The host reads the count to
split the call, where the observer is on (a wait for the card; serving
turns the observer off). ``dynamic``: every site on the grid
of its own min and max at every step (``dynamic_act_quant``), a plain loop
on every device (:func:`~fqss_tpu_torch.ops.lstm.bilstm_dynamic_sequence`).
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
from fqss_tpu_torch.ops.lstm import (
    OBSERVE_STEPS,
    SITES,
    bilstm_dynamic_sequence,
    bilstm_sequence,
    bilstm_static_sequence,
    lstm_dynamic_sequence,
    lstm_sequence,
    lstm_static_sequence,
)
from fqss_tpu_torch.quant.spec import FLOAT, QuantSpec

Tensor = torch.Tensor


class _LSTMDirection(nn.Module):
    """One direction's parameters and weight quantizers (and the static cell's site ranges and count);
    :meth:`project` hoists its input projection."""

    WEIGHT_QUANTIZERS = {"wq_ih": "w_ih", "wq_hh": "w_hh"}

    def __init__(self, input_size: int, hidden_size: int, q: QuantSpec = FLOAT,
                 generator: torch.Generator | None = None, static: bool = False):
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
        if static:
            self.site_min = nn.Parameter(torch.full((len(SITES),), -0.5), requires_grad=q.gradient_based)
            self.site_max = nn.Parameter(torch.full((len(SITES),), 0.5), requires_grad=q.gradient_based)
            self.register_buffer("site_n_iter", torch.zeros((), dtype=torch.int32))

    def keep(self, site_min: Tensor, site_max: Tensor, steps: int) -> None:
        """The static cell's state after a call whose first ``steps`` were observed (``train()`` mode)."""
        with torch.no_grad():
            self.site_min.copy_(site_min)
            self.site_max.copy_(site_max)
            self.site_n_iter.add_(steps)

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
    """Quantized (bi)LSTM -> output act-quant (qat_layers.py:571-862). [B, T, C] -> [B, T, D*H].

    ``mode``: ``fused`` (LSTMQ), ``static`` or ``dynamic``; the cell takes its 12 sites only under ``q.qat`` and
    ``q.act_quant`` (``self.mode`` is then the mode given, else ``fused``)."""

    def __init__(self, input_size: int, hidden_size: int, bidirectional: bool = True, mode: str = "fused",
                 q: QuantSpec = FLOAT, generator: torch.Generator | None = None):
        super().__init__()
        if mode not in ("fused", "static", "dynamic"):
            raise ValueError(f"lstm_mode must be 'fused', 'static' or 'dynamic', got {mode!r}")
        self.q = q
        self.mode = mode if q.qat and q.act_quant else "fused"
        static = self.mode == "static"
        self.fw = _LSTMDirection(input_size, hidden_size, q, generator, static)
        self.bw = _LSTMDirection(input_size, hidden_size, q, generator, static) if bidirectional else None
        self.activation_fake_quantize = make_act_quantizer(q)

    def forward(self, x: Tensor) -> Tensor:
        ih_f, w_f = self.fw.project(x, reverse=False)
        if self.bw is None:
            y = self._one(ih_f, w_f).transpose(0, 1).contiguous()
        else:
            ih_b, w_b = self.bw.project(x, reverse=True)
            hs_f, hs_b = self._both(ih_f, ih_b, w_f, w_b)
            y = torch.cat([hs_f.transpose(0, 1), hs_b.flip(0).transpose(0, 1)], dim=-1)  # [B, T, 2H], contiguous
        return self.activation_fake_quantize(y) if self.activation_fake_quantize is not None else y

    def _window(self, d: _LSTMDirection, T: int) -> int:
        """The steps of a call of T that lie in ``d``'s observer window (read from the card: a wait, where the
        observer is on; serving turns it off)."""
        return max(0, min(T, OBSERVE_STEPS - int(d.site_n_iter))) if self.q.observer else 0

    def _static(self, d: _LSTMDirection, ih: Tensor, w: Tensor) -> Tensor:
        k = self._window(d, ih.shape[0])
        hs, mn, mx = lstm_static_sequence(ih, w, d.site_min, d.site_max, k, self.q.act_n_bits)
        if k and self.training:
            d.keep(mn, mx, k)
        return hs

    def _one(self, ih: Tensor, w: Tensor) -> Tensor:
        if self.mode == "static":
            return self._static(self.fw, ih, w)
        if self.mode == "dynamic":
            return lstm_dynamic_sequence(ih, w, self.q.act_n_bits)
        return lstm_sequence(ih, w)

    def _both(self, ih_f: Tensor, ih_b: Tensor, w_f: Tensor, w_b: Tensor) -> tuple[Tensor, Tensor]:
        if self.mode == "dynamic":
            return bilstm_dynamic_sequence(ih_f, ih_b, w_f, w_b, self.q.act_n_bits)
        if self.mode == "fused":
            return bilstm_sequence(ih_f, ih_b, w_f, w_b)
        k, k_b = self._window(self.fw, ih_f.shape[0]), self._window(self.bw, ih_b.shape[0])
        if k != k_b:  # the directions' windows differ (a state written apart): a launch each
            return self._static(self.fw, ih_f, w_f), self._static(self.bw, ih_b, w_b)
        hs_f, hs_b, sites_f, sites_b = bilstm_static_sequence(
            ih_f, ih_b, w_f, w_b, (self.fw.site_min, self.fw.site_max), (self.bw.site_min, self.bw.site_max), k,
            self.q.act_n_bits)
        if k and self.training:
            self.fw.keep(*sites_f, k)
            self.bw.keep(*sites_b, k)
        return hs_f, hs_b
