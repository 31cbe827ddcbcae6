"""Input splitter / output combiner (``fqss_tpu/separation/splitter.py``).

The splitter carries the input waveform as ``n_splitter`` 8-bit streams: the
floor-quantized signal (MSB) followed by its quantization residual rescaled
to full range (LSB), recursively. The combiner rebuilds the output from
``n_combiner`` decoder planes as ``plane0 + sum_i plane_i * (0.5 * delta)^i``.
All scale factors are powers of two, so both are exact and equal the JAX
functions bit for bit.
"""

from __future__ import annotations

import torch

from fqss_tpu_torch.quant.fake_quant import splitter_quantize

Tensor = torch.Tensor


def preprocess(x: Tensor, n_splitter: int = 1, n_bits: int = 8, sign: bool = True) -> Tensor:
    """Split the input into MSB + residual streams (reference process.py:16-37).

    x: [B, T] or [B, C, T] -> [B, C * n_splitter, T]. The input is
    normalised by its max-abs over the whole tensor (batch included),
    faithful to the reference; the JAX function's ``normalize=False`` is not
    ported (no caller uses it).
    """
    if x.ndim == 2:
        x = x[:, None, :]
    if n_splitter <= 1:
        return x
    x = x / torch.maximum(x.min().abs(), x.max().abs())
    threshold = 1.0
    delta = threshold / (2 ** (n_bits - int(sign)))
    streams = []
    for _ in range(n_splitter):
        x_quant = splitter_quantize(x, threshold=threshold, n_bits=n_bits, sign=sign)
        streams.append(x_quant)
        # error = x - x_quant is in [0, delta); remap to [-threshold, threshold].
        x = 2.0 * (x - x_quant) * threshold / delta - threshold
    return torch.cat(streams, dim=1)


def postprocess(x: Tensor, n_combiner: int = 1, n_bits: int = 8, sign: bool = True) -> Tensor:
    """Recombine decoder output planes (reference process.py:39-52).

    x: [n_combiner, B, S, C, T] -> [B, S, T] (C == 1) or [B, S, C, T].
    """
    y = x[0]
    if n_combiner > 1:
        delta = 1.0 / (2 ** (n_bits - int(sign)))
        for i in range(1, n_combiner):
            y = y + x[i] * (0.5 * delta) ** i
    if y.ndim <= 4 and y.shape[-2] == 1:
        y = y.squeeze(-2)
    return y
