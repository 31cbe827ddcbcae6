"""Fold weight fake-quantization into the parameters for serving (``fqss_tpu/serve/fold.py``).

At inference the weight quantizers are pure functions of frozen (weight,
range) pairs, so their quant-dequant can run once at load instead of on
every forward. On CUDA the fold goes through the weight kernel, so the
folded weights are bitwise the values the fake-quant forward computes on
every call (K5 applies the same device function to a ``QDense`` weight,
and the folded ``QDense`` runs K5 with its weight grid off), and the two
engines give bitwise equal outputs.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
from torch import nn

from fqss_tpu_torch.ops.fake_quant import weight_fake_quant
from fqss_tpu_torch.quant.quantizers import WeightQuantizer, weight_quantizer_sites


def fold_quantized_weights(model: nn.Module) -> nn.Module:
    """A serving copy of ``model`` with the weight fake-quant applied once.

    Every (weight, WeightQuantizer) pair of every layer — ``weight`` and its
    ``weight_fake_quantize``, or the pairs a layer lists in
    ``WEIGHT_QUANTIZERS`` (the LSTM's ``w_ih``/``w_hh`` per direction, the
    attention's in- and out-projections, the Linear decoder's residual
    encoder) — gets the weight replaced by its per-channel symmetric grid
    values and the quantizer removed; the copy's spec has
    ``weight_quant=False``. Activation quantizers are untouched. ``model``
    itself is not changed. Raises if a WeightQuantizer is left unfolded.
    """
    q = model.q
    if not (q.qat and q.weight_quant):
        return model
    serving = copy.deepcopy(model)
    with torch.no_grad():
        for layer, quantizer_name, weight_name in weight_quantizer_sites(serving):
            wq, w = getattr(layer, quantizer_name), getattr(layer, weight_name)
            # the per-tensor kernel: the same device function as the grouped one, so the folded weights are
            # bitwise the fake-quant forward's
            w.copy_(weight_fake_quant(w, wq.min_range, wq.max_range, wq.n_bits, wq.ch_axis))
            setattr(layer, quantizer_name, None)
    left = [name for name, m in serving.named_modules() if isinstance(m, WeightQuantizer)]
    if left:
        raise ValueError(f"fold_quantized_weights: no weight is known for the quantizers {left}")
    serving.q = dataclasses.replace(q, weight_quant=False)
    return serving
