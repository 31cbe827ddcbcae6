"""Fold weight fake-quantization into the parameters for serving (``fqss_tpu/serve/fold.py``).

At inference the weight quantizers are pure functions of frozen (weight,
range) pairs, so their quant-dequant can run once at load instead of on
every forward. On CUDA the fold goes through the weight kernel, so the
folded weights are bitwise the values the fake-quant forward computes on
every call, and the two engines give bitwise equal outputs.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
from torch import nn

from fqss_tpu_torch.ops.fake_quant import weight_fake_quant
from fqss_tpu_torch.quant.quantizers import WeightQuantizer


def fold_quantized_weights(model: nn.Module) -> nn.Module:
    """A serving copy of ``model`` with the weight fake-quant applied once.

    Every layer whose ``weight_fake_quantize`` is a WeightQuantizer gets its
    ``weight`` replaced by the per-channel symmetric grid values and loses
    the quantizer; the copy's spec has ``weight_quant=False``. Activation
    quantizers are untouched. ``model`` itself is not changed.
    """
    q = model.q
    if not (q.qat and q.weight_quant):
        return model
    serving = copy.deepcopy(model)
    with torch.no_grad():
        for layer in serving.modules():
            wq = getattr(layer, "weight_fake_quantize", None)
            if isinstance(wq, WeightQuantizer):
                layer.weight.copy_(weight_fake_quant(layer.weight, wq.min_range, wq.max_range, wq.n_bits, wq.ch_axis))
                layer.weight_fake_quantize = None
    serving.q = dataclasses.replace(q, weight_quant=False)
    return serving
