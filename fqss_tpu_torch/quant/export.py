"""Deploy-grid export: learned quantizer ranges frozen to integer grids (``fqss_tpu/quant/export.py``).

The reference's torch-export wrappers (qat_quant.py:15-72, TorchWeightFakeQuantize / TorchActivationFakeQuantize,
and the replacers at qat_utils.py:334-351): after QAT each quantizer's (min, max) becomes the integer grid (scale,
zero point) that a deployment runtime takes. The frozen grids replay with
:func:`~fqss_tpu_torch.quant.fake_quant.torch_fake_quantize_per_tensor` and ``..._per_channel``.
"""

from __future__ import annotations

import numpy as np
from torch import nn

from fqss_tpu_torch.quant.quantizers import ActQuantizer, WeightQuantizer


def freeze_weight_grid(min_range, max_range, n_bits: int = 8, sign: bool = True) -> dict:
    """Per-channel symmetric grid (TorchWeightFakeQuantize, qat_quant.py:15-35)."""
    max_abs = np.maximum(np.abs(_numpy(min_range)), np.abs(_numpy(max_range)))
    scales = max_abs / (2 ** (n_bits - int(sign)))
    return {
        "scales": scales.reshape(-1).astype(np.float32),
        "zero_points": np.zeros(scales.size, np.int32),
        "quant_min": -(2 ** (n_bits - 1)) if sign else 0,
        "quant_max": 2 ** (n_bits - 1) - 1 if sign else 2**n_bits - 1,
        "kind": "per_channel",
    }


def freeze_activation_grid(min_range, max_range, n_bits: int = 8) -> dict:
    """Per-tensor asymmetric grid (TorchActivationFakeQuantize, qat_quant.py:38-53): ``zp = round(min / scale)``,
    negated where min < 0 (the reference's sign fix)."""
    mn = float(_numpy(min_range).reshape(-1)[0])
    mx = float(_numpy(max_range).reshape(-1)[0])
    scale = (mx - mn) / (2**n_bits - 1)
    zp = int(round(mn / scale)) if scale > 0 else 0
    zp = -zp if mn < 0 else zp
    return {
        "scale": np.float32(scale),
        "zero_point": np.int32(zp),
        "quant_min": 0,
        "quant_max": 2**n_bits - 1,
        "kind": "per_tensor",
    }


def export_quantizer_grids(model: nn.Module, weight_n_bits: int = 8, act_n_bits: int = 8) -> dict:
    """Every quantizer of ``model`` frozen to its grid, in a nested dict keyed by scope as the JAX package's
    ``qparams`` tree is: a weight quantizer's per-channel grid, a mu-law quantizer's ``{kind, min_range, max_range,
    mu, n_bits}``, an activation quantizer's per-tensor grid. The handoff artifact for an integer runtime."""
    grids: dict = {}
    for name, m in model.named_modules():
        if isinstance(m, WeightQuantizer):
            grid = freeze_weight_grid(m.min_range, m.max_range, weight_n_bits)
        elif isinstance(m, ActQuantizer) and m.kind == "mulaw":
            grid = {"kind": "mulaw", "min_range": np.float32(_numpy(m.min_range).reshape(-1)[0]),
                    "max_range": np.float32(_numpy(m.max_range).reshape(-1)[0]),
                    "mu": np.float32(_numpy(m.mu).reshape(-1)[0]), "n_bits": act_n_bits}
        elif isinstance(m, ActQuantizer):
            grid = freeze_activation_grid(m.min_range, m.max_range, act_n_bits)
        else:
            continue
        *scope, leaf = name.split(".")
        node = grids
        for part in scope:
            node = node.setdefault(part, {})
        node[leaf] = grid
    return grids


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
