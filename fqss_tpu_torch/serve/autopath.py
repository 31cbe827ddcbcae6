"""Automatic serving-path selection (``--engine auto``; ``fqss_tpu/serve/autopath.py``).

A table keyed on the model family names the serving engine that ran
fastest on the card, so that ``infer``/``val --engine auto`` serve each
family on it. The JAX package's table (``BEST_PATHS`` there) holds TPU
readings and QuantSpec overrides (bf16 compute, Pallas flags); this one
holds the port's engines as measured on an H100, and nothing of the TPU's.
"""

from __future__ import annotations

from torch import nn

from fqss_tpu_torch.serve.fold import fold_quantized_weights

# The fastest engine per family: chip_smoke.py's throughput phases 7 and 15 (ConvTasNet, 32 x 12 s), 23 (DPTNet,
# 8 x 4 s) and 30 (Sepformer, 8 x 4 s), ms per forward (CUDA events, 3 forwards after a warm-up) on an NVIDIA
# H100 80GB HBM3 at a 700 W power limit:
#                fake_quant  folded  int8 f32  int8 bf16
#   ConvTasNet        578.9   578.4     973.6     1001.4
#   DPTNet            281.4   284.4     389.6      436.4
#   Sepformer         228.4   228.0     260.3      282.3
# fake_quant and folded are one function (bitwise equal outputs). Folded launches no weight-grid kernel and is the
# faster by 0.5 ms or less for ConvTasNet and the Sepformer; DPTNet's folded forward is 3.0 ms slower, as in every
# reading so far (283.5 against 286.5 ms before): its LSTM projections run as other cuBLAS products (mm, not bmm)
# on the folded weights. Every int8 engine is slower on this card: its requantization chains run as eager
# elementwise kernels (PERF.md section 5).
BEST_PATHS: dict[str, str] = {"ConvTasNet": "folded", "DPTNet": "fake_quant", "Sepformer": "folded"}
DEFAULT_PATH = "folded"  # a family the table does not name: the weight-folded fake-quant model


def best_path(model: nn.Module) -> str:
    """The engine of ``model``'s family (by its class or a base class), or DEFAULT_PATH."""
    for cls in type(model).__mro__:
        if cls.__name__ in BEST_PATHS:
            return BEST_PATHS[cls.__name__]
    return DEFAULT_PATH


def auto_serving_model(model: nn.Module) -> nn.Module:
    """``model`` on its family's fastest path: the weight-folded copy (bitwise the fake-quant forward) or, where
    the table says fake_quant, the model itself."""
    return model if best_path(model) == "fake_quant" else fold_quantized_weights(model)
