"""Automatic serving-path selection (``--engine auto``; ``fqss_tpu/serve/autopath.py``).

A table keyed on the model family names the serving engine that ran
fastest on the card, so that ``infer``/``val --engine auto`` serve each
family on it. The JAX package's table (``BEST_PATHS`` there) holds TPU
readings and QuantSpec overrides (bf16 compute, Pallas flags); this one
holds the port's engines as measured on an H100, and nothing of the TPU's.
It overrides no field of the spec: no family's bf16 engine is the faster
here, so a config in float32 is served in float32, and one that asks for
``compute_dtype: bfloat16`` gets it.
"""

from __future__ import annotations

from torch import nn

from fqss_tpu_torch.serve.fold import fold_quantized_weights

# The fastest engine per family: chip_smoke.py's throughput phases 7 and 15 (ConvTasNet, 32 x 12 s), 23 (DPTNet,
# 8 x 4 s) and 30 (Sepformer, 8 x 4 s), and phases 40-42 for the two engines in bf16 compute (compute_dtype
# "bfloat16", in turns with the float32 fake_quant forward, which read 581.3 / 243.4 / 180.0 ms there), ms per
# forward (CUDA events, 3 forwards after a warm-up) on an NVIDIA H100 80GB HBM3 at a 700 W power limit:
#                fake_quant  folded  int8 f32  int8 bf16  fake_quant bf16  folded bf16
#   ConvTasNet        579.4   579.3     960.7      987.8            664.2        664.1
#   DPTNet            243.8   246.9     368.7      415.7            286.5        286.5
#   Sepformer         180.1   179.9     245.2      267.3            202.1        201.9
# fake_quant and folded are one function (bitwise equal outputs). Folded launches no weight-grid kernel and is the
# faster by 0.2 ms or less for ConvTasNet and the Sepformer; DPTNet's folded forward is 3.1 ms slower, as in every
# reading so far: its LSTM projections run as other cuBLAS products (mm, not bmm) on the folded weights. Every int8
# engine is slower on this card: its requantization chains run as eager elementwise kernels (PERF.md section 5).
# bf16 compute is slower for every family, so the table keeps float32 (JAX's table takes bf16 where its TPU ran it
# faster): ConvTasNet's convs stay cuDNN float32 on rounded operands, and K8's bf16 route takes three passes over
# the keys (PERF.md section 5).
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
