"""Automatic serving-path selection (``--engine auto``; ``fqss_tpu/serve/autopath.py``).

A table keyed on the model family names the serving engine that ran
fastest on the card, so that ``infer``/``val --engine auto`` serve each
family on it. The JAX package's table (``BEST_PATHS`` there) holds TPU
readings and QuantSpec overrides (bf16 compute, Pallas flags); this one
holds the port's engines as measured on an H100, and nothing of the TPU's.
It overrides no field of the spec: no family's bf16 engine is the faster
here, so a config in float32 is served in float32, and one that asks for
``compute_dtype: bfloat16`` gets it. ConvTasNet-music is the one family
whose int8 engine is the fastest (its gLNs reduce with whole-card kernels
there, where ``F.group_norm`` takes a block a row): ``auto`` serves it the
int8 engine, which is not bitwise the fake-quant forward but sits at that
forward's own noise floor (``chip_smoke.py`` phase 47).
"""

from __future__ import annotations

from torch import nn

from fqss_tpu_torch.serve.common import mulaw_output
from fqss_tpu_torch.serve.fold import fold_quantized_weights

# The fastest engine per family: chip_smoke.py's throughput phases 7 and 15 (ConvTasNet, 32 x 12 s), 23 (DPTNet,
# 8 x 4 s), 30 (Sepformer, 8 x 4 s) and 48 (ConvTasNet-music, 8 x 441,000 stereo samples), and phases 40-42 for the
# two engines in bf16 compute (compute_dtype "bfloat16", in turns with the float32 fake_quant forward, which read
# 581.3 / 243.4 / 180.0 ms there), ms per forward (CUDA events, 3 forwards after a warm-up) on an NVIDIA H100 80GB
# HBM3 at a 700 W power limit:
#                     fake_quant  folded  int8 f32  int8 bf16  fake_quant bf16  folded bf16
#   ConvTasNet             579.4   579.3     960.7      987.8            664.2        664.1
#   DPTNet                 243.8   246.9     368.7      415.7            286.5        286.5
#   Sepformer              180.1   179.9     245.2      267.3            202.1        201.9
#   ConvTasNetMusic       1959.2  1959.9    1358.1     1396.2           2011.0   not measured
# fake_quant and folded are one function (bitwise equal outputs). Folded launches no weight-grid kernel and is the
# faster by 0.2 ms or less for ConvTasNet and the Sepformer; DPTNet's folded forward is 3.1 ms slower, as in every
# reading so far: its LSTM projections run as other cuBLAS products (mm, not bmm) on the folded weights. The int8
# engines of the speech models are slower on this card: their requantization chains run as eager elementwise
# kernels (PERF.md section 5). ConvTasNet-music's is the faster by 0.6 s: its fake-quant forward spends 75% of its
# time in F.group_norm, which takes one block a row at its 8 rows, where the engine's gLN reduces with whole-card
# kernels.
# bf16 compute is slower for every family, so the table keeps float32 (JAX's table takes bf16 where its TPU ran it
# faster): ConvTasNet's convs stay cuDNN float32 on rounded operands, and K8's bf16 route takes three passes over
# the keys (PERF.md section 5).
# HTDemucs (phase 58, 8 x 343,980 stereo samples padded to 441,000): fake_quant 202.6, folded 202.3, int8 f32
# 214.6, int8 bf16 288.2 ms. Its int8 engine runs only the transformer's products as int8 (the conv branches stay the
# folded model's), and its requantization chains cost more than K4 saves there; bf16 adds K8's three-pass route.
BEST_PATHS: dict[str, str] = {"ConvTasNet": "folded", "DPTNet": "fake_quant", "Sepformer": "folded",
                              "ConvTasNetMusic": "int8", "HTDemucs": "folded"}
DEFAULT_PATH = "folded"  # a family the table does not name: the weight-folded fake-quant model
INT8_COMPUTE_DTYPE = "float32"  # the int8 path's float products: float32, the faster of the two on this card


def best_path(model: nn.Module) -> str:
    """The engine of ``model``'s family (by its class or a base class), or DEFAULT_PATH."""
    for cls in type(model).__mro__:
        if cls.__name__ in BEST_PATHS:
            return BEST_PATHS[cls.__name__]
    return DEFAULT_PATH


def auto_serving_model(model: nn.Module):
    """``model`` on its family's fastest path: the weight-folded copy (bitwise the fake-quant forward), the model
    itself where the table says fake_quant, or its int8 engine (float32 products) where the table says int8 and the
    engine serves the model (not a mu-law output grid: that one is served folded)."""
    path = best_path(model)
    if path == "int8" and mulaw_output(model.q):  # the int8 engines refuse a mu-law output grid
        path = DEFAULT_PATH
    if path == "fake_quant":
        return model
    if path == "int8":
        from fqss_tpu_torch.serve import make_int8_engine  # the package imports this module

        return make_int8_engine(model, compute_dtype=INT8_COMPUTE_DTYPE)
    return fold_quantized_weights(model)
