"""Declarative quantization plan (mirror of ``fqss_tpu/quant/spec.py``).

The JAX package's ``QuantSpec`` cannot be imported here: its package
``__init__`` pulls in jax. This dataclass has the same fields and defaults,
so one YAML ``model_cfg.quantization`` dict drives both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Mirror of the YAML ``model_cfg.quantization`` schema.

    ``pallas_qat``, ``pallas_lstm`` and ``pallas_attn`` are accepted so that
    configs written for the JAX package load unchanged, but they have no
    effect here: on a CUDA tensor the quantizers always run the hand-written
    kernels of :mod:`fqss_tpu_torch.ops.fake_quant`.

    ``compute_dtype="bfloat16"`` rounds the operands of every convolution and
    matrix product to bfloat16 (:func:`fqss_tpu_torch.nn.layers.mxu_operands`)
    and keeps the sums and the grid math in float32, as JAX's
    ``preferred_element_type=float32`` does; any other value computes in
    float32. It is ported for serving: a bf16 forward that needs a gradient
    raises ``NotImplementedError`` (ROADMAP.md, queue 1: bf16 training).
    """

    qat: bool = False
    gradient_based: bool = True
    weight_quant: bool = True
    weight_n_bits: int = 8
    act_quant: bool = True
    act_n_bits: int = 8
    in_quant: bool = False
    in_act_n_bits: int = 8
    out_quant: bool = False
    out_act_n_bits: int = 8
    n_splitter: int = 1
    n_combiner: int = 1
    inout_nl_quant: bool = False
    observer: bool = True
    train_res_dec: bool = False
    act_quantizer: str = "linear"  # 'linear' | 'mse'
    max_observations: int = 50
    lstm_mode: str = "fused"
    pallas_qat: bool = False
    pallas_lstm: bool = False
    pallas_attn: bool = False
    compute_dtype: str = "float32"

    @property
    def bf16(self) -> bool:
        """Whether products take bfloat16 operands (``fqss_tpu/quant/spec.py:mxu_dtype`` is bfloat16)."""
        return self.compute_dtype == "bfloat16"

    @property
    def mxu_dtype(self) -> torch.dtype:
        """The operands' type: bfloat16 exactly when ``compute_dtype`` is ``"bfloat16"``, else float32."""
        return torch.bfloat16 if self.bf16 else torch.float32

    @classmethod
    def from_config(cls, cfg: Mapping[str, Any] | None) -> "QuantSpec":
        """Build from a YAML ``quantization`` dict; unknown keys are ignored."""
        if not cfg:
            return cls()
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in cfg.items() if k in fields})


FLOAT = QuantSpec()
