"""Declarative quantization plan (mirror of ``fqss_tpu/quant/spec.py``).

The JAX package's ``QuantSpec`` cannot be imported here: its package
``__init__`` pulls in jax. This dataclass has the same fields and defaults,
so one YAML ``model_cfg.quantization`` dict drives both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Mirror of the YAML ``model_cfg.quantization`` schema.

    ``pallas_qat``, ``pallas_lstm`` and ``pallas_attn`` are accepted so that
    configs written for the JAX package load unchanged, but they have no
    effect here: on a CUDA tensor the quantizers always run the hand-written
    kernels of :mod:`fqss_tpu_torch.ops.fake_quant`.

    ``compute_dtype="bfloat16"`` is not ported yet (ROADMAP.md, queue 2) and
    raises ``NotImplementedError``.
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

    def __post_init__(self):
        if self.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={self.compute_dtype!r} is not ported yet; only float32 "
                "(see ROADMAP.md, queue 2)"
            )

    @classmethod
    def from_config(cls, cfg: Mapping[str, Any] | None) -> "QuantSpec":
        """Build from a YAML ``quantization`` dict; unknown keys are ignored."""
        if not cfg:
            return cls()
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in cfg.items() if k in fields})


FLOAT = QuantSpec()
