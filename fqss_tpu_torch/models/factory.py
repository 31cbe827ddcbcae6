"""Model factory (``fqss_tpu/models/factory.py``): name -> quantized model with weights,
and the student/teacher pair of KD training.

The port holds the ConvTasNet slice; the other model names of the JAX
factory raise ``NotImplementedError`` until their slices land (ROADMAP.md,
queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch

from fqss_tpu_torch.models.convtasnet import ConvTasNet
from fqss_tpu_torch.nn.io_layers import expand_encoder_kernel
from fqss_tpu_torch.quant.spec import QuantSpec

MODEL_NAMES = ("ConvTasNet",)
_ARCH_KEYS = ("n_filters", "bn_chan", "hid_chan", "n_blocks", "n_repeats", "mask_act", "mask_kernel_size")


def create_model(model_cfg: Mapping[str, Any], q: QuantSpec | None = None,
                 generator: torch.Generator | None = None) -> ConvTasNet:
    """Build a model by config name (load_model.py:21-51), on the CPU."""
    name = model_cfg["name"]
    if q is None:
        q = QuantSpec.from_config(model_cfg.get("quantization"))
        if not model_cfg.get("quantization", {}).get("qat", False):
            q = QuantSpec()
    if name != "ConvTasNet":
        raise NotImplementedError(f"model {name!r} is not ported yet; the port has {MODEL_NAMES} "
                                  "(ROADMAP.md, queue 1)")
    extra = {k: model_cfg[k] for k in _ARCH_KEYS if k in model_cfg}
    return ConvTasNet(
        n_srcs=model_cfg.get("n_src", 1),
        kernel_size=model_cfg.get("kernel_size", 32),
        stride=model_cfg.get("stride", 16),
        q=q,
        generator=generator,
        **extra,
    )


def quant_spec_from_cfg(model_cfg: Mapping[str, Any], observer: bool | None = None) -> QuantSpec:
    """QuantSpec from model_cfg['quantization'] (load_model.py:53-74).

    ``observer`` overrides the config's observer flag (val/infer turn it off)."""
    q = QuantSpec.from_config(model_cfg.get("quantization"))
    if observer is not None:
        q = dataclasses.replace(q, observer=observer)
    return q


def create_pretrained_model(model_cfg: Mapping[str, Any], observer: bool | None = None,
                            device: torch.device | str = "cpu") -> ConvTasNet:
    """The quantized model with its weights, in eval mode on ``device``.

    ``model_cfg['model_path']``: None for a seeded init (``torch.Generator``
    seeded with 0), or a state dict of this package saved with
    ``torch.save``. Reference ``.pth`` checkpoints are not imported yet
    (ROADMAP.md, queue 1).
    """
    q = quant_spec_from_cfg(model_cfg, observer)
    model = create_model(model_cfg, q, generator=torch.Generator().manual_seed(0))
    path = model_cfg.get("model_path")
    if path is not None:
        state = torch.load(path, map_location="cpu", weights_only=True)
        model.load_state_dict(state)
    return model.to(device).eval()


def create_model_and_teacher(model_cfg: Mapping[str, Any], pretrained: str | None = None,
                             generator: torch.Generator | None = None) -> tuple[ConvTasNet, ConvTasNet]:
    """(quantized student, float teacher) for KD training, on the CPU (train_utils.py:8-27).

    The teacher is the same architecture with ``QuantSpec()``: no
    quantizers, one splitter plane. Both draw their initial weights from
    ``generator`` (teacher first). ``pretrained`` is None, or the path of a
    float model's state dict saved with ``torch.save``: the teacher loads
    it, and the student takes its shared weights through
    :func:`merge_float_params`; the student's quantizer ranges and
    QAT-only layers keep their initial values.
    """
    q = quant_spec_from_cfg(model_cfg)
    teacher = create_model(model_cfg, QuantSpec(), generator=generator)
    model = create_model(model_cfg, q, generator=generator)
    if pretrained is not None:
        teacher.load_state_dict(torch.load(pretrained, map_location="cpu", weights_only=True))
        model.load_state_dict(merge_float_params(model.state_dict(), teacher.state_dict(), q.n_splitter,
                                                 generator=generator))
    teacher.requires_grad_(False)
    return model, teacher.eval()


def merge_float_params(q_state: Mapping[str, torch.Tensor], float_state: Mapping[str, torch.Tensor],
                       n_splitter: int = 1, lsb_init: str = "gauss",
                       generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
    """Load float-teacher weights into a QAT state dict.

    Shared entries are overwritten from the float model; QAT-only entries
    (quantizer ranges and counters, combiner residual blocks) keep their
    values; the encoder weight is splitter-widened along its input-channel
    axis (1) when the shapes differ (:func:`expand_encoder_kernel`).
    """
    out = dict(q_state)
    for k, fv in float_state.items():
        if k not in out:
            continue
        qv = out[k]
        if qv.shape == fv.shape:
            out[k] = fv.clone()
        elif qv.ndim == fv.ndim == 3 and qv.shape[1] == n_splitter * fv.shape[1]:
            out[k] = expand_encoder_kernel(fv, n_splitter, generator, lsb_init=lsb_init)
        else:
            raise ValueError(f"Error: mismatch model weights for {k} ({tuple(fv.shape)} vs {tuple(qv.shape)}). "
                             "Please check if the model configuration matches the checkpoint.")
    return out
