"""Model factory (``fqss_tpu/models/factory.py``): name -> quantized model with weights,
and the student/teacher pair of KD training.

The port holds ConvTasNet, DPTNet, the Sepformer, ConvTasNet-music and
HTDemucs; the JAX factory's legacy ``HDemucsLegacy`` raises
``NotImplementedError`` (ROADMAP.md, queue 1).

Checkpoint formats accepted by :func:`load_pretrained_state` (through
``model_cfg['model_path']`` and ``training_cfg['pretrained']``), told apart
by content: the port's own ``torch.save`` exports, reference float
``.pth``/``.pt``/``.ckpt`` checkpoints (through ``models/convert.py``, with
the splitter widening), and the JAX package's ``.npz`` exports.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Any, Callable, Mapping

import torch

from torch import nn

from fqss_tpu_torch.models import convert
from fqss_tpu_torch.models.convtasnet import ConvTasNet
from fqss_tpu_torch.models.convtasnet_music import SOURCES, ConvTasNetMusic
from fqss_tpu_torch.models.dptnet import DPTNet
from fqss_tpu_torch.models.htdemucs import HTDemucs
from fqss_tpu_torch.models.sepformer import Sepformer
from fqss_tpu_torch.nn.io_layers import expand_encoder_kernel
from fqss_tpu_torch.quant.calibration import calibrate_mse_quantizers, has_pending_mse
from fqss_tpu_torch.quant.spec import QuantSpec
from fqss_tpu_torch.train.checkpoints import is_npz, restore_jax_export

MODEL_NAMES = ("ConvTasNet", "DPTNet", "Sepformer", "ConvTasNetMusic", "HTDemucs")
_ARCH_KEYS = ("n_filters", "bn_chan", "hid_chan", "n_blocks", "n_repeats", "mask_act", "mask_kernel_size")
_DPTNET_KEYS = ("enc_dim", "feature_dim", "hidden_dim", "layer", "segment_size")
_SEPFORMER_KEYS = ("n_filters", "n_repeats", "n_heads", "chunk_size", "n_ffn", "n_layers")
_MUSIC_KEYS = ("audio_channels", "n_filters", "bn_chan", "hid_chan", "conv_kernel", "n_blocks", "n_repeats",
               "mask_act")
_HTDEMUCS_KEYS = ("audio_channels", "channels", "nfft", "depth", "t_layers", "t_heads", "t_hidden_scale",
                  "bottom_channels", "segment", "samplerate")  # fqss_tpu/models/factory.py:104-106


def create_model(model_cfg: Mapping[str, Any], q: QuantSpec | None = None,
                 generator: torch.Generator | None = None) -> nn.Module:
    """Build a model by config name (load_model.py:21-51), on the CPU."""
    name = model_cfg["name"]
    if q is None:
        q = QuantSpec.from_config(model_cfg.get("quantization"))
        if not model_cfg.get("quantization", {}).get("qat", False):
            q = QuantSpec()
    if name == "DPTNet":
        extra = {k: model_cfg[k] for k in _DPTNET_KEYS if k in model_cfg}
        return DPTNet(n_srcs=model_cfg.get("n_src", 2), kernel_size=model_cfg.get("kernel_size", 2), q=q,
                      generator=generator, **extra)
    if name == "Sepformer":
        extra = {k: model_cfg[k] for k in _SEPFORMER_KEYS if k in model_cfg}
        return Sepformer(n_srcs=model_cfg.get("n_src", 2), kernel_size=model_cfg.get("kernel_size", 16),
                         stride=model_cfg.get("stride", 8), q=q, generator=generator, **extra)
    if name == "ConvTasNetMusic":
        extra = {k: model_cfg[k] for k in _MUSIC_KEYS if k in model_cfg}
        return ConvTasNetMusic(sources=tuple(model_cfg.get("sources", SOURCES)),
                               kernel_size=model_cfg.get("kernel_size", 20), stride=model_cfg.get("stride", 10), q=q,
                               generator=generator, **extra)
    if name == "HTDemucs":
        extra = {k: model_cfg[k] for k in _HTDEMUCS_KEYS if k in model_cfg}
        return HTDemucs(sources=tuple(model_cfg.get("sources", SOURCES)), q=q, generator=generator, **extra)
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


def _family(model: nn.Module) -> tuple[Callable, Callable, Callable]:
    """(``*_from_jax``, ``*_to_jax``, the reference float map at the model's depth) of ``model``'s family: the
    port's ``_torch_to_params`` (``fqss_tpu/models/factory.py:157-179``)."""
    if isinstance(model, ConvTasNet):
        return (convert.convtasnet_from_jax, convert.convtasnet_to_jax,
                lambda sd: convert.convtasnet_params_from_torch(sd, model.n_repeats, model.n_blocks))
    if isinstance(model, DPTNet):
        return (convert.dptnet_from_jax, convert.dptnet_to_jax,
                lambda sd: convert.dptnet_params_from_torch(sd, model.layer))
    if isinstance(model, Sepformer):
        return (convert.sepformer_from_jax, convert.sepformer_to_jax,
                lambda sd: convert.sepformer_params_from_torch(sd, model.n_repeats, model.n_layers))
    if isinstance(model, ConvTasNetMusic):
        return (convert.convtasnet_music_from_jax, convert.convtasnet_music_to_jax,
                lambda sd: convert.convtasnet_music_params_from_torch(sd, model.n_repeats, model.n_blocks))
    if isinstance(model, HTDemucs):
        return (convert.htdemucs_from_jax, convert.htdemucs_to_jax,
                lambda sd: convert.htdemucs_params_from_torch(sd, model.depth, model.t_layers, model.dconv_depth))
    raise NotImplementedError(f"checkpoint import is not wired for {type(model).__name__}")


def load_pretrained_state(model: nn.Module, path: str,
                          generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
    """The state dict that ``model`` takes from the checkpoint at ``path`` (``load_pretrained_variables``,
    ``fqss_tpu/models/factory.py:127-154``). The format is told by content:

    * a directory: an orbax checkpoint of the JAX package, refused (reading it needs orbax);
    * a ``.npz`` archive: the JAX package's ``export_model`` file, read strictly by
      :func:`~fqss_tpu_torch.train.checkpoints.restore_jax_export` (a missing key raises, as JAX's
      ``restore_variables``) and carried over by the family's ``*_from_jax``;
    * anything else is read by ``torch.load(weights_only=True)``, which refuses a file holding objects other than
      tensors and plain containers (the JAX package unpickles anything). A dict whose keys are exactly
      ``model.state_dict()``'s is the port's own export (``train/checkpoints.py:export_model``, a trainer's
      ``best_model.pt``) and is returned as it is; any other is a reference float checkpoint
      (``.pth``/``.pt``/``.ckpt``): its ``state``/``state_dict`` wrapper is taken off, the ``fmodel.*`` keys (a KD
      run's teacher) dropped and the ``model.`` prefix removed, the weights go through the family's reference map
      (``models/convert.py:*_params_from_torch``) and merge into ``model``'s state by :func:`merge_float_params`:
      QAT-only entries keep their values, a splitter-widened encoder takes the float kernel widened (LSB planes
      from ``generator``).

    A file that cannot be read so raises ``ValueError`` naming it and the format it was taken for.
    """
    from_jax, to_jax, from_torch = _family(model)
    if not os.path.exists(path):
        raise FileNotFoundError(f"checkpoint {path} does not exist")
    if os.path.isdir(path) or is_npz(path):
        return from_jax(restore_jax_export(path, to_jax(model.state_dict())))
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(f"{path}: refused: taken for a torch checkpoint, it holds objects other than tensors and "
                         f"plain containers, which torch.load(weights_only=True) does not unpickle ({e})") from e
    except Exception as e:
        raise ValueError(f"{path}: not readable as a torch checkpoint (.pth/.pt/.ckpt): {e}") from e
    state = model.state_dict()
    if isinstance(sd, Mapping) and sd.keys() == state.keys():
        return dict(sd)
    for key in ("state", "state_dict"):
        if isinstance(sd, Mapping) and key in sd:
            sd = sd[key]
    if not isinstance(sd, Mapping):
        raise ValueError(f"{path}: taken for a reference float checkpoint, it holds a {type(sd).__name__}, not a "
                         "state dict")
    ref = {}
    for k, v in sd.items():
        if k.startswith("fmodel."):
            continue
        if not isinstance(v, torch.Tensor):
            raise ValueError(f"{path}: taken for a reference float checkpoint, its entry {k!r} is a "
                             f"{type(v).__name__}, not a tensor")
        ref[k.removeprefix("model.")] = v.detach().cpu().numpy()
    try:
        float_state = from_torch(ref)
    except KeyError as e:
        raise ValueError(f"{path}: taken for a reference float {type(model).__name__} checkpoint, it lacks the key "
                         f"{e}") from e
    return merge_float_params(state, float_state, model.q.n_splitter, generator=generator)


def create_pretrained_model(model_cfg: Mapping[str, Any], observer: bool | None = None,
                            device: torch.device | str = "cpu") -> nn.Module:
    """The quantized model with its weights, in eval mode on ``device``.

    ``model_cfg['model_path']``: None for a seeded init (``torch.Generator``
    seeded with 0), or a checkpoint in any format of
    :func:`load_pretrained_state` (a widened encoder's LSB planes from a
    generator seeded with 1, as JAX's ``PRNGKey(1)``). A state saved inside an
    MSE observer window has its histograms calibrated here, so that serving
    quantizes instead of running the float branch
    (``fqss_tpu/models/factory.py:187-195``).
    """
    q = quant_spec_from_cfg(model_cfg, observer)
    model = create_model(model_cfg, q, generator=torch.Generator().manual_seed(0))
    path = model_cfg.get("model_path")
    if path is not None:
        model.load_state_dict(load_pretrained_state(model, path, generator=torch.Generator().manual_seed(1)))
    if has_pending_mse(model):
        calibrate_mse_quantizers(model)
    return model.to(device).eval()


def create_model_and_teacher(model_cfg: Mapping[str, Any], pretrained: str | None = None,
                             generator: torch.Generator | None = None) -> tuple[nn.Module, nn.Module]:
    """(quantized student, float teacher) for KD training, on the CPU (train_utils.py:8-27).

    The teacher is the same architecture with ``QuantSpec()``: no
    quantizers, one splitter plane. Both draw their initial weights from
    ``generator`` (teacher first). ``pretrained`` is None, or a float
    model's checkpoint in any format of :func:`load_pretrained_state`: the
    teacher loads it, and the student takes its shared weights through
    :func:`merge_float_params` (the encoder widened); the student's
    quantizer ranges and QAT-only layers keep their initial values.
    """
    q = quant_spec_from_cfg(model_cfg)
    teacher = create_model(model_cfg, QuantSpec(), generator=generator)
    model = create_model(model_cfg, q, generator=generator)
    if pretrained is not None:
        teacher.load_state_dict(load_pretrained_state(teacher, pretrained))
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
    values; the encoder weight, 1-D ``[Cout, Cin, k]`` or 2-D ``[Cout, Cin,
    kh, kw]`` (HTDemucs's frequency branch), is splitter-widened along its
    input-channel axis (1) when the shapes differ
    (:func:`expand_encoder_kernel`).
    """
    out = dict(q_state)
    for k, fv in float_state.items():
        if k not in out:
            continue
        qv = out[k]
        if qv.shape == fv.shape:
            out[k] = fv.clone()
        elif qv.ndim == fv.ndim and qv.ndim in (3, 4) and qv.shape[1] == n_splitter * fv.shape[1]:
            out[k] = expand_encoder_kernel(fv, n_splitter, generator, lsb_init=lsb_init)
        else:
            raise ValueError(f"Error: mismatch model weights for {k} ({tuple(fv.shape)} vs {tuple(qv.shape)}). "
                             "Please check if the model configuration matches the checkpoint.")
    return out
