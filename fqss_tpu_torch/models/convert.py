"""Bridges from the JAX package's variables and from reference checkpoints to a port state dict.

:func:`convtasnet_from_jax`, :func:`dptnet_from_jax`,
:func:`sepformer_from_jax`, :func:`convtasnet_music_from_jax` and
:func:`htdemucs_from_jax` take the flax
variables of a ``fqss_tpu.models`` model (or of one of its layers) as nested
dicts of numpy arrays — collections ``params``, ``qparams`` and ``qstats`` —
and return the ``state_dict`` of the matching ``fqss_tpu_torch`` module.
Scope names carry over unchanged; what changes is the layout:

* conv kernels ``(k, Cin/g, Cout)`` -> ``[Cout, Cin/g, k]``, and their
  weight ranges ``(1, 1, C)`` -> ``[C, 1, 1]``; 2-D ones ``(kh, kw, Cin/g,
  Cout)`` -> ``[Cout, Cin/g, kh, kw]``, ranges ``(1, 1, 1, C)`` -> ``[C, 1,
  1, 1]``;
* transposed-conv kernels ``(k, Cin, Cout)`` -> ``[Cin, Cout, k]``, and
  their ranges ``(1, 1, C)`` -> ``[1, C, 1]`` (2-D: ``(kh, kw, Cin, Cout)``
  -> ``[Cin, Cout, kh, kw]``, ranges -> ``[1, C, 1, 1]``): a decoder's ``kernel``, and
  the combiner's trained ``residual_decoder_kernel`` (renamed
  ``residual_decoder_weight``) with its ``weight_fake_quantize_dec``, which
  live in the scope of the residual block's encoder conv (a Linear
  decoder's 2-D ``residual_decoder_kernel`` ``(latent, out)`` is a dense
  kernel: -> ``[out, latent]``, ranges ``(1, C)`` -> ``[C, 1]``);
* dense kernels ``(in, out)`` -> ``[out, in]``, and their ranges ``(1, C)``
  -> ``[C, 1]``: ``kernel``, and the attention's ``in_proj_kernel`` /
  ``out_proj_kernel`` and the Linear decoder's ``residual_encoder_kernel``,
  renamed ``*_weight``;
* ``kernel`` -> ``weight``, norm ``scale`` -> ``weight`` (a LayerScale's
  ``scale`` keeps its name);
* an embedding table ``(num, features)`` and its per-row ranges
  ``(num, 1)`` keep JAX's layout.

The LSTM's ``w_ih``/``w_hh`` and their quantizers (``wq_ih``/``wq_hh``)
keep the JAX layout, which the port's LSTM uses as it is.

Each ``*_to_jax`` is the inverse: the JAX variables (``params``,
``qparams``, ``qstats``) of a port state dict, as the JAX package's
``export_model`` would write them.

Reference PyTorch checkpoints come in through the JAX package's own key
maps (copied into :mod:`fqss_tpu_torch.models.reference_layout`), composed
with ``*_from_jax``: ``*_params_from_torch`` takes a reference float state
dict, ``*_qat_from_torch`` a reference post-surgery QAT state dict with its
learned ranges (flat ``{name: np.ndarray}`` dicts both), and each returns
the port's state dict of what it holds. The QAT maps are an API, as in the
JAX package: the factory routes reference files through the float maps.
"""

from __future__ import annotations

import re
from typing import Callable, Iterator, Mapping

import numpy as np
import torch

from fqss_tpu_torch.models import reference_layout as ref

_CONV = {3: (2, 1, 0), 4: (3, 2, 0, 1)}
_CONV_TRANSPOSE = {3: (1, 2, 0), 4: (2, 3, 0, 1)}
_DENSE_KERNELS = ("in_proj_kernel", "out_proj_kernel", "residual_encoder_kernel")
_TRANSPOSED_CONV = {"residual_decoder_kernel": "residual_decoder_weight"}  # named apart from `kernel`
_TRANSPOSED_CONV_QUANTIZERS = ("weight_fake_quantize_dec",)


def _leaves(tree: Mapping, path: tuple[str, ...] = ()) -> Iterator[tuple[tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


Scopes = tuple[tuple[str, ...], ...] | Callable[[tuple], bool]
# A quantizer's learned ranges (and the static LSTM cell's, which its direction holds itself); what else they hold
# is qstats.
_QPARAMS = ("min_range", "max_range", "mu", "site_min", "site_max")
_QSTATS = ("n_iter", "observed", "site_n_iter", "hist", "val_min", "val_max", "calibrated")


def _from_jax(variables: Mapping, transposed_conv_scopes: Scopes,
              layer_scale: Callable[[tuple], bool] = lambda scope: False,
              embeddings: Callable[[tuple], bool] = lambda scope: False) -> dict[str, torch.Tensor]:
    """``transposed_conv_scopes``: the scopes whose ``kernel`` is a transposed conv (or a predicate on the scope);
    ``layer_scale``: the scopes whose ``scale`` is a LayerScale's (it keeps its name); ``embeddings``: the scopes of
    embedding tables, whose weight ranges keep their layout."""
    transposed = (transposed_conv_scopes if callable(transposed_conv_scopes)
                  else lambda scope: scope in transposed_conv_scopes)

    def conv_order(scope: list[str], ndim: int) -> tuple[int, ...]:
        return (_CONV_TRANSPOSE if transposed(tuple(scope)) else _CONV)[ndim]

    sd: dict[str, torch.Tensor] = {}
    for path, v in _leaves(variables.get("params", {})):
        *scope, name = path
        if name == "kernel":
            v = v.transpose(conv_order(scope, v.ndim)) if v.ndim >= 3 else v.T
            name = "weight"
        elif name in _TRANSPOSED_CONV:  # a Linear decoder's (2-D) is a dense kernel
            v, name = v.transpose(_CONV_TRANSPOSE[v.ndim]) if v.ndim >= 3 else v.T, _TRANSPOSED_CONV[name]
        elif name in _DENSE_KERNELS:
            v = v.T
            name = name.replace("_kernel", "_weight")
        elif name == "scale" and not layer_scale(tuple(scope)):
            name = "weight"
        sd[".".join([*scope, name])] = torch.from_numpy(np.array(v))
    for collection in ("qparams", "qstats"):
        for path, v in _leaves(variables.get(collection, {})):
            *scope, quantizer, name = path
            if quantizer.startswith("weight_fake_quantize") and v.ndim >= 3:
                v = v.transpose(_CONV_TRANSPOSE[v.ndim] if quantizer in _TRANSPOSED_CONV_QUANTIZERS
                                else conv_order(scope, v.ndim))
            elif quantizer.startswith("weight_fake_quantize") and v.ndim == 2 and not embeddings(tuple(scope)):
                v = v.T
            sd[".".join([*scope, quantizer, name])] = torch.from_numpy(np.array(v))
    return sd


def _to_jax(state: Mapping[str, torch.Tensor], transposed_conv_scopes: Scopes,
            embeddings: Callable[[tuple], bool] = lambda scope: False) -> dict:
    """The inverse of :func:`_from_jax` with the same arguments (a LayerScale's ``scale`` and a norm's ``weight``
    tell themselves apart by name): nested ``{collection: {scope: ... {name:
    np.ndarray}}}``. A quantizer's ranges go to ``qparams``, its counters and flags to ``qstats``."""
    transposed = (transposed_conv_scopes if callable(transposed_conv_scopes)
                  else lambda scope: scope in transposed_conv_scopes)

    def undo(v: np.ndarray, order: tuple[int, ...]) -> np.ndarray:
        return v.transpose(np.argsort(order))

    def conv_order(scope: list[str], ndim: int) -> tuple[int, ...]:
        return (_CONV_TRANSPOSE if transposed(tuple(scope)) else _CONV)[ndim]

    kernels = {name.replace("_kernel", "_weight"): name for name in _DENSE_KERNELS}
    variables: dict = {}
    for key, t in state.items():
        v = t.detach().cpu().numpy()
        *scope, name = key.split(".")
        if name in _QPARAMS or name in _QSTATS:
            collection = "qparams" if name in _QPARAMS else "qstats"
            *scope, quantizer = scope
            if quantizer.startswith("weight_fake_quantize") and v.ndim >= 3:
                v = undo(v, _CONV_TRANSPOSE[v.ndim] if quantizer in _TRANSPOSED_CONV_QUANTIZERS
                         else conv_order(scope, v.ndim))
            elif quantizer.startswith("weight_fake_quantize") and v.ndim == 2 and not embeddings(tuple(scope)):
                v = v.T
            scope = [*scope, quantizer]
        else:
            collection = "params"
            if name == "weight" and v.ndim == 1:  # a norm's scale: kernels have two axes or more
                name = "scale"
            elif name == "weight":
                v = undo(v, conv_order(scope, v.ndim)) if v.ndim >= 3 else v.T
                name = "kernel"
            elif name in kernels:
                v, name = v.T, kernels[name]
            elif name in _TRANSPOSED_CONV.values():
                v = undo(v, _CONV_TRANSPOSE[v.ndim]) if v.ndim >= 3 else v.T
                name = name.replace("_weight", "_kernel")
        node = variables.setdefault(collection, {})
        for part in scope:
            node = node.setdefault(part, {})
        node[name] = np.array(v)  # a contiguous copy; 0-d stays 0-d
    return variables


def convtasnet_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """State dict for the port's module from JAX ConvTasNet variables.

    The ``kernel`` of the ``decoder`` scope is the transposed conv; a
    standalone decoder's variables go in under a ``decoder`` scope.
    """
    return _from_jax(variables, (("decoder",),))


def convtasnet_to_jax(state: Mapping[str, torch.Tensor]) -> dict:
    """JAX ConvTasNet variables of the port's state dict (the inverse of :func:`convtasnet_from_jax`)."""
    return _to_jax(state, (("decoder",),))


def dptnet_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """State dict for the port's module from JAX DPTNet variables (or one of its layers')."""
    return _from_jax(variables, ())


def dptnet_to_jax(state: Mapping[str, torch.Tensor]) -> dict:
    """JAX DPTNet variables of the port's state dict (the inverse of :func:`dptnet_from_jax`)."""
    return _to_jax(state, ())


def sepformer_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """State dict for the port's module from JAX Sepformer variables (or one of its layers').

    The ``decoder`` scope's ``kernel`` is the transposed conv; the combiner's
    ``residual_decoder_kernel`` and its ranges are transposed convs by name."""
    return _from_jax(variables, (("decoder",),))


def sepformer_to_jax(state: Mapping[str, torch.Tensor]) -> dict:
    """JAX Sepformer variables of the port's state dict (the inverse of :func:`sepformer_from_jax`)."""
    return _to_jax(state, (("decoder",),))


def convtasnet_music_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """State dict for the port's module from JAX ConvTasNetMusic variables (or one of its layers').

    It has no transposed conv: its decoder is a Linear, whose ``kernel`` and
    combiner ``residual_encoder_kernel`` are dense kernels."""
    return _from_jax(variables, ())


def convtasnet_music_to_jax(state: Mapping[str, torch.Tensor]) -> dict:
    """JAX ConvTasNetMusic variables of the port's state dict (the inverse of :func:`convtasnet_music_from_jax`)."""
    return _to_jax(state, ())


_LAYER_SCALE = re.compile(r"gamma_\d+|layer_\d+_scale")


def htdemucs_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """State dict for the port's module from JAX HTDemucs variables (or one of its layers').

    The ``conv_tr`` scopes hold transposed convs (1-D in the time decoders, 2-D in the frequency ones; the combiner's
    ``residual_decoder_kernel`` by name), ``gamma_*`` and ``layer_*_scale`` are LayerScales, ``freq_emb`` the
    embedding table."""
    return _from_jax(variables, _htdemucs_transposed, layer_scale=_htdemucs_layer_scale,
                     embeddings=_htdemucs_embeddings)


def htdemucs_to_jax(state: Mapping[str, torch.Tensor]) -> dict:
    """JAX HTDemucs variables of the port's state dict (the inverse of :func:`htdemucs_from_jax`)."""
    return _to_jax(state, _htdemucs_transposed, embeddings=_htdemucs_embeddings)


def _htdemucs_transposed(scope: tuple) -> bool:
    return bool(scope) and scope[-1] == "conv_tr"


def _htdemucs_layer_scale(scope: tuple) -> bool:
    return bool(scope) and bool(_LAYER_SCALE.fullmatch(scope[-1]))


def _htdemucs_embeddings(scope: tuple) -> bool:
    return bool(scope) and scope[-1] == "freq_emb"


# Reference checkpoints: the JAX package's key maps (reference_layout), then *_from_jax.


def convtasnet_params_from_torch(sd: Mapping[str, np.ndarray], n_repeats: int = 3,
                                 n_blocks: int = 8) -> dict[str, torch.Tensor]:
    """The port's ConvTasNet state dict of a reference float ConvTasNetQ state dict (convtasnetq.py:118-288)."""
    return convtasnet_from_jax({"params": ref.convtasnet_params_from_torch(sd, n_repeats, n_blocks)})


def dptnet_params_from_torch(sd: Mapping[str, np.ndarray], layer: int = 6) -> dict[str, torch.Tensor]:
    """The port's DPTNet state dict of a reference float DPTNetQ state dict (dptnetq.py:311-428). The LSTM's weights
    come out as JAX's ``w_ih [C, 4H]``/``w_hh [H, 4H]``, the layout of ``nn/lstm.py``."""
    return dptnet_from_jax({"params": ref.dptnet_params_from_torch(sd, layer)})


def sepformer_params_from_torch(sd: Mapping[str, np.ndarray], n_repeats: int = 2,
                                n_layers: int = 8) -> dict[str, torch.Tensor]:
    """The port's Sepformer state dict of a reference float SepformerQ state dict (sepformerq.py:342-470)."""
    return sepformer_from_jax({"params": ref.sepformer_params_from_torch(sd, n_repeats, n_layers)})


def convtasnet_music_params_from_torch(sd: Mapping[str, np.ndarray], n_repeats: int = 4,
                                       n_blocks: int = 10) -> dict[str, torch.Tensor]:
    """The port's ConvTasNetMusic state dict of a reference float ConvTasNetMusicQ state dict
    (convtasnetq_music.py:178-288)."""
    return convtasnet_music_from_jax({"params": ref.convtasnet_music_params_from_torch(sd, n_repeats, n_blocks)})


def htdemucs_params_from_torch(sd: Mapping[str, np.ndarray], depth: int = 4, t_layers: int = 5,
                               dconv_depth: int = 2) -> dict[str, torch.Tensor]:
    """The port's HTDemucs state dict of a reference float HTDemucsQ state dict (htdemucsq.py:532-930; default
    topology: no branch merge, dconv in the encoders only)."""
    return htdemucs_from_jax({"params": ref.htdemucs_params_from_torch(sd, depth, t_layers, dconv_depth)})


def convtasnet_qat_from_torch(sd: Mapping[str, np.ndarray], n_repeats: int = 3, n_blocks: int = 8,
                              n_combiner: int = 2) -> dict[str, torch.Tensor]:
    """The port's ConvTasNet weights and ranges of a reference QAT ConvTasNetQ state dict (post surgery,
    convtasnetq.py:243-288). Load into a model built with ``observer=False`` (``strict=False``: the counters keep
    theirs)."""
    return convtasnet_from_jax(_qat(ref.convtasnet_qat_from_torch(sd, n_repeats, n_blocks, n_combiner)))


def dptnet_qat_from_torch(sd: Mapping[str, np.ndarray], layer: int = 6,
                          n_combiner: int = 2) -> dict[str, torch.Tensor]:
    """The port's DPTNet weights and ranges of a reference QAT DPTNetQ state dict (dptnetq.py:430-478)."""
    return dptnet_from_jax(_qat(ref.dptnet_qat_from_torch(sd, layer, n_combiner)))


def sepformer_qat_from_torch(sd: Mapping[str, np.ndarray], n_repeats: int = 2, n_layers: int = 8,
                             n_combiner: int = 2) -> dict[str, torch.Tensor]:
    """The port's Sepformer weights and ranges of a reference QAT SepformerQ state dict (sepformerq.py:472-527),
    the combiner's trained residual decoder included."""
    return sepformer_from_jax(_qat(ref.sepformer_qat_from_torch(sd, n_repeats, n_layers, n_combiner)))


def convtasnet_music_qat_from_torch(sd: Mapping[str, np.ndarray], n_repeats: int = 4, n_blocks: int = 10,
                                    n_combiner: int = 2) -> dict[str, torch.Tensor]:
    """The port's ConvTasNetMusic weights and ranges of a reference QAT ConvTasNetMusicQ state dict
    (convtasnetq_music.py:290-333)."""
    return convtasnet_music_from_jax(_qat(ref.convtasnet_music_qat_from_torch(sd, n_repeats, n_blocks, n_combiner)))


def htdemucs_qat_from_torch(sd: Mapping[str, np.ndarray], depth: int = 4, t_layers: int = 5, dconv_depth: int = 2,
                            n_combiner: int = 2) -> dict[str, torch.Tensor]:
    """The port's HTDemucs weights and ranges of a reference QAT HTDemucsQ state dict (htdemucsq.py:1157-1242;
    default topology)."""
    return htdemucs_from_jax(_qat(ref.htdemucs_qat_from_torch(sd, depth, t_layers, dconv_depth, n_combiner)))


def _qat(trees: tuple[dict, dict]) -> dict:
    params, qparams = trees
    return {"params": params, "qparams": qparams}
