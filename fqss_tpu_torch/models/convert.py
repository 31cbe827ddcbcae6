"""Bridge from the JAX package's variables to a port state dict.

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
  live in the scope of the residual block's encoder conv;
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
"""

from __future__ import annotations

import re
from typing import Callable, Iterator, Mapping

import numpy as np
import torch

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


def _from_jax(variables: Mapping, transposed_conv_scopes: tuple[tuple[str, ...], ...] | Callable[[tuple], bool],
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
        elif name in _TRANSPOSED_CONV:
            v, name = v.transpose(_CONV_TRANSPOSE[v.ndim]), _TRANSPOSED_CONV[name]
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


def convtasnet_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """State dict for the port's module from JAX ConvTasNet variables.

    The ``kernel`` of the ``decoder`` scope is the transposed conv; a
    standalone decoder's variables go in under a ``decoder`` scope.
    """
    return _from_jax(variables, (("decoder",),))


def dptnet_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """State dict for the port's module from JAX DPTNet variables (or one of its layers')."""
    return _from_jax(variables, ())


def sepformer_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """State dict for the port's module from JAX Sepformer variables (or one of its layers').

    The ``decoder`` scope's ``kernel`` is the transposed conv; the combiner's
    ``residual_decoder_kernel`` and its ranges are transposed convs by name."""
    return _from_jax(variables, (("decoder",),))


def convtasnet_music_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """State dict for the port's module from JAX ConvTasNetMusic variables (or one of its layers').

    It has no transposed conv: its decoder is a Linear, whose ``kernel`` and
    combiner ``residual_encoder_kernel`` are dense kernels."""
    return _from_jax(variables, ())


_LAYER_SCALE = re.compile(r"gamma_\d+|layer_\d+_scale")


def htdemucs_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """State dict for the port's module from JAX HTDemucs variables (or one of its layers').

    The ``conv_tr`` scopes hold transposed convs (1-D in the time decoders, 2-D in the frequency ones; the combiner's
    ``residual_decoder_kernel`` by name), ``gamma_*`` and ``layer_*_scale`` are LayerScales, ``freq_emb`` the
    embedding table."""
    return _from_jax(variables, lambda scope: bool(scope) and scope[-1] == "conv_tr",
                     layer_scale=lambda scope: bool(scope) and bool(_LAYER_SCALE.fullmatch(scope[-1])),
                     embeddings=lambda scope: bool(scope) and scope[-1] == "freq_emb")
