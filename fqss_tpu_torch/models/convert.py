"""Bridge from the JAX package's variables to a port state dict.

:func:`convtasnet_from_jax` takes the flax variables of a
``fqss_tpu.models.ConvTasNet`` (or of one of its layers) as nested dicts of
numpy arrays — collections ``params``, ``qparams`` and ``qstats`` — and
returns the ``state_dict`` of the matching ``fqss_tpu_torch`` module. Scope
names carry over unchanged; what changes is the layout:

* conv kernels ``(k, Cin/g, Cout)`` -> ``[Cout, Cin/g, k]``, and their
  weight ranges ``(1, 1, C)`` -> ``[C, 1, 1]``;
* transposed-conv kernels ``(k, Cin, Cout)`` -> ``[Cin, Cout, k]``, and
  their ranges ``(1, 1, C)`` -> ``[1, C, 1]``;
* ``kernel`` -> ``weight``, GroupNorm ``scale`` -> ``weight``.
"""

from __future__ import annotations

from typing import Iterator, Mapping

import numpy as np
import torch

_CONV = (2, 1, 0)
_CONV_TRANSPOSE = (1, 2, 0)


def _leaves(tree: Mapping, path: tuple[str, ...] = ()) -> Iterator[tuple[tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def convtasnet_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """State dict for the port's module from JAX ConvTasNet variables.

    The ``kernel`` of the ``decoder`` scope is the transposed conv; a
    standalone decoder's variables go in under a ``decoder`` scope.
    """
    sd: dict[str, torch.Tensor] = {}
    for path, v in _leaves(variables.get("params", {})):
        *scope, name = path
        if name == "kernel":
            v = v.transpose(_CONV_TRANSPOSE if scope == ["decoder"] else _CONV)
            name = "weight"
        elif name == "scale":
            name = "weight"
        sd[".".join([*scope, name])] = torch.from_numpy(np.array(v))
    for collection in ("qparams", "qstats"):
        for path, v in _leaves(variables.get(collection, {})):
            *scope, quantizer, name = path
            if quantizer.startswith("weight_fake_quantize") and v.ndim == 3:
                v = v.transpose(_CONV_TRANSPOSE if scope == ["decoder"] else _CONV)
            sd[".".join([*scope, quantizer, name])] = torch.from_numpy(np.array(v))
    return sd
