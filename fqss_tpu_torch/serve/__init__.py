"""Serving: weight folding, the int8 engines, the automatic path and streaming.

* :func:`fold_quantized_weights` — pre-apply the weight fake-quant once at
  load (bitwise-equal forward);
* :class:`ConvTasNetInt8Engine` — the ConvTasNet's 1x1 convolutions as int8
  products through the K4 kernel, int8 activations between stages;
* :class:`DPTNetInt8Engine` — the DPTNet's on-grid products (attention
  projections, 1x1 convs, dense layers) through K4, its LSTMs through K7;
* :class:`SepformerInt8Engine` — the Sepformer's on-grid products (attention
  projections, feed-forward linears, the masker's 1x1 convs) through K4;
* :class:`ConvTasNetMusicInt8Engine` — ConvTasNet-music's 1x1 convs and
  Linear decoder through K4;
* :class:`HTDemucsInt8Engine` — HTDemucs's transformer projections through
  K4 (its conv branches the folded model's);
* :func:`make_int8_engine` — model-type dispatch used by ``infer`` and ``val``;
* :func:`auto_serving_model` — each family on its fastest engine on the H100
  (``--engine auto``, the table :data:`BEST_PATHS`);
* :class:`StreamingSeparator` — chunked separation of a live stream, equal to
  offline OLA once drained (``infer --stream``).
"""

from fqss_tpu_torch.models.convtasnet import ConvTasNet
from fqss_tpu_torch.models.convtasnet_music import ConvTasNetMusic
from fqss_tpu_torch.models.dptnet import DPTNet
from fqss_tpu_torch.models.htdemucs import HTDemucs
from fqss_tpu_torch.models.sepformer import Sepformer
from fqss_tpu_torch.serve.autopath import BEST_PATHS, auto_serving_model, best_path
from fqss_tpu_torch.serve.convtasnet_int8 import ConvTasNetInt8Engine
from fqss_tpu_torch.serve.convtasnet_music_int8 import ConvTasNetMusicInt8Engine
from fqss_tpu_torch.serve.dptnet_int8 import DPTNetInt8Engine
from fqss_tpu_torch.serve.fold import fold_quantized_weights
from fqss_tpu_torch.serve.htdemucs_int8 import HTDemucsInt8Engine
from fqss_tpu_torch.serve.sepformer_int8 import SepformerInt8Engine
from fqss_tpu_torch.serve.streaming import StreamingSeparator


def make_int8_engine(model, compute_dtype: str = "bfloat16"):
    """Build the int8 serving engine matching ``model``'s family.

    Raises NotImplementedError for families without an int8 engine (the
    port has the ConvTasNet's, the DPTNet's, the Sepformer's,
    ConvTasNet-music's and HTDemucs's, the JAX package's five).
    """
    if isinstance(model, ConvTasNet):
        return ConvTasNetInt8Engine(model, compute_dtype=compute_dtype)
    if isinstance(model, DPTNet):
        return DPTNetInt8Engine(model, compute_dtype=compute_dtype)
    if isinstance(model, Sepformer):
        return SepformerInt8Engine(model, compute_dtype=compute_dtype)
    if isinstance(model, ConvTasNetMusic):
        return ConvTasNetMusicInt8Engine(model, compute_dtype=compute_dtype)
    if isinstance(model, HTDemucs):
        return HTDemucsInt8Engine(model, compute_dtype=compute_dtype)
    raise NotImplementedError(f"no int8 engine for {type(model).__name__}; use fold_quantized_weights")


__all__ = ["BEST_PATHS", "ConvTasNetInt8Engine", "ConvTasNetMusicInt8Engine", "DPTNetInt8Engine", "HTDemucsInt8Engine",
           "SepformerInt8Engine", "StreamingSeparator", "auto_serving_model", "best_path", "fold_quantized_weights", "make_int8_engine"]
