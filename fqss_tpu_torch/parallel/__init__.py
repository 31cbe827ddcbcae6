"""Parallelism over ``torch.distributed`` (``fqss_tpu/parallel/``): data parallelism and the (dp, tp) grid
(:mod:`.mesh`), tensor parallelism (:mod:`.tp`), FSDP (:mod:`.fsdp`), pipeline parallelism (:mod:`.pp`) and the
multi-rank dry run (:mod:`.dryrun`).

The names of the JAX package's ``parallel`` package come from their modules on first use: those modules import the
quantizers, which import :mod:`.mesh` from this package.
"""

import importlib

from fqss_tpu_torch.parallel.mesh import Mesh, init_distributed, rank, rank_rows, sharded, shutdown, world_size

_FROM = {"fsdp_sharding": "fsdp", "shard_state_fsdp": "fsdp", "layer_stack_vars": "pp", "pipeline_apply": "pp",
         "pipeline_layer_module": "pp", "shard_layer_stack": "pp", "shard_model_tp": "tp",
         "transformer_tp_specs": "tp", "dryrun_multichip": "dryrun"}


def __getattr__(name: str):
    if name in _FROM:
        return getattr(importlib.import_module(f"{__name__}.{_FROM[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Mesh", "init_distributed", "rank", "rank_rows", "sharded", "shutdown", "world_size", *_FROM]
