"""Parallelism over ``torch.distributed`` (``fqss_tpu/parallel/``): data parallelism and the (dp, tp) grid
(:mod:`.mesh`), tensor parallelism (:mod:`.tp`, imported by its users)."""

from fqss_tpu_torch.parallel.mesh import Mesh, init_distributed, rank, rank_rows, sharded, shutdown, world_size

__all__ = ["Mesh", "init_distributed", "rank", "rank_rows", "sharded", "shutdown", "world_size"]
