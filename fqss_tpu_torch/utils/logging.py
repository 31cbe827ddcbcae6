"""Experiment logging (``fqss_tpu/utils/logging.py``): per-epoch metrics to results.txt and stdout.

The reference logs to results.txt (utils.py:16-21) and optionally to wandb
(asteroid_librimix_trainer.py:176-183); wandb logging is not ported yet.
"""

from __future__ import annotations

from typing import Any, Mapping

from fqss_tpu_torch.train.checkpoints import save_log


def log_metrics(work_dir: str, metrics: Mapping[str, Any], step: int | None = None) -> None:
    text = " ".join(f"{k}={float(v):.5g}" for k, v in metrics.items())
    save_log(work_dir, (f"step {step}: " if step is not None else "") + text)
