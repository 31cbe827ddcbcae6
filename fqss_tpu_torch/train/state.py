"""Train state (``fqss_tpu/train/state.py``): what one training run carries from step to step.

The JAX package threads a functional pytree through its jitted step; here
the student module, the frozen float teacher and the optimizer are mutable
objects, and the train step updates them in place. The host-side counters
are plain numbers: the step decides on the host whether to apply an update
(the non-finite skip), so it reads the loss there once per step anyway.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    model: nn.Module  # the quantized student; its quantizer ranges are parameters, its counters buffers
    optimizer: torch.optim.Optimizer  # over the student's trainable parameters, ranges included
    teacher: nn.Module | None = None  # the frozen float teacher (None without KD)
    step: int = 0
    lr_scale: float = 1.0  # multiplies the learning rate (ReduceLROnPlateau / StepLR write it)
    skipped: int = 0  # steps whose update was skipped (non-finite or over-limit loss)

    def state_dict(self) -> dict[str, Any]:
        sd = {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(), "step": self.step,
              "lr_scale": self.lr_scale, "skipped": self.skipped}
        if self.teacher is not None:
            sd["teacher"] = self.teacher.state_dict()
        return sd

    def load_state_dict(self, sd: dict[str, Any]) -> None:
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        if self.teacher is not None and "teacher" in sd:
            self.teacher.load_state_dict(sd["teacher"])
        self.step, self.lr_scale, self.skipped = int(sd["step"]), float(sd["lr_scale"]), int(sd["skipped"])
