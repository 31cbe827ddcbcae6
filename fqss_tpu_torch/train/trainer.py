"""The KD train step, the eval step and the host-side schedulers (``fqss_tpu/train/trainer.py``).

One train step:

* the float teacher's forward, without gradient;
* the student's QAT forward in ``train()`` mode, so that the quantizers'
  observers write their ranges and counters;
* the sensitivity-weighted PIT SI-SDR KD loss (mysystem.py:124-146), or,
  with ``threshold_byloss``, the speechbrain recipe's per-sample
  thresholding (speechbrain_librimix_trainer.py:138-149);
* the backward through the quantizers' backward kernels, for the model's
  parameters and the learned quantizer ranges together;
* clipping by the global norm of all those gradients, with optax's rule
  (``clip_by_global_norm``: scale by ``max_norm / norm`` unless
  ``norm < max_norm``; no epsilon), then the optimizer step at
  ``lr * lr_scale``;
* the non-finite skip: when the loss is not finite or not below
  ``loss_upper_lim`` the optimizer step is skipped and its state left as it
  was; the observers' writes of this forward stay, as in the JAX step
  (trainer.py:174-187).

The step reads the loss on the host once, after the backward has been
queued, to decide on the skip. TF32 must be off for parity runs
(``fqss_tpu_torch.infer.disable_tf32``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from fqss_tpu_torch.separation.losses import fqss_kd_loss, pit_neg_sisdr_db
from fqss_tpu_torch.train.state import TrainState

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    kd_lambda: float = 0.1
    lr: float = 1e-3
    weight_decay: float = 0.0
    grad_clip: float = 5.0
    # speechbrain-style robustness (speechbrain_librimix_trainer.py:140-197)
    threshold_byloss: bool = False
    threshold: float = -30.0
    loss_upper_lim: float = 999999.0
    optimizer: str = "adam"


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.Optimizer:
    """Adam, AdamW (with ``weight_decay``) or SGD, as optax's with its defaults.

    torch's Adam and AdamW compute optax's update up to rounding (the bias
    corrections are applied in another order). The clip is not part of the
    optimizer: the train step applies it first, as the JAX chain does.
    """
    if cfg.optimizer == "adam":
        if cfg.weight_decay:
            return torch.optim.AdamW(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=cfg.weight_decay)
        return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=cfg.lr)
    raise ValueError(cfg.optimizer)


def clip_by_global_norm_(grads: list[Tensor], max_norm: float) -> Tensor:
    """optax.clip_by_global_norm in place: ``g * max_norm / norm`` for all g unless norm < max_norm.

    Returns the global norm before the clip. Stays on the device."""
    norm = global_norm(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm


def global_norm(grads: list[Tensor]) -> Tensor:
    """The L2 norm of all ``grads`` together (optax.global_norm), on the device."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))


def make_train_step(cfg: TrainConfig) -> Callable[[TrainState, Tensor, Tensor], dict]:
    """The KD train step ``(state, mix [B, T], targets [B, S, T]) -> metrics``; updates ``state`` in place.

    The loss is the FQSS speech KD loss. Metrics: ``loss``, ``kd_loss``,
    ``grad_norm`` (before the clip) as device tensors, and ``skipped`` (bool).
    """

    def compute_loss(state: TrainState, mix: Tensor, targets: Tensor) -> tuple[Tensor, Tensor]:
        t_len = targets.shape[-1]
        est = state.model(mix)[..., :t_len]
        if cfg.kd_lambda > 0 and state.teacher is not None:
            with torch.no_grad():
                fest = state.teacher(mix)[..., :t_len]
        else:
            fest = est.detach()
        if cfg.threshold_byloss:
            # Keep the hard samples (loss > threshold) before the mean; with
            # none left, the unfiltered mean (speechbrain_librimix_trainer.py:138-149).
            per, kd_per = fqss_kd_loss(est, fest, targets, kd_lambda=cfg.kd_lambda, per_sample=True)
            keep = (per > cfg.threshold).to(per.dtype)
            n_keep = keep.sum()
            loss = torch.where(n_keep > 0, (per * keep).sum() / n_keep.clamp_min(1.0), per.mean())
            return loss, kd_per.mean()
        return fqss_kd_loss(est, fest, targets, kd_lambda=cfg.kd_lambda)

    def train_step(state: TrainState, mix: Tensor, targets: Tensor) -> dict:
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss, kd_loss = compute_loss(state, mix, targets)
        loss.backward()
        grads = [p.grad for group in state.optimizer.param_groups for p in group["params"] if p.grad is not None]
        if cfg.grad_clip and cfg.grad_clip > 0:
            grad_norm = clip_by_global_norm_(grads, cfg.grad_clip)
        else:
            grad_norm = global_norm(grads)
        ok = bool(torch.isfinite(loss) & (loss < cfg.loss_upper_lim))  # the step's one wait for the device
        if ok:
            for group in state.optimizer.param_groups:
                group["lr"] = cfg.lr * state.lr_scale  # exact lr scaling for Adam, AdamW and SGD
            state.optimizer.step()
        else:
            state.skipped += 1
        state.step += 1
        return {"loss": loss.detach(), "kd_loss": kd_loss.detach(), "grad_norm": grad_norm, "skipped": not ok}

    return train_step


def make_eval_step() -> Callable[[TrainState, Tensor, Tensor], dict]:
    """Validation step: PIT neg SI-SDR without KD, the student in ``eval()`` mode (mysystem.py:148-151)."""

    def eval_step(state: TrainState, mix: Tensor, targets: Tensor) -> dict:
        state.model.eval()
        with torch.no_grad():
            est = state.model(mix)[..., : targets.shape[-1]]
            return {"val_loss": pit_neg_sisdr_db(est, targets)}

    return eval_step


class ReduceLROnPlateau:
    """Host-side plateau scheduler writing ``TrainState.lr_scale``.

    As torch's ReduceLROnPlateau in the asteroid recipe
    (asteroid_librimix_trainer.py:110-115: factor 0.5, patience 5).
    ``dont_halve_until_epoch`` is the speechbrain scheduler's grace window:
    no reduction before that many ``update()`` calls.
    """

    def __init__(self, factor: float = 0.5, patience: int = 5, min_scale: float = 1e-4,
                 dont_halve_until_epoch: int = 0):
        self.factor = factor
        self.patience = patience
        self.min_scale = min_scale
        self.dont_halve_until_epoch = dont_halve_until_epoch
        self.best = float("inf")
        self.bad_epochs = 0
        self.epochs = 0

    def update(self, state: TrainState, val_loss: float) -> TrainState:
        self.epochs += 1
        if val_loss < self.best:
            self.best = val_loss
            self.bad_epochs = 0
            return state
        if self.epochs <= self.dont_halve_until_epoch:
            return state
        self.bad_epochs += 1
        if self.bad_epochs > self.patience:
            self.bad_epochs = 0
            state.lr_scale = max(state.lr_scale * self.factor, self.min_scale)
        return state


class StepLR:
    """Host-side step scheduler writing ``TrainState.lr_scale``: after epoch e the scale is
    ``gamma ** floor((e + 1) / step_size)`` (asteroid_librimix_trainer.py:99-101)."""

    def __init__(self, step_size: int = 2, gamma: float = 0.98):
        self.step_size = max(1, int(step_size))
        self.gamma = gamma
        self.epochs = 0

    def update(self, state: TrainState, val_loss: float | None = None) -> TrainState:
        self.epochs += 1
        state.lr_scale = self.gamma ** (self.epochs // self.step_size)
        return state


class EarlyStopping:
    """Stop after ``patience`` epochs without a better val loss (asteroid_librimix_trainer.py:119-123)."""

    def __init__(self, patience: int = 30):
        self.patience = patience
        self.best = float("inf")
        self.bad_epochs = 0

    def update(self, val_loss: float) -> bool:
        """True when training should stop."""
        if val_loss < self.best:
            self.best = val_loss
            self.bad_epochs = 0
            return False
        self.bad_epochs += 1
        return self.bad_epochs >= self.patience
