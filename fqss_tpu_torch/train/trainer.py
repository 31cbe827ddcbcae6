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

Data parallelism (``mesh``, ``parallel/mesh.py``): each rank runs the step on
its rows of the global batch, and the step is the global batch's, as JAX's
one step over a sharded batch: the observers and the loss's batch means
reduce over the ranks in the forward, the gradients of the global loss are
all-reduced (the world-size factor taken once) before the clip, and every
rank takes the same decision to skip.

On a (dp, tp) grid (``parallel/mesh.py:grid``, a model sharded by
``parallel/tp.py:shard_model_tp``) the batch is sharded over dp and
replicated over tp: the gradients that are partial sums over a tp shard (the
sharded quantizers' ranges) are summed over tp, then every gradient is
reduced over dp; the clip's global norm counts each sharded parameter's
shards once and each replicated parameter once; the optimizer updates each
rank's shard.

With the state sharded over dp (``parallel/fsdp.py:shard_state_fsdp``, on a
1-D mesh or a grid) the model gathers its whole weights in its forward, and
the gather's backward leaves on each slice the ranks' gradients summed
already: the step divides those by the dp size and reduces the rest as
above; the clip's norm counts each slice once, and the optimizer updates the
slices.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from fqss_tpu_torch.parallel import mesh as dp
from fqss_tpu_torch.parallel import shards, tp
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


class OptaxAdam(torch.optim.Optimizer):
    """optax's ``adam`` (``adamw`` where a group's ``weight_decay`` is nonzero) element for element, with a
    learning rate and weight decay per parameter group: the music recipe's per-module groups
    (``optax.multi_transform`` of two such optimizers, ``fqss_tpu/train/recipes_music.py:make_music_optimizer``).

    Per element, in float32 and in optax's order: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g g + b2 nu``,
    ``u = (mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps)``, ``u + wd p`` where the group decays, ``(-lr) u``,
    ``p + u``; ``n`` counts the steps. A parameter without a gradient takes a zero gradient, as JAX's tree has
    one for every leaf (with decay it still decays). torch's Adam and AdamW compute the same update up to
    rounding; this one equals optax's run op by op (eagerly) bit for bit.
    """

    def __init__(self, params, lr: float, weight_decay: float = 0.0, betas: tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = group["params"]
            if not params:
                continue
            b1, b2 = group["betas"]
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
            states = [self.state[p] for p in params]
            for p, st in zip(params, states):
                if not st:
                    st["count"] = 0
                    st["mu"], st["nu"] = torch.zeros_like(p), torch.zeros_like(p)
            mus = torch._foreach_add(torch._foreach_mul(grads, 1 - b1),
                                     torch._foreach_mul([st["mu"] for st in states], b1))
            nus = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2),
                                     torch._foreach_mul([st["nu"] for st in states], b2))
            count = states[0]["count"] + 1
            # 1 - decay^count in float32, as optax's bias_correction takes it
            bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
            bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
            # the square root in float64, rounded once to float32: IEEE's float32 square root, which XLA takes
            # (PyTorch's vectorised float32 one on the CPU is not correctly rounded)
            roots = [torch.sqrt(v.double()).float() for v in torch._foreach_div(nus, bc2)]
            denom = torch._foreach_add(roots, group["eps"])
            updates = torch._foreach_div(torch._foreach_div(mus, bc1), denom)
            if group["weight_decay"]:
                updates = torch._foreach_add(updates, torch._foreach_mul(params, group["weight_decay"]))
            torch._foreach_add_(params, torch._foreach_mul(updates, -group["lr"]))
            for st, mu, nu in zip(states, mus, nus):
                st["count"], st["mu"], st["nu"] = count, mu, nu


def clip_by_global_norm_(grads: list[Tensor], max_norm: float, norm: Tensor | None = None) -> Tensor:
    """optax.clip_by_global_norm in place: ``g * max_norm / norm`` for all g unless norm < max_norm.

    ``norm``: the global norm where the caller has it (a grid's), else :func:`global_norm` of ``grads``. Returns
    the global norm before the clip. Stays on the device."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm


def global_norm(grads: list[Tensor]) -> Tensor:
    """The L2 norm of all ``grads`` together (optax.global_norm), on the device."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))


def make_train_step(cfg: TrainConfig, mesh: dp.Mesh | None = None) -> Callable[[TrainState, Tensor, Tensor], dict]:
    """The KD train step ``(state, mix [B, T], targets [B, S, T]) -> metrics``; updates ``state`` in place.

    The loss is the FQSS speech KD loss. Metrics: ``loss``, ``kd_loss``,
    ``grad_norm`` (before the clip) as device tensors, and ``skipped`` (bool).
    With ``mesh``, every rank calls the step with its rows of the global batch
    (:meth:`~fqss_tpu_torch.parallel.mesh.Mesh.rows`), and the step is the one
    of the global batch: the observers, the loss's batch means and the
    gradients reduced over the ranks (``parallel/mesh.py``).
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
            # Over the global batch under a mesh: the kept sum and count, and the fallback mean.
            per, kd_per = fqss_kd_loss(est, fest, targets, kd_lambda=cfg.kd_lambda, per_sample=True)
            keep = (per > cfg.threshold).to(per.dtype)
            n_keep = dp.batch_sum(keep)
            loss = torch.where(n_keep > 0, dp.batch_sum(per * keep) / n_keep.clamp_min(1.0), dp.batch_mean(per))
            return loss, dp.batch_mean(kd_per)
        return fqss_kd_loss(est, fest, targets, kd_lambda=cfg.kd_lambda)

    def train_step(state: TrainState, mix: Tensor, targets: Tensor) -> dict:
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        with dp.sharded(mesh):
            loss, kd_loss = compute_loss(state, mix, targets)
            grad_norm, ok = backward_and_update(state, cfg, loss)
        return {"loss": loss.detach(), "kd_loss": kd_loss.detach(), "grad_norm": grad_norm, "skipped": not ok}

    return train_step


def backward_and_update(state: TrainState, cfg: TrainConfig, loss: Tensor) -> tuple[Tensor, bool]:
    """The step after the loss: the backward, the clip, the non-finite skip and the optimizer step.

    Under an active mesh the loss is the global batch's on every rank; the gradients are reduced over the ranks
    before the clip, and every rank takes the same decision to skip. Returns the gradients' global norm before the
    clip (on the device) and whether the update was applied."""
    loss.backward()
    params = [p for group in state.optimizer.param_groups for p in group["params"] if p.grad is not None]
    grads = [p.grad for p in params]
    mesh = dp.active()
    on_grid = mesh is not None and mesh.tp_size > 1
    slices = [p.grad for p in params if shards.is_part(p, shards.DP)]
    if slices and mesh is None:
        raise RuntimeError("a model sharded by parallel.fsdp trains inside parallel.mesh.sharded() of its mesh")
    if on_grid:
        tp.reduce_partial_gradients_(params)
    dp.reduce_gradients_([p.grad for p in params if not shards.is_part(p, shards.DP)])
    for g in slices:  # summed over the data ranks by the gather's backward: the world-size factor alone
        g.div_(mesh.size)
    norm = shards.global_norm(params) if on_grid or slices else None
    if cfg.grad_clip and cfg.grad_clip > 0:
        grad_norm = clip_by_global_norm_(grads, cfg.grad_clip, norm)
    else:
        grad_norm = global_norm(grads) if norm is None else norm
    ok = dp.all_agree(bool(torch.isfinite(loss) & (loss < cfg.loss_upper_lim)))  # the step's one wait for the device
    if ok:
        for group in state.optimizer.param_groups:
            # exact lr scaling for Adam, AdamW and SGD; a group with a rate of its own keeps it as base_lr
            group["lr"] = group.get("base_lr", cfg.lr) * state.lr_scale
        state.optimizer.step()
    else:
        state.skipped += 1
    state.step += 1
    return grad_norm, ok


def make_eval_step(mesh: dp.Mesh | None = None) -> Callable[[TrainState, Tensor, Tensor], dict]:
    """Validation step: PIT neg SI-SDR without KD, the student in ``eval()`` mode (mysystem.py:148-151); with
    ``mesh``, of the global batch whose rows each rank holds."""

    def eval_step(state: TrainState, mix: Tensor, targets: Tensor) -> dict:
        state.model.eval()
        with torch.no_grad(), dp.sharded(mesh):
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
