"""PIT SI-SDR losses and the FQSS sensitivity-weighted KD loss (``fqss_tpu/separation/losses.py``).

* Pairwise SI-SDR matrices and permutation-invariant training (PIT) over
  every source permutation (n_src <= 4), as asteroid's PITLossWrapper
  (reference: train_env/asteroid_librimix/wsdr.py:46-102).
* The KD loss with per-sample quantization-sensitivity weights
  ``w = 10**((sdr_f - sdr_q)/10)``, computed without gradient, and the
  final ``-10*log10((1-lambda)*task + lambda*kd + eps)`` mix
  (train_env/asteroid_librimix/mysystem.py:124-146).

Tensors are ``[B, S, T]``. The best permutation is taken with ``amin``,
whose gradient splits evenly between tied minima as JAX's ``min`` does.
"""

from __future__ import annotations

import itertools

import torch

Tensor = torch.Tensor

EPS = 1e-8


def pairwise_sisdr_ratio(est: Tensor, targets: Tensor, zero_mean: bool = True, eps: float = EPS) -> Tensor:
    """Pairwise SI-SDR ratio matrix [B, n_est, n_src] (wsdr.py:56-89, linear)."""
    if zero_mean:
        targets = targets - targets.mean(-1, keepdim=True)
        est = est - est.mean(-1, keepdim=True)
    s_target = targets[:, None, :, :]  # [B, 1, S, T]
    s_est = est[:, :, None, :]  # [B, S, 1, T]
    dot = (s_est * s_target).sum(-1, keepdim=True)
    energy = (s_target**2).sum(-1, keepdim=True) + eps
    proj = dot * s_target / energy
    noise = s_est - proj
    return (proj**2).sum(-1) / ((noise**2).sum(-1) + eps)


def _perm_matrix_reduce(pw: Tensor) -> Tensor:
    """Best (minimum) over source permutations of the mean of a pairwise matrix [B, est, src] -> [B]."""
    n_src = pw.shape[-1]
    perms = torch.tensor(list(itertools.permutations(range(n_src))), device=pw.device)  # [P, S]
    gathered = pw[:, perms, torch.arange(n_src, device=pw.device)]  # [B, P, S]: pw[b, perms[p, i], i]
    return gathered.mean(-1).amin(-1)


def pit_neg_sisdr_db(est: Tensor, targets: Tensor, eps: float = EPS, per_sample: bool = False) -> Tensor:
    """PIT negative SI-SDR in dB — asteroid PITLossWrapper(pairwise_neg_sisdr)."""
    pw = -10.0 * torch.log10(pairwise_sisdr_ratio(est, targets, eps=eps) + eps)
    per = _perm_matrix_reduce(pw)
    return per if per_sample else per.mean()


def pit_wsisdr_ratio(est: Tensor, targets: Tensor, weights: Tensor | None = None, eps: float = EPS,
                     per_sample: bool = False) -> Tensor:
    """PIT over the (optionally per-sample weighted) negative SI-SDR ratio matrix
    (PITLossWrapper(pairwise_wsisdr, pit_from='pw_mtx'), mysystem.py:83).

    Returns the batch mean of the per-sample minima, or the [B] minima with
    ``per_sample``; negate for the weighted best-permutation SI-SDR ratio.
    """
    pw = -pairwise_sisdr_ratio(est, targets, eps=eps)
    if weights is not None:
        pw = pw * weights[:, None, None]
    per = _perm_matrix_reduce(pw)
    return per if per_sample else per.mean()


def kd_sensitivity_weights(est: Tensor, fest: Tensor, targets: Tensor, eps: float = EPS) -> Tensor:
    """Per-sample KD weights ``w = 10**((sdr_f - sdr_q)/10)``, without gradient (mysystem.py:131-141)."""
    with torch.no_grad():
        sdrs = pit_neg_sisdr_db(fest, targets, eps, per_sample=True)
        sdrqs = pit_neg_sisdr_db(est, targets, eps, per_sample=True)
        return 10.0 ** ((sdrs - sdrqs) / 10.0)


def fqss_kd_loss(est: Tensor, fest: Tensor, targets: Tensor, kd_lambda: float, eps: float = EPS,
                 per_sample: bool = False) -> tuple[Tensor, Tensor]:
    """The FQSS speech training loss (mysystem.py:124-146): ``(loss, kd_loss_db)``.

    est: student (quantized) separations [B, S, T]; fest: float-teacher
    separations [B, S, T], detached here. ``per_sample`` keeps the [B]
    per-utterance losses (the speechbrain recipe thresholds them).
    """
    fest = fest.detach()
    if kd_lambda > 0:
        w = kd_sensitivity_weights(est, fest, targets, eps)
        kd_sdr = -pit_wsisdr_ratio(est, fest, weights=w, eps=eps, per_sample=per_sample)
        task_sdr = -pit_wsisdr_ratio(est, targets, eps=eps, per_sample=per_sample)
        loss = -10.0 * torch.log10((1.0 - kd_lambda) * task_sdr + kd_lambda * kd_sdr + eps)
        return loss, -10.0 * torch.log10(kd_sdr + eps)
    loss = pit_neg_sisdr_db(est, targets, eps, per_sample=per_sample)
    return loss, torch.zeros_like(loss)
