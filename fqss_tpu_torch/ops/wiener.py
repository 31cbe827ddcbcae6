"""Wiener filtering (EM with spatial covariances) of spectrogram masks (``fqss_tpu/ops/wiener.py``).

The openunmix expectation-maximization Wiener filter of the legacy HDemucs's
output stage (reference: hdemucsq.py:678-704 ``_wiener``, 300-frame windows).
Complex64 on every device, as JAX keeps it; the 2 x 2 (C x C) inverses are
``torch.linalg.inv``, as JAX takes ``jnp.linalg.inv`` outside any Pallas
kernel.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

EPS = 1e-10


def _covariance(y: Tensor) -> Tensor:
    """``[..., C]`` complex -> ``[..., C, C]`` outer products ``y y^H``."""
    return y[..., :, None] * torch.conj(y[..., None, :])


def wiener(targets_mag: Tensor, mix_stft: Tensor, n_iter: int = 1, residual: bool = False,
           scale_factor: float = 10.0) -> Tensor:
    """EM Wiener filter.

    ``targets_mag``: ``[F, T, C, S]`` non-negative source magnitude estimates; ``mix_stft``: ``[F, T, C]`` complex
    mixture STFT. Returns the complex source STFTs ``[F, T, C, S (+1 with residual)]``: the ratio-mask estimates,
    then ``n_iter`` EM steps, the whole scaled down by ``max(1, max |mix| / scale_factor)`` and back up.
    """
    f, t, c = mix_stft.shape
    max_abs = torch.clamp_min(mix_stft.abs().max() / scale_factor, 1.0)
    mix = mix_stft / max_abs
    mag = targets_mag / max_abs
    if residual:
        res = torch.clamp_min(mix.abs()[..., None] - mag.sum(dim=-1, keepdim=True), 0.0)
        mag = torch.cat([mag, res], dim=-1)

    total = mag.sum(dim=-1, keepdim=True) + EPS
    y = (mag / total) * mix[..., None]  # [F, T, C, S]
    eye = EPS * torch.eye(c, dtype=mix.dtype, device=mix.device)
    for _ in range(n_iter):
        # M-step: source PSDs v [F, T, S] and spatial covariances R [S, F, C, C] (frame averages)
        v = torch.mean(y.abs() ** 2, dim=2)
        cov = _covariance(y.movedim(-1, 0))  # [S, F, T, C, C]
        weight = v.permute(2, 0, 1)[..., None, None] + EPS
        r = torch.sum(cov / weight, dim=2) / t
        # E-step: Cxx = sum_j v_j R_j, gain_j = v_j R_j Cxx^-1, y_j = gain_j x
        vc = v.to(r.dtype)
        cxx = torch.einsum("ftj,jfab->ftab", vc, r) + eye
        inv_cxx = torch.linalg.inv(cxx)
        gains = torch.einsum("ftj,jfab,ftbc->jftac", vc, r, inv_cxx)  # [S, F, T, C, C]
        y = torch.einsum("jftac,ftc->ftaj", gains, mix)
    return y * max_abs


def apply_wiener_windowed(targets_mag: Tensor, mix_stft: Tensor, n_iter: int, win_len: int = 300,
                          residual: bool = False) -> Tensor:
    """The EM run on each ``win_len``-frame window of the track on its own (HDemucs._wiener,
    hdemucsq.py:678-698): ``[F, T, C, S]``, ``[F, T, C]`` -> ``[F, T, C, S (+1)]``."""
    t = mix_stft.shape[1]
    return torch.cat([wiener(targets_mag[:, s:s + win_len], mix_stft[:, s:s + win_len], n_iter, residual)
                      for s in range(0, t, win_len)], dim=1)
