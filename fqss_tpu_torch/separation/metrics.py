"""Separation quality metrics: SI-SNR, SNR, NSDR, SDR (``fqss_tpu/separation/metrics.py``).

The reference's metric stack (reference: process.py:64-152, torchmetrics +
museval) as PyTorch functions over the last axis, on any device. The
FIR-projection SDR solves its 512-tap Toeplitz system with
``torch.linalg.solve``.

``metric_evaluation`` reproduces the reference's best-permutation matching
by SI-SNR (process.py:125-152) and ``swap_channel_order`` the eval-time
per-chunk PIT re-alignment (process.py:105-123); both take and return numpy
arrays and compute on the CPU, where the evaluation loop keeps its audio.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fqss_tpu_torch.separation.stoi import stoi as stoi_fn

Tensor = torch.Tensor


def si_snr_db(est: Tensor, target: Tensor, zero_mean: bool = True, eps: float = 1e-8) -> Tensor:
    """Scale-invariant SNR in dB over the last axis (torchmetrics semantics)."""
    if zero_mean:
        est = est - est.mean(dim=-1, keepdim=True)
        target = target - target.mean(dim=-1, keepdim=True)
    dot = (est * target).sum(dim=-1, keepdim=True)
    energy = (target**2).sum(dim=-1, keepdim=True) + eps
    proj = dot * target / energy
    noise = est - proj
    ratio = ((proj**2).sum(dim=-1) + eps) / ((noise**2).sum(dim=-1) + eps)
    return 10.0 * torch.log10(ratio)


def snr_db(est: Tensor, target: Tensor, eps: float = 1e-8) -> Tensor:
    ratio = ((target**2).sum(dim=-1) + eps) / (((est - target) ** 2).sum(dim=-1) + eps)
    return 10.0 * torch.log10(ratio)


def nsisdr_db(sig: Tensor, ref: Tensor, eps: float = 1e-7) -> Tensor:
    """Normalized SI-SDR used for music KD weights (process.py:64-68)."""
    alpha = (ref * sig).sum(dim=-1) / (ref**2).sum(dim=-1)
    alpha = alpha[..., None]
    num = ((alpha * ref) ** 2).sum(dim=-1) + eps
    den = ((sig - alpha * ref) ** 2).sum(dim=-1) + eps
    return 10.0 * torch.log10(num / den)


def sdr_db(est: Tensor, target: Tensor, filter_length: int = 512, zero_mean: bool = False,
           eps: float = 1e-8) -> Tensor:
    """FIR-projection SDR (torchmetrics SignalDistortionRatio semantics, fast-bss-eval style):
    allows a ``filter_length``-tap distortion filter on the reference. est/target: [..., T]."""
    if zero_mean:
        est = est - est.mean(dim=-1, keepdim=True)
        target = target - target.mean(dim=-1, keepdim=True)

    # autocorrelation of the target (Toeplitz) and its cross-correlation with est, by FFT
    t_len = est.shape[-1]
    n_fft = 2 ** math.ceil(math.log2(t_len + filter_length))
    tf = torch.fft.rfft(target, n_fft)
    ef = torch.fft.rfft(est, n_fft)
    acf = torch.fft.irfft(tf * tf.conj(), n_fft)[..., :filter_length]
    xcorr = torch.fft.irfft(ef * tf.conj(), n_fft)
    # b_j = sum_t est[t] target[t - j] = xcorr at lag j
    b = xcorr[..., :filter_length]

    # Solve the Toeplitz system R h = b (R from acf) as a dense solve.
    ar = torch.arange(filter_length, device=est.device)
    idx = (ar[:, None] - ar[None, :]).abs()
    R = acf[..., idx]
    R = R + eps * acf[..., :1, None] * torch.eye(filter_length, dtype=acf.dtype, device=acf.device)
    h = torch.linalg.solve(R, b[..., None])[..., 0]

    # SDR = coherent energy ratio: ||proj||^2 / (||est||^2 - ||proj||^2). The
    # residual is clamped at a relative floor: perfect reconstruction cancels
    # catastrophically in float32, capping the metric at -10*log10(eps).
    proj_energy = (h * b).sum(dim=-1)
    est_energy = (est**2).sum(dim=-1)
    residual = torch.clamp(est_energy - proj_energy, min=0.0) + eps * est_energy + eps
    return 10.0 * torch.log10((proj_energy + eps) / residual)


def _pair_si_snr(sep: np.ndarray, clean: np.ndarray) -> np.ndarray:
    """SI-SNR of every output channel against every clean source: [n_src, n_src]."""
    sep_t = torch.from_numpy(np.asarray(sep, np.float32))
    clean_t = torch.from_numpy(np.asarray(clean, np.float32))
    return si_snr_db(sep_t[:, None, :], clean_t[None, :, :]).numpy()


def swap_channel_order(sep: np.ndarray, clean: np.ndarray) -> np.ndarray:
    """Per-chunk PIT re-alignment with sign fix (process.py:105-123).

    sep/clean: [n_src, T] numpy. For each model output channel, place it at
    the index of the clean source it best matches by SI-SNR; if swapped, the
    signal is negated (faithful to the reference's sign-fix quirk).
    """
    n_src = clean.shape[0]
    if n_src == 1:
        return sep
    new_sep = sep.copy()
    sisnr = _pair_si_snr(sep, clean)
    for src in range(n_src):
        best = int(np.argmax(sisnr[src]))
        new_sep[best] = sep[src] if src == best else -sep[src]
    return new_sep


def metric_evaluation(sep: np.ndarray, clean: np.ndarray, sample_rate: int = 16000,
                      compute_stoi: bool = True) -> tuple[float, float, float]:
    """Best-permutation SI-SNR / SDR / STOI per source, averaged
    (process.py:125-152). sep/clean: [n_src, T] numpy."""
    n_src = clean.shape[0]
    sisnrs, sdrs, stois = np.zeros(n_src), np.zeros(n_src), np.zeros(n_src)
    pair_sisnr = _pair_si_snr(sep, clean)
    for src in range(n_src):
        best = int(np.argmax(pair_sisnr[src]))
        ref = clean[best]
        sisnrs[src] = pair_sisnr[src, best]
        sdrs[src] = float(sdr_db(torch.from_numpy(np.asarray(sep[src], np.float32)),
                                 torch.from_numpy(np.asarray(ref, np.float32))))
        stois[src] = stoi_fn(sep[src], ref, sample_rate) if compute_stoi else np.nan
    return float(sisnrs.mean()), float(sdrs.mean()), float(stois.mean())
