"""Short-Time Objective Intelligibility (STOI) metric (``fqss_tpu/separation/stoi.py``).

Host-side numpy implementation of the standard STOI algorithm
(C.H. Taal et al., "An Algorithm for Intelligibility Prediction of
Time-Frequency Weighted Noisy Speech", IEEE TASL 2011) — the metric the
reference consumes through torchmetrics/pystoi
(reference: process.py:4,147-148). Eval-only, so numpy is appropriate
(matches the reference's CPU metric path).
"""

from __future__ import annotations

import numpy as np
from scipy.signal import resample_poly

FS = 10000  # internal sample rate
N_FRAME = 256
NFFT = 512
NUM_BANDS = 15
MIN_FREQ = 150.0
N = 30  # analysis segment length in frames
BETA = -15.0  # SDR clip (dB)
DYN_RANGE = 40.0  # silent-frame removal threshold (dB)


def _thirdoct(fs: int, nfft: int, num_bands: int, min_freq: float) -> np.ndarray:
    """1/3-octave band matrix [num_bands, nfft//2 + 1]."""
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands)
    cf = 2.0 ** (k / 3.0) * min_freq
    lo = cf * 2 ** (-1.0 / 6)
    hi = cf * 2 ** (1.0 / 6)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        lo_idx = np.argmin((f - lo[i]) ** 2)
        hi_idx = np.argmin((f - hi[i]) ** 2)
        obm[i, lo_idx:hi_idx] = 1.0
    return obm


def _remove_silent_frames(x: np.ndarray, y: np.ndarray, dyn_range: float, framelen: int, hop: int):
    w = np.hanning(framelen + 2)[1:-1]
    n_frames = (len(x) - framelen) // hop + 1
    if n_frames <= 0:
        return x, y
    frames = np.arange(n_frames)[:, None] * hop + np.arange(framelen)[None, :]
    x_frames = x[frames] * w
    y_frames = y[frames] * w
    energies = 20 * np.log10(np.linalg.norm(x_frames, axis=1) + 1e-12)
    mask = energies > (np.max(energies) - dyn_range)
    x_frames, y_frames = x_frames[mask], y_frames[mask]
    # overlap-add back
    n_kept = len(x_frames)
    out_len = (n_kept - 1) * hop + framelen if n_kept else 0
    x_out = np.zeros(out_len)
    y_out = np.zeros(out_len)
    for i in range(n_kept):
        x_out[i * hop : i * hop + framelen] += x_frames[i]
        y_out[i * hop : i * hop + framelen] += y_frames[i]
    return x_out, y_out


def _stft_mag(x: np.ndarray, framelen: int, hop: int, nfft: int) -> np.ndarray:
    w = np.hanning(framelen + 2)[1:-1]
    n_frames = (len(x) - framelen) // hop + 1
    frames = np.arange(n_frames)[:, None] * hop + np.arange(framelen)[None, :]
    spec = np.fft.rfft(x[frames] * w, nfft, axis=1)
    return np.abs(spec)  # [n_frames, nfft//2+1]


def stoi(est: np.ndarray, ref: np.ndarray, fs: int) -> float:
    """STOI of degraded ``est`` against clean ``ref`` at sample rate ``fs``."""
    est = np.asarray(est, np.float64).reshape(-1)
    ref = np.asarray(ref, np.float64).reshape(-1)
    if fs != FS:
        g = np.gcd(int(fs), FS)
        est = resample_poly(est, FS // g, fs // g)
        ref = resample_poly(ref, FS // g, fs // g)

    ref, est = _remove_silent_frames(ref, est, DYN_RANGE, N_FRAME, N_FRAME // 2)
    if len(ref) < N_FRAME * (N + 1) // 2:
        return float("nan")  # too short after silence removal

    obm = _thirdoct(FS, NFFT, NUM_BANDS, MIN_FREQ)
    X = np.sqrt(obm @ (_stft_mag(ref, N_FRAME, N_FRAME // 2, NFFT).T ** 2))  # [bands, frames]
    Y = np.sqrt(obm @ (_stft_mag(est, N_FRAME, N_FRAME // 2, NFFT).T ** 2))

    if X.shape[1] < N:
        return float("nan")

    c = 10 ** (-BETA / 20.0)
    d_sum, count = 0.0, 0
    for m in range(N, X.shape[1] + 1):
        x_seg = X[:, m - N : m]  # [bands, N]
        y_seg = Y[:, m - N : m]
        alpha = np.linalg.norm(x_seg, axis=1, keepdims=True) / (np.linalg.norm(y_seg, axis=1, keepdims=True) + 1e-12)
        y_prime = np.minimum(alpha * y_seg, x_seg * (1 + c))
        xm = x_seg - x_seg.mean(axis=1, keepdims=True)
        ym = y_prime - y_prime.mean(axis=1, keepdims=True)
        corr = np.sum(xm * ym, axis=1) / (np.linalg.norm(xm, axis=1) * np.linalg.norm(ym, axis=1) + 1e-12)
        d_sum += corr.sum()
        count += NUM_BANDS
    return float(d_sum / count)
