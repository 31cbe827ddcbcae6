"""BSS Eval v4 (images, framewise): SDR / ISR / SIR / SAR (``fqss_tpu/separation/bss_eval.py``).

The museval metrics the reference consumes through ``museval.eval_mus_track``
(reference: val.py:134-181), following museval's
``_bss_decomp_mtifilt_images``: for true source images s_j [C, W] and
estimates e_j [C, W], each window builds the least-squares projections of
every estimate channel onto the {0..L-1}-shifted copies of (a) source j's
channels and (b) all sources' channels (filter length L = 512 by default),
on the zero-padded support [0, W+L-1):

    s_true   = pad(s_j)
    e_spat   = P_j(e_j)   - s_true
    e_interf = P_all(e_j) - P_j(e_j)
    e_artif  = pad(e_j)   - P_all(e_j)

    SDR = 10 log10 |s_true|^2 / |e_spat + e_interf + e_artif|^2
    ISR = 10 log10 |s_true|^2 / |e_spat|^2
    SIR = 10 log10 |s_true + e_spat|^2 / |e_interf|^2
    SAR = 10 log10 |s_true + e_spat + e_interf|^2 / |e_artif|^2

The Gram and cross-correlation systems are assembled with FFTs and solved
as one batched linear system. Framewise protocol (museval defaults): window
= hop = 1 s, NaN for windows whose reference is silent; :func:`aggregate_frames`
takes museval's median over the frames.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _bss_eval_window(refs: Tensor, ests: Tensor, filter_length: int = 512):
    """One window: refs/ests [S, C, W] -> (sdr, isr, sir, sar) each [S]."""
    s, c, w = refs.shape
    m = s * c
    L = filter_length
    nfft = _next_pow2(w + L - 1)

    rf = torch.fft.rfft(refs.reshape(m, w), nfft)  # [M, F]
    ef = torch.fft.rfft(ests.reshape(s, c, w), nfft)  # [S, C, F]

    # cross-correlations c_ij(d) = sum_t x_i[t] x_j[t+d] for all reference pairs
    cross = torch.fft.irfft(rf.conj()[:, None] * rf[None, :], nfft)  # [M, M, nfft]
    ar = torch.arange(L)
    lag = (ar[:, None] - ar[None, :]) % nfft  # a - b mod nfft
    G = cross[:, :, lag]  # [M, M, L, L]; G[(i,a),(j,b)] = c_ij(a-b)
    G = G.permute(0, 2, 1, 3).reshape(m * L, m * L)
    # Tikhonov jitter keeps the solve stable when references are correlated
    eps = 1e-8 * (torch.trace(G) / (m * L) + 1e-12)
    G = G + eps * torch.eye(m * L, dtype=G.dtype)

    # D[(j,a), (s,c)] = sum_t ref_j[t-a] est_sc[t]
    D = torch.fft.irfft(rf.conj()[:, None, None, :] * ef[None, :, :, :], nfft)[..., :L]
    D = D.permute(0, 3, 1, 2).reshape(m * L, s * c)  # [M*L, S*C]

    coef_all = torch.linalg.solve(G, D)  # projection onto all references' shifts

    wp = w + L - 1  # padded support (museval keeps the projection tail)
    h = coef_all.reshape(m, L, s * c)
    hf = torch.fft.rfft(h, nfft, dim=1)  # [M, F, S*C]
    p_all = torch.fft.irfft(torch.einsum("mf,mfk->kf", rf, hf), nfft)[:, :wp].reshape(s, c, wp)

    # per-source projection: solve the j-th diagonal block for estimate j only
    Gb = G.reshape(s, c * L, s, c * L)
    Db = D.reshape(s, c * L, s, c)
    diag = torch.arange(s)
    coef_j = torch.linalg.solve(Gb[diag, :, diag], Db[diag, :, diag])  # [S, C*L, C]
    hj = torch.fft.rfft(coef_j.reshape(s, c, L, c), nfft, dim=2)  # [S, C, F, C]
    p_j = torch.fft.irfft(torch.einsum("smf,smfk->skf", rf.reshape(s, c, -1), hj), nfft)[..., :wp]  # [S, C, W+L-1]

    s_true = torch.nn.functional.pad(refs, (0, L - 1))
    ests_p = torch.nn.functional.pad(ests, (0, L - 1))
    e_spat = p_j - s_true
    e_interf = p_all - p_j
    e_artif = ests_p - p_all

    def energy(x):
        return (x**2).sum(dim=(1, 2))

    eps_e = 1e-12
    sdr = 10.0 * torch.log10((energy(s_true) + eps_e) / (energy(ests_p - s_true) + eps_e))
    isr = 10.0 * torch.log10((energy(s_true) + eps_e) / (energy(e_spat) + eps_e))
    sir = 10.0 * torch.log10((energy(s_true + e_spat) + eps_e) / (energy(e_interf) + eps_e))
    sar = 10.0 * torch.log10((energy(s_true + e_spat + e_interf) + eps_e) / (energy(e_artif) + eps_e))
    return sdr, isr, sir, sar


def bss_eval_images_framewise(
    refs: np.ndarray,
    ests: np.ndarray,
    window: int,
    hop: int | None = None,
    filter_length: int = 512,
    silence_eps: float = 1e-10,
) -> dict[str, np.ndarray]:
    """Framewise BSS Eval v4 over a whole track, on the CPU.

    refs/ests: [S, C, T] (or [S, T] mono). Returns {"SDR","ISR","SIR","SAR"}:
    [S, n_frames] with NaN for frames whose reference source is silent
    (museval skips those from the median).
    """
    refs = np.asarray(refs, np.float32)
    ests = np.asarray(ests, np.float32)
    if refs.ndim == 2:  # [S, T] mono
        refs = refs[:, None, :]
        ests = ests[:, None, :]
    s, c, t = refs.shape
    hop = hop or window
    n_frames = max(1, (t - window) // hop + 1) if t >= window else 0
    if n_frames == 0:  # short track: one window over everything
        n_frames, window, hop = 1, t, t

    out = {k: np.full((s, n_frames), np.nan, np.float32) for k in ("SDR", "ISR", "SIR", "SAR")}
    for f in range(n_frames):
        sl = slice(f * hop, f * hop + window)
        r = refs[..., sl]
        e = ests[..., sl]
        flen = min(filter_length, r.shape[-1])
        vals = _bss_eval_window(torch.from_numpy(np.ascontiguousarray(r)), torch.from_numpy(np.ascontiguousarray(e)),
                                filter_length=flen)
        silent = np.sum(r**2, axis=(1, 2)) < silence_eps
        for k, v in zip(("SDR", "ISR", "SIR", "SAR"), vals):
            out[k][:, f] = np.where(silent, np.nan, v.numpy())
    return out


def aggregate_frames(scores: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Median over frames per source, silent (NaN) frames left out (museval EvalStore frame aggregation)."""
    return {k: np.nanmedian(v, axis=1) for k, v in scores.items()}
