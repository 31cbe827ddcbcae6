"""STFT / iSTFT with ``torch.stft``-parity semantics (``fqss_tpu/ops/stft.py``).

The transforms of HTDemucs's spectrogram branch: Hann window, ``normalized``
(the spectrum scaled by 1/sqrt(n_fft)), centred with a reflect pad. The FFT
is ``torch.fft.rfft``/``irfft`` (cuFFT on the card), as the JAX package
takes XLA's FFT, outside any Pallas kernel. The framing and the inverse's
overlap-add are the JAX function's: frames are views of the padded signal,
and the inverse sums each output sample's frames in frame order (the order
of XLA's scatter-add) before it divides by the squared window's envelope.
Every step is a differentiable PyTorch operation.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def hann_window(n: int) -> np.ndarray:
    """torch.hann_window(n, periodic=True), computed as the JAX package computes it."""
    return (0.5 * (1 - np.cos(2 * np.pi * np.arange(n) / n))).astype(np.float32)


def _window(n: int, window: Tensor | None, like: Tensor) -> Tensor:
    return torch.from_numpy(hann_window(n)).to(like.device) if window is None else window


def reflect_pad(x: Tensor, left: int, right: int) -> Tensor:
    """``jnp.pad(mode="reflect")`` of the last axis, any number of leading axes."""
    lead = x.shape[:-1]
    y = F.pad(x.reshape(-1, 1, x.shape[-1]), (left, right), mode="reflect")
    return y.reshape(*lead, y.shape[-1])


def stft(x: Tensor, n_fft: int, hop: int, window: Tensor | None = None, normalized: bool = True) -> Tensor:
    """``[..., T]`` -> complex ``[..., n_fft // 2 + 1, frames]`` (centre, reflect pad)."""
    window = _window(n_fft, window, x)
    pad = n_fft // 2
    frames = reflect_pad(x, pad, pad).unfold(-1, n_fft, hop) * window  # [..., frames, n_fft]
    spec = torch.fft.rfft(frames, n_fft, dim=-1)
    if normalized:
        spec = spec * float(np.float32(1.0 / np.sqrt(n_fft)))
    return spec.transpose(-1, -2)


def _overlap_add(frames: Tensor, hop: int) -> Tensor:
    """``[..., n_frames, n]`` -> ``[..., n + hop (n_frames - 1)]``: frame f added at offset ``f hop``; each output
    sample sums its frames from the first to the last, as XLA's scatter-add does."""
    *lead, n_frames, n = frames.shape
    r = -(-n // hop)  # hop-sized pieces of a frame
    pieces = F.pad(frames, (0, r * hop - n)).reshape(*lead, n_frames, r, hop)
    out = None
    for j in reversed(range(r)):  # output piece c takes frame c - j: the earliest frame first
        part = F.pad(pieces[..., j, :], (0, 0, j, r - 1 - j))
        out = part if out is None else out + part
    return out.reshape(*lead, (n_frames + r - 1) * hop)[..., : n + hop * (n_frames - 1)]


def istft(z: Tensor, n_fft: int, hop: int, window: Tensor | None = None, normalized: bool = True,
          length: int | None = None) -> Tensor:
    """complex ``[..., n_fft // 2 + 1, frames]`` -> ``[..., length]`` (centre)."""
    window = _window(n_fft, window, z)
    z = z.transpose(-1, -2)  # [..., frames, freq]
    if normalized:
        z = z * float(np.float32(np.sqrt(n_fft)))
    frames = torch.fft.irfft(z, n_fft, dim=-1) * window  # [..., frames, n_fft]
    n_frames = frames.shape[-2]
    out_len = n_fft + hop * (n_frames - 1)
    y = _overlap_add(frames, hop)
    env = _overlap_add((window**2).expand(n_frames, n_fft), hop)
    y = y / torch.clamp_min(env, 1e-11)
    pad = n_fft // 2
    y = y[..., pad:]
    return y[..., :length] if length is not None else y[..., : out_len - 2 * pad]


def spectro(x: Tensor, n_fft: int, hop: int) -> Tensor:
    """demucs ``spectro``."""
    return stft(x, n_fft, hop)


def ispectro(z: Tensor, hop: int, length: int | None = None) -> Tensor:
    """demucs ``ispectro``: n_fft from the one-sided frequency count."""
    return istft(z, 2 * (z.shape[-2] - 1), hop, length=length)
