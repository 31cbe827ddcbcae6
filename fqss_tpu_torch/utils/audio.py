"""Audio I/O and resampling on the host (``fqss_tpu/utils/audio.py``).

WAV read/write through scipy, polyphase resampling, peak normalisation and
the numpy/python seeding of the data pipeline. numpy and scipy only.
"""

from __future__ import annotations

import os
import random

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def read_audio(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 [C, T] in [-1, 1], sample_rate)."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    data = data[None, :] if data.ndim == 1 else data.T  # scipy gives [T, C]
    return np.ascontiguousarray(data), int(sr)


def save_audio(path: str, waveform: np.ndarray, sample_rate: int) -> None:
    """Write float32 [C, T] (or [T]) to a 16-bit PCM WAV."""
    waveform = np.asarray(waveform, np.float32)
    if waveform.ndim == 1:
        waveform = waveform[None, :]
    pcm = np.clip(waveform.T * 32767.0, -32768, 32767).astype(np.int16)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    wavfile.write(path, sample_rate, pcm if pcm.shape[1] > 1 else pcm[:, 0])


def resample_audio(waveform: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase resampling along the last axis."""
    if orig_sr == new_sr:
        return waveform
    g = np.gcd(int(orig_sr), int(new_sr))
    return resample_poly(waveform, new_sr // g, orig_sr // g, axis=-1).astype(np.float32)


def normalize_audio(waveform: np.ndarray, axis: int = -1) -> np.ndarray:
    """Peak normalisation."""
    peak = np.max(np.abs(waveform), axis=axis, keepdims=True)
    return waveform / np.maximum(peak, 1e-12)


def set_seed(seed: int) -> None:
    """Seed numpy's and python's global generators (the data pipeline's)."""
    np.random.seed(seed)
    random.seed(seed)
