"""Audio I/O and resampling on the host (``fqss_tpu/utils/audio.py``).

WAV read/write through scipy, a WAV header's sizes and a segment read
through the standard ``wave`` module, polyphase resampling, peak
normalisation and the numpy/python seeding of the data pipeline. numpy and
scipy only.
"""

from __future__ import annotations

import os
import random
import wave

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


def wav_info(path: str) -> tuple[int, int, int]:
    """(n_frames, sample_rate, n_channels) without reading samples."""
    with wave.open(path, "rb") as f:
        return f.getnframes(), f.getframerate(), f.getnchannels()


def read_wav_segment(path: str, offset: int = 0, n_frames: int = -1) -> tuple[np.ndarray, int]:
    """float32 ``[C, n]`` frames ``[offset, offset + n_frames)`` of a 16-bit PCM WAV (all to the end with
    ``n_frames < 0``; fewer at the end of the file) and the sample rate, read without decoding the rest
    (the JAX package's ``fqss_tpu/native`` reader, which the MUSDB loader crops with). The samples equal
    :func:`read_audio`'s."""
    with wave.open(path, "rb") as f:
        if f.getsampwidth() != 2:
            raise ValueError(f"read_wav_segment: 16-bit PCM expected, {path} has {8 * f.getsampwidth()}-bit samples")
        channels, total = f.getnchannels(), f.getnframes()
        offset = min(max(offset, 0), total)
        f.setpos(offset)
        frames = f.readframes(total - offset if n_frames < 0 else n_frames)
        sr = f.getframerate()
    pcm = np.frombuffer(frames, dtype="<i2").reshape(-1, channels)
    return np.ascontiguousarray(pcm.T.astype(np.float32) / 32768.0), int(sr)


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
