"""Synthetic speech-like mixtures and music stems (``fqss_tpu/data/synthetic.py``).

Deterministic multi-speaker mixtures (:func:`synth_batch`), the
band-disjoint two-source task (:func:`synth_band_batch`) and stereo
multi-stem music (:func:`synth_music_batch`) from a numpy generator, for the
smoke run and the tests, so that the port needs no dataset on disk. The same
seed gives the same arrays as the JAX package's generators.
"""

from __future__ import annotations

import numpy as np


def synth_sources(rng: np.random.Generator, batch: int, n_src: int, length: int,
                  sample_rate: int = 8000) -> np.ndarray:
    """Band-limited random 'speech-like' sources [B, S, T] with AM envelopes."""
    t = np.arange(length) / sample_rate
    out = np.zeros((batch, n_src, length), np.float32)
    for b in range(batch):
        for s in range(n_src):
            sig = np.zeros(length, np.float32)
            for _ in range(4):
                f0 = rng.uniform(80, 1200)
                sig += rng.uniform(0.2, 1.0) * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 2 * np.pi))
            env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(0.5, 3.0) * t + rng.uniform(0, 2 * np.pi)))
            sig = sig * env + 0.01 * rng.standard_normal(length)
            out[b, s] = 0.5 * sig / (np.abs(sig).max() + 1e-8)
    return out


def synth_batch(rng: np.random.Generator, batch: int, n_src: int, length: int,
                sample_rate: int = 8000) -> tuple[np.ndarray, np.ndarray]:
    """(mixture [B, T], sources [B, S, T]), the mixture peak-limited to 0.9."""
    src = synth_sources(rng, batch, n_src, length, sample_rate)
    mix = src.sum(axis=1)
    peak = np.abs(mix).max(axis=-1, keepdims=True) + 1e-8
    scale = np.minimum(1.0, 0.9 / peak)
    return (mix * scale).astype(np.float32), (src * scale[:, None]).astype(np.float32)


def synth_band_sources(
    rng: np.random.Generator,
    batch: int,
    length: int,
    sample_rate: int = 8000,
    bands: tuple[tuple[float, float], ...] = ((150.0, 1300.0), (2700.0, 3800.0)),
    n_tones: int = 6,
) -> np.ndarray:
    """Band-disjoint 2-source task for the QAT quality experiment.

    Each source is a sum of sinusoids confined to its own frequency band with
    a wide guard gap, plus a slow AM envelope — an *easy* separation task a
    small float model solves to 30+ dB SI-SDR. That head-room is the point:
    it exposes the SDR ceiling that 8-bit input/output quantization imposes
    (the failure mode the FQSS splitter/combiner exists to lift — reference
    README.md:3-7), which a hard task (float plateauing near 7 dB) cannot.
    """
    t = np.arange(length) / sample_rate
    out = np.zeros((batch, len(bands), length), np.float32)
    for b in range(batch):
        for s, (f_lo, f_hi) in enumerate(bands):
            sig = np.zeros(length, np.float64)
            for _ in range(n_tones):
                f0 = rng.uniform(f_lo, f_hi)
                sig += rng.uniform(0.3, 1.0) * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 2 * np.pi))
            env = 1.0 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.3, 2.0) * t + rng.uniform(0, 2 * np.pi))
            sig = sig * env
            out[b, s] = rng.uniform(0.4, 1.0) * sig / (np.abs(sig).max() + 1e-8)
    return out


def synth_band_batch(
    rng: np.random.Generator, batch: int, length: int, sample_rate: int = 8000
) -> tuple[np.ndarray, np.ndarray]:
    """(mixture [B, T], sources [B, 2, T]) for the band-disjoint task."""
    src = synth_band_sources(rng, batch, length, sample_rate)
    mix = src.sum(axis=1)
    peak = np.abs(mix).max(axis=-1, keepdims=True) + 1e-8
    scale = np.minimum(1.0, 0.9 / peak)
    return (mix * scale).astype(np.float32), (src * scale[:, None]).astype(np.float32)


_MUSIC_BANDS = ((60.0, 300.0), (350.0, 900.0), (1000.0, 1900.0), (2200.0, 3400.0))


def _hard_music_stem(rng: np.random.Generator, s: int, t: np.ndarray,
                     sample_rate: int) -> np.ndarray:
    """One mono stem for the spectrally-overlapping 'hard' music task.

    Stems share the 80–3400 Hz band but are identifiable by *timbre* — the
    analog of fixed stem identity (drums/bass/vocals/other) in real stem
    separation, where there is no PIT and the model must learn what each
    output slot sounds like. Without this, an all-same-band tone-stack task
    gives the model nothing to key stem identity on and no variant trains
    above ~1 dB NSDR.
    """
    length = t.shape[0]
    kind = s % 4
    if kind == 0:  # bass-ish: low-f0 harmonic stack, amplitudes 1/k
        f0 = rng.uniform(70.0, 160.0)
        sig = np.zeros(length, np.float64)
        for k in range(1, 6):
            sig += (1.0 / k) * np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 2 * np.pi))
        env = 1.0 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.3, 1.0) * t + rng.uniform(0, 2 * np.pi))
        return sig * env
    if kind == 1:  # drums-ish: periodic exponentially-decaying noise bursts
        rate = rng.uniform(2.0, 6.0)
        period = max(1, int(sample_rate / rate))
        decay = np.exp(-np.arange(length) / (0.02 * sample_rate))
        hits = np.zeros(length, np.float64)
        hits[rng.integers(0, period)::period] = 1.0
        burst = np.convolve(hits, decay[: int(0.08 * sample_rate)])[:length]
        return burst * rng.standard_normal(length)
    if kind == 2:  # vocal-ish: vibrato harmonic stack, odd partials
        f0 = rng.uniform(200.0, 600.0)
        vib = 1.0 + 0.03 * np.sin(2 * np.pi * 5.0 * t + rng.uniform(0, 2 * np.pi))
        phase = 2 * np.pi * f0 * np.cumsum(vib) / sample_rate
        sig = np.zeros(length, np.float64)
        for k in (1, 3, 5):
            sig += (1.0 / k) * np.sin(k * phase + rng.uniform(0, 2 * np.pi))
        env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(0.5, 2.0) * t + rng.uniform(0, 2 * np.pi)))
        return sig * env
    # pad-ish: smoothed wideband noise under a slow envelope
    noise = rng.standard_normal(length)
    k = np.ones(8) / 8.0
    sig = np.convolve(noise, k, mode="same")
    env = 1.0 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.1, 0.5) * t + rng.uniform(0, 2 * np.pi))
    return sig * env


def synth_music_batch(
    rng: np.random.Generator,
    batch: int,
    length: int,
    sample_rate: int = 8000,
    n_stems: int = 4,
    band_disjoint: bool = True,
) -> np.ndarray:
    """Stereo multi-stem 'music' batch [B, S, 2, T] for the music QAT
    quality experiment (the stereo/4-stem analog of synth_band_sources).

    Each stem is a tone stack with an AM envelope, rendered to two channels
    with a per-stem stereo image (per-channel gain + interaural phase).
    ``band_disjoint=True`` confines each stem to its own frequency band — an
    easy task that exposes the 8-bit I/O ceiling the FQSS splitter/combiner
    lifts; ``False`` gives every stem the same wide band but a distinct
    *timbre* per output slot (_hard_music_stem) — the hard task, where
    accuracy is model-limited instead, and stem identity is learnable the
    way fixed-order stems are in real music separation (no PIT in the music
    trainers). The mixture (sum of stems) is peak-normalized to 0.9,
    matching the music trainers' mix = sources.sum(1) convention
    (musdbhq_train.py:60-66).
    """
    t = np.arange(length) / sample_rate
    out = np.zeros((batch, n_stems, 2, length), np.float32)
    for b in range(batch):
        for s in range(n_stems):
            pan = rng.uniform(0.2, 0.8)  # constant-power stereo position
            gains = (np.cos(pan * np.pi / 2), np.sin(pan * np.pi / 2))
            itd = rng.uniform(0.0, 2e-4)  # interaural delay, seconds
            sig_ch = []
            if band_disjoint:
                f_lo, f_hi = _MUSIC_BANDS[s % len(_MUSIC_BANDS)]
                tones = [
                    (rng.uniform(f_lo, f_hi), rng.uniform(0.3, 1.0), rng.uniform(0, 2 * np.pi))
                    for _ in range(6)
                ]
                env = 1.0 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.3, 2.0) * t + rng.uniform(0, 2 * np.pi))
                for ch, g in enumerate(gains):
                    sig = np.zeros(length, np.float64)
                    for f0, a, ph in tones:
                        sig += a * np.sin(2 * np.pi * f0 * (t - ch * itd) + ph)
                    sig_ch.append(g * sig * env)
            else:
                mono = _hard_music_stem(rng, s, t, sample_rate)
                for ch, g in enumerate(gains):
                    # fractional interaural delay for arbitrary (noise) stems
                    sig_ch.append(g * np.interp(t - ch * itd, t, mono))
            stem = np.stack(sig_ch)
            out[b, s] = rng.uniform(0.4, 1.0) * stem / (np.abs(stem).max() + 1e-8)
        mix_peak = np.abs(out[b].sum(axis=0)).max() + 1e-8
        out[b] *= min(1.0, 0.9 / mix_peak)
    return out
