"""Mixing augmentations, host-side numpy (``fqss_tpu/data/augment.py``).

Reimplements the reference's SNR-controlled remixing
(reference: process.py:57-103, train_env/train_utils.py:30-52): random-SNR
2/3-source remixes and noise mixing with 0.9 peak clipping.
"""

from __future__ import annotations

import numpy as np

from fqss_tpu_torch.utils.audio import resample_audio


def max_clip(x: np.ndarray, max_check: float = 0.9, max_clip_val: float = 0.9) -> np.ndarray:
    x_max = np.max(np.abs(x))
    if x_max >= max_check:
        x = x * (max_clip_val / x_max)
    return x


def generate_2mix_snr(sig1: np.ndarray, sig2: np.ndarray, snr: float, clip: bool = True) -> np.ndarray:
    e1, e2 = float(np.mean(sig1**2)), float(np.mean(sig2**2))
    if e1 > 0.0 and e2 > 0.0:
        current_snr = 10 * np.log10(e1 / e2)
        if current_snr < snr:
            sig2 = sig2 * np.sqrt((e1 / e2) * 10 ** (-snr / 10))
        else:
            sig1 = sig1 * np.sqrt((e2 / e1) * 10 ** (snr / 10))
    mix = sig1 + sig2
    return max_clip(mix) if clip else mix


def generate_3mix_snr(s1, s2, s3, snr1_23: float, snr2_3: float) -> np.ndarray:
    mix23 = generate_2mix_snr(s2, s3, snr2_3)
    return generate_2mix_snr(s1, mix23, snr1_23)


def generate_mix_noise(sig: np.ndarray, noise: np.ndarray, snr: float) -> np.ndarray:
    es, en = float(np.mean(sig**2)), float(np.mean(noise**2))
    gain = np.sqrt((es / en) / (10 ** (snr / 10))) if es > 0 else 1.0
    return max_clip(sig + gain * noise)


def augmentation_2mix(rng: np.random.Generator, sig1, sig2, cfg: dict) -> np.ndarray:
    if cfg.get("distribution") == "uniform":
        snr = rng.uniform(cfg.get("param0"), cfg.get("param1"))
        return generate_2mix_snr(sig1, sig2, snr)
    raise ValueError(f"Augmentation distribution not supported: {cfg.get('distribution')}")


def augmentation_3mix(rng: np.random.Generator, s1, s2, s3, cfg: dict) -> np.ndarray:
    if cfg.get("distribution") == "uniform":
        snr1_23 = rng.uniform(cfg.get("param0"), cfg.get("param1"))
        snr2_3 = rng.uniform(cfg.get("param0"), cfg.get("param1"))
        return generate_3mix_snr(s1, s2, s3, snr1_23, snr2_3)
    raise ValueError(f"Augmentation distribution not supported: {cfg.get('distribution')}")


def speed_perturb(rng: np.random.Generator, wav: np.ndarray, speeds=(95, 100, 105)) -> np.ndarray:
    """Speed perturbation by resampling (the speechbrain recipe's
    TimeDomainSpecAugment speed-perturb, speechbrain_librimix_trainer.py's
    augment path). Host-side; output length varies with the chosen speed."""
    speed = int(rng.choice(list(speeds)))
    if speed == 100:
        return wav
    return resample_audio(wav, 100, speed)


def rand_shift(rng: np.random.Generator, wav: np.ndarray, min_shift: int = -8000, max_shift: int = 8000) -> np.ndarray:
    """Random circular shift of one source (the speechbrain recipe's
    use_rand_shift, speechbrain_librimix_trainer.py:284-295: torch.roll by
    randint(min_shift, max_shift) per source before re-summing the mix)."""
    s = int(rng.integers(min_shift, max_shift))
    return np.roll(wav, s, axis=-1)


def _notch_kernel(freq: float, length: int = 101, width: float = 0.05) -> np.ndarray:
    """FIR notch filter (speechbrain notch_filter semantics): a normalized
    low-pass sinc below the notch plus a spectral-inverted low-pass above it,
    both Blackman-windowed. ``freq`` is in [0, 1] with 1 = Nyquist."""
    pad = length // 2
    t = np.arange(length, dtype=np.float64) - pad
    freq = freq + width

    def sinc(x):
        out = np.sin(x) / np.where(x == 0, 1.0, x)
        out[pad] = 1.0
        return out

    window = np.blackman(length)
    hlpf = sinc(3.0 * (freq - width) * t) * window
    hlpf /= hlpf.sum()
    hhpf = sinc(3.0 * (freq + width) * t) * window
    hhpf /= -hhpf.sum()
    hhpf[pad] += 1.0
    return (hlpf + hhpf).astype(np.float32)


def drop_freq(
    rng: np.random.Generator,
    wav: np.ndarray,
    drop_count_low: int = 1,
    drop_count_high: int = 2,
    drop_freq_low: float = 1e-14,
    drop_freq_high: float = 1.0,
    drop_width: float = 0.05,
) -> np.ndarray:
    """speechbrain DropFreq: notch-filter a few random frequencies out of the
    mixture (half of the wavedrop TimeDomainSpecAugment,
    configs/sepformer_2spks_8k.yaml drop_freq_prob)."""
    n_drops = int(rng.integers(drop_count_low, drop_count_high + 1))
    out = wav.astype(np.float32)
    for _ in range(n_drops):
        f = float(rng.uniform(drop_freq_low, drop_freq_high))
        out = np.convolve(out, _notch_kernel(f, width=drop_width), mode="same")
    return out


def drop_chunk(
    rng: np.random.Generator,
    wav: np.ndarray,
    drop_length_low: int = 100,
    drop_length_high: int = 1000,
    drop_count_low: int = 1,
    drop_count_high: int = 10,
) -> np.ndarray:
    """speechbrain DropChunk: zero out random time chunks (the other half of
    wavedrop)."""
    n_drops = int(rng.integers(drop_count_low, drop_count_high + 1))
    t = wav.shape[-1]
    out = wav.copy()
    for _ in range(n_drops):
        length = min(int(rng.integers(drop_length_low, drop_length_high + 1)), t)
        start = int(rng.integers(0, max(1, t - length)))
        out[..., start : start + length] = 0.0
    return out


def wavedrop(rng: np.random.Generator, wav: np.ndarray) -> np.ndarray:
    """TimeDomainSpecAugment(perturb_prob=0, drop_freq_prob=1,
    drop_chunk_prob=1) applied to the MIXTURE only — the speechbrain
    recipe's use_wavedrop path (speechbrain_librimix_trainer.py:70-72)."""
    return drop_chunk(rng, drop_freq(rng, wav))


def repitch(rng: np.random.Generator, wav: np.ndarray, max_pitch: int = 2, max_tempo: float = 12.0,
            sample_rate: int = 44100) -> np.ndarray:
    """Repitch/retempo augmentation (the htdemucs recipe's RepitchedWrapper):
    approximated by polyphase resampling with a random combined
    pitch (semitones) + tempo (percent) factor, then length restored by crop
    or pad. Host-side."""
    semitones = rng.integers(-max_pitch, max_pitch + 1)
    tempo = rng.uniform(-max_tempo, max_tempo)
    factor = (2.0 ** (semitones / 12.0)) * (1.0 + tempo / 100.0)
    if abs(factor - 1.0) < 1e-3:
        return wav
    t = wav.shape[-1]
    out = resample_audio(wav, 1000, max(1, int(round(1000 * factor))))
    if out.shape[-1] >= t:
        return out[..., :t]
    return np.pad(out, [(0, 0)] * (out.ndim - 1) + [(0, t - out.shape[-1])])
