"""Synthetic speech-like mixtures (``fqss_tpu/data/synthetic.py:synth_batch``).

Deterministic multi-speaker mixtures from a numpy generator, for the smoke
run and the tests, so that the port needs no dataset on disk. The same seed
gives the same arrays as the JAX package's generator.
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
