"""Overlap-add (OLA) chunked inference for long mixtures (``fqss_tpu/separation/ola.py``).

All chunks of a track are cut on the host, pushed through the model in
batches of ``chunk_batch`` on the device, and recombined on the host with
the reference's triangular cross-fade weights (process.py:154-194). Chunks
are batched and zero-padded exactly as the JAX function does, because the
splitter normalises by the max-abs of the whole batch.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def triangular_weight(segment: int) -> np.ndarray:
    """The reference's cross-fade window (process.py:164-166)."""
    w = np.concatenate([np.arange(1, segment // 2 + 1), np.arange(segment - segment // 2, 0, -1)])
    return (w / w.max()).astype(np.float32)


def ola_infer(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    mix: np.ndarray,
    n_srcs: int = 1,
    segment: int | None = None,
    overlap: float = 0.25,
    target: np.ndarray | None = None,
    chunk_batch: int = 8,
    mesh=None,
    center_pad_to: int | None = None,
    device: torch.device | str = "cpu",
) -> np.ndarray:
    """Chunked separation of one track.

    apply_fn: model forward over a [K, segment] (or [K, C, segment]) batch
              of chunks on ``device`` -> [K, S, segment'] separations.
    mix: [C, T] numpy waveform. Returns [S, T] (or [S, C, T] for C > 1).

    The per-chunk PIT re-alignment (``target``), chunk sharding (``mesh``)
    and centred padding (``center_pad_to``) are not ported yet (ROADMAP.md,
    queue 1) and raise ``NotImplementedError``.
    """
    for name, value in (("target", target), ("mesh", mesh), ("center_pad_to", center_pad_to)):
        if value is not None:
            raise NotImplementedError(f"ola_infer({name}=...) is not ported yet (ROADMAP.md, queue 1)")
    mix = np.asarray(mix, np.float32)
    channels, length = mix.shape

    def run(block: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            return apply_fn(torch.from_numpy(block).to(device)).float().cpu().numpy()

    if not segment:
        out = run(mix[None, 0] if channels == 1 else mix[None])[0]
        pad = length - out.shape[-1]
        if pad > 0:
            out = np.pad(out, [(0, 0)] * (out.ndim - 1) + [(0, pad)])
        return out[..., :length]

    stride = int((1 - overlap) * segment)
    offsets = list(range(0, length, stride))
    weight = triangular_weight(segment)

    # Right-zero-padded chunks (the reference speech path, process.py:176).
    chunks = np.zeros((len(offsets), channels, segment), np.float32)
    chunk_lens = []
    for i, off in enumerate(offsets):
        stop = min(off + segment, length)
        chunks[i, :, : stop - off] = mix[:, off:stop]
        chunk_lens.append(stop - off)

    outs = []
    for i in range(0, len(offsets), chunk_batch):
        block = chunks[i : i + chunk_batch]
        pad_n = chunk_batch - block.shape[0]
        if pad_n:
            block = np.concatenate([block, np.zeros((pad_n, channels, segment), np.float32)])
        y = run(block[:, 0] if channels == 1 else block)
        if pad_n:
            y = y[: chunk_batch - pad_n]
        outs.append(y[..., :segment])
    chunk_out = np.concatenate(outs, axis=0)  # [K, S, (C,) segment]

    out_shape = (n_srcs, channels, length) if channels > 1 else (n_srcs, length)
    out = np.zeros(out_shape, np.float32)
    sum_weight = np.zeros(length, np.float32)
    for i, off in enumerate(offsets):
        clen = chunk_lens[i]
        out[..., off : off + clen] += weight[:clen] * chunk_out[i][..., :clen]
        sum_weight[off : off + clen] += weight[:clen]
    if sum_weight.min() <= 0:
        raise ValueError(f"overlap={overlap} leaves samples that no chunk covers")
    return out / sum_weight
