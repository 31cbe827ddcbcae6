"""Overlap-add (OLA) chunked inference for long mixtures (``fqss_tpu/separation/ola.py``).

All chunks of a track are cut on the host, pushed through the model in
batches of ``chunk_batch`` on the device (``chunk_batch`` a rank over a
data-parallel mesh), and recombined on the host with
the reference's triangular cross-fade weights (process.py:154-194). Chunks
are batched and padded (right-zero, or centred with the mixture as context)
exactly as the JAX function does, because the
splitter normalises by the max-abs of the whole batch. Optional per-chunk
PIT re-alignment against a target (``swap_channel_order``,
process.py:105-123) matches the reference's eval behaviour.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from fqss_tpu_torch.parallel import mesh as dp
from fqss_tpu_torch.separation.metrics import swap_channel_order


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
    target: the clean sources [S, T]; each chunk's outputs are re-ordered to
    match them before the overlap-add (eval only).

    ``center_pad_to``: demucs's TensorChunk padding (musdbhq_utils.py:86-111,
    ``padded``; HTDemucs's evaluation): every chunk is padded to this length
    centred on itself, with the real mixture around it as context where
    there is one and zeros past the track's edges, and its output is cut
    back from the centre. None: right-zero-padding (the speech reference,
    process.py:176).

    ``mesh``: a :class:`~fqss_tpu_torch.parallel.mesh.Mesh` to shard the
    chunk batches over, as the JAX function shards them over a device mesh:
    every rank calls with the same track, each block holds ``chunk_batch``
    chunks a rank (the tail zero-padded, as JAX pads), rank r runs its
    ``chunk_batch`` rows under the mesh (the splitter's max-abs is the
    block's), and the outputs are gathered on every rank before the
    overlap-add, so every rank returns the whole separation. The same
    blocks without a mesh at ``chunk_batch`` times the world size give the
    same separation.
    """
    mix = np.asarray(mix, np.float32)
    channels, length = mix.shape
    step = chunk_batch * (mesh.size if mesh is not None else 1)

    def run(block: np.ndarray, on: dp.Mesh | None = None) -> np.ndarray:
        x = torch.from_numpy(block)
        if on is not None:
            x = x[on.rows(len(x))]
        with torch.inference_mode(), dp.sharded(on):
            return dp.gather_rows(apply_fn(x.to(device)), len(block)).float().cpu().numpy()

    if not segment:  # the whole track in one call on every rank, as JAX's unsharded call
        out = run(mix[None, 0] if channels == 1 else mix[None])[0]
        pad = length - out.shape[-1]
        if pad > 0:
            out = np.pad(out, [(0, 0)] * (out.ndim - 1) + [(0, pad)])
        return out[..., :length]

    stride = int((1 - overlap) * segment)
    offsets = list(range(0, length, stride))
    weight = triangular_weight(segment)

    # Right-zero-padded chunks (the reference speech path, process.py:176), or centre-padded ones with the
    # mixture around them as context (demucs TensorChunk).
    pad_target = max(center_pad_to or segment, segment)
    chunks = np.zeros((len(offsets), channels, pad_target), np.float32)
    chunk_lens, trim_lefts = [], []
    for i, off in enumerate(offsets):
        stop = min(off + segment, length)
        clen = stop - off
        if center_pad_to is None:
            chunks[i, :, :clen] = mix[:, off:stop]
            trim_lefts.append(0)
        else:
            delta = pad_target - clen
            start = off - delta // 2
            cs, ce = max(0, start), min(length, start + pad_target)
            chunks[i, :, cs - start : cs - start + (ce - cs)] = mix[:, cs:ce]
            trim_lefts.append(delta // 2)
        chunk_lens.append(clen)

    outs = []
    for i in range(0, len(offsets), step):
        block = chunks[i : i + step]
        pad_n = step - block.shape[0]
        if pad_n:
            block = np.concatenate([block, np.zeros((pad_n, channels, pad_target), np.float32)])
        y = run(block[:, 0] if channels == 1 else block, mesh)
        if pad_n:
            y = y[: step - pad_n]
        outs.append(y[..., :pad_target])
    chunk_out = np.concatenate(outs, axis=0)  # [K, S, (C,) pad_target]

    out_shape = (n_srcs, channels, length) if channels > 1 else (n_srcs, length)
    out = np.zeros(out_shape, np.float32)
    sum_weight = np.zeros(length, np.float32)
    for i, off in enumerate(offsets):
        clen, tl = chunk_lens[i], trim_lefts[i]
        co = chunk_out[i][..., tl : tl + clen]
        if target is not None and n_srcs > 1:
            co = swap_channel_order(co, target[..., off : off + clen])
        out[..., off : off + clen] += weight[:clen] * co
        sum_weight[off : off + clen] += weight[:clen]
    if sum_weight.min() <= 0:
        raise ValueError(f"overlap={overlap} leaves samples that no chunk covers")
    return out / sum_weight
