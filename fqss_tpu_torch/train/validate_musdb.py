"""MUSDB18-HQ evaluation loops (``fqss_tpu/train/validate_musdb.py``; reference: val.py:95-181).

:func:`val_musdbhq_nsdr` scores the MDX NSDR per stem; :func:`val_musdbhq`
runs BSS Eval v4 (``separation/bss_eval.py``): framewise SDR/ISR/SIR/SAR
over 1 s windows with 512-tap distortion filters, the median over frames,
then the median over tracks, as museval's ``agg_frames_tracks_scores``.
Each track is normalised by its mixture's mean and std, separated by
overlap-add and de-normalised. The serving forward is any callable on
tensors of ``device``: the model, its folded copy or the int8 engine.
HTDemucs (``model_cfg.name``) is evaluated as the JAX loop evaluates it
(``fqss_tpu/train/validate_musdb.py:45-60``): its forward with
``train=False``, each chunk centre-padded with the mixture around it to
``segment_samples`` (``ola_infer(center_pad_to=...)``); every other family,
the legacy HDemucs (``HDemucsLegacy``) among them, as JAX's non-HTDemucs
branch: its forward as it is, the chunks unpadded.
Tracks live in the musdb layout ``<root>/test/<track>/{mixture, <stem>}.wav``.
With a data-parallel ``mesh`` every rank calls the loop: each track's OLA is
sharded over the ranks, rank ``j % W`` scores track ``j``, and the per-track
scores are summed over the ranks (each slot once) before the means and
medians.
"""

from __future__ import annotations

import functools
import os
from typing import Any, Callable, Mapping

import numpy as np
import torch

from fqss_tpu_torch.parallel import mesh as dp
from fqss_tpu_torch.separation.bss_eval import aggregate_frames, bss_eval_images_framewise
from fqss_tpu_torch.separation.losses import nsdr_db
from fqss_tpu_torch.separation.ola import ola_infer
from fqss_tpu_torch.utils.audio import read_audio

SOURCES = ("drums", "bass", "other", "vocals")


def list_musdb_tracks(root: str, subset: str = "test") -> list[str]:
    d = os.path.join(root, subset)
    tracks = sorted(t for t in os.listdir(d)
                    if os.path.isdir(os.path.join(d, t)) and os.path.exists(os.path.join(d, t, "mixture.wav")))
    if not tracks:
        raise FileNotFoundError(f"Dataset is missing files! ({d})")
    return [os.path.join(d, t) for t in tracks]


def eval_forward(apply_fn: Callable, model_cfg: Mapping[str, Any]) -> Callable[[torch.Tensor], torch.Tensor]:
    """The forward evaluation calls: HTDemucs's (the model, its folded copy or its int8 engine) with
    ``train=False``, every other family's as it is."""
    return functools.partial(apply_fn, train=False) if model_cfg.get("name") == "HTDemucs" else apply_fn


def _separate_track(apply_fn: Callable[[torch.Tensor], torch.Tensor], track_dir: str, n_srcs: int,
                    testing_cfg: Mapping[str, Any], mesh=None, device: torch.device | str = "cpu",
                    model_cfg: Mapping[str, Any] | None = None):
    """The track's stems ``[S, C, T]`` and its sample rate: OLA on the mixture normalised by its mean and std,
    non-finite values zeroed (solver.py:325), then de-normalised. HTDemucs's chunks are centre-padded to
    ``segment_samples`` (use_train_segment: demucs TensorChunk, musdbhq_utils.py:86-111)."""
    model_cfg = model_cfg or {}
    mix, fs = read_audio(os.path.join(track_dir, "mixture.wav"))  # [C, T]
    ref = mix.mean(axis=0)
    mix_mean, mix_std = float(ref.mean()), float(ref.std())
    segment = testing_cfg.get("segment_samples")
    seps = ola_infer(eval_forward(apply_fn, model_cfg), (mix - mix_mean) / mix_std, n_srcs=n_srcs, segment=segment,
                     overlap=testing_cfg.get("overlap", 0.25), mesh=mesh, device=device,
                     center_pad_to=segment if model_cfg.get("name") == "HTDemucs" else None)
    return np.nan_to_num(seps) * mix_std + mix_mean, fs


def _tracks(testing_cfg: Mapping[str, Any], limit: int | None) -> list[str]:
    tracks = list_musdb_tracks(testing_cfg["test_dir"])
    return tracks[:limit] if limit else tracks


def val_musdbhq_nsdr(apply_fn: Callable[[torch.Tensor], torch.Tensor], model_cfg: Mapping[str, Any],
                     testing_cfg: Mapping[str, Any], limit: int | None = None, mesh=None,
                     device: torch.device | str = "cpu") -> tuple[float, ...]:
    """(mean NSDR, NSDR of each stem), each stem's the mean over tracks (val.py:95-132)."""
    sources = tuple(model_cfg.get("sources", SOURCES))
    tracks = _tracks(testing_cfg, limit)
    sdrs = np.zeros((len(sources), len(tracks)))
    for j, track in enumerate(tracks):
        seps, _ = _separate_track(apply_fn, track, len(sources), testing_cfg, mesh, device, model_cfg)
        if mesh is not None and j % mesh.size != mesh.rank:
            continue
        for i, src in enumerate(sources):
            ref_audio, _ = read_audio(os.path.join(track, f"{src}.wav"))
            sep = np.ascontiguousarray(seps[i][..., : ref_audio.shape[-1]])
            sdrs[i, j] = float(nsdr_db(torch.from_numpy(ref_audio.reshape(1, -1)),
                                       torch.from_numpy(sep.reshape(1, -1)))[0])
        if j % 10 == 0 and mesh is None:
            print(f"\n****** Track {j + 1}/{len(tracks)} ******")
            for i, src in enumerate(sources):
                print(f"{src}: NSDR={sdrs[i, j]:0.3f}")
    per_src = dp.host_sum(sdrs, mesh).mean(axis=1)
    return (float(per_src.mean()), *[float(v) for v in per_src])


def val_musdbhq(apply_fn: Callable[[torch.Tensor], torch.Tensor], model_cfg: Mapping[str, Any],
                testing_cfg: Mapping[str, Any], limit: int | None = None, return_full: bool = False,
                filter_length: int = 512, mesh=None, device: torch.device | str = "cpu"):
    """BSS Eval v4 (val.py:134-181): (mean SDR, SDR of each stem), each the median over frames then over
    tracks; with ``return_full`` also ``{"SDR"|"ISR"|"SIR"|"SAR": {stem: value}}``."""
    sources = tuple(model_cfg.get("sources", SOURCES))
    tracks = _tracks(testing_cfg, limit)
    keys = ("SDR", "ISR", "SIR", "SAR")
    track_scores = {k: np.zeros((len(sources), len(tracks))) for k in keys}
    for j, track in enumerate(tracks):
        seps, fs = _separate_track(apply_fn, track, len(sources), testing_cfg, mesh, device, model_cfg)
        if mesh is not None and j % mesh.size != mesh.rank:
            continue
        refs = [read_audio(os.path.join(track, f"{src}.wav"))[0] for src in sources]
        t_len = min(min(r.shape[-1] for r in refs), seps.shape[-1])
        refs = np.stack([r[..., :t_len] for r in refs])  # [S, C, T]
        ests = np.asarray(seps)[..., :t_len]
        if ests.ndim == 2:
            ests = ests[:, None, :]
        if refs.ndim == 2:
            refs = refs[:, None, :]
        agg = aggregate_frames(bss_eval_images_framewise(refs, ests, window=fs, hop=fs, filter_length=filter_length))
        for k in keys:
            track_scores[k][:, j] = agg[k]
        if j % 10 == 0 and mesh is None:
            print(f"track {j + 1}/{len(tracks)}: " + ", ".join(
                f"{s} SDR={track_scores['SDR'][i, j]:0.2f}" for i, s in enumerate(sources)))
    per_src = {k: np.nanmedian(dp.host_sum(track_scores[k], mesh), axis=1) for k in keys}
    sdr = per_src["SDR"]
    result = (float(sdr.mean()), *[float(v) for v in sdr])
    if return_full:
        return result, {k: {s: float(v) for s, v in zip(sources, per_src[k])} for k in keys}
    return result
