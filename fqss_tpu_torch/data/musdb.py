"""MUSDB18-HQ dataset (per-track WAV folders) and the demucs augmentations (``fqss_tpu/data/musdb.py``).

``Wavset`` gives stride-windowed examples over track folders, normalised by
the mean and std of a metadata file (reference:
train_env/tasnet_musdbhq/musdbhq_dataset.py:118-206); :func:`build_metadata`
writes that file from a track directory. The augmentations
(Shift → FlipSign → FlipChannels → Scale → Remix, musdbhq_dataset.py:21-115)
run on the device inside the train step, in two pieces:
:func:`draw_augment` draws their random values from an explicit
``torch.Generator`` and :func:`apply_augment` is the pure transform of a
batch given those values, which equals JAX's ``augment_batch`` bit for bit
when it is given the values JAX draws. :class:`RepitchedWavset` is the
htdemucs recipe's host-side pitch/tempo stretch of the training examples.
"""

from __future__ import annotations

import json
import math
import os
from collections import OrderedDict

import numpy as np
import torch

from fqss_tpu_torch.utils.audio import read_audio, read_wav_segment, resample_audio, save_audio

MIXTURE = "mixture"
EXT = ".wav"

Tensor = torch.Tensor


def build_metadata(root: str, sources: tuple[str, ...]) -> dict:
    """Per-track {length, samplerate, mean, std} of the mixture, as demucs's musdbhq.json."""
    meta = {}
    for name in sorted(os.listdir(root)):
        mix_path = os.path.join(root, name, MIXTURE + EXT)
        if not os.path.exists(mix_path):
            continue
        wav, sr = read_audio(mix_path)
        meta[name] = {"length": wav.shape[-1], "samplerate": sr, "mean": float(wav.mean()), "std": float(wav.std())}
    return meta


class Wavset:
    """Stride-windowed examples over per-track source WAVs (musdbhq_dataset.py:118-183).

    ``__getitem__`` -> float32 ``[n_sources, C, length]`` (the whole track without ``length``)."""

    def __init__(self, root: str, metadata: dict, sources: tuple[str, ...], length: int | None = None,
                 stride: int | None = None, normalize: bool = True, sample_rate: int = 44100):
        self.root = root
        self.metadata = OrderedDict(metadata)
        self.length = length
        self.stride = stride or length
        self.normalize = normalize
        self.sources = sources
        self.sample_rate = sample_rate
        self.num_examples = []
        for meta in self.metadata.values():
            track_length = int(self.sample_rate * meta["length"] / meta["samplerate"])
            if length is None or track_length < length:
                examples = 1
            else:
                examples = int(math.ceil((track_length - self.length) / self.stride) + 1)
            self.num_examples.append(examples)

    def __len__(self) -> int:
        return sum(self.num_examples)

    def skip(self, index: int) -> None:
        """What ``self[index]`` draws: nothing (a data-parallel rank's call for another rank's row)."""

    def get_file(self, name: str, source: str) -> str:
        return os.path.join(self.root, name, f"{source}{EXT}")

    def __getitem__(self, index: int) -> np.ndarray:
        for name, examples in zip(self.metadata, self.num_examples):
            if index >= examples:
                index -= examples
                continue
            meta = self.metadata[name]
            wavs = []
            for source in self.sources:
                if self.length is not None:
                    offset = int(math.ceil(meta["samplerate"] * self.stride * index / self.sample_rate))
                    num = int(math.ceil(meta["samplerate"] * self.length / self.sample_rate))
                    wav, _ = read_wav_segment(self.get_file(name, source), offset, num)
                else:
                    wav, _ = read_audio(self.get_file(name, source))
                wavs.append(wav)
            example = np.stack(wavs)  # [S, C, T]
            if self.normalize:
                example = (example - meta["mean"]) / meta["std"]
            if self.length:
                example = example[..., : self.length]
                pad = self.length - example.shape[-1]
                if pad > 0:
                    example = np.pad(example, [(0, 0), (0, 0), (0, pad)])
            return example.astype(np.float32)
        raise IndexError(index)


def get_musdb_wav_datasets(musdb_root: str, data_stride: int, sample_rate: int, samples: int,
                           sources: tuple[str, ...], metadata_file: str | None = None,
                           valid_tracks: list[str] | None = None) -> tuple[Wavset, Wavset]:
    """(train_set, valid_set) as musdbhq_dataset.py:191-206, over ``<musdb_root>/train``.

    The metadata comes from ``metadata_file`` where it exists, else it is
    built (and written there). Without the musdb package the validation
    tracks are ``valid_tracks``, or the last ``max(1, min(8, n // 10))``
    tracks (none for a single track). The validation set yields whole tracks,
    the mixture first: ``[1 + n_sources, C, T]``.
    """
    root = os.path.join(musdb_root, "train")
    if metadata_file and os.path.exists(metadata_file):
        with open(metadata_file) as f:
            metadata = json.load(f)
    else:
        metadata = build_metadata(root, sources)
        if metadata_file:
            tmp = metadata_file + ".tmp"
            with open(tmp, "w") as f:
                json.dump(metadata, f)
            os.replace(tmp, metadata_file)
    names = list(metadata)
    if valid_tracks is None:
        n_valid = max(1, min(8, len(names) // 10)) if len(names) > 1 else 0
        valid_tracks = names[len(names) - n_valid:]
    metadata_train = {n: m for n, m in metadata.items() if n not in valid_tracks}
    metadata_valid = {n: m for n, m in metadata.items() if n in valid_tracks}
    train_set = Wavset(root, metadata_train, sources, length=samples, stride=data_stride, sample_rate=sample_rate)
    valid_set = Wavset(root, metadata_valid, (MIXTURE,) + tuple(sources), sample_rate=sample_rate)
    return train_set, valid_set


class RepitchedWavset:
    """The htdemucs recipe's RepitchedWrapper over a :class:`Wavset` (train_env/htdemucs_musdbhq/train.py:207-214;
    ``fqss_tpu/data/musdb.py:RepitchedWavset``), on the host.

    Every example is cut to the worst-case stretched length ``(1 - max_tempo / 100) * length``, so batch shapes
    stay static, and with probability ``proba`` all stems of an example are resampled by the same random pitch
    (semitones) and tempo (percent) factor: a polyphase resample by the combined rate change
    (:func:`fqss_tpu_torch.utils.audio.resample_audio`), as the JAX package does in place of SoundTouch. The draws
    come from ``np.random.default_rng(seed)`` in JAX's order, so the same tracks give the same examples bit for
    bit.
    """

    def __init__(self, dataset: Wavset, proba: float = 0.2, max_pitch: int = 2, max_tempo: float = 12.0,
                 tempo_std: float = 5.0, seed: int = 0):
        if dataset.length is None:
            raise ValueError("repitch needs fixed-length examples")
        self.dataset = dataset
        self.proba = proba
        self.max_pitch = max_pitch
        self.max_tempo = max_tempo
        self.tempo_std = tempo_std
        self.rng = np.random.default_rng(seed)
        self.out_length = int((1 - 0.01 * max_tempo) * dataset.length)

    def __len__(self) -> int:
        return len(self.dataset)

    def _draw(self) -> tuple[int, float] | None:
        """One example's pitch and tempo, or None where it is not repitched."""
        if self.rng.uniform() < self.proba:
            semitones = int(self.rng.integers(-self.max_pitch, self.max_pitch + 1))
            return semitones, float(np.clip(self.rng.normal(0, self.tempo_std), -self.max_tempo, self.max_tempo))
        return None

    def skip(self, index: int) -> None:
        """Draw what ``self[index]`` draws without reading it (a data-parallel rank's call for another rank's row):
        the draws do not depend on the audio."""
        self._draw()

    def __getitem__(self, index: int) -> np.ndarray:
        example = self.dataset[index]  # [S, C, T]
        out = example[..., : self.out_length]
        drawn = self._draw()
        if drawn is not None:
            semitones, tempo = drawn
            factor = (2.0 ** (semitones / 12.0)) * (1.0 + tempo / 100.0)
            if abs(factor - 1.0) > 1e-3:
                stretched = resample_audio(example, 1000, max(1, int(round(1000 * factor))))
                out = stretched[..., : self.out_length]
                pad = self.out_length - out.shape[-1]
                if pad > 0:
                    out = np.pad(out, [(0, 0)] * (out.ndim - 1) + [(0, pad)])
        return np.ascontiguousarray(out, np.float32)


def draw_augment(generator: torch.Generator, shape: tuple[int, int, int, int], shift: int = 8192,
                 flip_channels: bool = True, flip_sign: bool = True,
                 scale: tuple[float, float] | None = (0.25, 1.25),
                 remix_group_size: int = 4) -> dict[str, Tensor | None]:
    """The random values of one augmentation of a ``[B, S, C, T]`` batch, on the CPU: ``offsets`` in [0, shift),
    ``signs`` and ``left`` in {0, 1} (``[B, S]``), ``gains`` in [scale) (``[B, S]``) and ``perm`` (``[groups, g,
    S]``, each column a permutation of the batch rows of a group); None for an augmentation that is off or that
    the batch's shape skips (stereo only for ``left``; remix needs ``g`` to divide ``B > 1``, with ``g = B``
    where the group size is 0)."""
    b, s, c, _ = shape

    def bits() -> Tensor:
        return torch.randint(0, 2, (b, s), generator=generator)

    offsets = torch.randint(0, shift, (b, s), generator=generator) if shift > 0 else None
    signs = bits() if flip_sign else None
    left = bits() if flip_channels and c == 2 else None
    gains = None
    if scale is not None:
        gains = scale[0] + (scale[1] - scale[0]) * torch.rand((b, s), generator=generator)
    g = remix_group_size or b
    perm = None
    if b % g == 0 and b > 1:
        perm = torch.argsort(torch.rand((b // g, g, s), generator=generator), dim=1)
    return {"offsets": offsets, "signs": signs, "left": left, "gains": gains, "perm": perm}


def apply_augment(wav: Tensor, offsets: Tensor | None = None, signs: Tensor | None = None,
                  left: Tensor | None = None, gains: Tensor | None = None, perm: Tensor | None = None,
                  shift: int = 0) -> Tensor:
    """Shift -> FlipSign -> FlipChannels -> Scale -> Remix of ``wav`` ``[B, S, C, T]`` with given values (those of
    :func:`draw_augment`; None skips an augmentation) -> ``[B, S, C, T - shift]``; ``offsets`` needs ``shift``.
    The arithmetic is JAX's ``augment_batch``'s: a sign of ``2 * signs - 1`` and a gain, each one float32
    multiplication."""
    b, s, c, t = wav.shape
    dev = wav.device
    if offsets is not None:
        length = t - shift
        idx = torch.arange(length, device=dev) + offsets.to(dev, torch.int64)[..., None, None]  # [B, S, 1, length]
        wav = torch.take_along_dim(wav, idx.expand(b, s, c, length), dim=3)
        t = length
    if signs is not None:
        wav = wav * (2 * signs.to(dev, wav.dtype) - 1)[..., None, None]
    if left is not None:
        lidx = left.to(dev, torch.int64)[..., None, None].expand(b, s, 1, t)
        wav = torch.cat([torch.take_along_dim(wav, lidx, dim=2), torch.take_along_dim(wav, 1 - lidx, dim=2)], dim=2)
    if gains is not None:
        wav = wav * gains.to(dev, wav.dtype)[..., None, None]
    if perm is not None:
        groups, g = perm.shape[:2]
        w = wav.reshape(groups, g, s, c, t)
        w = torch.take_along_dim(w, perm.to(dev, torch.int64)[..., None, None].expand(groups, g, s, c, t), dim=1)
        wav = w.reshape(b, s, c, t)
    return wav


def make_mini_musdb(root: str, n_train: int = 3, n_test: int = 2,
                    sources: tuple[str, ...] = ("drums", "bass", "other", "vocals"), sample_rate: int = 8000,
                    seconds: float = 1.0, seed: int = 0) -> str:
    """A tiny MUSDB-layout dataset: ``train/`` and ``test/`` track folders of per-stem stereo WAVs and their
    mixture, from synthetic sources (the same files as JAX's ``make_mini_musdb`` on the same seed)."""
    from fqss_tpu_torch.data.synthetic import synth_sources

    rng = np.random.default_rng(seed)
    t_len = int(seconds * sample_rate)
    for subset, n in (("train", n_train), ("test", n_test)):
        for i in range(n):
            track = os.path.join(root, subset, f"track_{i}")
            os.makedirs(track, exist_ok=True)
            stems = synth_sources(rng, 1, len(sources), t_len, sample_rate)[0]
            stereo = np.stack([stems, stems * 0.8], axis=1)  # [S, 2, T]
            mix = np.clip(stereo.sum(0), -0.99, 0.99)
            save_audio(os.path.join(track, "mixture.wav"), mix, sample_rate)
            for s, name in enumerate(sources):
                save_audio(os.path.join(track, f"{name}.wav"), stereo[s], sample_rate)
    return root
