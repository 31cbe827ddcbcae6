"""LibriMix dataset (CSV-driven) with a prefetching host pipeline (``fqss_tpu/data/librimix.py``).

The reference LibriMix Dataset
(reference: train_env/asteroid_librimix/librimix_dataset.py:25-170):
CSV metadata, tasks enh_single/enh_both/sep_clean/sep_noisy, random
fixed-length segment crops, on-the-fly resampling (``resample`` factor, e.g.
0.5 for 16k->8k), and optional SNR-remix augmentation. Batches are assembled
on the host in numpy and prefetched on a background thread.

The metadata CSVs are read and written with the standard ``csv`` module, so
the loader needs no pandas (the GPU machine has none). A crop is read by
seeking to it in the 16-bit WAV (``utils/audio.py:read_wav_segment``), as the
JAX package's native reader does; a data-parallel rank reads its own rows of
each batch and only draws the others' random values
(:func:`batch_iterator`'s ``rows``). Downloading MiniLibriMix
(``mini_download``/``mini_from_download``) needs the network and is not
ported; :func:`make_mini_librimix` writes an equivalent mini set.
"""

from __future__ import annotations

import csv
import os
import queue
import random
import threading
from typing import Iterator

import numpy as np

from fqss_tpu_torch.data import augment
from fqss_tpu_torch.data.synthetic import synth_sources
from fqss_tpu_torch.utils.audio import read_wav_segment, resample_audio, save_audio


def read_metadata(path: str) -> list[dict[str, str]]:
    """The rows of a metadata CSV as dicts of strings."""
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


def write_metadata(path: str, rows: list[dict]) -> None:
    """Write rows with the columns of the first one (``DataFrame.to_csv(index=False)``'s layout)."""
    with open(path, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)


class LibriMix:
    """Indexable LibriMix view over a metadata CSV directory."""

    def __init__(
        self,
        csv_dir: str,
        task: str = "sep_clean",
        sample_rate: int = 16000,
        resample: float = 1.0,
        n_src: int = 2,
        segment: float | None = 3,
        augmentation_cfg: dict | None = None,
        speed_perturb: bool = False,
        speeds: tuple[int, ...] = (95, 100, 105),
        rand_shift: bool = False,
        shift_range: tuple[int, int] = (-8000, 8000),
        wavedrop: bool = False,
        seed: int = 0,
    ):
        self.csv_dir = csv_dir
        self.task = task
        self.resample = resample
        self.sample_rate = sample_rate
        self.n_src = n_src
        self.augmentation_cfg = augmentation_cfg if (augmentation_cfg or {}).get("enable") else None
        # speechbrain speed-perturb (speechbrain_librimix_trainer.py:52-57,
        # add_speed_perturb): each source resampled by an independent random
        # speed, mixture re-summed from the perturbed sources.
        self.speed_perturb = speed_perturb
        self.speeds = tuple(speeds)
        # speechbrain use_rand_shift / use_wavedrop
        # (speechbrain_librimix_trainer.py:70-72,284-295).
        self.rand_shift = rand_shift
        self.shift_range = tuple(shift_range)
        self.wavedrop = wavedrop
        self.rng = np.random.default_rng(seed)
        self.pyrng = random.Random(seed)

        files = os.listdir(csv_dir)
        if task == "enh_single":
            md = [f for f in files if "single" in f][0]
        elif task == "enh_both":
            md = [f for f in files if "both" in f][0]
            clean = [f for f in files if "clean" in f][0]
            self.rows_clean = read_metadata(os.path.join(csv_dir, clean))
        elif task == "sep_clean":
            md = [f for f in files if "clean" in f][0]
        elif task == "sep_noisy":
            md = [f for f in files if "both" in f][0]
        else:
            raise ValueError(f"Unknown task {task}")
        self.rows = read_metadata(os.path.join(csv_dir, md))

        if segment is not None:
            self.seg_len = int(segment * sample_rate)
            before = len(self.rows)
            self.rows = [row for row in self.rows if int(row["length"]) >= self.seg_len]
            dropped = before - len(self.rows)
            if dropped:
                print(f"Drop {dropped} utterances from {before} (shorter than {segment} seconds)")
        else:
            self.seg_len = None

    def __len__(self) -> int:
        return len(self.rows)

    def _read(self, path: str, start: int, stop: int | None) -> np.ndarray:
        wav = read_wav_segment(path, start, -1 if stop is None else stop - start)[0][0]
        if self.resample != 1:
            wav = resample_audio(wav, self.sample_rate, int(self.resample * self.sample_rate))
        return wav

    def __getitem__(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        """Returns (mixture [T], sources [n_src, T])."""
        row = self.rows[idx]
        if self.seg_len is not None:
            start = self.pyrng.randint(0, int(row["length"]) - self.seg_len)
            stop = start + self.seg_len
        else:
            start, stop = 0, None

        noise = None
        if self.task in ("enh_single", "sep_noisy"):
            noise = self._read(row["noise_path"], start, stop)

        if self.task == "enh_both":
            sources = [self._read(self.rows_clean[idx]["mixture_path"], start, stop)]
        else:
            sources = [self._read(row[f"source_{i + 1}_path"], start, stop) for i in range(self.n_src)]
        sources_arr = np.stack(sources)

        if self.augmentation_cfg and self.rng.uniform() < self.augmentation_cfg.get("prob", 1):
            cfg = self.augmentation_cfg
            if self.task == "enh_single":
                mixture = augment.augmentation_2mix(self.rng, sources_arr[0], noise, cfg)
            elif self.task == "sep_clean" and self.n_src == 2:
                mixture = augment.augmentation_2mix(self.rng, sources_arr[0], sources_arr[1], cfg)
            elif self.task == "sep_clean" and self.n_src == 3:
                mixture = augment.augmentation_3mix(self.rng, *sources_arr[:3], cfg)
            elif self.task == "sep_noisy":
                if self.n_src == 2:
                    mixture = augment.augmentation_2mix(self.rng, sources_arr[0], sources_arr[1], cfg)
                else:
                    mixture = augment.augmentation_3mix(self.rng, *sources_arr[:3], cfg)
                mixture = augment.generate_mix_noise(mixture, noise, self.rng.uniform(6, 18))
            else:
                raise ValueError("Augmentation is not supported for this task")
        else:
            mixture = self._read(row["mixture_path"], start, stop)

        if self.speed_perturb or self.rand_shift:
            mixture, sources_arr = self._apply_speed_perturb(sources_arr, noise)

        if self.wavedrop:
            mixture = augment.wavedrop(self.rng, mixture)

        return mixture.astype(np.float32), sources_arr.astype(np.float32)

    def skip(self, idx: int) -> None:
        """Draw what ``self[idx]`` draws, without reading its files where the draws do not depend on the audio
        (the crop's start alone); with an augmentation, speed perturbation, shift or wavedrop the item is read and
        dropped. A data-parallel rank calls it for the other ranks' rows, so that its generators stay where one
        process's would be."""
        if self.augmentation_cfg or self.speed_perturb or self.rand_shift or self.wavedrop:
            self[idx]
        elif self.seg_len is not None:
            self.pyrng.randint(0, int(self.rows[idx]["length"]) - self.seg_len)

    def _apply_speed_perturb(self, sources_arr: np.ndarray, noise: np.ndarray | None):
        """Per-source random-speed resample, then mix = sum of perturbed
        sources (+ noise for noisy tasks) — speechbrain add_speed_perturb
        followed by ``mix = targets.sum(-1)``
        (speechbrain_librimix_trainer.py:52-69,210-236). Lengths are restored
        to the original segment length by crop/zero-pad so batches keep one shape."""
        t_len = sources_arr.shape[-1]
        out = np.zeros_like(sources_arr)
        for i in range(sources_arr.shape[0]):
            w = sources_arr[i]
            if self.speed_perturb:
                w = augment.speed_perturb(self.rng, w, speeds=self.speeds)
            n = min(t_len, w.shape[-1])
            out[i, :n] = w[:n]
        if self.rand_shift:
            for i in range(out.shape[0]):
                out[i] = augment.rand_shift(self.rng, out[i], *self.shift_range)
        mixture = out.sum(axis=0)
        if noise is not None and self.task in ("enh_single", "sep_noisy"):
            n = min(t_len, noise.shape[-1])
            mixture[:n] = mixture[:n] + noise[:n]
        return mixture, out


def batch_iterator(
    dataset: LibriMix,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = True,
    prefetch: int = 2,
    epoch: int = 0,
    rows: slice | None = None,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Threaded prefetching batch iterator -> (mix [B, T], src [B, S, T]).

    The epoch-seeded shuffle mirrors DistributedSampler.set_epoch
    (musdbhq_train.py:52-56). ``rows``: only these rows of each batch (a
    data-parallel rank's, :meth:`~fqss_tpu_torch.parallel.mesh.Mesh.rows`),
    from the same order and the same random draws as the whole batch's
    (:meth:`LibriMix.skip` for the rest), so that the ranks' rows together
    are the batch one process reads, as JAX's host draws it.
    """
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(order)
    n = (len(order) // batch_size) * batch_size if drop_last else len(order)
    order = order[:n]

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = object()

    def worker():
        mine = range(batch_size)[rows] if rows is not None else range(batch_size)
        try:
            for i in range(0, len(order), batch_size):
                items = []
                for k, j in enumerate(order[i : i + batch_size]):
                    if k in mine:
                        items.append(dataset[int(j)])
                    else:
                        dataset.skip(int(j))
                mix = np.stack([m for m, _ in items])
                src = np.stack([s for _, s in items])
                q.put((mix, src))
        except Exception as e:  # handed to the consumer, which raises it: a failed read ends the loop, not hangs it
            q.put(e)
            return
        q.put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            break
        if isinstance(item, Exception):
            raise item
        yield item


def make_mini_librimix(root: str, n_train: int = 12, n_val: int = 4, sample_rate: int = 8000, seconds: float = 1.0,
                       n_src: int = 2, seed: int = 0):
    """Build a tiny on-disk LibriMix-format dataset (WAVs + CSVs).

    The reference downloads MiniLibriMix from zenodo
    (librimix_dataset.py:172-262); tests and smoke runs synthesize an
    equivalent directory structure instead. The same seed gives the same
    audio as the JAX package's function.
    """
    rng = np.random.default_rng(seed)
    t_len = int(seconds * sample_rate)
    for split, n in (("train", n_train), ("val", n_val)):
        csv_dir = os.path.join(root, split)
        wav_dir = os.path.join(csv_dir, "wav")
        os.makedirs(wav_dir, exist_ok=True)
        rows = []
        for i in range(n):
            src = synth_sources(rng, 1, n_src, t_len, sample_rate)[0]
            mix = np.clip(src.sum(0), -0.99, 0.99)
            paths = {}
            for s in range(n_src):
                p = os.path.join(wav_dir, f"{split}_{i}_s{s + 1}.wav")
                save_audio(p, src[s], sample_rate)
                paths[f"source_{s + 1}_path"] = p
            mp = os.path.join(wav_dir, f"{split}_{i}_mix.wav")
            save_audio(mp, mix, sample_rate)
            rows.append({"mixture_ID": f"{split}_{i}", "mixture_path": mp, **paths, "length": t_len})
        write_metadata(os.path.join(csv_dir, "mixture_clean.csv"), rows)

    # test split in the eval directory layout (val.py:28-57: mix_clean/, s1/, s2/)
    test_dir = os.path.join(root, "test")
    for sub in ["mix_clean"] + [f"s{i + 1}" for i in range(n_src)]:
        os.makedirs(os.path.join(test_dir, sub), exist_ok=True)
    for i in range(n_val):
        src = synth_sources(rng, 1, n_src, t_len, sample_rate)[0]
        mix = np.clip(src.sum(0), -0.99, 0.99)
        save_audio(os.path.join(test_dir, "mix_clean", f"test_{i}.wav"), mix, sample_rate)
        for s in range(n_src):
            save_audio(os.path.join(test_dir, f"s{s + 1}", f"test_{i}.wav"), src[s], sample_rate)
    return os.path.join(root, "train"), os.path.join(root, "val")
