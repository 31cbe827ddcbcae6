"""Dataset evaluation loop (``fqss_tpu/train/validate.py``; reference: val.py:28-181).

``val_librimix``: per-file OLA separation -> best-permutation SI-SDR, SI-SDR
improvement over the mixture, SDR, STOI, with running-mean prints every 500
items (val.py:59-92). ``save_results``: the speechbrain recipe's
per-utterance ``test_results.csv``. The serving forward is any callable on
tensors of the chosen device: the model, its folded copy or the int8 engine.
"""

from __future__ import annotations

import csv
import glob
import os
from typing import Any, Callable, Mapping

import numpy as np
import torch

from fqss_tpu_torch.parallel import mesh as dp
from fqss_tpu_torch.separation.bss_eval import bss_eval_images_framewise
from fqss_tpu_torch.separation.metrics import metric_evaluation, si_snr_db
from fqss_tpu_torch.separation.ola import ola_infer
from fqss_tpu_torch.utils.audio import read_audio, resample_audio


def read_librimix_files(folder: str, n_spks: int = 1, noisy: bool = False):
    """Enumerate mixture + per-source wav paths (val.py:28-57)."""
    if not 1 <= n_spks <= 3:
        raise ValueError("Error: Up to 3 sources to separate!")
    if n_spks == 1:
        mix = sorted(glob.glob(os.path.join(folder, "mix_single", "*")))
        srcs = [sorted(glob.glob(os.path.join(folder, "s1", "*")))]
    else:
        mix_dir = "mix_both" if noisy else "mix_clean"
        mix = sorted(glob.glob(os.path.join(folder, mix_dir, "*")))
        srcs = [sorted(glob.glob(os.path.join(folder, f"s{i + 1}", "*"))) for i in range(n_spks)]
    if not (all(len(mix) == len(s) for s in srcs) and len(mix) > 0):
        raise FileNotFoundError(f"Dataset is missing files! ({folder})")
    return mix, srcs


def _resampled(path: str, resample: float):
    wav, fs = read_audio(path)
    if resample != 1:
        wav = resample_audio(wav, fs, int(fs * resample))
        fs = int(fs * resample)
    return wav, fs


def val_librimix(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    model_cfg: Mapping[str, Any],
    dataset_cfg: Mapping[str, Any],
    testing_cfg: Mapping[str, Any],
    limit: int | None = None,
    compute_stoi: bool = True,
    device: torch.device | str = "cpu",
    mesh: dp.Mesh | None = None,
) -> tuple[float, float, float, float]:
    """Returns (SI-SDR, SI-SDR improvement, SDR, STOI) means (val.py:59-92).

    ``apply_fn`` is the serving forward ``[K, T] -> [K, S, T]`` on ``device``. With ``mesh`` every rank calls it:
    each file's OLA is sharded over the ranks (``ola_infer(mesh=...)``), rank ``i % W`` scores file ``i``, and the
    scores are summed over the ranks (each slot once), so every rank returns the one-process means of that OLA.
    """
    n_srcs = model_cfg.get("n_src", 1)
    mix_files, src_files = read_librimix_files(testing_cfg["test_dir"], n_srcs, dataset_cfg.get("noisy", False))
    n = len(mix_files) if limit is None else min(limit, len(mix_files))
    resample = dataset_cfg.get("resample", 1)
    segment = testing_cfg.get("segment_samples")
    overlap = testing_cfg.get("overlap", 0.25)

    sisdrs = np.zeros(n)
    sisdrs_imp = np.zeros(n)
    sdrs = np.zeros(n)
    stois = np.zeros(n)
    for i in range(n):
        mix_wav, fs = _resampled(mix_files[i], resample)
        clean = np.stack([_resampled(files[i], resample)[0][0] for files in src_files])
        wavs = ola_infer(apply_fn, mix_wav, n_srcs=n_srcs, segment=segment, overlap=overlap, target=clean,
                         device=device, mesh=mesh)
        if mesh is not None and i % mesh.size != mesh.rank:
            continue
        sisdrs[i], sdrs[i], stois[i] = metric_evaluation(wavs, clean, sample_rate=fs, compute_stoi=compute_stoi)
        # baseline: mixture vs clean, for the improvement number
        mix_stack = torch.from_numpy(np.stack([mix_wav[0]] * n_srcs))
        sisdrs_imp[i] = sisdrs[i] - float(si_snr_db(mix_stack, torch.from_numpy(clean)).mean())
        if mesh is None and ((i % 500 == 0 and i > 0) or i == 1):
            print(
                "SI-SDR={:0.3f},SI-SDR-imp={:0.3f},SDR={:0.3f},STOI={:0.4f}".format(
                    np.mean(sisdrs[:i]), np.mean(sisdrs_imp[:i]), np.mean(sdrs[:i]), np.mean(stois[:i])
                )
            )
    sisdrs, sisdrs_imp, sdrs, stois = dp.host_sum(np.stack([sisdrs, sisdrs_imp, sdrs, stois]), mesh)
    return float(np.mean(sisdrs)), float(np.mean(sisdrs_imp)), float(np.mean(sdrs)), float(np.mean(stois))


def save_results(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    model_cfg: Mapping[str, Any],
    dataset_cfg: Mapping[str, Any],
    testing_cfg: Mapping[str, Any],
    work_dir: str,
    limit: int | None = None,
    device: torch.device | str = "cpu",
) -> dict:
    """Per-utterance ``test_results.csv`` in the work dir.

    The speechbrain env's test report (reference
    speechbrain_librimix_trainer.py:336-441 ``save_results``): one row per
    test sentence with columns snt_id, sdr, sdr_i, si-snr, si-snr_i (BSS-Eval
    SDR over the full utterance, best-permutation SI-SNR, and both
    improvements over the raw mixture), plus a final "avg" row. Returns the
    averages as a dict.
    """
    n_srcs = model_cfg.get("n_src", 1)
    mix_files, src_files = read_librimix_files(testing_cfg["test_dir"], n_srcs, dataset_cfg.get("noisy", False))
    n = len(mix_files) if limit is None else min(limit, len(mix_files))
    resample = dataset_cfg.get("resample", 1)

    def full_sdr(ests: np.ndarray, refs: np.ndarray) -> float:
        # full-utterance single window == mir_eval bss_eval_sources usage
        t = refs.shape[-1]
        scores = bss_eval_images_framewise(refs, ests, window=t, filter_length=min(512, t))
        return float(np.nanmean(scores["SDR"]))

    save_file = os.path.join(work_dir, "test_results.csv")
    cols = ["snt_id", "sdr", "sdr_i", "si-snr", "si-snr_i"]
    sums = {k: [] for k in cols[1:]}
    with open(save_file, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=cols)
        writer.writeheader()
        for i in range(n):
            mix_wav, fs = _resampled(mix_files[i], resample)
            clean = np.stack([_resampled(files[i], resample)[0][0] for files in src_files])
            wavs = ola_infer(apply_fn, mix_wav, n_srcs=n_srcs, segment=testing_cfg.get("segment_samples"),
                             overlap=testing_cfg.get("overlap", 0.25), target=clean,
                             device=device)[..., : clean.shape[-1]]
            mix_stack = np.stack([mix_wav[0]] * n_srcs)
            sisnr, _, _ = metric_evaluation(wavs, clean, sample_rate=fs, compute_stoi=False)
            sisnr_base = float(si_snr_db(torch.from_numpy(mix_stack), torch.from_numpy(clean)).mean())
            sdr = full_sdr(wavs, clean)
            sdr_base = full_sdr(mix_stack, clean)
            row = {"snt_id": os.path.basename(mix_files[i]), "sdr": sdr, "sdr_i": sdr - sdr_base,
                   "si-snr": sisnr, "si-snr_i": sisnr - sisnr_base}
            writer.writerow(row)
            for k in sums:
                sums[k].append(row[k])
            if i % 500 == 0 and i > 0:
                print("Mean SISNR is {:0.3f}".format(np.mean(sums["si-snr"])))
        avg = {k: float(np.mean(v)) for k, v in sums.items()}
        writer.writerow({"snt_id": "avg", **avg})
    return avg
