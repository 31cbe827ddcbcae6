"""The music training recipe, tasnet environment (``fqss_tpu/train/recipes_music.py``).

``train_tasnet_music`` is the reference's tasnet trainer
(train_env/tasnet_musdbhq/musdbhq_train.py:45-170) on one device: MUSDB
track windows (``data/musdb.py``), the Shift/FlipSign/FlipChannels/Scale/
Remix augmentations on the device inside the step, mix = sum of the stems,
KD from the float teacher into the quantized student with the weighted L1
loss ``w = 10**((nsdr_f - nsdr_q)/10)`` (``music_kd_l1_loss``, ``pow10``),
clip 5.0, the non-finite skip, the gradients' norm logged; each epoch a
validation pass over whole tracks (OLA without overlap: the L1 ``reco`` and
the NSDR per stem), best/latest exports, epoch checkpoints with the best
model state, resume from the latest checkpoint (or a start from another
run's, ``continue_from``), and the test set's NSDR after the last epoch
(or every ``test.every`` epochs). It reads the reference YAML schema in
both spellings of the dataset keys.

The htdemucs environment (EMA model zoos, per-module optimizer groups,
Repitch, the hydra schema) is not ported yet (ROADMAP.md, queue 1).

One difference from the JAX step: where ``(T - shift - kernel_size)`` is not
a multiple of the model's stride (the config's 6 s windows with the
8192-sample shift: 256,408 samples against 256,400 out), the estimates are
shorter than the stems; JAX's loss then fails on the shapes, the port pads
the estimates with zeros to the stems' length, as asteroid's
``pad_x_to_y`` does.
"""

from __future__ import annotations

import copy
import functools
import os
import time
from typing import Any, Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fqss_tpu_torch.data.musdb import Wavset, apply_augment, draw_augment, get_musdb_wav_datasets
from fqss_tpu_torch.models.factory import create_model_and_teacher
from fqss_tpu_torch.separation.losses import music_kd_l1_loss, nsdr_db
from fqss_tpu_torch.separation.ola import ola_infer
from fqss_tpu_torch.train.checkpoints import CheckpointManager, dump_config, export_model, save_log
from fqss_tpu_torch.train.state import TrainState
from fqss_tpu_torch.train.trainer import TrainConfig, backward_and_update, make_optimizer
from fqss_tpu_torch.train.validate_musdb import SOURCES, val_musdbhq_nsdr
from fqss_tpu_torch.utils.audio import set_seed

Tensor = torch.Tensor


def _pad_to(x: Tensor, length: int) -> Tensor:
    return F.pad(x, (0, length - x.shape[-1])) if x.shape[-1] < length else x[..., :length]


def make_music_train_step(cfg: TrainConfig, augment_cfg: Mapping[str, Any] | None = None
                          ) -> Callable[[TrainState, Tensor, torch.Generator], dict]:
    """The tasnet KD step ``(state, sources [B, S, C, T], generator) -> metrics`` over stem batches; updates
    ``state``.

    The augmentation's values come from ``generator`` (a CPU generator: the same draws on every device) unless
    ``augment_cfg["enable"]`` is false; mix = sum of the augmented stems (musdbhq_train.py:60-66); the loss is
    ``music_kd_l1_loss``'s ``pow10`` kind. Metrics: ``loss`` and ``grad_norm`` (before the clip) as device
    tensors, ``skipped`` (bool).
    """
    aug = dict(augment_cfg or {})
    aug_args = dict(shift=aug.get("shift", 8192), flip_channels=aug.get("flip", True), flip_sign=aug.get("flip", True),
                    scale=(0.25, 1.25) if aug.get("scale", True) else None,
                    remix_group_size=aug.get("remix_group_size", 0))

    def train_step(state: TrainState, sources: Tensor, generator: torch.Generator) -> dict:
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        if aug.get("enable", True):
            draws = draw_augment(generator, tuple(sources.shape), **aug_args)
            sources = apply_augment(sources, **draws, shift=aug_args["shift"])
        mix = sources.sum(dim=1)  # [B, C, T]
        t_len = sources.shape[-1]
        wavs = _pad_to(state.model(mix), t_len)
        if cfg.kd_lambda > 0 and state.teacher is not None:
            with torch.no_grad():
                fwavs = _pad_to(state.teacher(mix), t_len)
        else:
            fwavs = wavs.detach()
        loss = music_kd_l1_loss(wavs, fwavs, sources, cfg.kd_lambda, "pow10")
        grad_norm, ok = backward_and_update(state, cfg, loss)
        return {"loss": loss.detach(), "grad_norm": grad_norm, "skipped": not ok}

    return train_step


def validate_music(apply_fn: Callable[[Tensor], Tensor], valid_set: Wavset, sources: tuple[str, ...],
                   weights: np.ndarray, testing_cfg: Mapping[str, Any], limit: int | None = None,
                   device: torch.device | str = "cpu") -> dict:
    """The validation pass (solver.py:299-390, train=False): each whole track separated by OLA without overlap
    from its stored mixture; the source-weighted L1 ``reco`` (also ``loss``) and the NSDR of each stem
    (``nsdr_<stem>``) and their weighted mean (``nsdr``), averaged over tracks."""
    n = len(valid_set) if limit is None else min(limit, len(valid_set))
    recos, nsdrs = [], []
    for i in range(n):
        ex = np.asarray(valid_set[i])  # [1 + S, C, T]
        mix, srcs = ex[0], ex[1:]
        est = ola_infer(apply_fn, mix, n_srcs=len(sources), segment=testing_cfg.get("segment_samples"), overlap=0.0,
                        device=device)
        est = np.nan_to_num(est)[..., : srcs.shape[-1]]
        l1 = np.abs(est - srcs).mean(axis=tuple(range(1, srcs.ndim)))  # per source
        recos.append(float((l1 * weights).sum() / weights.sum()))
        nsdrs.append(nsdr_db(torch.from_numpy(srcs.reshape(len(sources), -1)),
                             torch.from_numpy(np.ascontiguousarray(est).reshape(len(sources), -1))).numpy())
    nsdrs = np.stack(nsdrs).mean(axis=0) if nsdrs else np.zeros(len(sources))
    reco = float(np.mean(recos)) if recos else float("nan")
    out = {"loss": reco, "reco": reco, "nsdr": float((nsdrs * weights).sum() / weights.sum())}
    for name, v in zip(sources, nsdrs):
        out[f"nsdr_{name}"] = float(v)
    return out


def _is_better(candidate: float, incumbent: float, metric: str) -> bool:
    """solver.py:226-231: NSDR metrics are maximised, losses minimised."""
    if metric.startswith("nsdr"):
        return candidate > incumbent
    return candidate < incumbent


def _state_copy(model: nn.Module) -> dict[str, Tensor]:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def _with_state(model: nn.Module, state: Mapping[str, Tensor]) -> nn.Module:
    """A copy of ``model`` holding ``state``, in eval mode."""
    other = copy.deepcopy(model)
    other.load_state_dict(state)
    return other.eval()


def train_tasnet_music(conf: Mapping[str, Any], device: torch.device | str = "cpu") -> dict:
    """Run the tasnet music recipe from a reference-schema config dict on ``device``.

    Returns ``{"best_loss", "epochs_run", "state", "best_state", "test"}``: the lowest epoch-mean train loss, the
    epochs in the config, the :class:`TrainState`, the best model state by ``test.metric`` and the last test
    NSDRs (None without ``testing_cfg.test_dir``).
    """
    work_dir = conf["work_dir"]
    model_cfg = conf["model_cfg"]
    dataset_cfg = conf.get("dataset_cfg", {})
    training_cfg = conf.get("training_cfg", {})
    testing_cfg = conf.get("testing_cfg", {})
    device = torch.device(device)

    seed = training_cfg.get("seed", 0)
    set_seed(seed)
    torch.manual_seed(seed)
    dump_config(work_dir, dict(conf))

    sources = tuple(model_cfg.get("sources", SOURCES))
    sample_rate = dataset_cfg.get("sample_rate", 44100)
    # Both this repo's keys and the reference YAML's spellings (train_dir / metadata / segment_samples /
    # data_stride in samples).
    if "segment_samples" in dataset_cfg:
        samples = int(dataset_cfg["segment_samples"])
    else:
        samples = int(dataset_cfg.get("segment", 6) * sample_rate)
    stride_cfg = dataset_cfg.get("data_stride", 1)
    stride = int(stride_cfg) if stride_cfg >= 1000 else int(stride_cfg * sample_rate)  # samples, or seconds
    root = dataset_cfg.get("musdb_root") or dataset_cfg["train_dir"]
    train_set, valid_set = get_musdb_wav_datasets(
        root, stride, sample_rate, samples, sources,
        metadata_file=dataset_cfg.get("metadata_file") or dataset_cfg.get("metadata"))
    aug_cfg = dict(dataset_cfg.get("augmentation", {"enable": True, "shift": min(8192, samples // 8)}))
    aug_cfg.pop("repitch", None)  # the htdemucs recipe's

    batch_size = training_cfg.get("batch_size", 4)
    model, teacher = create_model_and_teacher(model_cfg, training_cfg.get("pretrained"),
                                              generator=torch.Generator().manual_seed(seed))
    optim_cfg = training_cfg.get("optim", {})
    cfg = TrainConfig(
        kd_lambda=training_cfg.get("kd_lambda", 0.1),
        lr=optim_cfg.get("lr", 3e-4),
        weight_decay=optim_cfg.get("weight_decay", 0.0),
        optimizer=optim_cfg.get("optimizer", "adam"),
        grad_clip=training_cfg.get("grad_clip", 5.0),
    )
    model.to(device)
    teacher.to(device)
    state = TrainState(model, make_optimizer(cfg, [p for p in model.parameters() if p.requires_grad]), teacher)
    weights = np.asarray(training_cfg.get("weights", [1.0] * len(sources)), np.float32)
    step_fn = make_music_train_step(cfg, aug_cfg)
    test_cfg = dict(training_cfg.get("test", {}) or {})
    test_every = int(test_cfg.get("every", testing_cfg.get("every", 0) or 0))
    test_metric = str(test_cfg.get("metric", "loss"))
    test_best = bool(test_cfg.get("best", True))
    valid_limit = training_cfg.get("valid_limit")

    ckpt = CheckpointManager(work_dir)
    best_state = _state_copy(model)
    # Resume (solver.py:111-122) from the latest checkpoint of work_dir, its best model state included; or start
    # from another run's model (continue_from, solver.py:128-140): its best state, or its latest model.
    start_epoch = 0
    last_epoch = ckpt.latest_epoch()
    if last_epoch is not None:
        saved = ckpt.load(last_epoch)
        state.load_state_dict(saved["state"])
        best_state = saved["extra"]["best_state"]
        start_epoch = last_epoch + 1
        save_log(work_dir, f"resumed from checkpoint at epoch {last_epoch}")
    elif training_cfg.get("continue_from"):
        other = CheckpointManager(training_cfg["continue_from"])
        continue_best = training_cfg.get("continue_best", True)
        epoch = other.best_epoch() if continue_best else other.latest_epoch()
        if epoch is not None:
            saved = other.load(epoch)
            model.load_state_dict(saved["extra"]["best_state"] if continue_best else saved["state"]["model"])
            save_log(work_dir, f"continued from {training_cfg['continue_from']}")

    generator = torch.Generator().manual_seed(seed)
    epochs = training_cfg.get("epochs", 4)
    metric_history = [h[f"valid_{test_metric}"] for h in ckpt.history if f"valid_{test_metric}" in h]
    best_loss = float("inf")
    order = np.arange(len(train_set))
    result_test = None
    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        np.random.default_rng(seed + epoch).shuffle(order)
        losses = []
        metrics = {"grad_norm": 0.0}
        for i in range(0, (len(order) // batch_size) * batch_size, batch_size):
            batch = np.stack([train_set[int(j)] for j in order[i: i + batch_size]])  # [B, S, C, T]
            metrics = step_fn(state, torch.from_numpy(batch).to(device), generator)
            losses.append(float(metrics["loss"]))
        mean_loss = float(np.mean(losses)) if losses else float("nan")

        model.eval()
        valid = validate_music(model, valid_set, sources, weights, testing_cfg, limit=valid_limit, device=device)
        valid_loss = valid[test_metric]
        metric_history.append(valid_loss)
        hist_best = functools.reduce(lambda a, b: b if _is_better(b, a, test_metric) else a, metric_history)
        if valid_loss == hist_best:
            best_state = _state_copy(model)
        save_log(work_dir, f"epoch {epoch}: loss={mean_loss:.5f} valid_loss={valid['loss']:.5f} "
                           f"valid_nsdr={valid['nsdr']:.3f} best={hist_best:.5f} "
                           f"grad_norm={float(metrics['grad_norm']):.3f} time={time.time() - t0:.1f}s")
        ckpt.save(epoch, state, {"val_loss": valid["loss"], "loss": mean_loss, f"valid_{test_metric}": valid_loss,
                                 "valid_nsdr": valid["nsdr"]}, extra={"best_state": best_state})
        export_model(os.path.join(work_dir, "latest_model.pt"), model)
        if valid_loss == hist_best:
            export_model(os.path.join(work_dir, "best_model.pt"), _with_state(model, best_state))
        best_loss = min(best_loss, mean_loss)

        # The test set's NSDR (solver.py:262-287) with the best state (test.best) or the current one.
        if testing_cfg.get("test_dir") and ((test_every and (epoch + 1) % test_every == 0) or epoch == epochs - 1):
            served = _with_state(model, best_state) if test_best else model
            vals = val_musdbhq_nsdr(served, model_cfg, testing_cfg, limit=testing_cfg.get("limit"), device=device)
            result_test = {"nsdr": vals[0], **{f"nsdr_{s}": v for s, v in zip(sources, vals[1:])}}
            save_log(work_dir, f"test epoch {epoch}: " + " ".join(f"{k}={v:.3f}" for k, v in result_test.items()))
    return {"best_loss": best_loss, "epochs_run": epochs, "state": state, "best_state": best_state,
            "test": result_test}
