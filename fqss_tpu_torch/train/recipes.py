"""The speech training recipe (``fqss_tpu/train/recipes.py:train_speech``).

``train_speech`` is the asteroid recipe (asteroid_librimix_trainer.py:140-214)
and, with ``env_name="speechbrain"``, the speechbrain recipe's data
augmentation, loss thresholding and test report (speechbrain_librimix_trainer.py:52-197, 336-441):
LibriMix data, KD from a float teacher into the quantized student,
ReduceLROnPlateau (half_lr) or StepLR, EarlyStopping(30), clip 5.0,
best/latest exports, a ``conf.yml`` dump and ``results.txt`` logging, from
the same YAML schema as the JAX package. With a data-parallel ``mesh``
(``parallel/mesh.py``; torchrun) every rank draws the global batch in the
same order and trains on its rows of it, the train and eval steps reduce
over the ranks (the JAX recipe's batches sharded over a mesh), every rank
restores and calibrates alike, and rank 0 writes the files.

The data comes from the port's LibriMix loader (``data/librimix.py``, numpy,
scipy and the standard ``csv`` module).
"""

from __future__ import annotations

import os
import time
from typing import Any, Mapping

import numpy as np
import torch

from fqss_tpu_torch.data.librimix import LibriMix, batch_iterator
from fqss_tpu_torch.models.factory import create_model_and_teacher
from fqss_tpu_torch.parallel.mesh import Mesh
from fqss_tpu_torch.quant.calibration import DEFAULT_OBSERVER_WINDOW, calibrate_mse_quantizers, has_pending_mse
from fqss_tpu_torch.train.checkpoints import CheckpointManager, dump_config, export_model, save_log
from fqss_tpu_torch.train.state import TrainState
from fqss_tpu_torch.train.trainer import (
    EarlyStopping,
    ReduceLROnPlateau,
    StepLR,
    TrainConfig,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from fqss_tpu_torch.train.validate import save_results
from fqss_tpu_torch.utils.audio import set_seed
from fqss_tpu_torch.utils.logging import log_metrics


def _make_datasets(dataset_cfg: Mapping[str, Any], seed: int, use_speedperturb: bool = False,
                   use_rand_shift: bool = False, shift_range: tuple[int, int] = (-8000, 8000),
                   use_wavedrop: bool = False):
    name = dataset_cfg.get("name", "librimix")
    if name != "librimix":
        raise ValueError(f"Dataset {name} is not supported for the speech recipe")
    common = dict(
        task=dataset_cfg.get("task", "sep_clean"),
        sample_rate=dataset_cfg.get("sample_rate", 16000),
        resample=dataset_cfg.get("resample", 1.0),
        n_src=dataset_cfg.get("n_src", 2),
        segment=dataset_cfg.get("segment", 3),
    )
    train_set = LibriMix(dataset_cfg["train_dir"], augmentation_cfg=dataset_cfg.get("augmentation"),
                         speed_perturb=use_speedperturb, rand_shift=use_rand_shift, shift_range=shift_range,
                         wavedrop=use_wavedrop, seed=seed, **common)
    val_set = LibriMix(dataset_cfg["valid_dir"], seed=seed + 1, **common)
    return train_set, val_set


def train_speech(conf: Mapping[str, Any], env_name: str = "asteroid", device: torch.device | str = "cuda",
                 mesh: Mesh | None = None) -> dict:
    """Run speech QAT training from a reference-schema config dict on ``device`` (the card by default; ``"cpu"``
    runs the kernels' plain versions; a missing card raises), or data-parallel over ``mesh`` on its device (the
    batch size must divide by the world size).

    Returns ``{"best_val_loss", "epochs_run", "state"}``.
    """
    from fqss_tpu_torch.infer import resolve_device

    work_dir = conf["work_dir"]
    model_cfg = conf["model_cfg"]
    dataset_cfg = conf["dataset_cfg"]
    training_cfg = conf["training_cfg"]
    device = mesh.device if mesh is not None else resolve_device(str(device))
    if training_cfg.get("wandb", False):
        raise NotImplementedError("wandb logging is not ported yet (ROADMAP.md, queue 1); set wandb: False")
    batch_size = training_cfg.get("batch_size", 2)
    rows = mesh.rows(batch_size) if mesh is not None else None  # raises where the batch does not divide
    main = mesh is None or mesh.is_main
    log = save_log if main else (lambda *_: None)

    seed = training_cfg.get("seed", 0)
    set_seed(seed)  # numpy and python, for the data pipeline
    torch.manual_seed(seed)
    if main:
        dump_config(work_dir, dict(conf))

    is_sb = env_name == "speechbrain"
    train_set, val_set = _make_datasets(
        dataset_cfg, seed,
        use_speedperturb=is_sb and training_cfg.get("use_speedperturb", True),
        use_rand_shift=is_sb and training_cfg.get("use_rand_shift", False),
        shift_range=(training_cfg.get("min_shift", -8000), training_cfg.get("max_shift", 8000)),
        use_wavedrop=is_sb and training_cfg.get("use_wavedrop", False),
    )

    model, teacher = create_model_and_teacher(model_cfg, training_cfg.get("pretrained"),
                                              generator=torch.Generator().manual_seed(seed))
    optim_cfg = training_cfg.get("optim", {})
    cfg = TrainConfig(
        kd_lambda=training_cfg.get("kd_lambda", 0.1),
        lr=optim_cfg.get("lr", 1e-3),
        weight_decay=optim_cfg.get("weight_decay", 0.0),
        optimizer=optim_cfg.get("optimizer", "adam"),
        grad_clip=training_cfg.get("grad_clip", 5.0),
        threshold_byloss=is_sb and training_cfg.get("threshold_byloss", False),
        threshold=training_cfg.get("threshold", -30.0),
        loss_upper_lim=training_cfg.get("loss_upper_lim", 999999.0),
    )
    model.to(device)
    teacher.to(device)
    state = TrainState(model, make_optimizer(cfg, [p for p in model.parameters() if p.requires_grad]), teacher)
    train_step = make_train_step(cfg, mesh)
    eval_step = make_eval_step(mesh)

    ckpt = CheckpointManager(work_dir, write=main)
    # asteroid_librimix_trainer.py:95-101: half_lr -> ReduceLROnPlateau(0.5, patience); elif step_lr -> StepLR.
    if training_cfg.get("half_lr", True):
        plateau = ReduceLROnPlateau(factor=0.5, patience=training_cfg.get("patience", 5),
                                    dont_halve_until_epoch=training_cfg.get("dont_halve_until_epoch", 0))
    elif training_cfg.get("step_lr") is not None:
        slr = training_cfg["step_lr"] or {}
        plateau = StepLR(step_size=slr.get("step_size", 2), gamma=slr.get("gamma", 0.98))
    else:
        plateau = None
    stopper = EarlyStopping(30) if training_cfg.get("early_stop", True) else None

    # observer: False in the quantization config means "resume"
    # (configs/convtasnet_2spks_8k.yaml): restore the latest checkpoint if any.
    start_epoch = 0
    if not model_cfg.get("quantization", {}).get("observer", True):
        last_epoch = ckpt.restore_latest(state)
        if last_epoch is not None:
            start_epoch = last_epoch + 1
            log(work_dir, f"resumed from checkpoint at epoch {last_epoch}")

    # MSE calibration when the observer window closes (fqss_tpu/train/recipes.py:167-196): the histograms gather on
    # the device during the window, and the host's search runs once, after the step at which it closes. A resumed,
    # calibrated state skips it; one resumed inside the window continues its histograms.
    mse_window = model_cfg.get("quantization", {}).get("max_observations", DEFAULT_OBSERVER_WINDOW)
    mse_pending = has_pending_mse(model)

    def to_device(mix: np.ndarray, src: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        return torch.from_numpy(mix).to(device), torch.from_numpy(src).to(device)

    epochs = training_cfg.get("epochs", 50)
    best_val = float("inf")
    epoch = start_epoch - 1
    # speechbrain's time-based checkpoint interval (ckpt_interval_minutes):
    # export the latest model mid-epoch so that long epochs survive preemption.
    ckpt_interval_s = 60.0 * float(training_cfg.get("ckpt_interval_minutes", 0) or 0)
    last_ckpt_t = time.time()
    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        losses = []
        for mix, src in batch_iterator(train_set, batch_size, seed=seed, epoch=epoch, rows=rows):
            metrics = train_step(state, *to_device(mix, src))
            losses.append(float(metrics["loss"]))
            if mse_pending and state.step >= mse_window:
                calibrate_mse_quantizers(model)  # every rank: the same histograms give the same grids
                mse_pending = False
                log(work_dir, f"MSE quantizer calibration at step {state.step}")
            if main and ckpt_interval_s and time.time() - last_ckpt_t >= ckpt_interval_s:
                export_model(os.path.join(work_dir, "latest_model.pt"), state.model)
                save_log(work_dir, f"interval checkpoint (epoch {epoch})")
                last_ckpt_t = time.time()

        val_losses = [float(eval_step(state, *to_device(mix, src))["val_loss"])
                      for mix, src in batch_iterator(val_set, batch_size, shuffle=False, seed=seed, epoch=epoch,
                                                     rows=rows)]
        val_loss = float(np.mean(val_losses)) if val_losses else float("nan")
        train_loss = float(np.mean(losses)) if losses else float("nan")

        if main:
            log_metrics(work_dir, {"loss": train_loss, "val_loss": val_loss, "lr_scale": state.lr_scale,
                                   "skipped": state.skipped, "epoch_time_s": time.time() - t0}, step=epoch)
        ckpt.save(epoch, state, {"val_loss": val_loss, "loss": train_loss})
        if main:
            export_model(os.path.join(work_dir, "latest_model.pt"), state.model)
            if val_loss < best_val:
                export_model(os.path.join(work_dir, "best_model.pt"), state.model)
        best_val = min(best_val, val_loss)
        if plateau is not None:
            plateau.update(state, val_loss)
        if stopper is not None and stopper.update(val_loss):
            log(work_dir, f"Early stopping at epoch {epoch}")
            break

    # speechbrain env: per-utterance test report after training
    # (speechbrain_librimix_trainer.py:336-441 save_results -> test_results.csv)
    testing_cfg = conf.get("testing_cfg", {})
    if main and is_sb and testing_cfg.get("test_dir") and os.path.isdir(testing_cfg["test_dir"]):
        avg = save_results(state.model.eval(), model_cfg, dataset_cfg, testing_cfg, work_dir,
                           limit=testing_cfg.get("limit"), device=device)
        save_log(work_dir, f"test_results.csv avg: {avg}")
    return {"best_val_loss": best_val, "epochs_run": epoch + 1, "state": state}
