"""The music training recipes, tasnet and htdemucs environments (``fqss_tpu/train/recipes_music.py``).

Both run on one device with the same KD step over MUSDB stem windows
(``data/musdb.py``), the Shift/FlipSign/FlipChannels/Scale/Remix
augmentations on the device inside the step, mix = sum of the stems, KD
from the float teacher into the quantized student, the non-finite skip and
the gradients' norm logged; each epoch a validation pass over whole tracks
(OLA without overlap: the L1 ``reco`` and the NSDR per stem), best/latest
exports, epoch checkpoints, resume from the latest checkpoint (or a start
from another run's, ``continue_from``), and the test set's NSDR after the
last epoch (or every ``test.every`` epochs). They read the reference YAML
schema in both spellings of the dataset keys.

* ``train_tasnet_music`` is the reference's tasnet trainer
  (train_env/tasnet_musdbhq/musdbhq_train.py:45-170): the weighted L1 loss
  ``w = 10**((nsdr_f - nsdr_q)/10)`` (``music_kd_l1_loss``, ``pow10``), clip
  5.0.
* ``train_htdemucs`` is the htdemucs solver (train_env/htdemucs_musdbhq/
  solver.py): ``exp((sdr - sdr_q)/10)`` KD weights with the config's source
  weights, Remix in groups of 4 and the host-side Repitch
  (:class:`~fqss_tpu_torch.data.musdb.RepitchedWavset`), ``train=True`` for
  student and teacher, the cross-transformer's own optimizer group
  (``t_lr``/``t_weight_decay``, :func:`make_music_optimizer`), clip
  ``optim.clip_grad`` (0: none), batch and epoch EMA model zoos of the
  parameters and quantizer ranges (not the observers' counters), each
  validated with the main model every epoch and the best kept by
  ``test.metric``, checkpoints that carry the EMAs and the best state, and
  the hydra/dora schema of the reference config (:func:`_hydra_compat`).

With a data-parallel ``mesh`` (``parallel/mesh.py``; torchrun) every rank
draws the global batch's order and augmentation values from the shared seeds
and trains on its rows (:func:`rows_to_read`: its own rows where no Remix
group crosses ranks, else the whole batch, augmented, then its rows); the
step reduces over the ranks as the JAX step over a mesh does, so the EMAs and
optimizer groups stay equal on every rank; rank 0 writes the files; every
rank restores and validates (the validation is not sharded, as JAX's).

One difference from the JAX step: where ``(T - shift - kernel_size)`` is not
a multiple of the model's stride (the tasnet config's 6 s windows with the
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

from fqss_tpu_torch.data.musdb import RepitchedWavset, Wavset, apply_augment, draw_augment, get_musdb_wav_datasets
from fqss_tpu_torch.models.factory import create_model_and_teacher
from fqss_tpu_torch.parallel import mesh as dp
from fqss_tpu_torch.quant.calibration import DEFAULT_OBSERVER_WINDOW, calibrate_mse_quantizers, has_pending_mse
from fqss_tpu_torch.separation.losses import music_kd_l1_loss, nsdr_db
from fqss_tpu_torch.separation.ola import ola_infer
from fqss_tpu_torch.train.checkpoints import CheckpointManager, dump_config, export_model, save_log
from fqss_tpu_torch.train.state import TrainState
from fqss_tpu_torch.train.trainer import OptaxAdam, TrainConfig, backward_and_update, make_optimizer
from fqss_tpu_torch.train.validate_musdb import SOURCES, val_musdbhq_nsdr
from fqss_tpu_torch.utils.audio import set_seed

Tensor = torch.Tensor


def _pad_to(x: Tensor, length: int) -> Tensor:
    return F.pad(x, (0, length - x.shape[-1])) if x.shape[-1] < length else x[..., :length]


def make_music_optimizer(cfg: TrainConfig, model_cfg: Mapping[str, Any], model: nn.Module) -> torch.optim.Optimizer:
    """The optimizer of the music recipes over ``model``'s trainable parameters (``fqss_tpu/train/recipes_music.py:
    make_music_optimizer``; reference htdemucs train.py:88-119).

    Where the config sets ``t_lr`` or a nonzero ``t_weight_decay`` and the model has a ``crosstransformer``, that
    module's parameters form their own group at ``t_lr`` (else the base rate) and ``t_weight_decay``, every other
    parameter the base group at ``lr``/``weight_decay``, each Adam, or AdamW where its decay is nonzero
    (:class:`OptaxAdam`, optax's arithmetic); else :func:`make_optimizer`. The clip stays global across the groups:
    the train step applies it to every gradient first."""
    t_lr = model_cfg.get("t_lr")
    t_wd = float(model_cfg.get("t_weight_decay") or 0.0)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    in_t = [("crosstransformer" in n.split(".")) for n, _ in named]
    if (t_lr is None and t_wd == 0.0) or not any(in_t):
        return make_optimizer(cfg, [p for _, p in named])
    groups = []
    for t, lr, wd in ((False, cfg.lr, cfg.weight_decay), (True, t_lr or cfg.lr, t_wd)):
        groups.append({"params": [p for (_, p), it in zip(named, in_t) if it == t], "lr": lr, "base_lr": lr,
                       "weight_decay": wd})
    return OptaxAdam(groups, lr=cfg.lr)


def ema_update_(emas: list[dict[str, Tensor]], model: nn.Module, decays: tuple[float, ...]) -> None:
    """Each EMA ``e`` of ``model``'s parameters (a dict by parameter name) becomes ``d e + (1 - d) p`` for its decay
    ``d`` (solver.py:425-426, 438-440): the weights and the quantizer ranges, not the observers' counters."""
    if not emas:
        return
    names, params = zip(*((n, p.detach()) for n, p in model.named_parameters()))
    for ema, d in zip(emas, decays):
        new = torch._foreach_add(torch._foreach_mul([ema[n] for n in names], d),
                                 torch._foreach_mul(list(params), 1.0 - d))
        ema.update(zip(names, new))


def _augment_args(augment_cfg: Mapping[str, Any] | None, is_htdemucs: bool) -> dict:
    aug = dict(augment_cfg or {})
    return dict(shift=aug.get("shift", 8192), flip_channels=aug.get("flip", True), flip_sign=aug.get("flip", True),
                scale=(0.25, 1.25) if aug.get("scale", True) else None,
                remix_group_size=aug.get("remix_group_size", 4 if is_htdemucs else 0))


def rows_to_read(batch: int, mesh: dp.Mesh | None, augment_cfg: Mapping[str, Any] | None = None,
                 is_htdemucs: bool = False) -> slice:
    """The rows of a global batch of ``batch`` that a rank reads for :func:`make_music_train_step`: its own, unless
    a Remix group of the augmentation spans two ranks' rows, which needs the whole batch."""
    if mesh is None:
        return slice(None)
    rows = mesh.rows(batch)
    g = _augment_args(augment_cfg, is_htdemucs)["remix_group_size"] or batch
    remix = dict(augment_cfg or {}).get("enable", True) and batch % g == 0 and batch > 1
    return slice(0, batch) if remix and (rows.stop - rows.start) % g else rows


def _rows_of(draws: dict[str, Tensor | None], rows: slice) -> dict[str, Tensor | None]:
    """The draws of a batch's ``rows`` (whole Remix groups)."""
    out = {k: None if v is None else v[rows] for k, v in draws.items() if k != "perm"}
    perm = draws["perm"]
    if perm is not None:
        g = perm.shape[1]
        perm = perm[rows.start // g: rows.stop // g]
    return {**out, "perm": perm}


def make_music_train_step(cfg: TrainConfig, augment_cfg: Mapping[str, Any] | None = None, weight_kind: str = "pow10",
                          is_htdemucs: bool = False, source_weights=None, batch_ema_decays: tuple[float, ...] = (),
                          mesh: dp.Mesh | None = None) -> Callable[..., dict]:
    """The music KD step ``(state, sources [B, S, C, T], generator, batch_emas=(), batch=None) -> metrics`` over stem
    batches; updates ``state`` and, after the optimizer, each of ``batch_emas`` (dicts by parameter name) by its
    decay in ``batch_ema_decays`` (solver.py:425-426).

    With ``mesh``, each rank passes the rows :func:`rows_to_read` names of a global batch of ``batch``; the
    augmentation's values are drawn for the global batch and the rank trains on its own rows of the augmented
    batch, and the step reduces over the ranks.

    The augmentation's values come from ``generator`` (a CPU generator: the same draws on every device) unless
    ``augment_cfg["enable"]`` is false; Remix groups ``remix_group_size`` rows (default 4 for HTDemucs, else 0:
    the whole batch); mix = sum of the augmented stems (musdbhq_train.py:60-66); the loss is
    ``music_kd_l1_loss``'s ``weight_kind`` (``pow10`` the tasnet trainer's, ``exp`` the htdemucs solver's, with
    ``source_weights``). ``is_htdemucs``: student and teacher called with ``train=True``. Metrics: ``loss`` and
    ``grad_norm`` (before the clip) as device tensors, ``skipped`` (bool).
    """
    aug = dict(augment_cfg or {})
    aug_args = _augment_args(aug, is_htdemucs)
    kwargs = {"train": True} if is_htdemucs else {}

    def train_step(state: TrainState, sources: Tensor, generator: torch.Generator,
                   batch_emas: list[dict[str, Tensor]] = (), batch: int | None = None) -> dict:
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        batch = batch or sources.shape[0]
        rows = mesh.rows(batch) if mesh is not None else slice(None)
        whole = sources.shape[0] == batch  # the whole batch, of which this rank keeps its rows
        if aug.get("enable", True):
            draws = draw_augment(generator, (batch, *sources.shape[1:]), **aug_args)
            sources = apply_augment(sources, **(draws if whole else _rows_of(draws, rows)), shift=aug_args["shift"])
        if whole and mesh is not None:
            sources = sources[rows]
        with dp.sharded(mesh):
            mix = sources.sum(dim=1)  # [B, C, T]
            t_len = sources.shape[-1]
            wavs = _pad_to(state.model(mix, **kwargs), t_len)
            if cfg.kd_lambda > 0 and state.teacher is not None:
                with torch.no_grad():
                    fwavs = _pad_to(state.teacher(mix, **kwargs), t_len)
            else:
                fwavs = wavs.detach()
            loss = music_kd_l1_loss(wavs, fwavs, sources, cfg.kd_lambda, weight_kind, source_weights=source_weights)
            grad_norm, ok = backward_and_update(state, cfg, loss)
        ema_update_(list(batch_emas), state.model, batch_ema_decays)
        return {"loss": loss.detach(), "grad_norm": grad_norm, "skipped": not ok}

    return train_step


def validate_music(apply_fn: Callable[[Tensor], Tensor], valid_set: Wavset, sources: tuple[str, ...],
                   weights: np.ndarray, testing_cfg: Mapping[str, Any], limit: int | None = None,
                   device: torch.device | str = "cpu", center_pad_to: int | None = None) -> dict:
    """The validation pass (solver.py:299-390, train=False): each whole track separated by OLA without overlap
    from its stored mixture; the source-weighted L1 ``reco`` (also ``loss``) and the NSDR of each stem
    (``nsdr_<stem>``) and their weighted mean (``nsdr``), averaged over tracks. ``center_pad_to``: each chunk
    centre-padded with the mixture around it to this length (HTDemucs: ``testing_cfg.segment_samples``, demucs's
    use_train_segment)."""
    n = len(valid_set) if limit is None else min(limit, len(valid_set))
    recos, nsdrs = [], []
    for i in range(n):
        ex = np.asarray(valid_set[i])  # [1 + S, C, T]
        mix, srcs = ex[0], ex[1:]
        est = ola_infer(apply_fn, mix, n_srcs=len(sources), segment=testing_cfg.get("segment_samples"), overlap=0.0,
                        center_pad_to=center_pad_to, device=device)
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


def _hydra_compat(conf: Mapping[str, Any]) -> Mapping[str, Any]:
    """The reference hydra/dora htdemucs schema mapped onto the plain schema (``fqss_tpu/train/recipes_music.py:
    _hydra_compat``).

    The reference configs/htdemucs.yaml keeps dataset/optimizer/augment/EMA settings in top-level hydra groups
    (``dset``, ``optim``, ``augment``, ``ema``, ``test``, ``epochs``, ``batch_size``, ``kd_lambda``, ``weights``,
    ``pretrained``, ``continue_from``; reference train_env/htdemucs_musdbhq/train.py:122-231). Where a ``dset``
    group is present, dataset_cfg/training_cfg are made from them so that the reference file runs unchanged;
    explicit plain-schema keys win.
    """
    if "dset" not in conf:
        return conf
    c = {k: v for k, v in conf.items()}
    dset = dict(conf.get("dset") or {})
    aug = dict(conf.get("augment") or {})
    optim = dict(conf.get("optim") or {})

    ds = dict(c.get("dataset_cfg") or {})
    ds.setdefault("name", "musdbhq")
    if dset.get("musdb"):
        ds.setdefault("musdb_root", dset["musdb"])
    sr = dset.get("samplerate", 44100)
    ds.setdefault("sample_rate", sr)
    ds.setdefault("segment", dset.get("segment", 10))
    ds.setdefault("data_stride", dset.get("shift", 1))
    meta = dset.get("metadata")
    if meta:
        ds.setdefault("metadata_file", os.path.join(meta, "musdbhq.json") if os.path.isdir(meta) else meta)
    remix = dict(aug.get("remix") or {})
    scale = dict(aug.get("scale") or {})
    repitch = dict(aug.get("repitch") or {})
    ds.setdefault("augmentation", {
        "enable": True,
        # demucs Shift(shift=samplerate * dset.shift) (train.py:191-199)
        "shift": int(sr * dset.get("shift", 1)),
        "flip": bool(aug.get("flip", True)),
        "scale": bool(scale.get("proba", 1)),
        "remix_group_size": int(remix.get("group_size", 4)) if remix.get("proba", 1) else 0,
        "repitch": {
            "proba": repitch.get("proba", 0.2),
            "max_tempo": repitch.get("max_tempo", 12),
        },
    })
    c["dataset_cfg"] = ds

    mc = dict(c.get("model_cfg") or {})
    if dset.get("sources"):
        mc.setdefault("sources", list(dset["sources"]))
    if dset.get("channels"):
        mc.setdefault("audio_channels", int(dset["channels"]))
    c["model_cfg"] = mc

    tc = dict(c.get("training_cfg") or {})
    for key in ("epochs", "batch_size", "kd_lambda", "seed", "weights",
                "pretrained", "continue_from", "continue_best", "ema"):
        if key in conf and conf[key] is not None:
            tc.setdefault(key, conf[key])
    if optim:
        tc.setdefault("optim", {
            "lr": optim.get("lr", 3e-4),
            "weight_decay": optim.get("weight_decay", 0.0),
            "optimizer": optim.get("optim", "adam"),
            "clip_grad": optim.get("clip_grad", 0.0),
        })
    if "test" in conf and conf["test"]:
        tc.setdefault("test", dict(conf["test"]))
    c["training_cfg"] = tc
    return c


def _state_copy(model: nn.Module) -> dict[str, Tensor]:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def _params_copy(model: nn.Module) -> dict[str, Tensor]:
    """An EMA's start: a copy of ``model``'s parameters on their device, by name."""
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _with_state(model: nn.Module, state: Mapping[str, Tensor]) -> nn.Module:
    """A copy of ``model`` holding ``state``, in eval mode."""
    other = copy.deepcopy(model)
    other.load_state_dict(state)
    return other.eval()


def _train_music(conf: Mapping[str, Any], env: str, device: torch.device | str, mesh: dp.Mesh | None = None) -> dict:
    from fqss_tpu_torch.infer import resolve_device

    conf = _hydra_compat(conf)
    work_dir = conf["work_dir"]
    model_cfg = conf["model_cfg"]
    dataset_cfg = conf.get("dataset_cfg", {})
    training_cfg = conf.get("training_cfg", {})
    testing_cfg = conf.get("testing_cfg", {})
    device = mesh.device if mesh is not None else resolve_device(str(device))
    main = mesh is None or mesh.is_main
    log = save_log if main else (lambda *_: None)

    seed = training_cfg.get("seed", 0)
    set_seed(seed)
    torch.manual_seed(seed)
    if main:
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

    is_htd = env == "htdemucs"
    aug_cfg = dict(dataset_cfg.get("augmentation", {"enable": True, "shift": min(8192, samples // 8)}))
    repitch_cfg = dict(aug_cfg.pop("repitch", {}) or {})
    if is_htd and repitch_cfg.get("proba", 0) > 0:
        # RepitchedWrapper (train.py:207-214): the train set only, every example cut to the worst-case stretched
        # length.
        train_set = RepitchedWavset(train_set, proba=repitch_cfg.get("proba", 0.2),
                                    max_pitch=repitch_cfg.get("max_pitch", 2),
                                    max_tempo=repitch_cfg.get("max_tempo", 12.0),
                                    tempo_std=repitch_cfg.get("tempo_std", 5.0), seed=seed)

    batch_size = training_cfg.get("batch_size", 4)
    reads = rows_to_read(batch_size, mesh, aug_cfg, is_htd)  # raises where the batch does not divide
    model, teacher = create_model_and_teacher(model_cfg, training_cfg.get("pretrained"),
                                              generator=torch.Generator().manual_seed(seed))
    optim_cfg = training_cfg.get("optim", {})
    cfg = TrainConfig(
        kd_lambda=training_cfg.get("kd_lambda", 0.1),
        lr=optim_cfg.get("lr", 3e-4),
        weight_decay=optim_cfg.get("weight_decay", 0.0),
        optimizer=optim_cfg.get("optimizer", "adam"),
        # the reference htdemucs default optim.clip_grad: 0 (no clipping)
        grad_clip=training_cfg.get("grad_clip", optim_cfg.get("clip_grad", 0.0) if is_htd else 5.0),
    )
    model.to(device)
    teacher.to(device)
    tx = (make_music_optimizer(cfg, model_cfg, model) if is_htd
          else make_optimizer(cfg, [p for p in model.parameters() if p.requires_grad]))
    state = TrainState(model, tx, teacher)

    # The EMA model zoo (solver.py:49-58): training_cfg.ema.{batch, epoch} decay lists; the key ema_batch is
    # ema.batch.
    ema_cfg = dict(training_cfg.get("ema", {}) or {})
    batch_decays = tuple(ema_cfg.get("batch", training_cfg.get("ema_batch", [0.9995] if is_htd else [])))
    epoch_decays = tuple(ema_cfg.get("epoch", ()) if is_htd else ())
    batch_emas = [_params_copy(model) for _ in batch_decays]
    epoch_emas = [_params_copy(model) for _ in epoch_decays]

    weights = np.asarray(training_cfg.get("weights", [1.0] * len(sources)), np.float32)
    # htdemucs applies the config's per-source weights to the train loss too (solver.py:371-372); the tasnet
    # trainer has none.
    step_fn = make_music_train_step(cfg, aug_cfg, weight_kind="exp" if is_htd else "pow10", is_htdemucs=is_htd,
                                    source_weights=weights if is_htd else None, batch_ema_decays=batch_decays,
                                    mesh=mesh)
    test_cfg = dict(training_cfg.get("test", {}) or {})
    test_every = int(test_cfg.get("every", testing_cfg.get("every", 0) or 0))
    test_metric = str(test_cfg.get("metric", "loss"))
    test_best = bool(test_cfg.get("best", True))
    valid_limit = training_cfg.get("valid_limit")
    valid_pad = testing_cfg.get("segment_samples") if is_htd else None
    kwargs = {"train": False} if is_htd else {}

    def host(emas: list[dict[str, Tensor]]) -> list[dict[str, Tensor]]:
        return [{n: v.cpu() for n, v in ema.items()} for ema in emas]

    def on_device(emas: list[dict[str, Tensor]]) -> list[dict[str, Tensor]]:
        return [{n: v.to(device) for n, v in ema.items()} for ema in emas]

    ckpt = CheckpointManager(work_dir, write=main)
    best_state = _state_copy(model)
    # Resume (solver.py:111-122) from the latest checkpoint of work_dir: the train state, the EMAs and the best
    # model state, the metric history replayed into the log; or start from another run's model (continue_from,
    # solver.py:128-140): its best state, or its latest model.
    start_epoch = 0
    last_epoch = ckpt.latest_epoch()
    if last_epoch is not None:
        saved = ckpt.load(last_epoch)
        state.load_state_dict(saved["state"])
        extra = saved["extra"]
        best_state = extra["best_state"]
        batch_emas = on_device(extra.get("batch_emas", host(batch_emas)))
        epoch_emas = on_device(extra.get("epoch_emas", host(epoch_emas)))
        start_epoch = last_epoch + 1
        for h in ckpt.history:
            log(work_dir, f"replay epoch {h.get('epoch')}: " + " ".join(
                f"{k}={v:.4f}" for k, v in h.items() if k != "epoch" and isinstance(v, float)))
        log(work_dir, f"resumed from checkpoint at epoch {last_epoch}")
    elif training_cfg.get("continue_from"):
        other = CheckpointManager(training_cfg["continue_from"])
        continue_best = training_cfg.get("continue_best", True)
        epoch = other.best_epoch() if continue_best else other.latest_epoch()
        if epoch is not None:
            saved = other.load(epoch)
            model.load_state_dict(saved["extra"]["best_state"] if continue_best else saved["state"]["model"])
            log(work_dir, f"continued from {training_cfg['continue_from']}")

    # MSE calibration when the observer window closes, as in the speech recipe (fqss_tpu/train/recipes_music.py:
    # 437-469)
    mse_window = (model_cfg.get("quantization") or {}).get("max_observations", DEFAULT_OBSERVER_WINDOW)
    mse_pending = has_pending_mse(model)
    generator = torch.Generator().manual_seed(seed)
    epochs = training_cfg.get("epochs", 4)
    metric_history = [h[f"valid_{test_metric}"] for h in ckpt.history if f"valid_{test_metric}" in h]
    best_loss = float("inf")
    order = np.arange(len(train_set))
    result_test, bname = None, None
    mine = range(batch_size)[reads]
    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        np.random.default_rng(seed + epoch).shuffle(order)
        losses = []
        metrics = {"grad_norm": 0.0}
        for i in range(0, (len(order) // batch_size) * batch_size, batch_size):
            items = []  # the rows this rank reads, [B', S, C, T]; the other rows' random draws taken in order
            for k, j in enumerate(order[i: i + batch_size]):
                if k in mine:
                    items.append(train_set[int(j)])
                else:
                    train_set.skip(int(j))
            batch = np.stack(items)
            metrics = step_fn(state, torch.from_numpy(batch).to(device), generator, batch_emas, batch=batch_size)
            losses.append(float(metrics["loss"]))
            if mse_pending and state.step >= mse_window:
                calibrate_mse_quantizers(model)  # every rank: the same histograms give the same grids
                mse_pending = False
                log(work_dir, f"MSE quantizer calibration at step {state.step}")
        mean_loss = float(np.mean(losses)) if losses else float("nan")
        ema_update_(epoch_emas, model, epoch_decays)  # once an epoch (solver.py:438-440)

        # Validate the main model and every EMA (the parameters and ranges of each, the main model's counters), and
        # keep the best by test.metric (solver.py:208-236).
        model.eval()
        candidates = [("main", None)] + [(f"ema_batch_{k}", e) for k, e in enumerate(batch_emas)]
        candidates += [(f"ema_epoch_{k}", e) for k, e in enumerate(epoch_emas)]
        shadow = copy.deepcopy(model) if len(candidates) > 1 else None
        bname, bvalid, bstate, valid_main = None, None, None, None
        for name, params in candidates:
            served = model
            if params is not None:
                with torch.no_grad():
                    for n, p in shadow.named_parameters():
                        p.copy_(params[n])
                served = shadow
            v = validate_music(lambda x, m=served: m(x, **kwargs), valid_set, sources, weights, testing_cfg,
                               limit=valid_limit, device=device, center_pad_to=valid_pad)
            if name == "main":
                valid_main = v
            if bvalid is None or _is_better(v[test_metric], bvalid[test_metric], test_metric):
                bname, bvalid, bstate = name, v, _state_copy(served)
        del shadow
        valid_loss = bvalid[test_metric]
        metric_history.append(valid_loss)
        hist_best = functools.reduce(lambda a, b: b if _is_better(b, a, test_metric) else a, metric_history)
        if valid_loss == hist_best:
            best_state = bstate
        log(work_dir, f"epoch {epoch}: loss={mean_loss:.5f} valid_loss={valid_main['loss']:.5f} "
                           f"valid_nsdr={valid_main['nsdr']:.3f} best={hist_best:.5f} bname={bname} "
                           f"grad_norm={float(metrics['grad_norm']):.3f} time={time.time() - t0:.1f}s")
        ckpt.save(epoch, state, {"val_loss": valid_main["loss"], "loss": mean_loss,
                                 f"valid_{test_metric}": valid_loss, "valid_nsdr": bvalid["nsdr"]},
                  extra={"best_state": best_state, "batch_emas": host(batch_emas), "epoch_emas": host(epoch_emas)})
        if main:
            export_model(os.path.join(work_dir, "latest_model.pt"), model)
        if main and valid_loss == hist_best:
            export_model(os.path.join(work_dir, "best_model.pt"), _with_state(model, best_state))
        best_loss = min(best_loss, mean_loss)

        # The test set's NSDR (solver.py:262-287) with the best state (test.best) or the current one.
        if testing_cfg.get("test_dir") and ((test_every and (epoch + 1) % test_every == 0) or epoch == epochs - 1):
            served = _with_state(model, best_state) if test_best else model
            vals = val_musdbhq_nsdr(served, model_cfg, testing_cfg, limit=testing_cfg.get("limit"), device=device)
            result_test = {"nsdr": vals[0], **{f"nsdr_{s}": v for s, v in zip(sources, vals[1:])}}
            log(work_dir, f"test epoch {epoch}: " + " ".join(f"{k}={v:.3f}" for k, v in result_test.items()))
    return {"best_loss": best_loss, "epochs_run": epochs, "state": state, "best_state": best_state,
            "batch_emas": host(batch_emas), "epoch_emas": host(epoch_emas), "bname": bname, "test": result_test}


def train_tasnet_music(conf: Mapping[str, Any], device: torch.device | str = "cuda",
                       mesh: dp.Mesh | None = None) -> dict:
    """Run the tasnet music recipe (tasnet_musdbhq_trainer.py:8 + musdbhq_train.py:170) from a reference-schema
    config dict on ``device`` (the card by default; ``"cpu"`` runs the kernels' plain versions; a missing card
    raises).

    Returns ``{"best_loss", "epochs_run", "state", "best_state", "batch_emas", "epoch_emas", "bname", "test"}``:
    the lowest epoch-mean train loss, the epochs in the config, the :class:`TrainState`, the best model state by
    ``test.metric``, the EMAs' parameters (on the CPU), the last epoch's best candidate and the last test NSDRs
    (None without ``testing_cfg.test_dir``). With ``mesh``: data-parallel over its ranks, on its device (the batch
    size must divide by the world size).
    """
    return _train_music(conf, "tasnet", device, mesh)


def train_htdemucs(conf: Mapping[str, Any], device: torch.device | str = "cuda", mesh: dp.Mesh | None = None) -> dict:
    """Run the htdemucs recipe (htdemucs_musdbhq/train.py:234-268) from a plain- or hydra-schema config dict on
    ``device`` (or over ``mesh``); returns what :func:`train_tasnet_music` returns."""
    return _train_music(conf, "htdemucs", device, mesh)
