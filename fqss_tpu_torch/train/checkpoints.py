"""Checkpoints (``fqss_tpu/train/checkpoints.py``): atomic, resumable, best and latest exports.

* :class:`CheckpointManager` saves the whole :class:`TrainState` (student,
  teacher, optimizer, counters) once per epoch under
  ``work_dir/checkpoints/epoch_<e>.pt``, each written to a temporary file
  and renamed, and keeps the ``keep`` best by ``val_loss`` (a save without
  one counts as worst) plus always the latest, with whatever ``extra`` the
  recipe hands it (the music recipes' best model state and EMAs). ``history.json``
  holds every epoch's metrics.
* :func:`export_model` writes the student's state dict, the file that
  ``models/factory.py:create_pretrained_model`` loads through
  ``model_path`` (the reference's ``best_model.pth``).
* :func:`restore_jax_export` reads the JAX package's ``.npz`` exports
  (``fqss_tpu/train/checkpoints.py:export_model``) with numpy alone;
  :func:`jax_export_entries` gives their flat keys.
* :func:`dump_config` writes ``conf.yml`` (asteroid_librimix_trainer.py:166-171),
  :func:`save_log` appends to ``results.txt`` (utils.py:16-21).
"""

from __future__ import annotations

import json
import math
import os
import re
import zipfile
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from fqss_tpu_torch.train.state import TrainState


def _atomic_save(obj: Any, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)  # a reader never sees half a file


class CheckpointManager:
    def __init__(self, work_dir: str, keep: int = 3):
        self.work_dir = os.path.abspath(work_dir)
        self.dir = os.path.join(self.work_dir, "checkpoints")
        os.makedirs(self.dir, exist_ok=True)
        self.keep = keep
        self.history_path = os.path.join(self.work_dir, "history.json")
        self.history: list[dict] = []
        if os.path.exists(self.history_path):
            with open(self.history_path) as f:
                self.history = json.load(f)

    def _path(self, epoch: int) -> str:
        return os.path.join(self.dir, f"epoch_{epoch}.pt")

    def epochs(self) -> list[int]:
        """The epochs that have a checkpoint on disk, in order."""
        found = (re.fullmatch(r"epoch_(\d+)\.pt", name) for name in os.listdir(self.dir))
        return sorted(int(m.group(1)) for m in found if m)

    def _val_loss(self, epoch: int) -> float:
        vals = [h.get("val_loss", math.inf) for h in self.history if h["epoch"] == epoch]
        v = vals[-1] if vals else math.inf
        return math.inf if math.isnan(v) else v

    def save(self, epoch: int, state: TrainState, metrics: Mapping[str, float],
             extra: Mapping[str, Any] | None = None) -> None:
        """Checkpoint ``state`` (and ``extra``, e.g. a recipe's best model state) as epoch ``epoch``."""
        metrics = {k: float(v) for k, v in metrics.items()}
        ckpt = {"epoch": epoch, "metrics": metrics, "state": state.state_dict()}
        if extra is not None:
            ckpt["extra"] = dict(extra)
        _atomic_save(ckpt, self._path(epoch))
        self.history.append({"epoch": epoch, **metrics})
        tmp = f"{self.history_path}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.history, f, indent=1)
        os.replace(tmp, self.history_path)
        epochs = self.epochs()
        kept = set(sorted(epochs, key=self._val_loss)[: self.keep]) | {epochs[-1]}
        for e in epochs:
            if e not in kept:
                os.remove(self._path(e))

    def latest_epoch(self) -> int | None:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def best_epoch(self) -> int | None:
        epochs = self.epochs()
        return min(epochs, key=self._val_loss) if epochs else None

    def load(self, epoch: int) -> dict[str, Any]:
        """Epoch ``epoch``'s checkpoint as saved: ``epoch``, ``metrics``, ``state`` and, where given, ``extra``."""
        return torch.load(self._path(epoch), map_location="cpu", weights_only=True)

    def restore(self, state: TrainState, epoch: int) -> None:
        state.load_state_dict(self.load(epoch)["state"])

    def restore_latest(self, state: TrainState) -> int | None:
        """Load the latest checkpoint into ``state``; returns its epoch, or None if there is none."""
        epoch = self.latest_epoch()
        if epoch is not None:
            self.restore(state, epoch)
        return epoch

    def restore_best(self, state: TrainState) -> int | None:
        """Load the checkpoint with the lowest ``val_loss`` into ``state``; returns its epoch, or None."""
        epoch = self.best_epoch()
        if epoch is not None:
            self.restore(state, epoch)
        return epoch


def export_model(path: str, model: nn.Module) -> None:
    """The model's state dict on the CPU, written atomically (the 'best_model.pth' analog)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    _atomic_save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)


def jax_export_entries(variables: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested variables as the flat ``collection/scope/.../name`` entries of the JAX package's ``export_model``."""
    out: dict[str, np.ndarray] = {}
    for k, v in variables.items():
        if isinstance(v, Mapping):
            out.update(jax_export_entries(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def is_npz(path: str) -> bool:
    """True if ``path`` is a numpy ``.npz`` archive (a zip of ``.npy`` members; ``torch.save``'s zips hold a
    pickle)."""
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as z:
        names = z.namelist()
    return bool(names) and all(n.endswith(".npy") for n in names)


def _pending_mse(data: Mapping[str, np.ndarray]) -> list[str]:
    """The quantizers of an export whose MSE histogram is not calibrated yet (``fqss_tpu/quant/calibration.py:27``
    ``has_pending_mse``)."""
    return [k.removesuffix("/calibrated") for k in data
            if k.startswith("qstats/") and k.endswith("/calibrated") and not bool(data[k])
            and k.removesuffix("calibrated") + "hist" in data]


def restore_jax_export(path: str, template: Mapping) -> dict:
    """The variables of a JAX ``export_model`` file, nested as ``template`` (e.g. ``models/convert.py:*_to_jax`` of
    the model's state dict) and cast to its dtypes, as ``fqss_tpu/train/checkpoints.py:restore_variables`` loads
    them: every key of ``template`` must be in the file (``ValueError: Missing key in checkpoint: <key>``), other
    keys of the file are not read, ``macs/`` is never persisted.

    Refused by name: an orbax checkpoint directory (reading it needs orbax), and an export taken inside an MSE
    observer window (its histograms carry no ranges yet; the JAX package calibrates them on import, which waits for
    the port's MSE quantizer, ROADMAP.md queue 1 item 3)."""
    if os.path.isdir(path):
        raise ValueError(f"{path}: an orbax checkpoint directory of the JAX package; reading it needs orbax, which "
                         "the port does not use. Export the variables with fqss_tpu.train.checkpoints.export_model "
                         "(.npz) instead.")
    try:
        with np.load(path, allow_pickle=False) as f:
            data = {k: f[k] for k in f.files}
    except Exception as e:
        raise ValueError(f"{path}: not readable as a .npz export of the JAX package: {e}") from e
    pending = _pending_mse(data)
    if pending:
        raise ValueError(f"{path}: a JAX export taken inside an MSE observer window ({len(pending)} quantizers with "
                         f"uncalibrated histograms, e.g. {pending[0]}); finishing that calibration needs the MSE "
                         "quantizer, which is not ported yet (ROADMAP.md, queue 1 item 3: MSE calibration)")
    out: dict = {}
    for key, leaf in jax_export_entries({k: v for k, v in template.items() if k != "macs"}).items():
        if key not in data:
            raise ValueError(f"Missing key in checkpoint: {key}")
        *scope, name = key.split("/")
        node = out
        for part in scope:
            node = node.setdefault(part, {})
        node[name] = data[key].astype(leaf.dtype)
    return out


def dump_config(work_dir: str, config: dict) -> None:
    """conf.yml dump like asteroid_librimix_trainer.py:166-171."""
    import yaml  # only here: the GPU machine that runs the kernels has no yaml

    os.makedirs(work_dir, exist_ok=True)
    with open(os.path.join(work_dir, "conf.yml"), "w") as f:
        yaml.safe_dump(config, f, default_flow_style=False)


def save_log(work_dir: str, text: str) -> None:
    """Append to results.txt (utils.py:16-21) and print."""
    os.makedirs(work_dir, exist_ok=True)
    with open(os.path.join(work_dir, "results.txt"), "a") as f:
        f.write(text + "\n")
    print(text)
