"""The port's speech recipe end to end on the CPU: ``train_speech`` on a mini LibriMix.

The LibriMix corpus is not in the repository, so the recipe runs on the
synthetic mini set that ``fqss_tpu.data.librimix.make_mini_librimix``
writes in the LibriMix layout, with the tiny FQSS-8bit ConvTasNet of the
other port tests. Two epochs write checkpoints, ``history.json`` and the best/latest exports; a
third epoch resumes from the checkpoint (``observer: False``); the best
export serves a file through ``fqss_tpu_torch.infer``. The CLI
``python -m fqss_tpu_torch.train`` runs one epoch in a subprocess; its ``--help``
and its refusal of the music environments are checked in this process.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fqss_tpu.data.librimix import make_mini_librimix
from fqss_tpu.data.synthetic import synth_batch
from fqss_tpu.utils.audio import read_audio, save_audio
from fqss_tpu_torch import infer
from fqss_tpu_torch.quant.quantizers import MseActQuantizer
from fqss_tpu_torch.train.recipes import train_speech

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def recipe_conf(work_dir, train_dir, val_dir, epochs=2, observer=True):
    return {
        "work_dir": str(work_dir),
        "model_cfg": {
            "name": "ConvTasNet", "model_path": None, "n_src": 2, "kernel_size": 16, "stride": 8,
            "n_filters": 32, "bn_chan": 8, "hid_chan": 16, "n_blocks": 2, "n_repeats": 1,
            "quantization": {"qat": True, "out_quant": True, "n_splitter": 2, "n_combiner": 2,
                             "observer": observer, "max_observations": 2},
        },
        "dataset_cfg": {"name": "librimix", "task": "sep_clean", "train_dir": train_dir, "valid_dir": val_dir,
                        "sample_rate": 8000, "resample": 1.0, "n_src": 2, "segment": 0.3,
                        "augmentation": {"enable": False}},
        "training_cfg": {"epochs": epochs, "batch_size": 2, "half_lr": True, "early_stop": True,
                         "ckpt_interval_minutes": 1e-6, "pretrained": None, "seed": 0, "kd_lambda": 0.1,
                         "optim": {"optimizer": "adam", "lr": 0.001, "weight_decay": 0.0}},
        "testing_cfg": {"test_dir": None, "segment_samples": 1200, "overlap": 0.25},
    }


@pytest.fixture(scope="module")
def mini_librimix(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("minilibrimix"))
    return make_mini_librimix(root, n_train=4, n_val=2, sample_rate=8000, seconds=0.3)


def test_train_speech_two_epochs_resume_and_serve_the_best_export(mini_librimix, tmp_path):
    train_dir, val_dir = mini_librimix
    work = tmp_path / "run"
    result = train_speech(recipe_conf(work, train_dir, val_dir), "asteroid", device="cpu")
    assert result["epochs_run"] == 2 and np.isfinite(result["best_val_loss"])
    state = result["state"]
    assert state.step == 4 and state.skipped == 0  # 2 batches per epoch
    for name in ("conf.yml", "results.txt", "best_model.pt", "latest_model.pt", "checkpoints/epoch_0.pt",
                 "checkpoints/epoch_1.pt"):
        assert (work / name).exists(), name
    history = json.loads((work / "history.json").read_text())
    assert [h["epoch"] for h in history] == [0, 1] and all(np.isfinite(h["loss"]) for h in history)
    assert "interval checkpoint" in (work / "results.txt").read_text()

    # observer: False resumes from the latest checkpoint and trains the third epoch only
    resumed = train_speech(recipe_conf(work, train_dir, val_dir, epochs=3, observer=False), "asteroid", device="cpu")
    assert resumed["epochs_run"] == 3 and resumed["state"].step == 6
    assert "resumed from checkpoint at epoch 1" in (work / "results.txt").read_text()
    assert [h["epoch"] for h in json.loads((work / "history.json").read_text())] == [0, 1, 2]

    # the best export serves a file through the infer entry
    conf = recipe_conf(work, train_dir, val_dir)
    conf["model_cfg"]["model_path"] = str(work / "best_model.pt")
    apply_fn = infer.load_engine(conf["model_cfg"], "folded", "cpu")
    mix, _ = synth_batch(np.random.default_rng(1), 1, 2, 3000)
    wav = tmp_path / "mixture.wav"
    save_audio(str(wav), mix[0], 8000)
    out_dir, out = infer.separate_file(apply_fn, conf, str(wav), str(tmp_path / "out"), device="cpu")
    assert out.shape == (2, 3000) and np.isfinite(out).all()
    audio, fs = read_audio(f"{out_dir}/source_1.wav")
    assert fs == 8000 and audio.shape == (1, 3000)


def test_train_speech_speechbrain_env_thresholds_and_refuses_what_is_not_ported(mini_librimix, tmp_path):
    train_dir, val_dir = mini_librimix
    conf = recipe_conf(tmp_path / "sb", train_dir, val_dir, epochs=1)
    conf["training_cfg"].update(threshold_byloss=True, threshold=-1e9, use_speedperturb=False)
    conf["testing_cfg"]["test_dir"] = os.path.join(os.path.dirname(train_dir), "test")
    result = train_speech(conf, "speechbrain", device="cpu")
    assert result["epochs_run"] == 1 and result["state"].step == 2
    # the speechbrain recipe's test report: one row per test mixture and the average
    with open(tmp_path / "sb" / "test_results.csv") as fh:
        assert [line.split(",")[0] for line in fh.read().split()][1:] == ["test_0.wav", "test_1.wav", "avg"]
    conf["training_cfg"]["wandb"] = True
    with pytest.raises(NotImplementedError, match="wandb"):
        train_speech(conf, "speechbrain", device="cpu")
    conf["training_cfg"]["wandb"] = False
    conf["model_cfg"]["quantization"]["act_quantizer"] = "mse"  # ported: calibrated when the window (2) closes
    conf["work_dir"] = str(tmp_path / "sb_mse")
    result = train_speech(conf, "speechbrain", device="cpu")
    assert result["state"].step == 2 and all(bool(m.calibrated) for m in result["state"].model.modules()
                                             if isinstance(m, MseActQuantizer))
    assert "MSE quantizer calibration at step 2" in (tmp_path / "sb_mse" / "results.txt").read_text()


def _run_cli(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable, "-m", "fqss_tpu_torch.train", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_train_cli_help_and_one_epoch_on_the_mini_set(mini_librimix, tmp_path, capsys):
    import yaml

    from fqss_tpu_torch.train.__main__ import main

    with pytest.raises(SystemExit) as exit_info:
        main(["--help"])
    help_text = capsys.readouterr().out
    assert exit_info.value.code == 0 and "-env" in help_text and "--device" in help_text
    train_dir, val_dir = mini_librimix
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(yaml.safe_dump(recipe_conf(tmp_path / "run", train_dir, val_dir, epochs=1)))
    proc = _run_cli(["-env", "asteroid", "-y", str(cfg), "--device", "cpu"], tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "Training done" in proc.stdout
    assert (tmp_path / "run" / "best_model.pt").exists() and (tmp_path / "run" / "checkpoints" / "epoch_0.pt").exists()
    assert "htdemucs" in help_text  # -env htdemucs trains (tests/test_torch_htdemucs_recipe.py)
