"""The port's htdemucs recipe on the CPU: its host code against the JAX package bit for bit, and the recipe end to end.

* ``make_music_optimizer``: the cross-transformer's group (``t_lr``,
  ``t_weight_decay``: AdamW) beside the base group (Adam), and one update of
  a tiny HTDemucs's parameters and ranges on the same gradients, equal to
  optax's ``multi_transform`` run op by op (eagerly) bit for bit;
* ``RepitchedWavset`` over a mini MUSDB against JAX's on the same tracks and
  seed, bit for bit;
* ``_hydra_compat`` on a config in the reference's hydra schema, equal to
  JAX's;
* ``train_htdemucs`` for one epoch, a resume that restores the EMAs and the
  best state, a second epoch, and ``continue_from``; the ``-env htdemucs``
  entry point; the recipes' default device, the card.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fqss_tpu_torch.data.musdb import RepitchedWavset, get_musdb_wav_datasets, make_mini_musdb
from fqss_tpu_torch.models.convert import htdemucs_from_jax
from fqss_tpu_torch.models.htdemucs import HTDemucs
from fqss_tpu_torch.quant.spec import QuantSpec
from fqss_tpu_torch.train.recipes_music import _hydra_compat, make_music_optimizer, train_htdemucs
from fqss_tpu_torch.train.trainer import OptaxAdam, TrainConfig

torch.set_num_threads(1)

SOURCES = ("drums", "bass", "other", "vocals")
TINY = dict(channels=8, nfft=512, depth=2, t_layers=2, t_heads=4, segment=0.5, samplerate=8000)
SPEC = dict(qat=True, n_splitter=2, n_combiner=2, out_quant=True, max_observations=2)
SR = 8000


@pytest.fixture(scope="module")
def mini_musdb(tmp_path_factory):
    return make_mini_musdb(str(tmp_path_factory.mktemp("musdb")), n_train=3, n_test=1, sample_rate=SR, seconds=1.0)


# ---------------------------------------------------------------------------
# Host code against JAX
# ---------------------------------------------------------------------------


def test_music_optimizer_groups_and_update_equal_optax():
    import optax

    from fqss_tpu.models.htdemucs import HTDemucs as JaxHTDemucs
    from fqss_tpu.quant import QuantSpec as JaxQuantSpec
    from fqss_tpu.train.recipes_music import make_music_optimizer as jax_make_music_optimizer
    from fqss_tpu.train.trainer import TrainConfig as JaxTrainConfig

    model = HTDemucs(q=QuantSpec(observer=True, **SPEC), **TINY, generator=torch.Generator().manual_seed(3))
    model_cfg = {"t_lr": 2e-3, "t_weight_decay": 0.05}
    cfg = TrainConfig(lr=3e-4, weight_decay=0.0, grad_clip=0.0)
    opt = make_music_optimizer(cfg, model_cfg, model)
    assert isinstance(opt, OptaxAdam) and len(opt.param_groups) == 2
    names = {id(p): n for n, p in model.named_parameters()}
    base, t = ([names[id(p)] for p in g["params"]] for g in opt.param_groups)
    assert t and all(n.startswith("crosstransformer.") for n in t)
    assert base and not any(n.startswith("crosstransformer.") for n in base)
    assert len(base) + len(t) == sum(p.requires_grad for p in model.parameters())
    assert [(g["lr"], g["weight_decay"]) for g in opt.param_groups] == [(3e-4, 0.0), (2e-3, 0.05)]
    assert type(make_music_optimizer(cfg, {}, model)) is torch.optim.Adam  # no group of its own: make_optimizer

    # The JAX tree of the same values, from the converter's places, and gradients on both sides.
    jm = JaxHTDemucs(q=JaxQuantSpec(observer=True, **SPEC), **TINY)
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x, train=True), jnp.zeros((1, 2, 4000)))
    shapes = {c: shapes[c] for c in ("params", "qparams")}
    leaves, tree = jax.tree_util.tree_flatten(shapes)
    sizes = np.cumsum([0] + [leaf.size for leaf in leaves])
    places = htdemucs_from_jax(jax.tree_util.tree_unflatten(
        tree, [np.arange(a, b).reshape(leaf.shape) for a, b, leaf in zip(sizes[:-1], sizes[1:], leaves)]))
    rng = np.random.default_rng(4)
    grads = {n: (rng.standard_normal(p.shape) * 1e-2).astype(np.float32) for n, p in model.named_parameters()}

    def jax_tree(values):
        flat = np.zeros(sizes[-1], np.float32)
        for n, place in places.items():
            flat[place.numpy().ravel()] = values[n].ravel()
        return jax.tree_util.tree_unflatten(tree, [jnp.asarray(flat[a:b].reshape(leaf.shape)) for a, b, leaf
                                                   in zip(sizes[:-1], sizes[1:], leaves)])

    params = jax_tree({n: p.detach().numpy() for n, p in model.named_parameters()})
    tx = jax_make_music_optimizer(JaxTrainConfig(lr=3e-4, weight_decay=0.0, grad_clip=0.0), model_cfg, params)
    updates, _ = tx.update(jax_tree(grads), tx.init(params), params)  # eagerly: each operation on its own
    want = htdemucs_from_jax(jax.device_get(optax.apply_updates(params, updates)))
    for n, p in model.named_parameters():
        p.grad = torch.from_numpy(grads[n])
    opt.step()
    got = dict(model.named_parameters())
    assert got.keys() == want.keys()
    for n, w in want.items():
        assert torch.equal(got[n].detach(), w), n


@pytest.mark.parametrize("proba", [1.0, 0.5])
def test_repitched_wavset_equals_jax(mini_musdb, proba):
    from fqss_tpu.data.musdb import RepitchedWavset as JaxRepitchedWavset
    from fqss_tpu.data.musdb import get_musdb_wav_datasets as jax_datasets

    train, _ = get_musdb_wav_datasets(mini_musdb, 1000, SR, 4000, SOURCES)
    jax_train, _ = jax_datasets(mini_musdb, 1000, SR, 4000, SOURCES)
    got, want = RepitchedWavset(train, proba=proba, seed=7), JaxRepitchedWavset(jax_train, proba=proba, seed=7)
    assert got.out_length == want.out_length == 3520 and len(got) == len(want) > 3
    stretched = 0
    for i in [*range(len(got)), 0, 2]:  # a second pass draws anew
        a, b = got[i], want[i]
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (4, 2, 3520)
        assert np.array_equal(a, b), i
        stretched += not np.array_equal(a, np.asarray(train[i])[..., :3520])
    assert stretched > 0


def test_hydra_compat_equals_jax():
    from fqss_tpu.train.recipes_music import _hydra_compat as jax_hydra_compat

    conf = {
        "work_dir": "runs/htdemucs", "model_cfg": {"name": "HTDemucs", "t_lr": 3e-4, "quantization": {"qat": True}},
        "dset": {"musdb": "/data/musdb18hq", "samplerate": 44100, "segment": 11, "shift": 1, "channels": 2,
                 "sources": list(SOURCES), "metadata": "./metadata/musdbhq.json"},
        "augment": {"flip": True, "shift_same": False, "repitch": {"proba": 0.2, "max_tempo": 12},
                    "remix": {"proba": 1, "group_size": 4}, "scale": {"proba": 1, "min": 0.25, "max": 1.25}},
        "optim": {"lr": 3e-4, "momentum": 0.9, "beta2": 0.999, "optim": "adam", "weight_decay": 0, "clip_grad": 0},
        "ema": {"epoch": [0.9, 0.95], "batch": [0.9995, 0.9999]}, "test": {"every": 20, "metric": "loss", "best": True},
        "epochs": 360, "batch_size": 32, "kd_lambda": 0.1, "seed": 42, "weights": [1.0, 1.0, 1.0, 1.0],
        "continue_from": None, "training_cfg": {"batch_size": 8},
    }
    got = _hydra_compat(conf)
    assert got == jax_hydra_compat(conf)
    assert got["training_cfg"]["batch_size"] == 8 and got["dataset_cfg"]["augmentation"]["shift"] == 44100
    plain = {"work_dir": "w", "model_cfg": {}, "training_cfg": {}}
    assert _hydra_compat(plain) is plain and jax_hydra_compat(plain) is plain


# ---------------------------------------------------------------------------
# The recipe
# ---------------------------------------------------------------------------


def _recipe_conf(work_dir, root, epochs, **training):
    return {
        "work_dir": str(work_dir),
        "model_cfg": {"name": "HTDemucs", "sources": list(SOURCES), "audio_channels": 2, **TINY, "t_lr": 1e-3,
                      "t_weight_decay": 0.01, "quantization": {**SPEC, "observer": True}},
        "dataset_cfg": {"name": "musdbhq", "musdb_root": root, "sample_rate": SR, "segment": 0.5, "data_stride": 0.25,
                        "augmentation": {"enable": True, "shift": 80, "flip": True, "scale": True, "remix_group_size": 2,
                                         "repitch": {"proba": 0.5, "max_tempo": 12}}},
        "training_cfg": {"epochs": epochs, "batch_size": 2, "kd_lambda": 0.1, "seed": 0, "weights": [1, 2, 1, 0.5],
                         "optim": {"lr": 1e-3, "clip_grad": 0.5}, "ema": {"batch": [0.9], "epoch": [0.5]},
                         "test": {"metric": "nsdr"}, **training},
        "testing_cfg": {"test_dir": root, "NSDR": True, "segment_samples": 4000, "overlap": 0.25},
    }


def _equal_dicts(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_htdemucs_recipe_trains_resumes_and_continues(mini_musdb, tmp_path):
    work = tmp_path / "run"
    first = train_htdemucs(_recipe_conf(work, mini_musdb, epochs=1), device="cpu")
    state = first["state"]
    # 2 training tracks x 3 windows (0.5 s, stride 0.25 s) / batch 2; repitch cuts each window to 3520
    assert state.step == 3 and np.isfinite(first["best_loss"]) and state.skipped == 0
    assert first["bname"] in ("main", "ema_batch_0", "ema_epoch_0")
    params = dict(state.model.named_parameters())
    for emas in (first["batch_emas"], first["epoch_emas"]):  # the weights and ranges, not the counters
        assert len(emas) == 1 and emas[0].keys() == params.keys()
        assert not _equal_dicts(emas[0], {n: p.detach() for n, p in params.items()})
    assert first["test"] is not None and np.isfinite(first["test"]["nsdr"])
    saved = torch.load(work / "checkpoints" / "epoch_0.pt", weights_only=True)["extra"]
    assert all(_equal_dicts(a, b) for a, b in zip(saved["batch_emas"] + saved["epoch_emas"],
                                                  first["batch_emas"] + first["epoch_emas"]))
    assert _equal_dicts(saved["best_state"], first["best_state"])

    # resume with nothing left to run: the EMAs, the best state and the train state come back as saved
    again = train_htdemucs(_recipe_conf(work, mini_musdb, epochs=1), device="cpu")
    assert again["state"].step == 3 and again["bname"] is None
    assert all(_equal_dicts(a, b) for a, b in zip(again["batch_emas"] + again["epoch_emas"],
                                                  first["batch_emas"] + first["epoch_emas"]))
    assert _equal_dicts(again["best_state"], first["best_state"])
    assert _equal_dicts(again["state"].model.state_dict(), state.model.state_dict())

    second = train_htdemucs(_recipe_conf(work, mini_musdb, epochs=2), device="cpu")
    assert second["state"].step == 6 and np.isfinite(second["best_loss"])
    log = (work / "results.txt").read_text()
    assert "replay epoch 0:" in log and "resumed from checkpoint at epoch 0" in log
    assert "epoch 1:" in log and "bname=" in log and "test epoch 1:" in log
    history = json.loads((work / "history.json").read_text())
    assert [h["epoch"] for h in history] == [0, 1]
    assert all(np.isfinite(h["valid_nsdr"]) and np.isfinite(h["loss"]) for h in history)
    best = torch.load(work / "best_model.pt", weights_only=True)
    best_epoch = int(np.argmax([h["valid_nsdr"] for h in history]))
    want = torch.load(work / "checkpoints" / f"epoch_{best_epoch}.pt", weights_only=True)["extra"]["best_state"]
    assert _equal_dicts(best, want)
    # continue_from: a new run starts from this one's best model state
    conf = _recipe_conf(tmp_path / "cont", mini_musdb, epochs=0, continue_from=str(work))
    cont = train_htdemucs(conf, device="cpu")
    assert _equal_dicts(cont["state"].model.state_dict(), best)


def test_train_cli_runs_htdemucs_on_cpu(mini_musdb, tmp_path, capsys):
    from fqss_tpu_torch.train.__main__ import main as train_main

    cfg = tmp_path / "htdemucs.json"
    cfg.write_text(json.dumps(_recipe_conf(tmp_path / "run", mini_musdb, epochs=1)))
    train_main(["-env", "htdemucs", "-y", str(cfg), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Training done" in out and "last epoch's best model: " in out
    assert (tmp_path / "run" / "best_model.pt").exists() and (tmp_path / "run" / "latest_model.pt").exists()


@pytest.mark.parametrize("entry", ["train_speech", "train_tasnet_music", "train_htdemucs"])
def test_recipes_default_to_the_card(entry, tmp_path):
    """Without ``device`` a recipe runs on the card, and raises where there is none (before it reads its data)."""
    import inspect

    from fqss_tpu_torch.train import recipes, recipes_music

    fn = getattr(recipes if entry == "train_speech" else recipes_music, entry)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return
    conf = {"work_dir": str(tmp_path), "model_cfg": {}, "dataset_cfg": {}, "training_cfg": {}}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn(conf)
