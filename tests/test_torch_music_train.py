"""The port's ConvTasNet-music training and MUSDB evaluation against the JAX package, on a synthetic mini-MUSDB.

The tiny model of ``tests/test_torch_music.py`` (n_filters 16, bn 8, hid
16, 2 blocks x 1 repeat) and its float teacher are initialised in JAX and
converted with ``convtasnet_music_from_jax``. Bounds:

* one KD step (augmentation off, the observer window closed) against JAX's
  ``value_and_grad`` of the recipe's loss, compiled with the algebraic
  simplifier off (``tests/test_torch_train.py``; the port's forward equals
  eager JAX's bit for bit, and this compile's to an ulp: XLA contracts
  ``delta * X + mn`` into one FMA): the loss and the gradients' norm to rtol
  1e-5, each clipped gradient tensor to a relative L2 error of 1e-3 against
  the larger of its norm and 1e-4 of the whole gradient's (that file's
  rule). The activation ranges' gradients are sums of thousands of terms
  that nearly cancel, and each term takes ``round(v) - v`` of a ``v`` the
  backward recomputes: where ``v`` sits within an ulp of a half step, the two
  packages' arithmetic (like eager JAX's and the compile's) puts it on either
  side, and the term moves by up to ``|g|``. Each is held within 1e-5 of the
  sum of its terms' magnitudes plus the largest ``|g|`` of its quantizer's
  cotangent, one such element (the port reads at most 0.01 of that ``|g|``
  beyond the 1e-5; a wrong rule would read about the sum itself);
* the validation pass and ``val_musdbhq_nsdr`` / ``val_musdbhq`` against
  JAX's on the same weights, each through its own package's model: NSDR and
  SDR within 1e-3 dB; ISR, SIR and SAR, which come from float32 solves of
  4096 unknowns, by ``tests/test_torch_val.py``'s BSS Eval rule (rtol and
  atol 1e-3; they read up to 1.4e-3 dB apart at -4.5 dB);
* the recipe end to end (two epochs, the second resumed from the first's
  checkpoint), and the ``-env tasnet`` and ``val`` entry points in-process on
  the CPU.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fqss_tpu.models.convtasnet_music import ConvTasNetMusic as JaxMusic
from fqss_tpu.quant import QuantSpec as JaxQuantSpec
from fqss_tpu.quant.calibration import run_observer
from fqss_tpu_torch.data.musdb import get_musdb_wav_datasets, make_mini_musdb
from fqss_tpu_torch.data.synthetic import synth_music_batch
from fqss_tpu_torch.models.convert import convtasnet_music_from_jax
from fqss_tpu_torch.models.convtasnet_music import ConvTasNetMusic
from fqss_tpu_torch.quant.spec import QuantSpec
from fqss_tpu_torch.train.recipes_music import _is_better, make_music_train_step, validate_music
from fqss_tpu_torch.train.state import TrainState
from fqss_tpu_torch.train.trainer import TrainConfig, make_optimizer

torch.set_num_threads(1)

ARCH = dict(n_filters=16, bn_chan=8, hid_chan=16, n_blocks=2, n_repeats=1)
SPEC = dict(qat=True, n_splitter=2, n_combiner=2, out_quant=True, max_observations=3)
SOURCES = ("drums", "bass", "other", "vocals")
SR = 8000
MODEL_CFG = {"name": "ConvTasNetMusic", "sources": list(SOURCES), "audio_channels": 2, "kernel_size": 20,
             "stride": 10, **ARCH, "quantization": {**SPEC, "observer": True}}
TESTING = {"segment_samples": 4000, "overlap": 0.25, "NSDR": True}


def _noalg(fn):
    return jax.jit(fn, compiler_options={"xla_disable_hlo_passes": "algsimp"})


@pytest.fixture(scope="module")
def mini_musdb(tmp_path_factory):
    return make_mini_musdb(str(tmp_path_factory.mktemp("musdb")), n_train=3, n_test=2, sample_rate=SR, seconds=1.0)


@pytest.fixture(scope="module")
def noise_musdb(tmp_path_factory):
    """A MUSDB test split of two 1.5 s tracks whose stems are independent Gaussian noise on each channel.

    BSS Eval projects each estimate on 512 shifts of every reference channel; ``make_mini_musdb``'s second
    channel is 0.8 x its first and its stems are sums of a few tones, so there those shifts span a space of low
    rank, the Gram matrix is singular up to the solver's jitter, and the float32 solves of both packages put ISR,
    SIR and SAR anywhere in that null space (SIR 1-8 dB apart; SDR, which needs no solve, agrees). Broadband
    stems, like real ones, leave the solve well posed."""
    from fqss_tpu_torch.utils.audio import save_audio

    root = str(tmp_path_factory.mktemp("noise_musdb"))
    rng = np.random.default_rng(11)
    for i in range(2):
        track = os.path.join(root, "test", f"track_{i}")
        stems = (0.2 * rng.standard_normal((len(SOURCES), 2, 12000))).astype(np.float32)
        save_audio(os.path.join(track, "mixture.wav"), np.clip(stems.sum(0), -0.99, 0.99), SR)
        for s, name in enumerate(SOURCES):
            save_audio(os.path.join(track, f"{name}.wav"), stems[s], SR)
    return root


@pytest.fixture(scope="module")
def jax_models():
    """(JAX student, its calibrated variables, JAX teacher, its variables, stems [2, 4, 2, 3000])."""
    sources = synth_music_batch(np.random.default_rng(1), 2, 3000, sample_rate=SR)
    mix = jnp.asarray(sources.sum(axis=1))
    jm = JaxMusic(q=JaxQuantSpec(observer=True, **SPEC), **ARCH)
    jt = JaxMusic(**ARCH)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), mix)
    v = jax.device_get(run_observer(jm, v, mix, steps=4))  # the observer window is closed
    tv = jax.device_get(jax.jit(jt.init)(jax.random.PRNGKey(1), mix))
    return jm, v, jt, tv, sources


def _port(variables, q=QuantSpec(observer=True, **SPEC)) -> ConvTasNetMusic:
    model = ConvTasNetMusic(q=q, **ARCH)
    model.load_state_dict(convtasnet_music_from_jax(variables), strict=True)
    return model


def _rel(got, want, floor=0.0):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), floor, 1e-30)


def test_one_kd_step_matches_jax(jax_models):
    import optax

    from fqss_tpu.separation.losses import music_kd_l1_loss
    from fqss_tpu_torch.ops.fake_quant import act_bwd_terms
    from fqss_tpu_torch.quant.quantizers import ActQuantizer

    jm, v, jt, tv, sources = jax_models
    mix = jnp.asarray(sources.sum(axis=1))
    trainable = {"params": v["params"], "qparams": v["qparams"]}
    fwavs = jax.jit(jt.apply)(tv, mix)  # the float teacher: no quantizer ties for jit to decide

    def loss_fn(trainable):
        wavs, _ = jm.apply({**trainable, "qstats": v["qstats"]}, mix, mutable=["qparams", "qstats"])
        return music_kd_l1_loss(wavs, fwavs, jnp.asarray(sources), 0.1, "pow10")

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn)).lower(trainable).compile(
        compiler_options={"xla_disable_hlo_passes": "algsimp"})
    want_loss, grads = value_and_grad(trainable)
    want_norm = float(jax.jit(optax.global_norm)(grads))
    want_clipped = jax.device_get(jax.jit(lambda g: optax.clip_by_global_norm(5.0).update(g, None)[0])(grads))

    cfg = TrainConfig(lr=3e-4)
    model, teacher = _port(v), ConvTasNetMusic(**ARCH)
    teacher.load_state_dict(convtasnet_music_from_jax(tv), strict=True)
    state = TrainState(model, make_optimizer(cfg, [p for p in model.parameters() if p.requires_grad]),
                       teacher.requires_grad_(False).eval())
    seen = {}  # each act quantizer's input and output cotangent, for its range gradients' terms
    for name, mod in model.named_modules():
        if isinstance(mod, ActQuantizer):
            def keep(mod, args, out, name=name):
                seen[name] = [args[0].detach()]
                out.register_hook(lambda g, name=name: seen[name].append(g.detach()))
            mod.register_forward_hook(keep)
    metrics = make_music_train_step(cfg, {"enable": False})(state, torch.from_numpy(sources), None)
    assert not metrics["skipped"] and state.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), want_norm, rtol=1e-5)
    want_g = convtasnet_music_from_jax(want_clipped)
    whole = np.sqrt(sum(np.sum(g.numpy() ** 2) for g in want_g.values()))
    params = dict(state.model.named_parameters())
    assert set(params) == set(want_g)
    ranges = set()
    for name, (x, g) in seen.items():
        mod = model.get_submodule(name)
        _, d_mn, d_mx = act_bwd_terms(x, g, mod.min_range.detach(), mod.max_range.detach(), mod.n_bits, 1.0)
        for which, terms in (("min_range", d_mn), ("max_range", d_mx)):
            k = f"{name}.{which}"
            ranges.add(k)
            err = abs(params[k].grad.item() - want_g[k].item())
            assert err <= 1e-5 * terms.abs().sum().item() + g.abs().max().item(), k
    assert len(ranges) == 2 * 20
    for k, p in params.items():
        if k not in ranges:
            assert _rel(p.grad.numpy(), want_g[k].numpy(), 1e-4 * whole) <= 1e-3, k


def test_augmented_step_is_reproducible_and_pads_short_estimates(jax_models):
    """With the augmentation on, the same generator seed gives the same step; a shift that leaves the estimate
    short of the stems (3000 - 95 - 20 is no multiple of the stride) is padded, where JAX's loss fails."""
    _, v, _, tv, sources = jax_models
    losses = []
    for _ in range(2):
        model, teacher = _port(v), ConvTasNetMusic(**ARCH)
        teacher.load_state_dict(convtasnet_music_from_jax(tv))
        cfg = TrainConfig()
        state = TrainState(model, make_optimizer(cfg, list(model.parameters())), teacher.requires_grad_(False).eval())
        step = make_music_train_step(cfg, {"enable": True, "shift": 95, "remix_group_size": 2})
        m = step(state, torch.from_numpy(sources), torch.Generator().manual_seed(5))
        assert np.isfinite(float(m["loss"])) and not m["skipped"]
        losses.append(float(m["loss"]))
    assert losses[0] == losses[1]


def test_is_better_maximises_nsdr_and_minimises_losses():
    assert _is_better(2.0, 1.0, "nsdr") and not _is_better(1.0, 2.0, "nsdr_vocals")
    assert _is_better(1.0, 2.0, "loss") and not _is_better(2.0, 1.0, "reco")


@pytest.fixture(scope="module")
def served(jax_models):
    """(JAX eval model and variables, the port's eval model on them, a jitted JAX forward)."""
    _, v, _, _, _ = jax_models
    je = JaxMusic(q=JaxQuantSpec(observer=False, **SPEC), **ARCH)
    port = _port(v, QuantSpec(observer=False, **SPEC)).eval()
    return je, v, port, _noalg(lambda x: je.apply(v, x))


def test_validation_pass_matches_jax(served, mini_musdb):
    from fqss_tpu.data.musdb import get_musdb_wav_datasets as jax_datasets
    from fqss_tpu.train.recipes_music import _validate_music

    je, v, port, _ = served
    _, valid_set = get_musdb_wav_datasets(mini_musdb, 2000, SR, 4000, SOURCES)
    _, jax_valid = jax_datasets(mini_musdb, 2000, SR, 4000, SOURCES)
    weights = np.asarray([1.0, 2.0, 1.0, 0.5], np.float32)
    got = validate_music(port, valid_set, SOURCES, weights, TESTING)
    want = _validate_music(je, v, jax_valid, SOURCES, weights, TESTING)
    assert got.keys() == want.keys()
    for k in got:
        tol = 1e-3 if k.startswith("nsdr") else 1e-4 * abs(want[k])
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])


def test_musdb_evaluations_match_jax(served, noise_musdb):
    from fqss_tpu.train.validate_musdb import val_musdbhq as jax_val_musdbhq
    from fqss_tpu.train.validate_musdb import val_musdbhq_nsdr as jax_val_musdbhq_nsdr
    from fqss_tpu_torch.train.validate_musdb import val_musdbhq, val_musdbhq_nsdr

    je, v, port, jax_apply = served
    testing = {**TESTING, "test_dir": noise_musdb}
    got = val_musdbhq_nsdr(port, MODEL_CFG, testing)
    want = jax_val_musdbhq_nsdr(je, v, MODEL_CFG, testing, apply_fn=jax_apply)
    assert len(got) == len(want) == 5
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    (got, full), (want, want_full) = (val_musdbhq(port, MODEL_CFG, testing, return_full=True),
                                      jax_val_musdbhq(je, v, MODEL_CFG, testing, return_full=True,
                                                      apply_fn=jax_apply))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)  # the SDR needs no solve
    for metric in ("ISR", "SIR", "SAR"):  # float32 solves of 4096 unknowns: tests/test_torch_val.py's BSS rule
        np.testing.assert_allclose(list(full[metric].values()), list(want_full[metric].values()), rtol=1e-3,
                                   atol=1e-3)
    from torch_ddp_cases import one_rank_mesh

    with one_rank_mesh() as mesh:  # the OLA and the scores over a one-rank group: the same numbers
        assert val_musdbhq_nsdr(port, MODEL_CFG, testing, mesh=mesh) == val_musdbhq_nsdr(port, MODEL_CFG, testing)


def _recipe_conf(work_dir, root, epochs):
    return {
        "work_dir": str(work_dir),
        "model_cfg": MODEL_CFG,
        "dataset_cfg": {"name": "musdbhq", "musdb_root": root, "sample_rate": SR, "segment": 0.5, "data_stride": 0.25,
                        "augmentation": {"enable": True, "shift": 80, "remix_group_size": 2}},
        "training_cfg": {"epochs": epochs, "batch_size": 2, "kd_lambda": 0.1, "seed": 0, "optim": {"lr": 1e-3}},
        "testing_cfg": {**TESTING, "test_dir": root},
    }


def test_recipe_trains_two_epochs_with_resume(mini_musdb, tmp_path):
    from fqss_tpu_torch.train.recipes_music import train_tasnet_music

    work = tmp_path / "run"
    first = train_tasnet_music(_recipe_conf(work, mini_musdb, epochs=1), device="cpu")
    assert np.isfinite(first["best_loss"]) and first["state"].step == 3  # 2 training tracks x 3 windows / batch 2
    assert first["test"] is not None and np.isfinite(first["test"]["nsdr"])
    second = train_tasnet_music(_recipe_conf(work, mini_musdb, epochs=2), device="cpu")  # resumes after epoch 0
    assert second["state"].step == 6 and np.isfinite(second["best_loss"])
    log = (work / "results.txt").read_text()
    assert "resumed from checkpoint at epoch 0" in log and "epoch 1:" in log and "test epoch 1:" in log
    history = json.loads((work / "history.json").read_text())
    assert [h["epoch"] for h in history] == [0, 1]
    assert all(np.isfinite(h["valid_loss"]) and np.isfinite(h["valid_nsdr"]) for h in history)
    for name in ("best_model.pt", "latest_model.pt", "checkpoints/epoch_1.pt"):
        assert (work / name).exists(), name
    saved = torch.load(work / "best_model.pt", weights_only=True)
    best_epoch = int(np.argmin([h["valid_loss"] for h in history]))
    want = torch.load(work / "checkpoints" / f"epoch_{best_epoch}.pt", weights_only=True)["extra"]["best_state"]
    assert all(torch.equal(saved[k], want[k]) for k in want)
    # continue_from: a new run starts from this one's best model state
    cont = train_tasnet_music({**_recipe_conf(tmp_path / "cont", mini_musdb, epochs=0),
                               "training_cfg": {**_recipe_conf(work, mini_musdb, 0)["training_cfg"],
                                                "continue_from": str(work)}}, device="cpu")
    got = cont["state"].model.state_dict()
    assert all(torch.equal(got[k], saved[k]) for k in saved)


def test_train_and_val_entry_points_on_cpu(mini_musdb, tmp_path, capsys):
    from fqss_tpu_torch.train.__main__ import main as train_main
    from fqss_tpu_torch.val import main as val_main

    cfg = tmp_path / "music.json"
    cfg.write_text(json.dumps(_recipe_conf(tmp_path / "run", mini_musdb, epochs=1)))
    train_main(["-env", "tasnet", "-y", str(cfg), "--device", "cpu"])
    assert "Training done" in capsys.readouterr().out
    model_path = str(tmp_path / "run" / "best_model.pt")
    for nsdr, engine in ((True, "int8"), (False, "folded")):
        conf = _recipe_conf(tmp_path / "run", mini_musdb, 1)
        conf["model_cfg"] = {**MODEL_CFG, "model_path": model_path}
        conf["testing_cfg"] = {**conf["testing_cfg"], "NSDR": nsdr}
        cfg.write_text(json.dumps(conf))
        val_main(["-y", str(cfg), "--engine", engine, "--limit", "1", "--device", "cpu"])
        lines = capsys.readouterr().out.strip().splitlines()
        if nsdr:
            assert lines[-1].startswith("NSDR=") and "NSDR_VOCALS=" in lines[-1]
        else:
            assert lines[-4].startswith("SDR=") and "SDR_DRUMS=" in lines[-4]
            assert [line.split("=")[0] for line in lines[-3:]] == ["ISR", "SIR", "SAR"]
    from fqss_tpu_torch.infer import main as infer_main

    with pytest.raises(NotImplementedError, match="ConvTasNetMusic"):  # music file separation is not ported
        infer_main(["-y", str(cfg), "-a", os.path.join(mini_musdb, "test", "track_0", "mixture.wav"),
                    "--device", "cpu"])
