"""One KD step of the tiny FQSS-8bit DPTNet with the LSTM's static and dynamic cells against the JAX trainer's, on
the CPU (the modes' other tests: ``tests/test_torch_lstm_modes.py``).

The model of ``tests/test_torch_train_models.py`` (encoder 16, features 8, LSTM hidden 16, one dual-path layer,
segments of 20, n_splitter = n_combiner = 2, out_quant, max_observations 3) with ``lstm_mode`` set, its observer
windows closed (the LSTM sites' 50 steps too), student and float teacher initialised in JAX and carried across.
The step's loss and gradients against JAX's ``value_and_grad`` compiled with XLA's algebraic simplifier off, held as
that file holds DPTNet's (``ONE_STEP``). In the dynamic mode the bounds widen to JAX's own distance between its two
compiles (the simplifier on against off), measured in the test: every site's grid there moves with its tensor's min
and max, so an ulp at an extreme moves a whole tensor's grid (the jitted step reads 0.24 dB and cosine 0.986 from
the reference on this model, the port 0.058 dB and 0.9997; the port's loss equals eager JAX's bit for bit). JAX's
dynamic cell has NaN gradients (``tests/test_torch_lstm_modes.py``), so both JAX steps run its QLSTM with
``dynamic_act_quant`` guarded as the port's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fqss_tpu.nn.lstm as jax_lstm
from fqss_tpu.data import synth_batch
from fqss_tpu.models.dptnet import DPTNet as JaxDPTNet
from fqss_tpu.quant import QuantSpec as JaxQuantSpec
from fqss_tpu.quant.calibration import run_observer
from fqss_tpu.quant.fake_quant import linear_fake_quant as jax_linear_fake_quant
from fqss_tpu_torch.models.convert import dptnet_from_jax
from fqss_tpu_torch.models.dptnet import DPTNet
from fqss_tpu_torch.quant.spec import QuantSpec

torch.set_num_threads(1)

ALGSIMP_OFF = {"xla_disable_hlo_passes": "algsimp"}
ARCH = dict(n_srcs=2, kernel_size=2, enc_dim=16, feature_dim=8, hidden_dim=16, layer=1, segment_size=20)
SPEC = dict(qat=True, n_splitter=2, n_combiner=2, out_quant=True, max_observations=3)
# tests/test_torch_train_models.py's ONE_STEP: |loss difference| in dB; whole-gradient cosine and relative L2 error;
# each gradient tensor's error against the whole gradient's norm
ONE_STEP = dict(loss_db=0.01, cos=0.999, whole_rel=0.02, tensor_of_whole=5e-3)


def _compile(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=ALGSIMP_OFF)


def _jax_guarded_dynamic(x, n_bits=8, sym=False, factor=0.99):
    """JAX's ``dynamic_act_quant`` with the port's guard: the constant tensor's branch on a stand-in range."""
    mn, mx = jnp.min(x), jnp.max(x)
    flat = mn == mx
    lo, hi = jnp.where(flat, 0.0, factor * mn), jnp.where(flat, 1.0, factor * mx)
    return jnp.where(flat, x, jax_linear_fake_quant(x, lo, hi, n_bits, lo < 0, sym))


def _step_distance(got: dict, want: dict, keys: list) -> dict:
    """Whole-gradient cosine and relative L2 error, and the largest tensor's error against the whole gradient's
    norm, of ``got`` against ``want``."""
    flat_got = torch.cat([got[k].flatten() for k in keys]).double()
    flat_want = torch.cat([want[k].flatten() for k in keys]).double()
    whole = float(flat_want.norm())
    return dict(cos=float(flat_got @ flat_want) / (float(flat_got.norm()) * whole),
                whole_rel=float((flat_got - flat_want).norm()) / whole,
                tensor_of_whole=max(float((got[k] - want[k]).double().norm()) for k in keys) / whole)


@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_kd_step_matches_jax(mode, monkeypatch):
    from fqss_tpu.separation.losses import fqss_kd_loss

    from fqss_tpu_torch.train.state import TrainState
    from fqss_tpu_torch.train.trainer import TrainConfig, make_optimizer, make_train_step

    monkeypatch.setattr(jax_lstm, "dynamic_act_quant", _jax_guarded_dynamic)  # JAX's own is NaN (module note)
    spec = dict(SPEC, lstm_mode=mode)
    mix0, _ = synth_batch(np.random.default_rng(0), 2, 2, 600)
    obs = JaxDPTNet(q=JaxQuantSpec(observer=True, **spec), **ARCH)
    v = jax.device_get(run_observer(obs, jax.jit(obs.init)(jax.random.PRNGKey(0), jnp.asarray(mix0)),
                                    jnp.asarray(mix0), steps=4))  # the observer windows closed
    jm, jt = JaxDPTNet(q=JaxQuantSpec(observer=True, **spec), **ARCH), JaxDPTNet(**ARCH)
    mix, src = synth_batch(np.random.default_rng(5), 2, 2, 800)
    tv = jax.device_get(jax.jit(jt.init)(jax.random.PRNGKey(1), jnp.asarray(mix)))
    fest = jax.jit(jt.apply)(tv, jnp.asarray(mix))[..., :800]

    def loss_fn(trainable):
        est, _ = jm.apply({**trainable, "qstats": v["qstats"]}, jnp.asarray(mix), mutable=["qparams", "qstats"])
        return fqss_kd_loss(est[..., :800], fest, jnp.asarray(src), kd_lambda=0.1)[0]

    trainable = {"params": v["params"], "qparams": v["qparams"]}
    want_loss, grads = _compile(jax.value_and_grad(loss_fn), trainable)(trainable)
    want_g = dptnet_from_jax(jax.device_get(grads))
    model = DPTNet(q=QuantSpec(observer=True, **spec), **ARCH)
    model.load_state_dict(dptnet_from_jax(v), strict=True)
    teacher = DPTNet(**ARCH)
    teacher.load_state_dict(dptnet_from_jax(tv), strict=True)
    teacher.requires_grad_(False)
    state = TrainState(model, make_optimizer(TrainConfig(), [p for p in model.parameters() if p.requires_grad]),
                       teacher.eval())
    # no clip, so that the parameters keep the loss's own gradients
    metrics = make_train_step(TrainConfig(grad_clip=1e9))(state, torch.from_numpy(mix), torch.from_numpy(src))
    assert not metrics["skipped"] and np.isfinite(float(metrics["loss"]))
    params = dict(model.named_parameters())
    got = {k: p.grad if p.grad is not None else torch.zeros_like(want_g[k]) for k, p in params.items()}
    bound = dict(ONE_STEP)
    if mode == "dynamic":
        # Every site's grid moves with its tensor's min and max, so an ulp at an extreme moves a whole tensor: JAX's
        # jitted step (algebraic simplifier on) reads 0.24 dB, cosine 0.986 from the reference, while the port
        # reads 0.058 dB, 0.9997 (its loss equals eager JAX's bit for bit). The bounds widen to JAX's own distance.
        jit_loss, jit_grads = jax.jit(jax.value_and_grad(loss_fn))(trainable)
        own = _step_distance(dptnet_from_jax(jax.device_get(jit_grads)), want_g, list(params))
        bound = dict(loss_db=max(bound["loss_db"], abs(float(jit_loss) - float(want_loss))),
                     cos=min(bound["cos"], own["cos"]), whole_rel=max(bound["whole_rel"], own["whole_rel"]),
                     tensor_of_whole=max(bound["tensor_of_whole"], own["tensor_of_whole"]))
    dist = _step_distance(got, want_g, list(params))
    assert abs(float(metrics["loss"]) - float(want_loss)) <= bound["loss_db"], (float(metrics["loss"]), bound)
    assert dist["cos"] >= bound["cos"], (dist, bound)
    assert dist["whole_rel"] <= bound["whole_rel"] and dist["tensor_of_whole"] <= bound["tensor_of_whole"], dist
    if mode == "static":  # the ranges learn, and the window is closed: no observer write
        assert all(params[k].grad is not None for k in params if "site_" in k)


def _step_distance(got: dict, want: dict, keys: list) -> dict:
    """Whole-gradient cosine and relative L2 error, and the largest tensor's error against the whole gradient's
    norm, of ``got`` against ``want``."""
    flat_got = torch.cat([got[k].flatten() for k in keys]).double()
    flat_want = torch.cat([want[k].flatten() for k in keys]).double()
    whole = float(flat_want.norm())
    return dict(cos=float(flat_got @ flat_want) / (float(flat_got.norm()) * whole),
                whole_rel=float((flat_got - flat_want).norm()) / whole,
                tensor_of_whole=max(float((got[k] - want[k]).double().norm()) for k in keys) / whole)


@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_recipe_infer_stream_and_val_clis_run_each_mode(mode, tmp_path, capsys):
    """``train -env asteroid`` (one epoch, through the sites' window), then ``infer`` on its export with every
    engine and ``--stream``, and ``val``: finite outputs, and the export loads into the model it was trained as."""
    import json

    from fqss_tpu_torch import infer, val
    from fqss_tpu_torch.data.librimix import make_mini_librimix
    from fqss_tpu_torch.train.__main__ import main
    from fqss_tpu_torch.utils.audio import read_audio

    root = tmp_path / "mini"
    make_mini_librimix(str(root), n_train=4, n_val=2, seconds=0.5, seed=1)
    arch = {k: v for k, v in ARCH.items() if k != "n_srcs"}
    quant = {"qat": True, "out_quant": True, "n_splitter": 2, "n_combiner": 2, "observer": True,
             "max_observations": 1, "lstm_mode": mode}
    conf = {
        "work_dir": str(tmp_path / "run"),
        "model_cfg": {"name": "DPTNet", "model_path": None, "n_src": 2, **arch, "quantization": quant},
        "dataset_cfg": {"name": "librimix", "task": "sep_clean", "train_dir": str(root / "train"),
                        "valid_dir": str(root / "val"), "sample_rate": 8000, "resample": 1.0, "n_src": 2,
                        "segment": 0.25, "augmentation": {"enable": False}},
        "training_cfg": {"epochs": 1, "batch_size": 2, "half_lr": True, "early_stop": True,
                         "ckpt_interval_minutes": 1e-6, "pretrained": None, "seed": 0, "kd_lambda": 0.1,
                         "optim": {"optimizer": "adam", "lr": 0.001, "weight_decay": 0.0}},
        "testing_cfg": {"test_dir": str(root / "test"), "segment_samples": 1000, "overlap": 0.25},
    }
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(conf))
    main(["-env", "asteroid", "-y", str(cfg), "--device", "cpu"])
    assert "Training done" in capsys.readouterr().out
    state = torch.load(tmp_path / "run" / "best_model.pt", weights_only=True)
    model = DPTNet(q=QuantSpec(**dict(SPEC, lstm_mode=mode, observer=False)), **ARCH)
    model.load_state_dict(state)  # the export loads into the model it was trained as
    counts = {int(v) for k, v in state.items() if k.endswith("site_n_iter")}
    assert (counts and max(counts) > 0) if mode == "static" else not counts
    conf["model_cfg"]["model_path"] = str(tmp_path / "run" / "best_model.pt")
    cfg.write_text(json.dumps(conf))
    wav = next((root / "test" / "mix_clean").glob("*.wav"))
    for engine, stream in (("fake_quant", None), ("folded", None), ("int8", None), ("folded", "300")):
        out = tmp_path / f"out_{engine}_{stream}"
        infer.main(["-y", str(cfg), "-a", str(wav), "-o", str(out), "--engine", engine, "--device", "cpu",
                    *(["--stream", stream] if stream else [])])
        for s in (1, 2):
            audio, fs = read_audio(str(out / f"source_{s}.wav"))
            assert fs == 8000 and np.isfinite(audio).all()
    capsys.readouterr()
    val.main(["-y", str(cfg), "--device", "cpu", "--engine", "int8", "--limit", "1", "--no-stoi"])
    values = dict(item.split("=") for item in capsys.readouterr().out.strip().splitlines()[-1].split(","))
    assert all(np.isfinite(float(values[k])) for k in ("SI-SDR", "SI-SDR-imp", "SDR")), values  # STOI off: nan
