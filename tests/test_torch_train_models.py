"""The port's KD training path for DPTNet and the Sepformer against the JAX trainer, on the CPU.

Tiny FQSS-8bit models (n_splitter = n_combiner = 2, out_quant,
max_observations = 3): DPTNet with encoder 16, features 8, LSTM hidden 16,
one dual-path layer, segments of 20; the Sepformer with 32 filters, 4 heads,
one dual-path block of one intra and one inter layer, feed-forward 48,
chunks of 20 (the model of ``tests/test_torch_sepformer.py``). Student and
float teacher are initialised in JAX and carried across by the converters.

* One step against JAX's ``value_and_grad`` compiled with XLA's algebraic
  simplifier off (eager's divisions), the observer window closed, as
  ``tests/test_torch_train.py:test_one_step_matches_eager_jax`` holds
  ConvTasNet. ConvTasNet's bounds (the loss to rtol 1e-5, every gradient
  tensor to 1e-3 of its own norm) do not hold here, and the reason is the
  models, not the train step: their float versions agree with JAX to 8e-7
  per gradient tensor, and each quantized layer to JAX's within one LSB
  (``tests/test_torch_qat_dense.py``, ``test_torch_dptnet.py``,
  ``test_torch_sepformer.py``), but the LSTM, attention and LayerNorm sums
  land in another order than XLA's, and a pre-activation an ulp from a
  rounding tie moves one step. Such flips change a range gradient's terms
  by a whole 1/Q each (a few percent of the small, cancelling range sums)
  and the downstream cotangents; in the Sepformer's forward 85% of the
  outputs differ by ulps and its loss by 1.2e-4 relative. Measured (CPU,
  this file's models): DPTNet loss 2e-6 relative, whole-gradient relative
  L2 error 1.3e-4, the worst tensor 2.1e-3 of its norm; the Sepformer 1.2e-4,
  6.3e-3 and 2.1e-2. So these steps are held as chip_smoke.py's phase 10
  holds card against CPU, where the same flips occur: ``ONE_STEP`` below.
  The update is held to optax's chain applied to the port's own clipped
  gradients, to ConvTasNet's 1e-3 per tensor (Adam's first update is about
  -lr sign(g) per element, so a gradient element near 0 that differs in
  sign moves it by 2 lr).
* Five steps from the fresh state, through the observer window, against the
  jitted ``make_train_step(donate=False)``: finite losses, the counters and
  the one-shot observation as JAX's, the act ranges within 1e-3 relative
  inside the window; the losses within TRAJECTORY_DB. The jitted JAX model
  decides the weight observer's half-step ties by XLA's reciprocal (ROADMAP.md
  queue 3), so it is not the port's model to rounding: with the tiny models
  its loss moves by up to a few hundredths of a dB against the port's.
* The K7/K6 wrapper's CPU path, the plain recurrence, differentiated by
  autograd, against ``jax.vjp`` of ``_lstm_scan``; and its
  ``autograd.Function`` (the card's path) with the kernel launch replaced
  by the plain recurrence: the same gradient.
* The speech recipe on a mini LibriMix: ``-env asteroid`` for DPTNet,
  ``-env speechbrain`` for the Sepformer, one epoch each through
  ``python -m fqss_tpu_torch.train``'s ``main``, from a YAML and a JSON
  config.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from fqss_tpu.data import synth_batch
from fqss_tpu.models.dptnet import DPTNet as JaxDPTNet
from fqss_tpu.models.sepformer import Sepformer as JaxSepformer
from fqss_tpu.ops import pallas_lstm
from fqss_tpu.quant import QuantSpec as JaxQuantSpec
from fqss_tpu.quant.calibration import run_observer
from fqss_tpu_torch.models.convert import dptnet_from_jax, sepformer_from_jax
from fqss_tpu_torch.models.dptnet import DPTNet
from fqss_tpu_torch.models.sepformer import Sepformer
from fqss_tpu_torch.ops import lstm
from fqss_tpu_torch.ops import qat_dense as qd
from fqss_tpu_torch.quant.spec import QuantSpec
from fqss_tpu_torch.train.state import TrainState
from fqss_tpu_torch.train.trainer import TrainConfig, make_optimizer, make_train_step

torch.set_num_threads(1)

MODELS = {
    "DPTNet": (JaxDPTNet, DPTNet, dptnet_from_jax,
               dict(n_srcs=2, kernel_size=2, enc_dim=16, feature_dim=8, hidden_dim=16, layer=1, segment_size=20)),
    "Sepformer": (JaxSepformer, Sepformer, sepformer_from_jax,
                  dict(n_srcs=2, kernel_size=8, stride=4, n_filters=32, n_repeats=1, n_heads=4, chunk_size=20,
                       n_ffn=48, n_layers=1)),
}
SPEC = dict(qat=True, n_splitter=2, n_combiner=2, out_quant=True, max_observations=3)
T = 800
N_STEPS = 5
LR = 1e-3
ALGSIMP_OFF = {"xla_disable_hlo_passes": "algsimp"}
TRAJECTORY_DB = 0.05
# One step against eager JAX (module note): |loss difference| in dB; whole-gradient cosine and relative L2 error;
# each gradient tensor's error against the whole gradient's norm.
ONE_STEP = dict(loss_db=0.01, cos=0.999, whole_rel=0.02, tensor_of_whole=5e-3)


@pytest.fixture(scope="module", params=list(MODELS))
def jax_init(request):
    """(name, student, teacher, student variables, teacher variables, five (mix, src) batches)."""
    name = request.param
    jax_cls, _, _, arch = MODELS[name]
    rng = np.random.default_rng(0)
    batches = [synth_batch(rng, 2, 2, T) for _ in range(N_STEPS)]
    jm = jax_cls(q=JaxQuantSpec(observer=True, **SPEC), **arch)
    jt = jax_cls(**arch)
    v = jax.device_get(dict(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(batches[0][0]))))
    tv = jax.device_get(jax.jit(jt.init)(jax.random.PRNGKey(1), jnp.asarray(batches[0][0])))
    return name, jm, jt, v, tv, batches


def port_state(name, v, tv, cfg=TrainConfig()) -> TrainState:
    _, cls, convert, arch = MODELS[name]
    model = cls(q=QuantSpec(observer=True, **SPEC), **arch)
    model.load_state_dict(convert(v), strict=True)
    teacher = cls(**arch)
    teacher.load_state_dict(convert(tv), strict=True)
    teacher.requires_grad_(False)
    return TrainState(model, make_optimizer(cfg, [p for p in model.parameters() if p.requires_grad]), teacher.eval())


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _rel(got, want, floor=0.0):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), floor, 1e-30)


def test_one_step_matches_eager_jax(jax_init):
    from fqss_tpu.separation.losses import fqss_kd_loss
    from fqss_tpu.train import TrainConfig as JaxTrainConfig
    from fqss_tpu.train import make_optimizer as jax_make_optimizer

    name, jm, jt, v0, tv, batches = jax_init
    convert = MODELS[name][2]
    mix, src = batches[0]
    v = jax.device_get(run_observer(jm, v0, jnp.asarray(mix), steps=4))  # the observer window is closed
    trainable = {"params": v["params"], "qparams": v["qparams"]}
    fest = jax.jit(jt.apply)(tv, jnp.asarray(mix))[..., :T]

    def loss_fn(trainable):
        est, _ = jm.apply({**trainable, "qstats": v["qstats"]}, jnp.asarray(mix), mutable=["qparams", "qstats"])
        return fqss_kd_loss(est[..., :T], fest, jnp.asarray(src), kd_lambda=0.1)[0]

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn)).lower(trainable).compile(compiler_options=ALGSIMP_OFF)
    want_loss, grads = value_and_grad(trainable)
    tx = jax_make_optimizer(JaxTrainConfig())
    want_clipped = jax.device_get(jax.jit(lambda g: optax.clip_by_global_norm(5.0).update(g, None)[0])(grads))
    want_norm = float(jax.jit(optax.global_norm)(grads))

    state = port_state(name, v, tv)
    before = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    qd.reset_launches()
    metrics = make_train_step(TrainConfig())(state, *_torch(mix, src))
    assert set(qd.LAUNCHES.values()) == {0}  # CPU tensors: the plain versions
    assert not metrics["skipped"] and state.step == 1
    assert abs(float(metrics["loss"]) - float(want_loss)) <= ONE_STEP["loss_db"]
    np.testing.assert_allclose(float(metrics["grad_norm"]), want_norm, rtol=ONE_STEP["whole_rel"])

    want_g = convert(want_clipped)
    params = dict(state.model.named_parameters())
    assert set(params) == set(want_g)
    # the attention's no-op sites feed no gradient in either package
    got = {k: p.grad.numpy() if p.grad is not None else np.zeros_like(want_g[k].numpy()) for k, p in params.items()}
    flat_got = np.concatenate([got[k].ravel() for k in params])
    flat_want = np.concatenate([want_g[k].numpy().ravel() for k in params])
    whole = np.linalg.norm(flat_want)
    assert flat_got @ flat_want / (np.linalg.norm(flat_got) * whole) >= ONE_STEP["cos"]
    assert _rel(flat_got, flat_want) <= ONE_STEP["whole_rel"]
    for k, p in params.items():
        want = want_g[k].numpy()
        if p.grad is None:
            assert not want.any(), k
            continue
        assert np.linalg.norm(got[k] - want) <= ONE_STEP["tensor_of_whole"] * whole, k
    # Adam's first update is about -lr sign(g) in each element, so gradients that differ near 0 move it by 2 lr:
    # the update is held to optax's chain applied to the port's own (clipped) gradients, to ConvTasNet's 1e-3.
    mine = {k: jnp.asarray(got[k]) for k in params}
    start = {k: jnp.asarray(before[k].numpy()) for k in params}
    want_updates, _ = jax.jit(tx.update)(mine, tx.init(start), start)
    for k, p in params.items():
        update = (p.detach() - before[k]).numpy()
        assert _rel(update, np.asarray(want_updates[k])) <= 1e-3, k


@pytest.fixture(scope="module")
def trajectories(jax_init):
    """Five steps from the fresh (observer-open) state through the jitted JAX step and the port's."""
    from fqss_tpu.train import TrainConfig as JaxTrainConfig
    from fqss_tpu.train import create_train_state
    from fqss_tpu.train import make_optimizer as jax_make_optimizer
    from fqss_tpu.train import make_train_step as jax_make_train_step

    name, jm, jt, v, tv, batches = jax_init
    convert = MODELS[name][2]
    cfg = JaxTrainConfig(lr=LR)
    tx = jax_make_optimizer(cfg)
    jstate = create_train_state(v, tx, teacher_params=tv["params"])
    jstep = jax_make_train_step(jm, jt, tx, cfg, donate=False)
    state = port_state(name, v, tv, TrainConfig(lr=LR))
    step = make_train_step(TrainConfig(lr=LR))
    out = {"jax": [], "port": []}
    for mix, src in batches:
        jstate, jm_ = jstep(jstate, jnp.asarray(mix), jnp.asarray(src))
        out["jax"].append((float(jm_["loss"]), convert(jax.device_get(
            {"qparams": jstate.qparams, "qstats": jstate.qstats}))))
        m = step(state, *_torch(mix, src))
        out["port"].append((float(m["loss"]), {k: v.clone() for k, v in state.model.state_dict().items()}))
    assert int(jstate.skipped) == state.skipped == 0
    return out


def test_five_step_trajectory_through_the_observer_window_tracks_jitted_jax(trajectories):
    jl = np.array([loss for loss, _ in trajectories["jax"]])
    pl = np.array([loss for loss, _ in trajectories["port"]])
    assert np.isfinite(pl).all()
    assert np.abs(pl - jl).max() <= TRAJECTORY_DB, (pl, jl)
    for i, ((_, jq), (_, sd)) in enumerate(zip(trajectories["jax"], trajectories["port"])):
        for k, want in jq.items():
            got = sd[k]
            if k.endswith("n_iter"):
                assert int(got) == int(want) == min(i + 1, SPEC["max_observations"]), k
            elif k.endswith("observed"):
                assert bool(got) and bool(want), k
            elif "activation_fake_quantize" in k and i + 1 <= SPEC["max_observations"]:
                np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3, atol=1e-6, err_msg=f"{i} {k}")
    # after the window the optimizer moves act ranges that the observer no longer writes
    window_end = trajectories["port"][SPEC["max_observations"] - 1][1]
    last = trajectories["port"][-1][1]
    assert any(not torch.equal(last[k], window_end[k]) for k in last
               if "activation_fake_quantize" in k and k.endswith("_range"))


# ---------------------------------------------------------------------------
# The LSTM recurrence's backward (K7/K6's wrapper)
# ---------------------------------------------------------------------------


def _lstm_case(T_, B, H, seed):
    rng = np.random.default_rng(seed)
    ih = [(rng.standard_normal((T_, B, 4 * H)) * 0.5).astype(np.float32) for _ in range(2)]
    w = [(rng.uniform(-1, 1, (H, 4 * H)) / np.sqrt(H)).astype(np.float32) for _ in range(2)]
    g = [rng.standard_normal((T_, B, H)).astype(np.float32) for _ in range(2)]
    return ih, w, g


@pytest.mark.parametrize("T_,B,H", [(11, 5, 16), (4, 3, 40)])
def test_recurrence_gradient_equals_the_scan_vjp(T_, B, H):
    ih, w, g = _lstm_case(T_, B, H, T_ * B + H)
    want = []
    for d in range(2):
        _, pullback = jax.vjp(pallas_lstm._lstm_scan, jnp.asarray(ih[d]), jnp.asarray(w[d]))
        want += [np.asarray(a) for a in pullback(jnp.asarray(g[d]))]
    t = [torch.from_numpy(a).requires_grad_(True) for a in (ih[0], ih[1], w[0], w[1])]
    lstm.reset_launches()
    hf, hb = lstm.bilstm_sequence(*t)
    ((hf * torch.from_numpy(g[0])).sum() + (hb * torch.from_numpy(g[1])).sum()).backward()
    assert set(lstm.LAUNCHES.values()) == {0}
    got = [t[0].grad, t[2].grad, t[1].grad, t[3].grad]  # (d ih, d w) per direction
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5)


def test_recurrence_function_backward_is_the_plain_gradient(monkeypatch):
    """The card's path: the autograd.Function around the launch, here with the launch replaced by the plain
    recurrence, gives the plain recurrence's gradient and saves only its inputs."""
    ih, w, g = _lstm_case(6, 4, 8, 3)

    def fake_launch(name, key, pairs):
        lstm.LAUNCHES[key] += 1
        return [lstm.lstm_sequence_ref(a, b) for a, b in pairs]

    monkeypatch.setattr(lstm, "_launch", fake_launch)
    grads, launches = [], []
    for use_function in (True, False):
        t = [torch.from_numpy(a).requires_grad_(True) for a in (ih[0], w[0], ih[1], w[1])]
        lstm.reset_launches()
        if use_function:
            outs = lstm._Recurrence.apply(*t)
            one = lstm._Recurrence.apply(t[0], t[1], None, None)
        else:
            outs = lstm.bilstm_sequence_ref(t[0], t[2], t[1], t[3])
            one = lstm.lstm_sequence_ref(t[0], t[1])
        loss = sum((o * torch.from_numpy(gi)).sum() for o, gi in zip(outs, g)) + one.sum()
        loss.backward()
        grads.append([a.grad for a in t])
        launches.append(dict(lstm.LAUNCHES))
    assert launches[0] == {"lstm": 1, "bilstm": 1, "lstm_static": 0, "bilstm_static": 0}  # forward launches only; the backward recomputes
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# The recipe on a mini LibriMix
# ---------------------------------------------------------------------------


def _recipe_conf(work_dir, train_dir, val_dir, name):
    arch = {k: v for k, v in MODELS[name][3].items() if k != "n_srcs"}
    return {
        "work_dir": str(work_dir),
        "model_cfg": {"name": name, "model_path": None, "n_src": 2, **arch,
                      "quantization": {"qat": True, "out_quant": True, "n_splitter": 2, "n_combiner": 2,
                                       "observer": True, "max_observations": 1}},
        "dataset_cfg": {"name": "librimix", "task": "sep_clean", "train_dir": train_dir, "valid_dir": val_dir,
                        "sample_rate": 8000, "resample": 1.0, "n_src": 2, "segment": 0.1,
                        "augmentation": {"enable": False}},
        "training_cfg": {"epochs": 1, "batch_size": 2, "half_lr": True, "early_stop": True,
                         "ckpt_interval_minutes": 1e-6, "pretrained": None, "seed": 0, "kd_lambda": 0.1,
                         "optim": {"optimizer": "adam", "lr": 0.001, "weight_decay": 0.0}},
        "testing_cfg": {"test_dir": None, "segment_samples": 800, "overlap": 0.25},
    }


@pytest.fixture(scope="module")
def mini_librimix(tmp_path_factory):
    from fqss_tpu.data.librimix import make_mini_librimix

    root = str(tmp_path_factory.mktemp("minilibrimix"))
    return make_mini_librimix(root, n_train=4, n_val=2, sample_rate=8000, seconds=0.1)


@pytest.mark.parametrize("name,env", [("DPTNet", "asteroid"), ("Sepformer", "speechbrain")])
def test_train_cli_runs_an_epoch_of_each_model(mini_librimix, tmp_path, capsys, name, env):
    import yaml

    from fqss_tpu_torch.train.__main__ import main

    train_dir, val_dir = mini_librimix
    conf = _recipe_conf(tmp_path / "run", train_dir, val_dir, name)
    if env == "speechbrain":
        conf["training_cfg"].update(threshold_byloss=True, threshold=-1e9, use_speedperturb=False)
    # the DPTNet config as YAML, the Sepformer's as JSON (what the machine with the card reads: it has no yaml)
    cfg = tmp_path / ("tiny.yaml" if name == "DPTNet" else "tiny.json")
    cfg.write_text(yaml.safe_dump(conf) if name == "DPTNet" else json.dumps(conf))
    main(["-env", env, "-y", str(cfg), "--device", "cpu"])
    assert "Training done" in capsys.readouterr().out
    assert (tmp_path / "run" / "best_model.pt").exists() and (tmp_path / "run" / "checkpoints" / "epoch_0.pt").exists()
    state = torch.load(tmp_path / "run" / "best_model.pt", weights_only=True)
    model = MODELS[name][1](q=QuantSpec(**dict(SPEC, observer=False)), **MODELS[name][3])
    model.load_state_dict(state)  # the export loads into the model it was trained as
    assert all(torch.isfinite(v).all() for v in state.values() if v.is_floating_point())
