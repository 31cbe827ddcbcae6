"""The port's KD train step against the JAX trainer, on the tiny FQSS-8bit ConvTasNet of the other port tests.

The model (n_filters 32, bn_chan 8, hid_chan 16, 2 blocks x 1 repeat,
n_splitter = n_combiner = 2, out_quant, max_observations = 3) and its float
teacher are initialised in JAX and converted with ``convtasnet_from_jax``;
the JAX gradient trees go through the same converter. Bounds:

* One step against JAX's ``value_and_grad`` compiled with XLA's algebraic
  simplifier turned off. That pass is what rewrites the quantizers' ``/ 255``
  as ``* (1/255)`` under ``jit``; without it the compiled loss equals the
  eager (``jax.disable_jit()``) loss bit for bit, as the port's forward
  does, so the quantizers' masks agree, and it compiles in a few seconds
  where eager dispatch compiles each op on its own for ~45 s. The loss to
  rtol 1e-5; each gradient tensor
  to a relative L2 error of 1e-3, measured against the larger of its own
  norm and 1e-4 of the whole gradient's norm. The floor is for the range
  gradients of a few quantizers that are sums of thousands of terms which
  nearly cancel (|grad| ~ 1e-5 of the whole gradient): there the two sums'
  orders leave relative errors up to 2.3e-3 at absolute errors below 1e-7.
  Model weights agree to 1e-5. The updates (the clipped gradients through
  optax's Adam, jitted) to a relative L2 error of 1e-3 per tensor.
* Five steps against the jitted ``make_train_step(donate=False)``, which
  sits 27-30 dB from the eager model (XLA's reciprocal rewrite decides the
  weight observer's half-step ties, ROADMAP.md queue 3): losses within
  0.05 dB of each other (0.0056 dB seen at step 5); the activation ranges
  within 1e-3 relative inside the observer window, and within 2·lr per
  optimizer step after it (Adam moves a parameter by about lr a step, and a
  range gradient near zero may take the other sign).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from fqss_tpu.data import synth_batch
from fqss_tpu.models import ConvTasNet as JaxConvTasNet
from fqss_tpu.quant import QuantSpec as JaxQuantSpec
from fqss_tpu.quant.calibration import run_observer
from fqss_tpu_torch.models.convert import convtasnet_from_jax
from fqss_tpu_torch.models.convtasnet import ConvTasNet
from fqss_tpu_torch.quant.spec import QuantSpec
from fqss_tpu_torch.train.state import TrainState
from fqss_tpu_torch.train.trainer import TrainConfig, clip_by_global_norm_, make_optimizer, make_train_step

torch.set_num_threads(1)

ARCH = dict(n_srcs=2, kernel_size=16, stride=8, n_filters=32, bn_chan=8, hid_chan=16, n_blocks=2, n_repeats=1)
SPEC = dict(qat=True, n_splitter=2, n_combiner=2, out_quant=True, max_observations=3)
T = 1600
N_STEPS = 5
LR = 1e-3


@pytest.fixture(scope="module")
def jax_init():
    """(student, teacher, student variables, teacher variables, five (mix, src) batches)."""
    rng = np.random.default_rng(0)
    batches = [synth_batch(rng, 2, 2, T) for _ in range(N_STEPS)]
    jm = JaxConvTasNet(q=JaxQuantSpec(observer=True, **SPEC), **ARCH)
    jt = JaxConvTasNet(**ARCH)
    v = jax.device_get(dict(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(batches[0][0]))))
    tv = jax.device_get(jax.jit(jt.init)(jax.random.PRNGKey(1), jnp.asarray(batches[0][0])))
    return jm, jt, v, tv, batches


def port_state(v, tv, cfg=TrainConfig()) -> TrainState:
    model = ConvTasNet(q=QuantSpec(observer=True, **SPEC), **ARCH)
    model.load_state_dict(convtasnet_from_jax(v), strict=True)
    teacher = ConvTasNet(**ARCH)
    teacher.load_state_dict(convtasnet_from_jax(tv), strict=True)
    teacher.requires_grad_(False)
    return TrainState(model, make_optimizer(cfg, [p for p in model.parameters() if p.requires_grad]), teacher.eval())


def _torch(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _rel(got, want, floor=0.0):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), floor, 1e-30)


def test_one_step_matches_eager_jax(jax_init):
    from fqss_tpu.separation.losses import fqss_kd_loss
    from fqss_tpu.train import make_optimizer as jax_make_optimizer
    from fqss_tpu.train import TrainConfig as JaxTrainConfig

    jm, jt, v0, tv, batches = jax_init
    mix, src = batches[0]
    v = run_observer(jm, v0, jnp.asarray(mix), steps=4)  # the observer window is closed
    trainable = {"params": v["params"], "qparams": v["qparams"]}

    # The float teacher has no quantizer ties for jit to decide: its jitted output is the eager one to
    # float32 rounding, and it costs a fraction of the eager dispatch.
    fest = jax.jit(jt.apply)(tv, jnp.asarray(mix))[..., :T]

    def loss_fn(trainable):
        est, _ = jm.apply({**trainable, "qstats": v["qstats"]}, jnp.asarray(mix), mutable=["qparams", "qstats"])
        return fqss_kd_loss(est[..., :T], fest, jnp.asarray(src), kd_lambda=0.1)[0]

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn)).lower(trainable).compile(
        compiler_options={"xla_disable_hlo_passes": "algsimp"})
    want_loss, grads = value_and_grad(trainable)
    # The JAX step's update (trainer.py:163-172) from these gradients: the clip and Adam of make_optimizer.
    tx = jax_make_optimizer(JaxTrainConfig())
    updates, _ = jax.jit(tx.update)(grads, tx.init(trainable), trainable)
    want_new = jax.device_get(jax.jit(optax.apply_updates)(trainable, updates))
    want_clipped = jax.device_get(jax.jit(lambda g: optax.clip_by_global_norm(5.0).update(g, None)[0])(grads))
    want_norm = float(jax.jit(optax.global_norm)(grads))

    state = port_state(v, tv)
    before = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    metrics = make_train_step(TrainConfig())(state, *_torch(mix, src))
    assert not metrics["skipped"] and state.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), want_norm, rtol=1e-5)
    assert want_norm > 5.0  # the clip fires

    want_g = convtasnet_from_jax(want_clipped)
    want_p = convtasnet_from_jax(want_new)
    whole = np.sqrt(sum(np.sum(g.numpy() ** 2) for g in want_g.values()))
    params = dict(state.model.named_parameters())
    assert set(params) == set(want_g)
    for k, p in params.items():
        want = want_g[k].numpy()
        if p.grad is None:  # the last block's residual branch feeds nothing: JAX's gradient is 0 there
            assert not want.any(), k
            continue
        assert _rel(p.grad.numpy(), want, 1e-4 * whole) <= 1e-3, k
        update, want_update = (p.detach() - before[k]).numpy(), want_p[k].numpy() - before[k].numpy()
        assert _rel(update, want_update) <= 1e-3, k


@pytest.fixture(scope="module")
def trajectories(jax_init):
    """Five steps from the fresh (observer-open) state through the jitted JAX step and the port's."""
    from fqss_tpu.train import TrainConfig as JaxTrainConfig
    from fqss_tpu.train import create_train_state
    from fqss_tpu.train import make_optimizer as jax_make_optimizer
    from fqss_tpu.train import make_train_step as jax_make_train_step

    jm, jt, v, tv, batches = jax_init
    cfg = JaxTrainConfig(lr=LR)
    tx = jax_make_optimizer(cfg)
    jstate = create_train_state(v, tx, teacher_params=tv["params"])
    jstep = jax_make_train_step(jm, jt, tx, cfg, donate=False)
    state = port_state(v, tv, TrainConfig(lr=LR))
    step = make_train_step(TrainConfig(lr=LR))
    out = {"jax": [], "port": []}
    for mix, src in batches:
        jstate, jm_ = jstep(jstate, jnp.asarray(mix), jnp.asarray(src))
        out["jax"].append((float(jm_["loss"]), convtasnet_from_jax(jax.device_get(
            {"qparams": jstate.qparams, "qstats": jstate.qstats}))))
        m = step(state, *_torch(mix, src))
        out["port"].append((float(m["loss"]), {k: v.clone() for k, v in state.model.state_dict().items()}))
    assert int(jstate.skipped) == state.skipped == 0
    return out


def test_five_step_loss_trajectory_tracks_jitted_jax(trajectories):
    jl = np.array([loss for loss, _ in trajectories["jax"]])
    pl = np.array([loss for loss, _ in trajectories["port"]])
    assert np.isfinite(pl).all()
    assert np.abs(pl - jl).max() <= 0.05, (pl, jl)


def test_observer_window_crossing_matches_jax(trajectories):
    for i, ((_, jq), (_, sd)) in enumerate(zip(trajectories["jax"], trajectories["port"])):
        after_window = max(0, i + 1 - SPEC["max_observations"])
        for k, want in jq.items():
            got = sd[k]
            if k.endswith("n_iter"):
                assert int(got) == int(want) == min(i + 1, SPEC["max_observations"]), k
            elif k.endswith("observed"):
                assert bool(got) and bool(want), k
            elif "activation_fake_quantize" in k and after_window == 0:
                np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3, atol=1e-6, err_msg=k)
            elif "activation_fake_quantize" in k:
                np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2 * LR * after_window + 1e-3, err_msg=k)
    # after the window the optimizer moves the activation ranges, which the observer no longer writes
    window_end = trajectories["port"][SPEC["max_observations"] - 1][1]
    last = trajectories["port"][-1][1]
    moved = [k for k in last if "activation_fake_quantize" in k and k.endswith("_range")
             and not torch.equal(last[k], window_end[k])]
    assert len(moved) == 2 * (24 - 2)  # all but the last block's residual add and conv, which feed nothing


def test_nonfinite_mixture_skips_the_update(jax_init):
    jm, _, v0, tv, batches = jax_init
    mix, src = batches[0]
    state = port_state(run_observer(jm, v0, jnp.asarray(mix), steps=4), tv)
    step = make_train_step(TrainConfig())
    step(state, *_torch(mix, src))  # one good step, so the optimizer has state to keep
    params = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    opt = [{k: v.clone() for k, v in s.items()} for s in state.optimizer.state.values()]
    bad = mix.copy()
    bad[0, 0] = np.nan
    metrics = step(state, *_torch(bad, src))
    assert metrics["skipped"] and not torch.isfinite(metrics["loss"])
    assert state.skipped == 1 and state.step == 2
    for k, p in state.model.named_parameters():
        assert torch.equal(p.detach(), params[k]), k
    for before, now in zip(opt, state.optimizer.state.values()):
        for k in before:
            assert torch.equal(before[k], now[k]), k
    metrics = make_train_step(TrainConfig(loss_upper_lim=-1e9))(state, *_torch(mix, src))  # over the limit
    assert metrics["skipped"] and state.skipped == 2


def test_threshold_byloss_keeps_the_hard_samples(jax_init):
    from fqss_tpu_torch.separation.losses import fqss_kd_loss

    jm, _, v0, tv, batches = jax_init
    mix, src = batches[1]
    state = port_state(run_observer(jm, v0, jnp.asarray(mix), steps=4), tv)
    with torch.no_grad():
        est = state.model.eval()(torch.from_numpy(mix))[..., :T]
        fest = state.teacher(torch.from_numpy(mix))[..., :T]
        per, _ = fqss_kd_loss(est, fest, torch.from_numpy(src), kd_lambda=0.1, per_sample=True)
    sd = {k: v.clone() for k, v in state.model.state_dict().items()}
    for threshold, want in ((float(per.min() + per.max()) / 2, per.max()), (float(per.max()) + 1, per.mean())):
        state.model.load_state_dict(sd)
        cfg = TrainConfig(threshold_byloss=True, threshold=threshold)
        metrics = make_train_step(cfg)(state, *_torch(mix, src))
        np.testing.assert_allclose(float(metrics["loss"]), float(want), rtol=1e-6)


@pytest.mark.parametrize("norm", [2.0, 5.0, 40.0])
def test_clip_by_global_norm_equals_optax(norm):
    rng = np.random.default_rng(int(norm))
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (7,), (2, 2, 2))]
    total = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2) for g in grads))
    grads = [g * np.float32(norm / total) for g in grads]
    want, _ = optax.clip_by_global_norm(5.0).update([jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    got_norm = clip_by_global_norm_(got, 5.0)
    np.testing.assert_allclose(float(got_norm), float(optax.global_norm(grads)), rtol=1e-6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
