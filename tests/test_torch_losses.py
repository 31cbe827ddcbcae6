"""The port's losses, KD factory, schedulers and checkpoints against the JAX package.

Losses: values and ``est`` gradients of every ported loss against JAX on the
same numpy inputs, with 2 and 3 sources (so PIT has 2 and 6 permutations to
choose from), rtol 1e-4 (float32 sums over T samples in another order).
Schedulers: the same val-loss sequence through the JAX and the port classes
gives the same LR scales. The splitter widening of the encoder
(``lsb_init="zeros"``) equals the JAX function exactly; ``"gauss"`` draws
from a ``torch.Generator`` and is checked by its statistics.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fqss_tpu.separation import losses as jl
from fqss_tpu_torch.separation import losses as tl

torch.set_num_threads(1)


def _sources(n_src, seed, b=3, t=400):
    rng = np.random.default_rng(seed)
    targets = rng.standard_normal((b, n_src, t)).astype(np.float32)
    # estimates: a permuted, noisy copy of the targets, so PIT must find the permutation
    est = targets[:, ::-1] * 0.8 + 0.3 * rng.standard_normal((b, n_src, t)).astype(np.float32)
    fest = targets * 0.9 + 0.2 * rng.standard_normal((b, n_src, t)).astype(np.float32)
    return est.astype(np.float32), fest.astype(np.float32), targets


LOSSES = {
    "pairwise_sisdr_ratio": (lambda m, e, f, t: m.pairwise_sisdr_ratio(e, t)),
    "pit_neg_sisdr_db": (lambda m, e, f, t: m.pit_neg_sisdr_db(e, t)),
    "pit_neg_sisdr_db_per_sample": (lambda m, e, f, t: m.pit_neg_sisdr_db(e, t, per_sample=True)),
    "pit_wsisdr_ratio": (lambda m, e, f, t: m.pit_wsisdr_ratio(e, t)),
    "pit_wsisdr_ratio_weighted": (lambda m, e, f, t: m.pit_wsisdr_ratio(e, f, weights=m.kd_sensitivity_weights(e, f, t),
                                                                       per_sample=True)),
    "kd_sensitivity_weights": (lambda m, e, f, t: m.kd_sensitivity_weights(e, f, t)),
    "fqss_kd_loss": (lambda m, e, f, t: m.fqss_kd_loss(e, f, t, kd_lambda=0.1)[0]),
    "fqss_kd_loss_kd_db": (lambda m, e, f, t: m.fqss_kd_loss(e, f, t, kd_lambda=0.1)[1]),
    "fqss_kd_loss_per_sample": (lambda m, e, f, t: m.fqss_kd_loss(e, f, t, kd_lambda=0.1, per_sample=True)[0]),
    "fqss_kd_loss_no_kd": (lambda m, e, f, t: m.fqss_kd_loss(e, f, t, kd_lambda=0.0)[0]),
}


@pytest.mark.parametrize("n_src", [2, 3])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_values_and_est_gradients_equal_jax(name, n_src):
    fn = LOSSES[name]
    est, fest, targets = _sources(n_src, seed=n_src)
    want = fn(jl, jnp.asarray(est), jnp.asarray(fest), jnp.asarray(targets))
    want_g = jax.grad(lambda e: jnp.sum(fn(jl, e, jnp.asarray(fest), jnp.asarray(targets))))(jnp.asarray(est))
    e = torch.from_numpy(est).requires_grad_()
    got = fn(tl, e, torch.from_numpy(fest), torch.from_numpy(targets))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)
    if got.requires_grad:
        got.sum().backward()
        np.testing.assert_allclose(e.grad.numpy(), np.asarray(want_g), rtol=1e-3, atol=1e-6)
    else:  # the sensitivity weights carry no gradient, in JAX too
        assert not np.asarray(want_g).any()


def test_pit_finds_the_permutation():
    _, _, targets = _sources(3, seed=9)
    perm = torch.from_numpy(targets[:, [2, 0, 1]].copy())
    assert tl.pit_neg_sisdr_db(perm, torch.from_numpy(targets)).item() < -70


# ---------------------------------------------------------------------------
# Student/teacher factory and the splitter widening
# ---------------------------------------------------------------------------

TINY_CFG = {"name": "ConvTasNet", "n_src": 2, "kernel_size": 16, "stride": 8, "n_filters": 32, "bn_chan": 8,
            "hid_chan": 16, "n_blocks": 2, "n_repeats": 1,
            "quantization": {"qat": True, "out_quant": True, "n_splitter": 2, "n_combiner": 2, "observer": True}}


def test_expand_encoder_kernel_zeros_equals_jax_and_gauss_statistics():
    from fqss_tpu.nn.io_layers import expand_encoder_kernel as jax_expand
    from fqss_tpu_torch.nn.io_layers import expand_encoder_kernel

    k = (np.random.default_rng(1).standard_normal((16, 2, 64)) * 0.2 + 0.05).astype(np.float32)  # JAX (k, Cin, Cout)
    kt = torch.from_numpy(k.transpose(2, 1, 0).copy())  # port [Cout, Cin, k]
    want = np.asarray(jax_expand(jnp.asarray(k), 3, jax.random.PRNGKey(0), lsb_init="zeros"))
    np.testing.assert_array_equal(expand_encoder_kernel(kt, 3, lsb_init="zeros").numpy(), want.transpose(2, 1, 0))
    got = expand_encoder_kernel(kt, 3, torch.Generator().manual_seed(0), lsb_init="gauss")
    assert got.shape == (64, 6, 16)
    torch.testing.assert_close(got[:, :2], kt, rtol=0, atol=0)
    for n, group in ((1, got[:, 2:4]), (2, got[:, 4:6])):  # group n: mean of channel c, std**n
        for c in range(2):
            w = kt[:, c]
            assert abs(group[:, c].mean() - w.mean()) < 4 * w.std(correction=0) ** n / 32
            assert abs(group[:, c].std() / w.std(correction=0) ** n - 1) < 0.15
    assert expand_encoder_kernel(kt, 1) is kt


def test_create_model_and_teacher_and_merge_float_params(tmp_path):
    from fqss_tpu_torch.models.factory import create_model_and_teacher, merge_float_params
    from fqss_tpu_torch.quant.quantizers import ActQuantizer

    model, teacher = create_model_and_teacher(TINY_CFG, generator=torch.Generator().manual_seed(0))
    assert teacher.q.qat is False and teacher.q.n_splitter == 1 and not teacher.training
    assert not any(isinstance(m, ActQuantizer) for m in teacher.modules())
    assert not any(p.requires_grad for p in teacher.parameters())
    assert model.q.qat and model.encoder.conv.weight.shape == (32, 2, 16)
    assert teacher.encoder.conv.weight.shape == (32, 1, 16)

    path = tmp_path / "float.pt"
    torch.save(teacher.state_dict(), path)
    student, teacher2 = create_model_and_teacher(TINY_CFG, str(path), generator=torch.Generator().manual_seed(5))
    for k, v in teacher.state_dict().items():
        torch.testing.assert_close(teacher2.state_dict()[k], v, rtol=0, atol=0)
        if k != "encoder.conv.weight":
            torch.testing.assert_close(student.state_dict()[k], v, rtol=0, atol=0)
    torch.testing.assert_close(student.encoder.conv.weight[:, :1], teacher.encoder.conv.weight, rtol=0, atol=0)
    # QAT-only entries keep their initial values
    assert torch.equal(student.mul.activation_fake_quantize.min_range, torch.full((1,), -0.5))
    merged = merge_float_params(student.state_dict(), teacher.state_dict(), 2, lsb_init="zeros")
    assert not merged["encoder.conv.weight"][:, 1:].any()
    with pytest.raises(ValueError, match="mismatch"):
        merge_float_params(student.state_dict(), {"decoder.weight": torch.zeros(3, 3, 3)})


# ---------------------------------------------------------------------------
# Schedulers and checkpoints
# ---------------------------------------------------------------------------

VAL_LOSSES = [5.0, 4.0, 4.5, 4.6, 4.7, 4.8, 3.9, 4.1, 4.2, 4.3, 4.4, 4.5, 4.6, 4.7, 4.8, 4.9, 5.0]


@pytest.mark.parametrize("kind,kwargs", [
    ("ReduceLROnPlateau", {"factor": 0.5, "patience": 2}),
    ("ReduceLROnPlateau", {"factor": 0.5, "patience": 1, "dont_halve_until_epoch": 6, "min_scale": 0.2}),
    ("StepLR", {"step_size": 2, "gamma": 0.98}),
])
def test_lr_schedulers_equal_jax(kind, kwargs):
    import optax

    from fqss_tpu.train import trainer as jtr
    from fqss_tpu.train.state import create_train_state
    from fqss_tpu_torch.train import trainer as ttr
    from fqss_tpu_torch.train.state import TrainState

    js = create_train_state({"params": {}}, optax.sgd(1.0))
    ts = TrainState(torch.nn.Linear(1, 1), torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=1.0))
    jsched, tsched = getattr(jtr, kind)(**kwargs), getattr(ttr, kind)(**kwargs)
    scales = []
    for v in VAL_LOSSES:
        js = jsched.update(js, v)
        ts = tsched.update(ts, v)
        assert np.float32(ts.lr_scale) == np.float32(js.lr_scale)
        scales.append(ts.lr_scale)
    assert len(set(scales)) > 1


def test_early_stopping_equals_jax():
    from fqss_tpu.train.trainer import EarlyStopping as JaxEarlyStopping
    from fqss_tpu_torch.train.trainer import EarlyStopping

    j, t = JaxEarlyStopping(patience=3), EarlyStopping(patience=3)
    decisions = [(t.update(v), j.update(v)) for v in VAL_LOSSES]
    assert all(a == b for a, b in decisions) and decisions[-1][0]


def test_checkpoint_manager_keeps_best_and_latest_and_restores(tmp_path):
    from fqss_tpu_torch.train.checkpoints import CheckpointManager, dump_config, save_log
    from fqss_tpu_torch.train.state import TrainState

    def state(seed):
        torch.manual_seed(seed)
        model = torch.nn.Linear(3, 2)
        return TrainState(model, torch.optim.Adam(model.parameters(), lr=1e-3), step=seed, lr_scale=0.5 ** seed)

    ckpt = CheckpointManager(str(tmp_path), keep=2)
    for epoch, val in enumerate([3.0, 1.0, 2.0, float("nan"), 4.0]):
        ckpt.save(epoch, state(epoch), {"val_loss": val, "loss": val + 1})
    assert ckpt.epochs() == [1, 2, 4]  # the 2 best by val_loss, and the latest
    history = json.loads((tmp_path / "history.json").read_text())
    assert [h["epoch"] for h in history] == [0, 1, 2, 3, 4] and history[1]["val_loss"] == 1.0

    target = state(9)
    assert CheckpointManager(str(tmp_path)).restore_best(target) == 1
    assert target.step == 1 and target.lr_scale == 0.5
    torch.testing.assert_close(target.model.weight, state(1).model.weight, rtol=0, atol=0)
    assert ckpt.restore_latest(target) == 4 and target.step == 4
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest(target) is None

    dump_config(str(tmp_path), {"a": {"b": 1}})
    save_log(str(tmp_path), "hello")
    assert "b: 1" in (tmp_path / "conf.yml").read_text()
    assert (tmp_path / "results.txt").read_text() == "hello\n"
    assert not [f for f in os.listdir(tmp_path / "checkpoints") if f.endswith(".tmp")]
