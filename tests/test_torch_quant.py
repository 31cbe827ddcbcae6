"""The port's quant core (fqss_tpu_torch/quant) against the JAX package's.

QuantSpec mirrors the JAX dataclass field for field. The grids are compared
with eager JAX, which divides as IEEE division does, so they must be bitwise
equal. The quantizer modules' observer state machines are compared with the
flax modules applied with ``mutable=["qparams", "qstats"]`` (the port's
``train()`` mode) and without (``eval()``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fqss_tpu_torch.quant import fake_quant as tfq
from fqss_tpu_torch.quant.quantizers import ActQuantizer, WeightQuantizer
from fqss_tpu_torch.quant.spec import QuantSpec

torch.set_num_threads(1)

MUTABLE = ["qparams", "qstats"]


def test_quant_spec_fields_and_defaults_equal_jax():
    from fqss_tpu.quant.spec import QuantSpec as JaxQuantSpec

    ours = [(f.name, f.default) for f in dataclasses.fields(QuantSpec)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(JaxQuantSpec)]
    assert ours == theirs
    cfg = {"qat": True, "n_splitter": 2, "n_combiner": 2, "out_quant": True, "unknown_key": 1}
    assert dataclasses.asdict(QuantSpec.from_config(cfg)) == dataclasses.asdict(JaxQuantSpec.from_config(cfg))
    assert QuantSpec.from_config(None) == QuantSpec()


def test_bfloat16_compute_is_not_ported():
    with pytest.raises(NotImplementedError, match="compute_dtype"):
        QuantSpec(compute_dtype="bfloat16")


@pytest.mark.parametrize("sym", [False, True])
def test_linear_fake_quant_bitwise_equals_eager_jax(sym):
    from fqss_tpu.quant.fake_quant import linear_fake_quant

    rng = np.random.default_rng(0)
    x = rng.uniform(-2.5, 2.5, (6, 7, 11)).astype(np.float32)
    if sym:  # per-channel ranges on axis 1
        mn = (-rng.uniform(0.1, 2.0, (1, 7, 1))).astype(np.float32)
        mx = rng.uniform(0.1, 2.0, (1, 7, 1)).astype(np.float32)
    else:
        mn, mx = np.full((1,), -0.83, np.float32), np.full((1,), 1.07, np.float32)
    x.reshape(-1)[:2] = [mn.reshape(-1)[0], mx.reshape(-1)[0]]
    want = np.asarray(linear_fake_quant(jnp.asarray(x), jnp.asarray(mn), jnp.asarray(mx), 8, True, sym))
    got = tfq.linear_fake_quant(torch.from_numpy(x), torch.from_numpy(mn), torch.from_numpy(mx), 8, sym)
    np.testing.assert_array_equal(got.numpy(), want)


def test_splitter_quantize_and_qrange_equal_jax():
    from fqss_tpu.quant.fake_quant import qrange, splitter_quantize

    x = np.random.default_rng(1).uniform(-1.2, 1.2, 4001).astype(np.float32)
    for sign in (True, False):
        assert tfq.qrange(8, sign) == qrange(8, sign)
        want = np.asarray(splitter_quantize(jnp.asarray(x), 1.0, 8, sign))
        np.testing.assert_array_equal(tfq.splitter_quantize(torch.from_numpy(x), 1.0, 8, sign).numpy(), want)


def _act_batches():
    rng = np.random.default_rng(2)
    return [(rng.standard_normal((3, 50)) * s + o).astype(np.float32) for s, o in
            ((1.0, 0.0), (2.0, 0.5), (0.5, -1.0), (3.0, 0.2))]


def test_act_observer_ema_trajectory_matches_jax():
    from fqss_tpu.quant.quantizers import ActQuantizer as JaxActQuantizer

    jq = JaxActQuantizer(n_bits=8, max_observations=3)
    xs = _act_batches()
    variables = jq.init({}, jnp.asarray(xs[0]))
    tq = ActQuantizer(n_bits=8, max_observations=3).train()
    for i, x in enumerate(xs):  # 3 observing calls, then the first quantizing call
        y_j, upd = jq.apply(variables, jnp.asarray(x), mutable=MUTABLE)
        variables = {**variables, **upd}
        with torch.no_grad():
            y_t = tq(torch.from_numpy(x))
        qp = variables["qparams"]
        np.testing.assert_allclose(tq.min_range.detach().numpy(), np.asarray(qp["min_range"]), rtol=1e-6)
        np.testing.assert_allclose(tq.max_range.detach().numpy(), np.asarray(qp["max_range"]), rtol=1e-6)
        assert int(tq.n_iter) == int(variables["qstats"]["n_iter"]) == min(i + 1, 3)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-6)
        if i < 3:
            np.testing.assert_array_equal(y_t.numpy(), x)
    assert not np.array_equal(y_t.numpy(), xs[-1])  # past the window it quantizes


def test_act_eval_inside_window_returns_input_and_writes_nothing():
    tq = ActQuantizer(n_bits=8, max_observations=3).eval()
    x = torch.from_numpy(_act_batches()[1])
    state = {k: v.clone() for k, v in tq.state_dict().items()}
    with torch.no_grad():
        y = tq(x)
    assert torch.equal(y, x)
    for k, v in tq.state_dict().items():
        assert torch.equal(v, state[k]), k
    # without an observer the default ranges quantize at once
    tq.observer = False
    with torch.no_grad():
        assert not torch.equal(tq(x), x)


def test_weight_one_shot_observer_matches_jax():
    from fqss_tpu.quant.quantizers import WeightQuantizer as JaxWeightQuantizer

    rng = np.random.default_rng(3)
    w = (rng.standard_normal((3, 4, 5)) * 0.3).astype(np.float32)  # JAX (k, Cin, Cout) layout
    jq = JaxWeightQuantizer(weight_shape=w.shape, ch_axis=2)
    variables = jq.init({}, jnp.asarray(w))
    tq = WeightQuantizer(w.shape, ch_axis=2).train()
    for call in range(2):
        y_j, upd = jq.apply(variables, jnp.asarray(w), mutable=MUTABLE)
        variables = {**variables, **upd}
        with torch.no_grad():
            y_t = tq(torch.from_numpy(w))
        np.testing.assert_array_equal(tq.min_range.detach().numpy(), np.asarray(variables["qparams"]["min_range"]))
        np.testing.assert_array_equal(tq.max_range.detach().numpy(), np.asarray(variables["qparams"]["max_range"]))
        assert bool(tq.observed)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-6)
        if call == 0:  # the observing call returns the float weights once
            np.testing.assert_array_equal(y_t.numpy(), w)
        else:
            assert not np.array_equal(y_t.numpy(), w)
    # eval before any observation: float weights, no state written
    fresh = WeightQuantizer(w.shape, ch_axis=2).eval()
    with torch.no_grad():
        assert torch.equal(fresh(torch.from_numpy(w)), torch.from_numpy(w))
    assert not bool(fresh.observed)
