"""Gradients of the port's quantizers against the JAX package.

* The STE grids (``quant/fake_quant.py:linear_fake_quant`` and the wrappers
  on CPU tensors) against ``jax.grad`` of ``fqss_tpu.quant.fake_quant``:
  the straight-through rounding, 0.5 at a clip bound, ``scale_grad``.
* The plain versions of the backward kernels (K1-bwd, K2-bwd) against three
  references: the JAX VJP of the Pallas kernels (interpret mode, as
  ``tests/test_pallas_qat.py`` runs them), ``jax.grad`` of the XLA grid,
  and torch autograd of the port's STE composition.
* The quantizer modules inside and after their observer window, against
  the flax modules applied with mutable collections under ``jax.grad``.

Inputs come from numpy with a seed and carry planted clip-bound, half-step
tie and ``|mn| == |mx|`` values. Tolerance: atol 5e-5 for the range
gradients (sums over a few thousand terms, taken in another order), the
bound of the JAX package's own Pallas gradient tests; the input gradients
are g·m, exact, and held to 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fqss_tpu.quant.fake_quant import linear_fake_quant as jax_linear_fake_quant
from fqss_tpu_torch.ops import fake_quant as fq
from fqss_tpu_torch.quant import ste
from fqss_tpu_torch.quant.fake_quant import linear_fake_quant
from fqss_tpu_torch.quant.quantizers import ActQuantizer, WeightQuantizer

torch.set_num_threads(1)

STEP = 2.0**-7
MUTABLE = ["qparams", "qstats"]
ATOL = 5e-5


@pytest.fixture
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _torch_grads(fn, g, *arrays):
    ts = [torch.from_numpy(np.array(a)).requires_grad_() for a in arrays]
    (fn(*ts) * torch.from_numpy(g)).sum().backward()
    return [t.grad.numpy() for t in ts]


def _assert_grads(got, want, atol=ATOL):
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=1e-6)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol)


# ---------------------------------------------------------------------------
# The step-0 repair: the plain path's gradients are JAX's
# ---------------------------------------------------------------------------

LINSPACE = np.linspace(-1, 1, 11, dtype=np.float32)


@pytest.mark.parametrize("entry", ["act_fake_quant", "linear_fake_quant"])
def test_linspace_example_act_grid_gradients_equal_jax(entry):
    """x = linspace(-1, 1, 11), mn = -0.8, mx = 0.8: dx = [0, .5, 1, ..., 1, .5, 0], dmn 1.498, dmx 1.502."""
    mn, mx = np.array([-0.8], np.float32), np.array([0.8], np.float32)
    fn = {"act_fake_quant": lambda x, a, b: fq.act_fake_quant(x, a, b, 8),
          "linear_fake_quant": lambda x, a, b: linear_fake_quant(x, a, b, 8)}[entry]
    got = _torch_grads(fn, np.ones(11, np.float32), LINSPACE, mn, mx)
    want = jax.grad(lambda x, a, b: jax_linear_fake_quant(x, a, b, 8).sum(), argnums=(0, 1, 2))(
        jnp.asarray(LINSPACE), jnp.asarray(mn), jnp.asarray(mx))
    np.testing.assert_array_equal(got[0], [0, 0.5, 1, 1, 1, 1, 1, 1, 1, 0.5, 0])
    np.testing.assert_allclose(got[1], [1.498], atol=1e-3)
    np.testing.assert_allclose(got[2], [1.502], atol=1e-3)
    _assert_grads(got, want, atol=1e-6)


@pytest.mark.parametrize("entry", ["weight_fake_quant", "linear_fake_quant"])
def test_linspace_example_weight_grid_gradients_equal_jax(entry):
    w = LINSPACE.reshape(1, 11)
    mn, mx = np.array([[-0.8]], np.float32), np.array([[0.8]], np.float32)
    fn = {"weight_fake_quant": lambda x, a, b: fq.weight_fake_quant(x, a, b, 8, 0),
          "linear_fake_quant": lambda x, a, b: linear_fake_quant(x, a, b, 8, sym=True)}[entry]
    got = _torch_grads(fn, np.ones_like(w), w, mn, mx)
    want = jax.grad(lambda x, a, b: jax_linear_fake_quant(x, a, b, 8, True, True).sum(), argnums=(0, 1, 2))(
        jnp.asarray(w), jnp.asarray(mn), jnp.asarray(mx))
    # -0.8 / step is -127.5, a tie that rounds to -128 = qmin: the clip passes half of it
    np.testing.assert_array_equal(got[0], [[0, 0.5, 1, 1, 1, 1, 1, 1, 1, 0, 0]])
    _assert_grads(got, want, atol=1e-6)


def _act_inputs(shape, seed, mn, mx):
    """Uniform values over the range and beyond, half the elements on exact half-step ties."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(mn - 0.5, mx + 0.5, shape).astype(np.float32)
    flat = x.reshape(-1)
    k = np.arange(flat.size // 2) % 262 - 3  # ties below, across and above the grid
    flat[: k.size] = np.float32(mn) + (k + 0.5) * STEP
    flat[-4:] = [mn, mx, mn - 1.0, mx + 1.0]
    return x, rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("scale_grad", [False, True])
def test_act_grid_gradients_equal_jax_with_planted_bounds_and_ties(scale_grad):
    mn, mx = np.array([-1.0], np.float32), np.array([-1.0 + 255 * STEP], np.float32)
    x, g = _act_inputs((3, 50, 7), 0, -1.0, -1.0 + 255 * STEP)  # JAX NTC; the port takes NCT
    got = _torch_grads(lambda x, a, b: linear_fake_quant(x.transpose(1, 2), a, b, 8, scale_grad=scale_grad),
                       np.ascontiguousarray(g.transpose(0, 2, 1)), x, mn, mx)
    want = jax.grad(lambda x, a, b: jnp.vdot(g, jax_linear_fake_quant(x, a, b, 8, True, False, scale_grad)),
                    argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(mn), jnp.asarray(mx))
    _assert_grads(got, want)


@pytest.mark.parametrize("scale_grad", [False, True])
def test_weight_grid_gradients_equal_jax_with_planted_ties(scale_grad):
    w, mn, mx, g = _weight_inputs((6, 9, 5), 1, 0)
    got = _torch_grads(lambda w, a, b: linear_fake_quant(w, a, b, 8, sym=True, scale_grad=scale_grad), g, w, mn, mx)
    want = jax.grad(lambda w, a, b: jnp.vdot(g, jax_linear_fake_quant(w, a, b, 8, True, True, scale_grad)),
                    argnums=(0, 1, 2))(jnp.asarray(w), jnp.asarray(mn), jnp.asarray(mx))
    _assert_grads(got, want)


@pytest.mark.parametrize("scale_grad", [False, True])
def test_grid_forward_without_a_gradient_equals_the_ste_forward(scale_grad):
    """No gradient: plain round and clamp. With one: the STE composition. The values are the same bits."""
    x, _ = _act_inputs((3, 40, 7), 8, -1.0, -1.0 + 255 * STEP)
    w, mn_w, mx_w, _ = _weight_inputs((6, 9, 5), 9, 0)
    mn_x, mx_x = np.array([-1.0], np.float32), np.array([-1.0 + 255 * STEP], np.float32)
    for args, sym in (((x, mn_x, mx_x), False), ((w, mn_w, mx_w), True)):
        plain = linear_fake_quant(*map(torch.from_numpy, args), 8, sym=sym, scale_grad=scale_grad)
        ts = [torch.from_numpy(a).requires_grad_() for a in args]
        assert not plain.requires_grad
        torch.testing.assert_close(linear_fake_quant(*ts, 8, sym=sym, scale_grad=scale_grad).detach(), plain,
                                   rtol=0, atol=0)


def test_ste_primitives_forward_and_gradient():
    from fqss_tpu.quant import ste as jste

    x = np.random.default_rng(5).uniform(-3, 3, 257).astype(np.float32)
    x[:4] = [0.5, -1.5, 2.5, 0.0]
    for name, args in (("round_ste", ()), ("floor_ste", ()), ("grad_sign", (0.3,)), ("grad_scale", (0.25,)),
                       ("clip_ste", (-1.0, 2.0))):
        t = torch.from_numpy(x.copy()).requires_grad_()
        y = getattr(ste, name)(t, *args)
        y.sum().backward()
        want_y = getattr(jste, name)(jnp.asarray(x), *args)
        want_g = jax.grad(lambda v: getattr(jste, name)(v, *args).sum())(jnp.asarray(x))
        np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want_y), err_msg=name)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g), rtol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# K1-bwd / K2-bwd plain versions against three references
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale_grad", [False, True])
def test_act_bwd_ref_matches_pallas_vjp_xla_grad_and_torch_autograd(scale_grad, interpret_mode):
    from fqss_tpu.ops.pallas_qat import act_fake_quant_train

    mn, mx = np.array([-0.83], np.float32), np.array([1.07], np.float32)
    x, g = _act_inputs((7, 333), 2, -0.83, 1.07)
    s = fq.act_scale(torch.from_numpy(x), 8, scale_grad)  # [7, 333]: channels on axis 1 = axis -1
    got = [t.numpy() for t in fq.act_fake_quant_bwd_ref(*map(torch.from_numpy, (x, g, mn, mx)), 8, s)]
    args = tuple(map(jnp.asarray, (x, mn, mx)))
    _, vjp = jax.vjp(lambda x, a, b: act_fake_quant_train(x, a, b, 8, scale_grad), *args)
    _assert_grads(got, vjp(jnp.asarray(g)))
    _assert_grads(got, jax.grad(lambda x, a, b: jnp.vdot(g, jax_linear_fake_quant(x, a, b, 8, True, False, scale_grad)),
                                argnums=(0, 1, 2))(*args))
    _assert_grads(got, _torch_grads(lambda x, a, b: linear_fake_quant(x, a, b, 8, scale_grad=scale_grad), g, x, mn, mx))
    # the wrapper's autograd Function on a CPU tensor takes the same plain backward
    _assert_grads(got, _torch_grads(lambda x, a, b: fq.act_fake_quant(x, a, b, 8, scale_grad), g, x, mn, mx),
                  atol=0)


def _weight_inputs(shape, seed, ch_axis):
    rng = np.random.default_rng(seed)
    c = shape[ch_axis]
    kd = [1] * len(shape)
    kd[ch_axis] = c
    w = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    mn = (-np.abs(rng.standard_normal(kd)) * 0.4 - 0.01).astype(np.float32)
    mx = (np.abs(rng.standard_normal(kd)) * 0.4 + 0.01).astype(np.float32)
    mx.reshape(-1)[1::3] = -mn.reshape(-1)[1::3]  # |mn| == |mx|: the range gradient splits 0.5/0.5
    mn.reshape(-1)[0], mx.reshape(-1)[0] = -255 * STEP, 0.5  # step exactly 2 * STEP
    first = np.moveaxis(w, ch_axis, 0)[0]
    k = np.arange(first.size) % 262 - 131
    first[...] = ((k + 0.5) * 2 * STEP).reshape(first.shape)  # ties across and beyond the grid
    return w, mn, mx, rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("ch_axis,shape,scale_grad", [
    (0, (40, 65), False), (1, (65, 40), True), (1, (7, 40, 3), False), (0, (24, 5, 3), True),
])
def test_weight_bwd_ref_matches_pallas_vjp_xla_grad_and_torch_autograd(ch_axis, shape, scale_grad, interpret_mode):
    from fqss_tpu.ops.pallas_qat import weight_fake_quant_train

    w, mn, mx, g = _weight_inputs(shape, 3, ch_axis)
    s = fq.weight_scale(shape[ch_axis], 8, scale_grad)
    got = [t.numpy() for t in fq.weight_fake_quant_bwd_ref(*map(torch.from_numpy, (w, g, mn, mx)), 8, s, ch_axis)]
    args = tuple(map(jnp.asarray, (w, mn, mx)))
    _, vjp = jax.vjp(lambda w, a, b: weight_fake_quant_train(w, a, b, 8, scale_grad, ch_axis), *args)
    _assert_grads(got, vjp(jnp.asarray(g)))
    _assert_grads(got, jax.grad(lambda w, a, b: jnp.vdot(g, jax_linear_fake_quant(w, a, b, 8, True, True, scale_grad)),
                                argnums=(0, 1, 2))(*args))
    _assert_grads(got, _torch_grads(lambda w, a, b: linear_fake_quant(w, a, b, 8, sym=True, scale_grad=scale_grad),
                                    g, w, mn, mx))
    _assert_grads(got, _torch_grads(lambda w, a, b: fq.weight_fake_quant(w, a, b, 8, ch_axis, scale_grad), g, w, mn, mx),
                  atol=0)
    ties = np.abs(mn.reshape(-1)) == np.abs(mx.reshape(-1))
    assert ties.any() and np.all(got[1].reshape(-1)[ties] == -got[2].reshape(-1)[ties])


def test_cpu_gradients_launch_no_kernel():
    fq.reset_launches()
    x = torch.linspace(-2, 2, 301).reshape(1, 301).requires_grad_()
    r = torch.tensor([-1.0], requires_grad=True), torch.tensor([1.0], requires_grad=True)
    fq.act_fake_quant(x, *r).sum().backward()
    w = torch.randn(7, 43, requires_grad=True)
    fq.weight_fake_quant(w, torch.full((7, 1), -1.0), torch.full((7, 1), 1.0), 8, 0).sum().backward()
    assert x.grad is not None and r[0].grad is not None and w.grad is not None
    assert fq.LAUNCHES == {"act": 0, "weight": 0, "act_bwd": 0, "weight_bwd": 0}


# ---------------------------------------------------------------------------
# Quantizer modules, inside and after the observer window
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale_grad", [False, True])
def test_act_quantizer_gradients_match_flax_through_the_window(scale_grad):
    from fqss_tpu.quant.quantizers import ActQuantizer as JaxActQuantizer

    rng = np.random.default_rng(6)
    xs = [(rng.standard_normal((3, 40, 5)) * s + o).astype(np.float32)  # JAX NTC
          for s, o in ((1.0, 0.0), (2.0, 0.5), (0.5, -1.0), (3.0, 0.2), (1.5, 0.1))]
    jq = JaxActQuantizer(n_bits=8, max_observations=3, scale_grad=scale_grad)
    variables = jq.init({}, jnp.asarray(xs[0]))
    tq = ActQuantizer(n_bits=8, max_observations=3, scale_grad=scale_grad).train()
    for i, x in enumerate(xs):  # 3 observing calls, then two quantizing calls
        g = rng.standard_normal(x.shape).astype(np.float32)

        def loss(qparams, x):
            y, upd = jq.apply({**variables, "qparams": qparams}, x, mutable=MUTABLE)
            return jnp.vdot(g, y), upd

        (dq, dx), upd = jax.grad(loss, argnums=(0, 1), has_aux=True)(variables["qparams"], jnp.asarray(x))
        xt = torch.from_numpy(x.transpose(0, 2, 1).copy()).requires_grad_()
        tq.min_range.grad = tq.max_range.grad = None
        (tq(xt) * torch.from_numpy(g.transpose(0, 2, 1).copy())).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 1), np.asarray(dx), atol=1e-6)
        np.testing.assert_allclose(tq.min_range.grad.numpy(), np.asarray(dq["min_range"]), atol=ATOL)
        np.testing.assert_allclose(tq.max_range.grad.numpy(), np.asarray(dq["max_range"]), atol=ATOL)
        if i < 3:  # inside the window the ranges get no gradient
            assert not tq.min_range.grad.any() and not tq.max_range.grad.any()
        variables = {**variables, **upd}
        np.testing.assert_allclose(tq.min_range.detach().numpy(), np.asarray(variables["qparams"]["min_range"]),
                                   rtol=1e-6)
    assert tq.max_range.grad.abs().item() > 0


def test_weight_quantizer_gradients_match_flax_through_the_window():
    from fqss_tpu.quant.quantizers import WeightQuantizer as JaxWeightQuantizer

    rng = np.random.default_rng(7)
    w = (rng.standard_normal((3, 4, 5)) * 0.3).astype(np.float32)  # the JAX (k, Cin, Cout) layout
    jq = JaxWeightQuantizer(weight_shape=w.shape, ch_axis=2)
    variables = jq.init({}, jnp.asarray(w))
    tq = WeightQuantizer(w.shape, ch_axis=2).train()
    for call in range(3):  # the observing call, then two quantizing calls
        g = rng.standard_normal(w.shape).astype(np.float32)

        def loss(qparams, w):
            y, upd = jq.apply({**variables, "qparams": qparams}, w, mutable=MUTABLE)
            return jnp.vdot(g, y), upd

        (dq, dw), upd = jax.grad(loss, argnums=(0, 1), has_aux=True)(variables["qparams"], jnp.asarray(w))
        wt = torch.from_numpy(w).requires_grad_()
        tq.min_range.grad = tq.max_range.grad = None
        (tq(wt) * torch.from_numpy(g)).sum().backward()
        np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw), atol=1e-6)
        np.testing.assert_allclose(tq.min_range.grad.numpy(), np.asarray(dq["min_range"]), atol=ATOL)
        np.testing.assert_allclose(tq.max_range.grad.numpy(), np.asarray(dq["max_range"]), atol=ATOL)
        assert bool(tq.min_range.grad.any()) == (call > 0)
        variables = {**variables, **upd}
