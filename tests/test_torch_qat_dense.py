"""The fused QAT dense layer (K5 and K5-bwd) of the port against the JAX package, on the CPU.

* ``qat_dense_ref`` and ``qat_dense_bwd_ref`` against JAX's Pallas
  ``qat_dense`` and its ``jax.grad`` in interpret mode (as
  ``tests/test_pallas_qat.py`` runs them), act grid on and off, on a grid of
  several blocks in every axis, at odd sizes and with planted half-step ties.
  The weight is JAX's kernel transposed (``[N, K]``). Forward: the sums land
  in another order, so outputs agree to one LSB with at most 1% of them a
  step apart, the planted ties exactly. Backward, at JAX's own
  pre-activation (``qat_dense`` with the act grid off gives it; the plain
  backward takes it as ``pre``, so both take the same mask): every gradient
  within 1e-5 of the sum of its terms' magnitudes. Without that, through
  ``jax.grad`` against the port's autograd: within 1e-3 of the gradient's
  largest magnitude (``tests/test_pallas_qat.py``'s bound for the same
  comparison).
* The port's ``QDense`` against JAX's, the quantizers inside the act
  observer window, on the step that crosses it and after: outputs, updated
  ranges and gradients (x, kernel, bias, four ranges), the JAX step jitted
  with XLA's algebraic simplifier off (eager's divisions). Inside the window
  the outputs are float pre-activations: within 1e-5 relative. After it:
  within one LSB, at most 1% a step apart. Ranges within 1e-5 relative;
  gradients within 1e-4 of their norm.
* CPU tensors take the plain versions and launch nothing; the autograd
  Function's CPU backward equals autograd of the plain composition; a device
  without a kernel raises.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from fqss_tpu.nn import QDense as JaxQDense
from fqss_tpu.ops.pallas_qat import qat_dense as jax_qat_dense
from fqss_tpu.quant import QuantSpec as JaxQuantSpec
from fqss_tpu_torch.models.convert import dptnet_from_jax
from fqss_tpu_torch.nn.layers import QDense
from fqss_tpu_torch.ops import qat_dense as qd
from fqss_tpu_torch.quant.spec import QuantSpec

torch.set_num_threads(1)

ALGSIMP_OFF = {"xla_disable_hlo_passes": "algsimp"}
STEP = 2.0**-7


def _inputs(m, k, n, seed, arange=3.0):
    """x [m, k], JAX's kernel [k, n], b, ranges, cotangent; output channel 0 carries planted ties."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    w_mn = (-np.abs(rng.standard_normal((1, n))) * 0.4 - 0.01).astype(np.float32)
    w_mx = (np.abs(rng.standard_normal((1, n))) * 0.4 + 0.01).astype(np.float32)
    a_mn, a_mx = np.float32([-arange]), np.float32([-arange + 255 * STEP * arange])
    # channel 0: weight step STEP, w[0, 0] = 5 steps; rows 0-4 take x[r, 0] = r + 1 alone, so their outputs are
    # a_mn + (5 (r + 1) + 0.5) steps of the act grid when that step is STEP (arange = 1): half-step ties
    w_mn[0, 0], w_mx[0, 0] = -255 / 256, 255 / 256
    w[0, 0], b[0] = 5 * STEP, a_mn[0] + 0.5 * STEP
    rows = min(m, 5)
    x[:rows] = 0
    x[:rows, 0] = np.arange(1, rows + 1)
    g = rng.standard_normal((m, n)).astype(np.float32)
    return x, w, b, w_mn, w_mx, a_mn, a_mx, g


def _port_args(x, w, b, w_mn, w_mx, a_mn, a_mx, act_quant=True):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (x, w.T, b, w_mn.reshape(-1, 1), w_mx.reshape(-1, 1),
                                                             a_mn, a_mx)]
    if not act_quant:
        t[5] = t[6] = None
    return t


def _jax(x, w, b, w_mn, w_mx, a_mn, a_mx, act_quant, g):
    """JAX's forward, its pre-activation and jax.grad of <g, qat_dense> in interpret mode."""
    args = tuple(map(jnp.asarray, (x, w, b, w_mn, w_mx, a_mn, a_mx)))
    with pltpu.force_tpu_interpret_mode():
        y = np.asarray(jax_qat_dense(*args, 8, 8, act_quant))
        pre = np.array(jax_qat_dense(*args, 8, 8, False))
        grads = jax.grad(lambda *a: jnp.vdot(jnp.asarray(g), jax_qat_dense(*a, 8, 8, act_quant)),
                         argnums=tuple(range(7)))(*args)
    return y, pre, [np.asarray(gr) for gr in grads]


def _port_grads_as_jax(grads):
    """(dx, dw [N, K], db, dw_mn [N, 1], dw_mx, da_mn, da_mx) in JAX's layouts, None as zeros of JAX's shapes."""
    dx, dw, db, dw_mn, dw_mx, da_mn, da_mx = (None if t is None else t.detach().numpy() for t in grads)
    return [dx, dw.T, db, dw_mn.reshape(1, -1), dw_mx.reshape(1, -1), da_mn, da_mx]


CASES = [(37, 24, 33, True), (300, 264, 260, True), (300, 264, 260, False), (5, 3, 2, True), (1, 7, 129, True)]


@pytest.mark.parametrize("m,k,n,act_quant", CASES)
def test_plain_versions_equal_the_pallas_kernel(m, k, n, act_quant):
    x, w, b, w_mn, w_mx, a_mn, a_mx, g = _inputs(m, k, n, m + k + n, arange=1.0)
    want, pre, want_grads = _jax(x, w, b, w_mn, w_mx, a_mn, a_mx, act_quant, g)
    args = _port_args(x, w, b, w_mn, w_mx, a_mn, a_mx, act_quant)
    got = qd.qat_dense_ref(*args).numpy()
    assert got.shape == want.shape == (m, n)
    if act_quant:
        diff = np.abs(got - want) / STEP  # arange 1: the act grid's step is STEP
        assert diff.max() <= 1 + 1e-4 and (diff > 0.5).mean() <= 0.01, (diff.max(), (diff > 0.5).mean())
        tie_rows = min(m, 5)
        np.testing.assert_array_equal(got[:tie_rows, 0], want[:tie_rows, 0])
        # the ties rounded half to even: a_mn + (5 (r + 1) + 0.5) steps -> the even neighbour
        X = np.round(5 * np.arange(1, tie_rows + 1) + 0.5)
        np.testing.assert_array_equal(got[:tie_rows, 0], (a_mn[0] + X * STEP).astype(np.float32))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    # at JAX's own pre-activation the backward takes the same masks: every gradient to sum-order noise
    tg = torch.from_numpy(g)
    at_pre = _port_grads_as_jax(qd.qat_dense_bwd_ref(*args[:3], tg, *args[3:], pre=torch.from_numpy(pre)))
    absg, absx = np.abs(g), np.abs(x)
    wq = qd._weight_q(args[1], args[3], args[4], 8, None).numpy()
    bounds = [absg @ np.abs(wq), (absg.T @ absx).T, absg.sum(0)]
    for i, bound in enumerate(bounds):
        assert (np.abs(at_pre[i] - want_grads[i]) <= 1e-5 * bound + 1e-7).all(), i
    scale_w = np.abs(want_grads[1]).max()
    for i in (3, 4):  # the weight ranges: sums over K of dwq's terms
        assert np.abs(at_pre[i] - want_grads[i]).max() <= 1e-5 * scale_w * k + 1e-7, i
    if act_quant:
        for i in (5, 6):  # the act ranges: sums over M x N terms of magnitude at most |g|
            assert np.abs(at_pre[i] - want_grads[i]).max() <= 1e-5 * absg.sum(), i
    else:
        assert at_pre[5] is None and not want_grads[5].any() and not want_grads[6].any()

    # autograd through the port's entry point (the Function's CPU backward) against jax.grad
    leaves = [t.clone().requires_grad_(True) if t is not None else None for t in args]
    qd.reset_launches()
    (qd.qat_dense(*leaves) * tg).sum().backward()
    assert set(qd.LAUNCHES.values()) == {0}
    port = _port_grads_as_jax([t.grad if t is not None else None for t in leaves])
    for i, (a, want_g) in enumerate(zip(port, want_grads)):
        if a is None:
            continue
        assert np.abs(a - want_g).max() <= 1e-3 * (np.abs(want_g).max() + 1e-12), i


def test_function_backward_equals_autograd_of_the_plain_composition():
    x, w, b, w_mn, w_mx, a_mn, a_mx, g = _inputs(40, 16, 12, 3)
    args = _port_args(x, w, b, w_mn, w_mx, a_mn, a_mx)
    for flags in ((None, None), (torch.tensor(True), torch.tensor(False)), (torch.tensor(False), torch.tensor(True))):
        grads = []
        for fn in (qd.qat_dense, qd.qat_dense_ref):
            leaves = [t.clone().requires_grad_(True) for t in args]
            (fn(*leaves, 8, 8, *flags) * torch.from_numpy(g)).sum().backward()
            grads.append([t.grad for t in leaves])
        for a, b_ in zip(*grads):
            torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-6)
        if flags[0] is not None and bool(flags[0]):  # an observing weight grid: straight through, ranges 0
            assert not grads[0][3].any() and not grads[0][4].any()
        if flags[1] is not None and bool(flags[1]):
            assert not grads[0][5].any() and not grads[0][6].any()


# ---------------------------------------------------------------------------
# The QDense layer through the observer window
# ---------------------------------------------------------------------------


def _lsb(ranges):
    return float(ranges[1][0] - ranges[0][0]) / 255


@pytest.mark.parametrize("gradient_based", [True, False])
def test_qdense_through_the_observer_window_matches_jax(gradient_based):
    spec = dict(qat=True, max_observations=2, observer=True, gradient_based=gradient_based)
    rng = np.random.default_rng(7)
    xs = [rng.standard_normal((2, 30, 20)).astype(np.float32) * (1 + i) for i in range(4)]
    g = rng.standard_normal((2, 30, 12)).astype(np.float32)
    jm = JaxQDense(12, q=JaxQuantSpec(**spec))
    variables = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(xs[0])))

    def loss(trainable, qstats, x):
        y, upd = jm.apply({**trainable, "qstats": qstats}, x, mutable=["qparams", "qstats"])
        return jnp.vdot(jnp.asarray(g), y), (y, upd)

    step = jax.jit(jax.value_and_grad(loss, argnums=(0, 2), has_aux=True)).lower(
        {"params": variables["params"], "qparams": variables["qparams"]}, variables["qstats"],
        jnp.asarray(xs[0])).compile(compiler_options=ALGSIMP_OFF)

    port = QDense(20, 12, q=QuantSpec(**spec))
    port.load_state_dict(dptnet_from_jax(variables), strict=True)
    port.train()
    for i, x in enumerate(xs):
        trainable = {"params": variables["params"], "qparams": variables["qparams"]}
        (_, (want, upd)), (want_g, want_dx) = step(trainable, variables["qstats"], jnp.asarray(x))
        ranges_before = (port.activation_fake_quantize.min_range.detach().clone(),
                         port.activation_fake_quantize.max_range.detach().clone())
        tx = torch.from_numpy(x).requires_grad_(True)
        port.zero_grad()
        got = port(tx)
        (got * torch.from_numpy(g)).sum().backward()
        want = np.asarray(want)
        if i < spec["max_observations"]:  # inside the window: the float pre-activation
            np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
        else:
            diff = np.abs(got.detach().numpy() - want) / _lsb(ranges_before)
            assert diff.max() <= 1 + 1e-4 and (diff > 0.5).mean() <= 0.01, (i, diff.max(), (diff > 0.5).mean())
        variables = jax.device_get({**variables, **upd})
        want_sd = dptnet_from_jax(variables)
        for k, v in port.state_dict().items():
            if k.endswith("n_iter") or k.endswith("observed"):
                assert int(v) == int(want_sd[k]), (i, k)
            else:
                np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), rtol=1e-5, atol=1e-7, err_msg=f"{i} {k}")
        want_grads = dptnet_from_jax(jax.device_get(want_g))
        grads = {k: p.grad for k, p in port.named_parameters() if p.requires_grad}
        whole = np.sqrt(sum(float(np.sum(want_grads[k].numpy() ** 2)) for k in grads))
        for k, gr in grads.items():
            assert gr is not None, (i, k)
            err = np.linalg.norm(gr.numpy() - want_grads[k].numpy())
            assert err <= 1e-4 * max(np.linalg.norm(want_grads[k].numpy()), 1e-3 * whole), (i, k, err)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx), rtol=1e-4, atol=1e-5 * np.abs(want_dx).max())
        if not gradient_based:
            assert port.activation_fake_quantize.min_range.grad is None


def test_cpu_tensors_launch_no_kernel_and_other_devices_raise():
    x, w, b, w_mn, w_mx, a_mn, a_mx, _ = _inputs(9, 8, 6, 1)
    args = _port_args(x, w, b, w_mn, w_mx, a_mn, a_mx)
    qd.reset_launches()
    y = qd.qat_dense(*args)
    assert torch.equal(y, qd.qat_dense_ref(*args))
    layer = QDense(8, 6, q=QuantSpec(qat=True, observer=False))
    layer(torch.randn(2, 3, 8)).sum().backward()
    assert set(qd.LAUNCHES.values()) == {0}
    meta = [torch.empty(t.shape, device="meta") for t in args]
    with pytest.raises(ValueError, match="no kernel"):
        qd.qat_dense(*meta)
    with pytest.raises(ValueError):
        qd.qat_dense(args[0], args[1][:, :3].contiguous(), args[2])  # K differs
    with pytest.raises(ValueError):
        qd.qat_dense(*args[:3], args[3], None)  # half a grid
    with pytest.raises(TypeError):
        qd.qat_dense(*(t.double() for t in args[:3]))
