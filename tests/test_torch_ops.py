"""Plain versions of the port's fake-quant kernels (fqss_tpu_torch/ops/fake_quant.py)
against the JAX Pallas kernels they replace, run in interpret mode on the CPU.

Inputs come from numpy with a seed and carry planted range-end, out-of-range
and exact half-step tie values. Tolerance atol=1e-6, as the JAX package's own
Pallas tests (tests/test_pallas_qat.py). On CPU tensors the wrappers take the
plain versions and launch nothing.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fqss_tpu_torch.ops import fake_quant as fq

torch.set_num_threads(1)

STEP = 2.0**-7  # ranges of width 255 * STEP give an exact step: planted ties are exact


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _act_inputs(shape, seed, mn, mx):
    rng = np.random.default_rng(seed)
    x = rng.uniform(mn - 0.5, mx + 0.5, shape).astype(np.float32)
    flat = x.reshape(-1)
    k = np.arange(flat.size // 2) % 262 - 3  # ties below, across and above the grid
    flat[: k.size] = np.float32(mn) + (k + 0.5) * STEP
    flat[-4:] = [mn, mx, mn - 1.0, mx + 1.0]
    return x


def _ranges(mn, mx):
    return np.full((1,), mn, np.float32), np.full((1,), mx, np.float32)


@pytest.mark.parametrize("shape,mn,mx", [
    ((7, 333), -0.83, 1.07),
    ((3, 5, 129), -1.0, -1.0 + 255 * STEP),
])
def test_act_ref_matches_pallas_act_fake_quant_train(shape, mn, mx):
    from fqss_tpu.ops.pallas_qat import act_fake_quant_train

    x = _act_inputs(shape, 0, mn, mx)
    mn_a, mx_a = _ranges(mn, mx)
    want = np.asarray(act_fake_quant_train(jnp.asarray(x), jnp.asarray(mn_a), jnp.asarray(mx_a), 8, False))
    got = fq.act_fake_quant(torch.from_numpy(x), torch.from_numpy(mn_a), torch.from_numpy(mx_a), 8)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_array_equal(got.numpy(), fq.act_fake_quant_ref(
        torch.from_numpy(x), torch.from_numpy(mn_a), torch.from_numpy(mx_a), 8).numpy())


def test_fake_quant_entry_matches_fake_quant_pallas():
    from fqss_tpu.ops.pallas_quant import fake_quant_pallas

    mn, mx = -1.0, -1.0 + 255 * STEP
    x = _act_inputs((9, 1025), 1, mn, mx)
    mn_a, mx_a = _ranges(mn, mx)
    want = np.asarray(fake_quant_pallas(jnp.asarray(x), jnp.asarray(mn_a), jnp.asarray(mx_a), n_bits=8))
    got = fq.fake_quant(torch.from_numpy(x), torch.from_numpy(mn_a), torch.from_numpy(mx_a), 8)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("ch_axis,shape", [(0, (40, 65)), (1, (65, 40)), (2, (5, 33, 24))])
def test_weight_ref_matches_pallas_weight_fake_quant_train(ch_axis, shape):
    from fqss_tpu.ops.pallas_qat import weight_fake_quant_train

    rng = np.random.default_rng(2)
    c = shape[ch_axis]
    kd = [1] * len(shape)
    kd[ch_axis] = c
    w = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    mn = (-np.abs(rng.standard_normal(kd)) * 0.4 - 0.01).astype(np.float32)
    mx = (np.abs(rng.standard_normal(kd)) * 0.4 + 0.01).astype(np.float32)
    # channel 0: step exactly 2*STEP, with ties and out-of-range values across it
    mn.reshape(-1)[0], mx.reshape(-1)[0] = -255 * STEP, 0.5
    first = np.moveaxis(w, ch_axis, 0)[0]
    k = np.arange(first.size) % 262 - 131
    first[...] = ((k + 0.5) * 2 * STEP).reshape(first.shape)
    want = np.asarray(weight_fake_quant_train(jnp.asarray(w), jnp.asarray(mn), jnp.asarray(mx), 8, False, ch_axis))
    got = fq.weight_fake_quant(torch.from_numpy(w), torch.from_numpy(mn), torch.from_numpy(mx), 8, ch_axis)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    # the flat [C] range layout gives the same grid
    flat = fq.weight_fake_quant(torch.from_numpy(w), torch.from_numpy(mn.reshape(-1)),
                                torch.from_numpy(mx.reshape(-1)), 8, ch_axis)
    assert torch.equal(flat, got)


def test_cpu_tensors_launch_no_kernel():
    fq.reset_launches()
    x = torch.linspace(-2, 2, 301)
    r = torch.tensor([-1.0]), torch.tensor([1.0])
    fq.act_fake_quant(x, *r)
    fq.fake_quant(x, *r)
    fq.weight_fake_quant(x.reshape(7, 43), torch.full((7, 1), -1.0), torch.full((7, 1), 1.0), 8, 0)
    assert fq.LAUNCHES == {"act": 0, "weight": 0, "act_bwd": 0, "weight_bwd": 0}


def test_devices_without_a_kernel_raise():
    x = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fq.act_fake_quant(x, torch.empty(1, device="meta"), torch.empty(1, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        fq.weight_fake_quant(x, torch.empty(4, device="meta"), torch.empty(4, device="meta"))
