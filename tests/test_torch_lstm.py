"""The port's LSTM recurrence (K6/K7's plain versions) and ``QLSTM`` against the JAX package.

* ``lstm_sequence_ref`` / ``bilstm_sequence_ref`` against JAX's
  ``lstm_sequence`` / ``bilstm_sequence`` (the Pallas kernels, in interpret
  mode) at H = 128, and against ``_lstm_scan`` at H = 96, which the TPU
  kernel does not take: atol 2e-6, as ``tests/test_pallas_lstm.py`` holds
  the kernels to the scan (float32 sums of 128 products in another order,
  carried through the recurrence).
* ``QLSTM``, uni- and bidirectional: float against JAX's Pallas path within
  2e-6; QAT (weights fake-quantized, output quantized) within one LSB of the
  output grid on at most 1% of the outputs, as the layer tests.

Inputs come from seeded numpy generators and go to both packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from fqss_tpu.nn.lstm import QLSTM as JaxQLSTM
from fqss_tpu.ops import pallas_lstm
from fqss_tpu.quant import QuantSpec as JaxQuantSpec
from fqss_tpu_torch.models.convert import dptnet_from_jax
from fqss_tpu_torch.nn.lstm import QLSTM
from fqss_tpu_torch.ops import lstm
from fqss_tpu_torch.quant.spec import QuantSpec

torch.set_num_threads(1)

ATOL = 2e-6


def _case(T, B, H, seed):
    rng = np.random.default_rng(seed)
    ih = [(rng.standard_normal((T, B, 4 * H)) * 0.5).astype(np.float32) for _ in range(2)]
    w = [(rng.uniform(-1, 1, (H, 4 * H)) / np.sqrt(H)).astype(np.float32) for _ in range(2)]
    return ih, w


@pytest.mark.parametrize("T,B", [(13, 5), (7, 3)])
def test_plain_versions_equal_the_pallas_kernels(T, B):
    (ih_f, ih_b), (w_f, w_b) = _case(T, B, 128, T * B)
    with pltpu.force_tpu_interpret_mode():
        want_one = np.asarray(pallas_lstm.lstm_sequence(jnp.asarray(ih_f), jnp.asarray(w_f)))
        want_f, want_b = (np.asarray(a) for a in pallas_lstm.bilstm_sequence(*map(jnp.asarray, (ih_f, ih_b, w_f, w_b))))
    np.testing.assert_allclose(lstm.lstm_sequence_ref(torch.from_numpy(ih_f), torch.from_numpy(w_f)).numpy(),
                               want_one, rtol=0, atol=ATOL)
    got_f, got_b = lstm.bilstm_sequence_ref(*map(torch.from_numpy, (ih_f, ih_b, w_f, w_b)))
    assert got_f.shape == got_b.shape == (T, B, 128)
    np.testing.assert_allclose(got_f.numpy(), want_f, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_b.numpy(), want_b, rtol=0, atol=ATOL)


def test_plain_version_equals_the_scan_at_a_hidden_size_the_tpu_kernel_refuses():
    (ih, _), (w, _) = _case(9, 4, 96, 96)
    assert not pallas_lstm.supported(96)
    want = np.asarray(pallas_lstm._lstm_scan(jnp.asarray(ih), jnp.asarray(w)))
    np.testing.assert_allclose(lstm.lstm_sequence_ref(torch.from_numpy(ih), torch.from_numpy(w)).numpy(), want,
                               rtol=0, atol=ATOL)


def test_wrappers_take_the_plain_versions_on_the_cpu_and_count_no_launch():
    (ih_f, ih_b), (w_f, w_b) = (list(map(torch.from_numpy, a)) for a in _case(6, 3, 20, 0))
    lstm.reset_launches()
    assert torch.equal(lstm.lstm_sequence(ih_f, w_f), lstm.lstm_sequence_ref(ih_f, w_f))
    for got, want in zip(lstm.bilstm_sequence(ih_f, ih_b, w_f, w_b), lstm.bilstm_sequence_ref(ih_f, ih_b, w_f, w_b)):
        assert torch.equal(got, want)
    assert set(lstm.LAUNCHES.values()) == {0}
    assert lstm.lstm_sequence(ih_f[:0], w_f).shape == (0, 3, 20)


def test_wrappers_hold_cpu_callers_to_what_the_kernel_takes():
    (ih, ih_b), (w, _) = (list(map(torch.from_numpy, a)) for a in _case(4, 2, 8, 1))
    with pytest.raises(ValueError, match="contiguous"):
        lstm.lstm_sequence(ih.transpose(0, 1).contiguous().transpose(0, 1), w)
    with pytest.raises(TypeError):
        lstm.lstm_sequence(ih.double(), w.double())
    with pytest.raises(ValueError, match=r"\[H, 4H\]"):
        lstm.lstm_sequence(ih, w[:4].contiguous())
    with pytest.raises(ValueError, match="directions differ"):
        lstm.bilstm_sequence(ih, ih_b[:3].contiguous(), w, w)


@pytest.mark.parametrize("bidirectional", [True, False], ids=["bi", "uni"])
@pytest.mark.parametrize("qat", [False, True], ids=["float", "qat"])
def test_qlstm_matches_jax(bidirectional, qat):
    B, T, C, H = 3, 7, 16, 128
    x = np.random.default_rng(5).standard_normal((B, T, C)).astype(np.float32)
    spec = dict(qat=qat, lstm_mode="fused", max_observations=2)
    jm = JaxQLSTM(H, bidirectional=bidirectional, mode="fused", q=JaxQuantSpec(observer=True, **spec))
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    if qat:  # the observers' window: one-shot weight ranges, two EMA steps of the output range
        observe = jax.jit(lambda v: jm.apply(v, jnp.asarray(x), mutable=["qparams", "qstats"])[1])
        for _ in range(2):
            variables = {**variables, **observe(variables)}
    variables = jax.device_get(variables)
    served = JaxQLSTM(H, bidirectional=bidirectional, mode="fused",
                      q=JaxQuantSpec(observer=False, pallas_lstm=True, **spec))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(served.apply(variables, jnp.asarray(x)))
    port = QLSTM(C, H, bidirectional=bidirectional, q=QuantSpec(observer=False, **spec))
    port.load_state_dict(dptnet_from_jax(variables), strict=True)
    lstm.reset_launches()
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
    assert set(lstm.LAUNCHES.values()) == {0}
    assert got.shape == want.shape == (B, T, (2 if bidirectional else 1) * H)
    if not qat:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
        return
    aq = variables["qparams"]["activation_fake_quantize"]
    lsb = float(aq["max_range"][0] - aq["min_range"][0]) / 255
    diff = np.abs(got - want)
    assert diff.max() <= lsb * (1 + 1e-4), diff.max() / lsb
    assert np.mean(diff > 0.5 * lsb) <= 0.01


def test_qlstm_backward_runs_through_the_plain_recurrence_on_the_cpu():
    port = QLSTM(6, 8, q=QuantSpec(qat=True, observer=False))
    x = torch.randn(2, 5, 6, generator=torch.Generator().manual_seed(0), requires_grad=True)
    port(x).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert port.fw.w_hh.grad is not None and port.bw.w_ih.grad is not None
