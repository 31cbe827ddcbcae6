"""The port's ConvTasNet layers (fqss_tpu_torch/nn) against the JAX modules.

Each JAX module is initialised, calibrated by a two-step observer pass, and
carried across with ``convtasnet_from_jax``; both then run with
``observer=False`` on the same numpy input (NTC for JAX, NCT for the port).
Tolerance: every output within one LSB of its quantizer, and at most 1% of
outputs off by more than half an LSB.

The JAX modules run eagerly. Under ``jit`` XLA turns the division by the
grid size into a multiplication by its reciprocal, one ulp away; and since
the one-shot observer sets each weight channel's range at its extreme weight,
that weight sits exactly on a half-step tie (±127.5 steps), which the ulp
decides. ``tests/test_torch_convtasnet.py`` holds the whole model against the
jitted JAX model by SNR instead.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fqss_tpu.nn import QConv1d as JaxQConv1d
from fqss_tpu.nn import QConv1dEncoder as JaxEncoder
from fqss_tpu.nn import QConvTr1dDecoder as JaxDecoder
from fqss_tpu.nn import QGroupNorm as JaxQGroupNorm
from fqss_tpu.quant import QuantSpec as JaxQuantSpec
from fqss_tpu_torch.models.convert import convtasnet_from_jax
from fqss_tpu_torch.nn.io_layers import QConv1dEncoder, QConvTr1dDecoder
from fqss_tpu_torch.nn.layers import QConv1d, QGroupNorm
from fqss_tpu_torch.quant.spec import QuantSpec

torch.set_num_threads(1)

SPEC = dict(qat=True, out_quant=True, n_splitter=2, n_combiner=2, max_observations=2)


def _jax_calibrated(make, x_ntc):
    """(variables after a 2-step observer pass, eager observer-free output)."""
    obs = make(JaxQuantSpec(observer=True, **SPEC))
    variables = obs.init(jax.random.PRNGKey(0), x_ntc)
    for _ in range(2):
        _, upd = obs.apply(variables, x_ntc, mutable=["qparams", "qstats"])
        variables = {**variables, **upd}
    served = make(JaxQuantSpec(observer=False, **SPEC))
    return jax.device_get(variables), np.asarray(served.apply(variables, x_ntc))


def _as_decoder(variables):
    """A standalone decoder's variables under the ``decoder`` scope the bridge knows."""
    return {col: {"decoder": tree} for col, tree in variables.items()}


def _port(module, variables, scope=None):
    sd = convtasnet_from_jax(_as_decoder(variables) if scope == "decoder" else variables)
    if scope:
        sd = {k.removeprefix(scope + "."): v for k, v in sd.items()}
    module.load_state_dict(sd, strict=True)
    return module.eval()


def _lsb(variables_qparams):
    mn, mx = float(variables_qparams["min_range"][0]), float(variables_qparams["max_range"][0])
    return (mx - mn) / 255


def _assert_within_one_lsb(got, want, lsb):
    diff = np.abs(got - want)
    assert diff.max() <= lsb * (1 + 1e-4), f"max diff {diff.max()} > 1 LSB {lsb}"
    flipped = np.mean(diff > 0.5 * lsb)
    assert flipped <= 0.01, f"{flipped:.4f} of outputs moved by a grid step (limit 0.01)"


def _ntc(x_nct):
    return jnp.asarray(np.swapaxes(x_nct, 1, 2))


def _input(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(kernel_size=1, nl="prelu"),
    dict(kernel_size=3, padding=2, dilation=2, groups=16, nl="prelu"),
], ids=["1x1_prelu", "depthwise_dilated"])
def test_qconv1d_matches_jax(kw):
    x = _input((2, 16, 150))
    variables, want = _jax_calibrated(lambda q: JaxQConv1d(features=16, q=q, **kw), _ntc(x))
    conv = _port(QConv1d(16, 16, q=QuantSpec(observer=False, **SPEC), **kw), variables)
    with torch.no_grad():
        got = conv(torch.from_numpy(x)).numpy()
    _assert_within_one_lsb(got, np.swapaxes(want, 1, 2), _lsb(variables["qparams"]["activation_fake_quantize"]))


def test_qgroupnorm_matches_jax():
    x = _input((2, 16, 150)) * 3 + 1
    variables, want = _jax_calibrated(lambda q: JaxQGroupNorm(num_groups=1, epsilon=1e-8, q=q), _ntc(x))
    norm = _port(QGroupNorm(1, 16, epsilon=1e-8, q=QuantSpec(observer=False, **SPEC)), variables)
    with torch.no_grad():
        got = norm(torch.from_numpy(x)).numpy()
    _assert_within_one_lsb(got, np.swapaxes(want, 1, 2), _lsb(variables["qparams"]["activation_fake_quantize"]))


def test_encoder_matches_jax():
    x = _input((2, 2, 808))
    variables, want = _jax_calibrated(
        lambda q: JaxEncoder(features=32, kernel_size=16, stride=8, use_bias=False, q=q), _ntc(x))
    enc = _port(QConv1dEncoder(2, 32, 16, stride=8, q=QuantSpec(observer=False, **SPEC)), variables)
    with torch.no_grad():
        got = enc(torch.from_numpy(x)).numpy()
    lsb = _lsb(variables["qparams"]["conv"]["activation_fake_quantize"])
    _assert_within_one_lsb(got, np.swapaxes(want, 1, 2), lsb)


def test_decoder_with_combiner_matches_jax():
    x = np.abs(_input((2, 32, 100)))  # a masked encoder output is non-negative
    variables, want = _jax_calibrated(
        lambda q: JaxDecoder(features=1, kernel_size=16, stride=8, use_bias=False, q=q), _ntc(x))
    dec = _port(QConvTr1dDecoder(32, 1, 16, stride=8, q=QuantSpec(observer=False, **SPEC)), variables,
                scope="decoder")
    with torch.no_grad():
        got = dec(torch.from_numpy(x)).numpy()  # [2 planes, B, 1, L]
    assert got.shape == (2, 2, 1, (100 - 1) * 8 + 16)
    want = np.swapaxes(want, -1, -2)  # [2 planes, B, L, 1] -> [2, B, 1, L]
    qp = variables["qparams"]
    _assert_within_one_lsb(got[0], want[0], _lsb(qp["activation_fake_quantize"]))
    _assert_within_one_lsb(got[1], want[1], _lsb(qp["activation_fake_quantize_residual"]))


def test_converted_weights_land_in_torch_layout():
    x = _input((1, 2, 160))
    variables, _ = _jax_calibrated(
        lambda q: JaxDecoder(features=1, kernel_size=16, stride=8, use_bias=False, q=q), _ntc(_input((1, 32, 20))))
    sd = convtasnet_from_jax(_as_decoder(variables))
    kernel = variables["params"]["kernel"]  # (k, Cin, Cout)
    np.testing.assert_array_equal(sd["decoder.weight"].numpy(), np.transpose(kernel, (1, 2, 0)))
    assert tuple(sd["decoder.weight_fake_quantize.min_range"].shape) == (1, 1, 1)
    # the residual encoder inside the decoder scope is a plain conv
    assert tuple(sd["decoder.residual_error_block.residual_encoder.weight"].shape) == (32, 1, 16)
    enc_vars, _ = _jax_calibrated(
        lambda q: JaxEncoder(features=32, kernel_size=16, stride=8, use_bias=False, q=q), _ntc(x))
    sd = convtasnet_from_jax(enc_vars)
    assert tuple(sd["conv.weight"].shape) == (32, 2, 16)
    assert tuple(sd["conv.weight_fake_quantize.max_range"].shape) == (32, 1, 1)
    assert sd["conv.weight_fake_quantize.observed"].dtype == torch.bool
