"""The port's whole serving slice against the JAX ConvTasNet.

A tiny FQSS-8bit model (n_filters=32, bn_chan=8, hid_chan=16, 2 blocks x 1
repeat, n_splitter = n_combiner = 2) is initialised and calibrated in JAX
(``run_observer``), converted with ``convtasnet_from_jax``, and run by both
packages on the same numpy mixtures.

Tolerance: SNR >= 20 dB per output against the jitted JAX model, the
standard of PARITY.md:546. Two jitted-vs-eager JAX runs of this model
already differ in most samples (27-30 dB apart): XLA's reciprocal rewrite
moves the grid's step by an ulp under ``jit``, which decides the half-step
ties that the one-shot weight observer creates (see
fqss_tpu_torch/quant/fake_quant.py). Against the eager JAX model the port
has no such source of difference and is held to the same bound.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fqss_tpu.data import synth_batch
from fqss_tpu.models import ConvTasNet as JaxConvTasNet
from fqss_tpu.quant import QuantSpec as JaxQuantSpec
from fqss_tpu.quant.calibration import run_observer
from fqss_tpu_torch.models.convert import convtasnet_from_jax
from fqss_tpu_torch.models.convtasnet import ConvTasNet
from fqss_tpu_torch.quant.quantizers import ActQuantizer, WeightQuantizer
from fqss_tpu_torch.quant.spec import QuantSpec
from fqss_tpu_torch.serve.fold import fold_quantized_weights

torch.set_num_threads(1)

ARCH = dict(n_srcs=2, kernel_size=16, stride=8, n_filters=32, bn_chan=8, hid_chan=16, n_blocks=2, n_repeats=1)
SPEC = dict(qat=True, n_splitter=2, n_combiner=2, out_quant=True, max_observations=3)


def snr_db(ref, est):
    return 10 * np.log10(np.sum(ref**2, -1) / np.maximum(np.sum((ref - est) ** 2, -1), 1e-30))


@pytest.fixture(scope="module")
def calibrated():
    """(jax eval model, calibrated jax variables, port model, mixtures [2, 1600])."""
    mix, _ = synth_batch(np.random.default_rng(0), 2, 2, 1600)
    jm = JaxConvTasNet(q=JaxQuantSpec(observer=True, **SPEC), **ARCH)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(mix))
    variables = run_observer(jm, variables, jnp.asarray(mix), steps=4)
    jax_eval = JaxConvTasNet(q=JaxQuantSpec(observer=False, **SPEC), **ARCH)
    port = ConvTasNet(q=QuantSpec(observer=False, **SPEC), **ARCH)
    port.load_state_dict(convtasnet_from_jax(jax.device_get(variables)), strict=True)
    return jax_eval, variables, port.eval(), mix


def _port_forward(model, x):
    with torch.inference_mode():
        return model(torch.from_numpy(np.asarray(x))).numpy()


def test_forward_matches_jitted_jax(calibrated):
    jax_eval, variables, port, mix = calibrated
    want = np.asarray(jax.jit(jax_eval.apply)(variables, jnp.asarray(mix)))
    got = _port_forward(port, mix)
    assert got.shape == want.shape == (2, 2, 1600)
    snr = snr_db(want, got)
    assert (snr >= 20).all(), f"port vs jitted JAX SNR {snr} dB < 20 dB"


def test_forward_matches_eager_jax(calibrated):
    jax_eval, variables, port, mix = calibrated
    want = np.asarray(jax_eval.apply(variables, jnp.asarray(mix)))
    snr = snr_db(want, _port_forward(port, mix))
    assert (snr >= 20).all(), f"port vs eager JAX SNR {snr} dB < 20 dB"


def test_folded_engine_bitwise_equals_fake_quant(calibrated):
    *_, port, mix = calibrated
    folded = fold_quantized_weights(port)
    assert folded.q.weight_quant is False and port.q.weight_quant is True
    assert not any(isinstance(m, WeightQuantizer) for m in folded.modules())
    np.testing.assert_array_equal(_port_forward(folded, mix), _port_forward(port, mix))


def test_quantizer_sites_equal_jax_scopes(calibrated):
    _, variables, port, _ = calibrated
    leaves = jax.tree_util.tree_flatten_with_path(variables["qparams"])[0]
    scopes = {tuple(k.key for k in path[:-1]) for path, _ in leaves}
    jax_weight = sum(s[-1] == "weight_fake_quantize" for s in scopes)
    assert sum(isinstance(m, WeightQuantizer) for m in port.modules()) == jax_weight == 13
    assert sum(isinstance(m, ActQuantizer) for m in port.modules()) == len(scopes) - jax_weight == 24


@pytest.mark.parametrize("n_splitter", [1, 2, 3])
def test_preprocess_postprocess_equal_jax(n_splitter):
    from fqss_tpu.separation.splitter import postprocess as jax_post
    from fqss_tpu.separation.splitter import preprocess as jax_pre
    from fqss_tpu_torch.separation.splitter import postprocess, preprocess

    x = np.random.default_rng(1).uniform(-0.7, 0.9, (3, 1001)).astype(np.float32)
    np.testing.assert_array_equal(preprocess(torch.from_numpy(x), n_splitter).numpy(),
                                  np.asarray(jax_pre(jnp.asarray(x), n_splitter)))
    planes = np.random.default_rng(2).standard_normal((n_splitter, 2, 2, 1, 333)).astype(np.float32)
    np.testing.assert_array_equal(postprocess(torch.from_numpy(planes), n_splitter).numpy(),
                                  np.asarray(jax_post(jnp.asarray(planes), n_splitter)))


def test_ola_infer_matches_jax(calibrated):
    from fqss_tpu.separation.ola import ola_infer as jax_ola_infer
    from fqss_tpu.separation.ola import triangular_weight as jax_triangular_weight
    from fqss_tpu_torch.separation.ola import ola_infer, triangular_weight

    jax_eval, variables, port, _ = calibrated
    seg = 800
    mix, _ = synth_batch(np.random.default_rng(3), 1, 2, 2 * seg + seg // 2)  # 2.5 segments
    want = jax_ola_infer(jax.jit(lambda x: jax_eval.apply(variables, x)), mix, n_srcs=2, segment=seg,
                         chunk_batch=2)
    got = ola_infer(port, mix, n_srcs=2, segment=seg, chunk_batch=2)
    assert got.shape == want.shape == (2, mix.shape[-1])
    snr = snr_db(want, got)
    assert (snr >= 20).all(), f"port vs JAX OLA SNR {snr} dB < 20 dB"
    np.testing.assert_array_equal(triangular_weight(seg), jax_triangular_weight(seg))
    # sharded over a one-rank group (every collective run, each the identity): the same blocks, the same separation
    from torch_ddp_cases import one_rank_mesh

    with one_rank_mesh() as mesh:
        np.testing.assert_array_equal(ola_infer(port, mix, n_srcs=2, segment=seg, chunk_batch=2, mesh=mesh), got)


def test_factory_loads_port_checkpoints_and_names_what_is_missing(calibrated, tmp_path):
    from fqss_tpu_torch.models.factory import create_model, create_pretrained_model

    *_, port, mix = calibrated
    ckpt = tmp_path / "convtasnet.pt"
    torch.save(port.state_dict(), ckpt)
    cfg = {"name": "ConvTasNet", "n_src": 2, "kernel_size": 16, "stride": 8, "model_path": str(ckpt),
           **{k: v for k, v in ARCH.items() if k not in ("n_srcs", "kernel_size", "stride")},
           "quantization": {**SPEC, "observer": True}}
    loaded = create_pretrained_model(cfg, observer=False)
    assert loaded.q.observer is False and not loaded.training
    np.testing.assert_array_equal(_port_forward(loaded, mix), _port_forward(port, mix))
    legacy = create_model({"name": "HDemucsLegacy"})  # the JAX factory's sixth family, at JAX's defaults
    assert type(legacy).__name__ == "HDemucs" and (legacy.nfft, legacy.depth, legacy.n_srcs) == (4096, 6, 4)
