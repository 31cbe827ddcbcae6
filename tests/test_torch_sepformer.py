"""The port's Sepformer serving slice against the JAX package.

Layers (``TransformerLayer``, ``DualPathBlock``, and ``QConvTr1dDecoder``
with two combiner planes and the trained residual decoder) are initialised
and calibrated in JAX, carried across with ``sepformer_from_jax`` and run by
both packages on the same numpy input: every output within one LSB of its
quantizer, at most 1% of them off by more than half an LSB (the JAX layers
compiled with XLA's algebraic simplifier off, so with eager JAX's
arithmetic). A TransformerLayer's output is the sum of its attention's and
its feed-forward's quantized outputs with its input (its residual adds are
no quant points), so one step of each is allowed there.

The whole model is the tiny FQSS-8bit Sepformer of
``tests/test_serve_transformer_int8.py`` (32 filters, 4 heads, one
dual-path block of one layer, chunks of 20, n_splitter = n_combiner = 2,
``train_res_dec`` forced on), calibrated in JAX: SNR >= 20 dB per output
against the JAX model compiled the same way. The int8 engine is held
against JAX's ``SepformerInt8Engine`` and against the port's fake-quant
forward.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fqss_tpu.data import synth_batch
from fqss_tpu.models import sepformer as jax_sepformer
from fqss_tpu.nn import QConvTr1dDecoder as JaxQConvTr1dDecoder
from fqss_tpu.quant import QuantSpec as JaxQuantSpec
from fqss_tpu.quant.calibration import run_observer
from fqss_tpu.serve.sepformer_int8 import SepformerInt8Engine as JaxEngine
from fqss_tpu_torch.models.convert import sepformer_from_jax
from fqss_tpu_torch.models.sepformer import DualPathBlock, Sepformer, TransformerLayer, sinusoidal_pe
from fqss_tpu_torch.nn.io_layers import QConvTr1dDecoder
from fqss_tpu_torch.ops import attention as k8
from fqss_tpu_torch.ops import fake_quant as fq
from fqss_tpu_torch.ops import int8_matmul as im
from fqss_tpu_torch.quant.quantizers import ActQuantizer, WeightQuantizer
from fqss_tpu_torch.quant.spec import QuantSpec
from fqss_tpu_torch.serve import SepformerInt8Engine, make_int8_engine
from fqss_tpu_torch.serve.fold import fold_quantized_weights
from fqss_tpu_torch.utils.audio import read_audio, save_audio

torch.set_num_threads(1)

ARCH = dict(n_srcs=2, kernel_size=8, stride=4, n_filters=32, n_repeats=1, n_heads=4, chunk_size=20, n_ffn=48,
            n_layers=1)
SPEC = dict(qat=True, n_splitter=2, n_combiner=2, out_quant=True, max_observations=3)
ALGSIMP_OFF = {"xla_disable_hlo_passes": "algsimp"}


def _snr_db(ref, est):
    return 10 * np.log10(np.sum(ref**2, -1) / np.maximum(np.sum((ref - est) ** 2, -1), 1e-30))


def _input(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def _jax_calibrated(make, x, **spec):
    """(variables after a 2-step observer pass, observer-free output) of a JAX layer, compiled with XLA's
    algebraic simplifier off (eager JAX's divisions)."""
    spec = dict(SPEC, max_observations=2, **spec)
    obs = make(JaxQuantSpec(observer=True, **spec))
    variables = jax.jit(obs.init)(jax.random.PRNGKey(0), *x)
    observe = jax.jit(lambda v, *a: obs.apply(v, *a, mutable=["qparams", "qstats"])[1])
    for _ in range(2):
        variables = {**variables, **observe(variables, *x)}
    apply = jax.jit(make(JaxQuantSpec(observer=False, **spec)).apply).lower(variables, *x)
    return jax.device_get(variables), np.asarray(apply.compile(compiler_options=ALGSIMP_OFF)(variables, *x))


def _port(module, variables):
    module.load_state_dict(sepformer_from_jax(variables), strict=True)
    return module.eval()


def _port_spec(**spec):
    return QuantSpec(observer=False, **dict(SPEC, max_observations=2, **spec))


def _lsb(qparams):
    return float(qparams["max_range"][0] - qparams["min_range"][0]) / 255


def _assert_within(got, want, lsb, tol=1.0):
    """At most ``tol`` steps apart anywhere, at most 1% of the values more than half of ``lsb`` apart."""
    diff = np.abs(got - want)
    assert diff.max() <= tol * lsb * (1 + 1e-4), f"max diff {diff.max()} > {tol} x LSB {lsb}"
    assert np.mean(diff > 0.5 * lsb) <= 0.01, f"{np.mean(diff > 0.5 * lsb):.4f} of outputs moved by a grid step"


def test_sinusoidal_pe_equals_jax():
    np.testing.assert_array_equal(sinusoidal_pe(300, 32), jax_sepformer.sinusoidal_pe(300, 32))


def test_transformer_layer_matches_jax():
    x = _input((3, 20, 32))
    variables, want = _jax_calibrated(lambda q: jax_sepformer.TransformerLayer(32, 48, 4, q=q), (jnp.asarray(x),))
    layer = _port(TransformerLayer(32, 48, 4, q=_port_spec()), variables)
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    qp = variables["qparams"]
    lsb_mha, lsb_ffn = _lsb(qp["mha"]["activation_fake_quantize"]), _lsb(qp["ffn_out"]["activation_fake_quantize"])
    _assert_within(got, want, min(lsb_mha, lsb_ffn), tol=(lsb_mha + lsb_ffn) / min(lsb_mha, lsb_ffn))


@pytest.mark.parametrize("batch", [1, 2])
def test_dual_path_block_matches_jax(batch):
    x = _input((batch, 20, 5, 32), seed=batch)
    variables, want = _jax_calibrated(lambda q: jax_sepformer.DualPathBlock(32, 4, 48, 1, q=q), (jnp.asarray(x),))
    block = _port(DualPathBlock(32, 4, 48, 1, q=_port_spec()), variables)
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    _assert_within(got, want, _lsb(variables["qparams"]["inter_add"]["activation_fake_quantize"]))


def test_convtr_decoder_with_the_trained_residual_decoder_matches_jax():
    x = np.abs(_input((4, 50, 32), seed=3))  # a masked encoder output is non-negative; JAX's layout [B, M, F]
    variables, want = _jax_calibrated(lambda q: JaxQConvTr1dDecoder(features=1, kernel_size=8, stride=4, q=q),
                                      (jnp.asarray(x),), train_res_dec=True)
    assert "residual_decoder_kernel" in variables["params"]["residual_error_block"]
    dec = QConvTr1dDecoder(32, 1, 8, stride=4, q=_port_spec(train_res_dec=True))
    _port(torch.nn.ModuleDict({"decoder": dec}), {k: {"decoder": v} for k, v in variables.items()})
    reb = dec.residual_error_block
    assert reb.residual_decoder_weight.shape == (32, 1, 8) and reb.weight_fake_quantize_dec.ch_axis == 1
    with torch.no_grad():
        got = dec(torch.from_numpy(x).transpose(1, 2).contiguous()).numpy()  # [2, B, 1, L]
    assert got.shape == (2, 4, 1, 49 * 4 + 8)
    qp = variables["qparams"]
    for plane, quantizer in enumerate(("activation_fake_quantize", "activation_fake_quantize_residual")):
        _assert_within(got[plane, :, 0], want[plane, ..., 0], _lsb(qp[quantizer]))


# ---------------------------------------------------------------------------
# The whole model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def calibrated():
    """(JAX eval model, calibrated JAX variables, port model, mixtures [2, 800])."""
    mix, _ = synth_batch(np.random.default_rng(0), 2, 2, 800)
    obs = jax_sepformer.Sepformer(q=JaxQuantSpec(observer=True, **SPEC), **ARCH)
    variables = jax.jit(obs.init)(jax.random.PRNGKey(0), jnp.asarray(mix))
    variables = run_observer(obs, variables, jnp.asarray(mix), steps=4)
    port = Sepformer(q=QuantSpec(observer=False, **SPEC), **ARCH)
    port.load_state_dict(sepformer_from_jax(variables), strict=True)
    return jax_sepformer.Sepformer(q=JaxQuantSpec(observer=False, **SPEC), **ARCH), variables, port.eval(), mix


def _forward(model, mix):
    with torch.inference_mode():
        return model(torch.from_numpy(np.asarray(mix))).numpy()


def _out_lsb(port):
    aq = port.decoder.activation_fake_quantize
    return float(aq.max_range.detach() - aq.min_range.detach()) / 255


def test_train_res_dec_is_forced_as_in_jax():
    assert Sepformer(q=QuantSpec(**SPEC), **ARCH).q.train_res_dec
    assert jax_sepformer.Sepformer(q=JaxQuantSpec(**SPEC), **ARCH).q.train_res_dec
    assert not Sepformer(q=QuantSpec(qat=True), **ARCH).q.train_res_dec  # one combiner plane


def test_forward_matches_jax(calibrated):
    jm, variables, port, mix = calibrated
    x = jnp.asarray(mix)
    want = np.asarray(jax.jit(jm.apply).lower(variables, x).compile(compiler_options=ALGSIMP_OFF)(variables, x))
    for module in (fq, k8, im):
        module.reset_launches()
    got = _forward(port, mix)
    assert fq.LAUNCHES["act"] == 0 and k8.LAUNCHES == {"attention": 0, "attention_bf16": 0}  # CPU tensors: the plain versions
    assert got.shape == want.shape == (2, 2, 800)
    snr = _snr_db(want, got)
    assert (snr >= 20).all(), f"port vs JAX SNR {snr} dB < 20 dB"


def test_quantizer_sites_equal_jax_scopes(calibrated):
    _, variables, port, _ = calibrated
    leaves = jax.tree_util.tree_flatten_with_path(variables["qparams"])[0]
    scopes = {tuple(k.key for k in path[:-1]) for path, _ in leaves}
    port_scopes = {tuple(name.split(".")) for name, m in port.named_modules()
                   if isinstance(m, (ActQuantizer, WeightQuantizer))}
    assert port_scopes == scopes
    # per layer: mha in/out, ffn_in, ffn_out; encoder, conv1d, conv2d, net_out, net_gate, end_conv, decoder,
    # its residual encoder and residual decoder
    assert sum(isinstance(m, WeightQuantizer) for m in port.modules()) == 2 * 4 + 9


def test_every_quantizer_input_is_contiguous(calibrated):
    """The CUDA kernels take contiguous tensors only: hold every call site to that on the CPU."""
    *_, port, mix = calibrated
    model = Sepformer(q=QuantSpec(observer=True, **SPEC), **ARCH)
    model.load_state_dict(port.state_dict())
    seen = []
    for m in model.modules():
        if isinstance(m, (ActQuantizer, WeightQuantizer)):
            m.register_forward_pre_hook(lambda mod, args: seen.append(args[0].is_contiguous()))
    x = torch.from_numpy(mix)
    with torch.no_grad():
        model.train()(x)  # the attn/softmax sites run too
        for batch in (x, x[:1]):  # at batch 1 reshapes of transposed segments are strided views
            model.eval()(batch)
            fold_quantized_weights(model)(batch)
    assert seen and all(seen)


def test_folded_engine_bitwise_equals_fake_quant(calibrated):
    *_, port, mix = calibrated
    folded = fold_quantized_weights(port)
    assert folded.q.weight_quant is False and port.q.weight_quant is True
    assert not any(isinstance(m, WeightQuantizer) for m in folded.modules())
    assert folded.decoder.residual_error_block.weight_fake_quantize_dec is None
    np.testing.assert_array_equal(_forward(folded, mix), _forward(port, mix))


def _int8_launches(model) -> int:
    """K4 launches of the engine, from the module tree: four products a transformer layer, three in the masker."""
    return 4 * sum(isinstance(m, TransformerLayer) for m in model.modules()) + 3


# The int8 engine against JAX's (compiled with XLA's algebraic simplifier off), per compute dtype: (minimum SNR in
# dB per output, largest share of samples more than half an output step apart).
JAX_BOUND = {"float32": (30.0, 5e-3), "bfloat16": (30.0, 5e-3)}


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_int8_engine_matches_the_jax_engine(calibrated, compute_dtype):
    jm, variables, port, mix = calibrated
    engine = JaxEngine(jm, variables, compute_dtype=compute_dtype)
    x = jnp.asarray(mix)
    want = np.asarray(jax.jit(engine._forward).lower(x).compile(compiler_options=ALGSIMP_OFF)(x))
    im.reset_launches()
    got = SepformerInt8Engine(port, compute_dtype=compute_dtype)(torch.from_numpy(mix)).numpy()
    assert im.LAUNCHES == {"int8_mm": 0}  # CPU tensors: the plain version
    assert got.shape == want.shape == (2, 2, 800)
    snr_min, share_max = JAX_BOUND[compute_dtype]
    snr, diff = _snr_db(want, got), np.abs(got - want) / _out_lsb(port)
    assert (snr >= snr_min).all(), snr
    assert (diff > 0.5).mean() <= share_max, (diff > 0.5).mean()


def test_int8_engine_agrees_with_the_fake_quant_forward(calibrated, monkeypatch):
    *_, port, mix = calibrated
    sites = []
    monkeypatch.setattr(im, "int8_matmul_requant_ref",
                        lambda *a, _ref=im.int8_matmul_requant_ref, **k: sites.append(a[1].shape) or _ref(*a, **k))
    ref, lsb, x = _forward(port, mix), _out_lsb(port), torch.from_numpy(mix)
    diff = np.abs(make_int8_engine(port, compute_dtype="float32")(x).numpy() - ref) / lsb
    assert len(sites) == _int8_launches(port) == 11
    assert sites[0] == (32, 32) and (3 * 32, 32) in sites  # the bottleneck; the in-projection's one product
    assert diff.max() <= 10 and diff.mean() <= 1.5, (diff.max(), diff.mean())
    diff = np.abs(make_int8_engine(port)(x).numpy() - ref) / lsb  # bfloat16 operands for the float products
    assert diff.mean() <= 2, diff.mean()


def test_int8_site_with_three_grids_equals_three_sites():
    from fqss_tpu_torch.serve import common

    rng = np.random.default_rng(11)
    w = torch.from_numpy((rng.standard_normal((24, 16)) * 0.3).astype(np.float32))
    w8 = common.int8_weight(w, w.amin(1), w.amax(1), torch.zeros(24))
    g_in = common.Grid(np.float32(2.0**-6), np.float32(-1.0))
    grids = [common.Grid(np.float32(d), np.float32(m)) for d, m in ((0.01, -1.2), (0.02, -2.0), (0.005, -0.6))]
    qa = common.requant(torch.from_numpy(rng.uniform(-1, 1, (5, 7, 16)).astype(np.float32)), g_in)
    thirds = common.Int8Site(g_in, w8, grids, 1.0, torch.device("cpu"))(qa)
    for i, (got, g) in enumerate(zip(thirds, grids)):
        rows = common.Int8Weight(w8.w_int[8 * i : 8 * (i + 1)], w8.scale[8 * i : 8 * (i + 1)],
                                 w8.sum_w[8 * i : 8 * (i + 1)], w8.bias[8 * i : 8 * (i + 1)])
        want = common.Int8Site(g_in, rows, g, 1.0, torch.device("cpu"))(qa)
        assert got.grid is g and torch.equal(got.Xs, want.Xs)


@pytest.mark.parametrize("spec,error", [
    (dict(qat=True, out_quant=True, n_combiner=3), NotImplementedError),
    (dict(qat=True, out_quant=True, act_n_bits=6), NotImplementedError),
    (dict(qat=False), ValueError),
])
def test_int8_engine_refuses_what_the_jax_engine_refuses(spec, error):
    with pytest.raises(error):
        SepformerInt8Engine(Sepformer(q=QuantSpec(**spec), **ARCH))


TINY_CFG = """
model_cfg:
  name: Sepformer
  model_path: {model_path}
  n_src: 2
  kernel_size: 8
  stride: 4
  n_filters: 32
  n_repeats: 1
  n_heads: 4
  chunk_size: 20
  n_ffn: 48
  n_layers: 1
  quantization: {{qat: True, out_quant: True, n_splitter: 2, n_combiner: 2, observer: True}}
testing_cfg: {{segment_samples: 1000, overlap: 0.25}}
"""


@pytest.mark.parametrize("engine", ["fake_quant", "folded", "int8"])
def test_infer_cli_serves_sepformer_on_cpu(calibrated, tmp_path, engine):
    from fqss_tpu_torch import infer

    *_, port, _ = calibrated
    torch.save(port.state_dict(), tmp_path / "sepformer.pt")
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY_CFG.format(model_path=tmp_path / "sepformer.pt"))
    mix, _ = synth_batch(np.random.default_rng(1), 1, 2, 2600)
    save_audio(str(tmp_path / "mixture.wav"), mix[0], 8000)
    infer.main(["-y", str(cfg), "-a", str(tmp_path / "mixture.wav"), "-o", str(tmp_path / "out"), "--engine", engine,
                "--device", "cpu"])
    for s in (1, 2):
        audio, fs = read_audio(str(tmp_path / "out" / f"source_{s}.wav"))
        assert fs == 8000 and audio.shape == (1, 2600) and np.isfinite(audio).all()


def test_factory_builds_and_loads_sepformer(calibrated, tmp_path):
    from fqss_tpu_torch.models.factory import MODEL_NAMES, create_model, create_pretrained_model

    *_, port, mix = calibrated
    assert "Sepformer" in MODEL_NAMES
    cfg = {"name": "Sepformer", "n_src": 2, "kernel_size": 8, "stride": 4, "model_path": str(tmp_path / "sep.pt"),
           **{k: v for k, v in ARCH.items() if k not in ("n_srcs", "kernel_size", "stride")},
           "quantization": {**SPEC, "observer": True}}
    torch.save(port.state_dict(), cfg["model_path"])
    loaded = create_pretrained_model(cfg, observer=False)
    assert isinstance(loaded, Sepformer) and loaded.q.observer is False and loaded.q.train_res_dec
    np.testing.assert_array_equal(_forward(loaded, mix), _forward(port, mix))
    full = create_model({"name": "Sepformer", "n_src": 2, "quantization": {"qat": True}})
    mk = full.masker
    assert (full.n_filters, full.n_heads, len(mk.blocks), len(mk.blocks[0].intra_transformer_block.layers),
            mk.chunk_size) == (256, 8, 2, 8, 250)
