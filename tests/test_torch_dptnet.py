"""The port's DPTNet serving slice against the JAX package.

Layers (``QDense``, ``QLayerNorm``, ``QMultiheadAttention`` with and without
``fix_attn_quant``, ``QLinearDecoder`` with two combiner planes) are
initialised and calibrated in JAX, carried across with ``dptnet_from_jax``
and run by both packages on the same numpy input: every output within one
LSB of its quantizer, at most 1% of them off by more than half an LSB (the
JAX layers compiled with XLA's algebraic simplifier off, so with eager
JAX's arithmetic, against which ``tests/test_torch_layers.py`` holds the
ConvTasNet layers).

The whole model is a tiny FQSS-8bit DPTNet (enc_dim 16, feature_dim 8,
hidden_dim 16, one dual-path layer, segment_size 20, n_splitter = n_combiner = 2),
calibrated in JAX: SNR >= 20 dB per output against the JAX model compiled
with XLA's algebraic simplifier off (PARITY.md:546's standard, as
``tests/test_torch_convtasnet.py``). The int8 engine is held against JAX's
``DPTNetInt8Engine`` compiled the same way (``JAX_BOUND``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fqss_tpu.data import synth_batch
from fqss_tpu.models.dptnet import DPTNet as JaxDPTNet
from fqss_tpu.models.dptnet import merge_segments as jax_merge_segments
from fqss_tpu.models.dptnet import overlap_and_add as jax_overlap_and_add
from fqss_tpu.models.dptnet import split_segments as jax_split_segments
from fqss_tpu.nn import QDense as JaxQDense
from fqss_tpu.nn import QLayerNorm as JaxQLayerNorm
from fqss_tpu.nn import QLinearDecoder as JaxQLinearDecoder
from fqss_tpu.nn.attention import QMultiheadAttention as JaxQMultiheadAttention
from fqss_tpu.quant import QuantSpec as JaxQuantSpec
from fqss_tpu.quant.calibration import run_observer
from fqss_tpu.serve.dptnet_int8 import DPTNetInt8Engine as JaxEngine
from fqss_tpu_torch.models.convert import dptnet_from_jax
from fqss_tpu_torch.models.dptnet import DPTNet, merge_segments, overlap_and_add, split_segments
from fqss_tpu_torch.nn.attention import QMultiheadAttention
from fqss_tpu_torch.nn.io_layers import QLinearDecoder
from fqss_tpu_torch.nn.layers import QDense, QLayerNorm
from fqss_tpu_torch.ops import int8_matmul as im
from fqss_tpu_torch.ops import lstm
from fqss_tpu_torch.quant.quantizers import ActQuantizer, WeightQuantizer
from fqss_tpu_torch.quant.spec import QuantSpec
from fqss_tpu_torch.serve import DPTNetInt8Engine, make_int8_engine
from fqss_tpu_torch.serve.fold import fold_quantized_weights
from fqss_tpu_torch.utils.audio import read_audio, save_audio

torch.set_num_threads(1)

ARCH = dict(n_srcs=2, kernel_size=2, enc_dim=16, feature_dim=8, hidden_dim=16, layer=1, segment_size=20)
SPEC = dict(qat=True, n_splitter=2, n_combiner=2, out_quant=True, max_observations=3)
ALGSIMP_OFF = {"xla_disable_hlo_passes": "algsimp"}


def _snr_db(ref, est):
    return 10 * np.log10(np.sum(ref**2, -1) / np.maximum(np.sum((ref - est) ** 2, -1), 1e-30))


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def _jax_calibrated(make, x):
    """(variables after a 2-step observer pass, observer-free output) of a JAX layer.

    Jitted, not eager (eager JAX compiles op by op); the output with XLA's algebraic simplifier off, which
    keeps eager's divisions."""
    spec = dict(SPEC, max_observations=2)
    obs = make(JaxQuantSpec(observer=True, **spec))
    variables = jax.jit(obs.init)(jax.random.PRNGKey(0), *x)
    observe = jax.jit(lambda v, *a: obs.apply(v, *a, mutable=["qparams", "qstats"])[1])
    for _ in range(2):
        variables = {**variables, **observe(variables, *x)}
    apply = jax.jit(make(JaxQuantSpec(observer=False, **spec)).apply).lower(variables, *x)
    return jax.device_get(variables), np.asarray(apply.compile(compiler_options=ALGSIMP_OFF)(variables, *x))


def _port(module, variables):
    module.load_state_dict(dptnet_from_jax(variables), strict=True)
    return module.eval()


def _lsb(qparams):
    return float(qparams["max_range"][0] - qparams["min_range"][0]) / 255


def _assert_within_one_lsb(got, want, lsb):
    diff = np.abs(got - want)
    assert diff.max() <= lsb * (1 + 1e-4), f"max diff {diff.max()} > 1 LSB {lsb}"
    assert np.mean(diff > 0.5 * lsb) <= 0.01, f"{np.mean(diff > 0.5 * lsb):.4f} of outputs moved by a grid step"


def _input(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _port_spec():
    return QuantSpec(observer=False, **dict(SPEC, max_observations=2))


def test_qdense_matches_jax():
    x = _input((2, 30, 20))
    variables, want = _jax_calibrated(lambda q: JaxQDense(12, q=q), (jnp.asarray(x),))
    dense = _port(QDense(20, 12, q=_port_spec()), variables)
    with torch.no_grad():
        got = dense(torch.from_numpy(x)).numpy()
    _assert_within_one_lsb(got, want, _lsb(variables["qparams"]["activation_fake_quantize"]))


def test_qlayernorm_matches_jax():
    x = _input((2, 30, 16)) * 3 + 1
    variables, want = _jax_calibrated(lambda q: JaxQLayerNorm(q=q), (jnp.asarray(x),))
    norm = _port(QLayerNorm(16, q=_port_spec()), variables)
    with torch.no_grad():
        got = norm(torch.from_numpy(x)).numpy()
    _assert_within_one_lsb(got, want, _lsb(variables["qparams"]["activation_fake_quantize"]))


@pytest.mark.parametrize("fix_attn_quant", [False, True])
def test_qmultiheadattention_matches_jax(fix_attn_quant):
    xn = _input((3, 25, 16), seed=1)
    x = jnp.asarray(xn)
    variables, want = _jax_calibrated(lambda q: JaxQMultiheadAttention(16, 4, q=q, fix_attn_quant=fix_attn_quant),
                                      (x, x, x))
    mha = _port(QMultiheadAttention(16, 4, q=_port_spec(), fix_attn_quant=fix_attn_quant), variables)
    xt = torch.from_numpy(xn)
    with torch.no_grad():
        got = mha(xt, xt, xt).numpy()
    _assert_within_one_lsb(got, want, _lsb(variables["qparams"]["activation_fake_quantize"]))


def test_attention_noop_sites_feed_their_observers_only_in_train_mode():
    mha = QMultiheadAttention(16, 4, q=QuantSpec(qat=True, max_observations=2))
    calls = {"attn": 0, "softmax": 0}
    for site in calls:
        getattr(mha, f"activation_fake_quantize_{site}").register_forward_hook(
            lambda *_, site=site: calls.__setitem__(site, calls[site] + 1))
    x = torch.from_numpy(_input((2, 10, 16)))
    with torch.no_grad():
        mha.train()(x, x, x)
        assert calls == {"attn": 1, "softmax": 1}
        assert int(mha.activation_fake_quantize_attn.n_iter) == 1
        mha.eval()(x, x, x)
    assert calls == {"attn": 1, "softmax": 1}  # eval: the quantizer would write nothing, so it is not called


def test_qlinear_decoder_with_combiner_matches_jax():
    x = np.abs(_input((2, 2, 40, 16)))  # a masked encoder output is non-negative
    variables, want = _jax_calibrated(lambda q: JaxQLinearDecoder(features=2, use_bias=False, q=q),
                                      (jnp.asarray(x),))
    dec = _port(QLinearDecoder(16, 2, q=_port_spec()), variables)
    with torch.no_grad():
        got = dec(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2, 2, 40, 2)
    qp = variables["qparams"]
    _assert_within_one_lsb(got[0], want[0], _lsb(qp["activation_fake_quantize"]))
    _assert_within_one_lsb(got[1], want[1], _lsb(qp["activation_fake_quantize_residual"]))


@pytest.mark.parametrize("t,k", [(57, 10), (60, 20), (250, 250)])
def test_segments_and_overlap_add_equal_jax(t, k):
    x = _input((2, t, 3), seed=t)
    segs, rest = split_segments(torch.from_numpy(x), k)
    want_segs, want_rest = jax_split_segments(jnp.asarray(x), k)
    assert rest == want_rest
    np.testing.assert_array_equal(segs.numpy(), np.asarray(want_segs))
    merged = merge_segments(segs, rest, torch.add)
    np.testing.assert_array_equal(merged.numpy(), np.asarray(jax_merge_segments(want_segs, rest, jnp.add)))
    frames = _input((2, 3, t, 4), seed=t + 1)
    for step in (1, 2, 4):
        np.testing.assert_allclose(overlap_and_add(torch.from_numpy(frames), step).numpy(),
                                   np.asarray(jax_overlap_and_add(jnp.asarray(frames), step)), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# The whole model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def calibrated():
    """(JAX eval model, calibrated JAX variables, port model, mixtures [2, 600])."""
    mix, _ = synth_batch(np.random.default_rng(0), 2, 2, 600)
    obs = JaxDPTNet(q=JaxQuantSpec(observer=True, **SPEC), **ARCH)
    variables = jax.jit(obs.init)(jax.random.PRNGKey(0), jnp.asarray(mix))  # eager init compiles op by op
    variables = run_observer(obs, variables, jnp.asarray(mix), steps=4)
    port = DPTNet(q=QuantSpec(observer=False, **SPEC), **ARCH)
    port.load_state_dict(dptnet_from_jax(variables), strict=True)
    return JaxDPTNet(q=JaxQuantSpec(observer=False, **SPEC), **ARCH), variables, port.eval(), mix


def _forward(model, mix):
    with torch.inference_mode():
        return model(torch.from_numpy(np.asarray(mix))).numpy()


def _out_lsb(port):
    aq = port.decoder.activation_fake_quantize
    return float(aq.max_range.detach() - aq.min_range.detach()) / 255


def test_forward_matches_jax(calibrated):
    jm, variables, port, mix = calibrated
    x = jnp.asarray(mix)
    want = np.asarray(jax.jit(jm.apply).lower(variables, x).compile(compiler_options=ALGSIMP_OFF)(variables, x))
    lstm.reset_launches()
    got = _forward(port, mix)
    assert set(lstm.LAUNCHES.values()) == {0}  # CPU tensors: the plain recurrence
    assert got.shape == want.shape == (2, 2, 600)
    snr = _snr_db(want, got)
    assert (snr >= 20).all(), f"port vs JAX SNR {snr} dB < 20 dB"


def test_quantizer_sites_equal_jax_scopes(calibrated):
    _, variables, port, _ = calibrated
    leaves = jax.tree_util.tree_flatten_with_path(variables["qparams"])[0]
    scopes = {tuple(k.key for k in path[:-1]) for path, _ in leaves}
    jax_weight = sum(s[-1].startswith("weight_fake_quantize") or s[-1].startswith("wq_") for s in scopes)
    # row and col: 2 MHA + 4 LSTM + 1 linear each; BN, out_conv, output, output_gate, encoder, mask, decoder
    # and its residual encoder
    assert sum(isinstance(m, WeightQuantizer) for m in port.modules()) == jax_weight == 2 * 7 + 8
    assert sum(isinstance(m, ActQuantizer) for m in port.modules()) == len(scopes) - jax_weight


def test_every_quantizer_input_is_contiguous(calibrated):
    """The CUDA kernels take contiguous tensors only: hold every call site to that on the CPU."""
    *_, port, mix = calibrated
    model = DPTNet(q=QuantSpec(observer=True, **SPEC), **ARCH)
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
    np.testing.assert_array_equal(_forward(folded, mix), _forward(port, mix))


# The int8 engine against JAX's, per compute dtype: (minimum SNR in dB per output, largest share of samples
# more than half an output step apart, largest mean |difference| in output steps). Both dtypes read
# 112.9-117.1 dB with no sample half a step apart (scripts/dptnet_int8_vs_jax.py); one flipped sample would
# read about 35 dB. Faulty engines read at most 25.3 dB with at least 0.022 of samples a step apart: the
# activations or the weights of the bf16 products left unrounded, row_0's in-projection taken as on the grid,
# the gates' tanh and sigmoid swapped (a mutation check outside the repository).
JAX_BOUND = {"float32": (30.0, 5e-3, 5e-3), "bfloat16": (30.0, 5e-3, 5e-3)}


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_int8_engine_matches_the_jax_engine(calibrated, compute_dtype):
    jm, variables, port, mix = calibrated
    engine = JaxEngine(jm, variables, compute_dtype=compute_dtype)
    x = jnp.asarray(mix)
    want = np.asarray(jax.jit(engine._forward).lower(x).compile(compiler_options=ALGSIMP_OFF)(x))
    im.reset_launches()
    got = DPTNetInt8Engine(port, compute_dtype=compute_dtype)(torch.from_numpy(mix)).numpy()
    assert im.LAUNCHES == {"int8_mm": 0}  # CPU tensors: the plain version
    assert got.shape == want.shape == (2, 2, 600)
    snr_min, share_max, mean_max = JAX_BOUND[compute_dtype]
    snr, diff = _snr_db(want, got), np.abs(got - want) / _out_lsb(port)
    assert (snr >= snr_min).all(), snr
    assert (diff > 0.5).mean() <= share_max, (diff > 0.5).mean()
    assert diff.mean() <= mean_max, diff.mean()


def test_int8_engine_agrees_with_the_fake_quant_forward(calibrated):
    *_, port, mix = calibrated
    ref, lsb, x = _forward(port, mix), _out_lsb(port), torch.from_numpy(mix)
    diff = np.abs(make_int8_engine(port, compute_dtype="float32")(x).numpy() - ref) / lsb
    assert diff.max() <= 10 and diff.mean() <= 1.5, (diff.max(), diff.mean())
    diff = np.abs(make_int8_engine(port)(x).numpy() - ref) / lsb  # bfloat16 operands for the float products
    assert diff.mean() <= 2, diff.mean()


@pytest.mark.parametrize("nl,fn", [("tanh", jnp.tanh), ("sigmoid", jax.nn.sigmoid)])
def test_k4_epilogues_equal_the_jax_engines_gate_arithmetic(nl, fn):
    """K4's tanh/sigmoid epilogue (plain version) against the JAX engine's requant(nl(int8_matmul(...)))."""
    from fqss_tpu.serve import common as jax_common

    from fqss_tpu_torch.serve import common

    rng = np.random.default_rng(4)
    g_in, g_out = common.Grid(np.float32(2.0**-7), np.float32(-1.0)), common.Grid(np.float32(2.0**-7), np.float32(-1.0))
    x = rng.uniform(-1, 1, (300, 16)).astype(np.float32)
    kernel = (rng.standard_normal((1, 16, 24)) * 0.3).astype(np.float32)  # JAX (k, K, N)
    wq = {"min_range": kernel.min(axis=(0, 1)), "max_range": kernel.max(axis=(0, 1))}
    bias = (rng.standard_normal(24) * 0.1).astype(np.float32)
    jg_in, jg_out = (jax_common.Grid(delta=g.delta, mn=g.mn) for g in (g_in, g_out))
    want = jax_common.requant(fn(jax_common.int8_matmul(jax_common.requant(jnp.asarray(x), jg_in),
                                                        jax_common.int8_weight(kernel, wq, bias))), jg_out)
    w8 = common.int8_weight(torch.from_numpy(kernel[0].T.copy()), wq["min_range"], wq["max_range"],
                            torch.from_numpy(bias))
    got = common.Int8Site(g_in, w8, g_out, 1.0, torch.device("cpu"), nl)(common.requant(torch.from_numpy(x), g_in))
    diff = np.abs(got.Xs.numpy().astype(int) - np.asarray(want.Xs).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("spec,error", [
    (dict(qat=True, out_quant=True, n_combiner=3), NotImplementedError),
    (dict(qat=True, out_quant=True, act_n_bits=6), NotImplementedError),
    (dict(qat=False), ValueError),
])
def test_int8_engine_refuses_what_the_jax_engine_refuses(spec, error):
    with pytest.raises(error):
        DPTNetInt8Engine(DPTNet(q=QuantSpec(**spec), **ARCH))


TINY_CFG = """
model_cfg:
  name: DPTNet
  model_path: {model_path}
  n_src: 2
  kernel_size: 2
  enc_dim: 16
  feature_dim: 8
  hidden_dim: 16
  layer: 1
  segment_size: 20
  quantization: {{qat: True, out_quant: True, n_splitter: 2, n_combiner: 2, observer: True}}
testing_cfg: {{segment_samples: 1000, overlap: 0.25}}
"""


@pytest.mark.parametrize("engine", ["fake_quant", "folded", "int8"])
def test_infer_cli_serves_dptnet_on_cpu(calibrated, tmp_path, engine):
    from fqss_tpu_torch import infer

    *_, port, _ = calibrated
    torch.save(port.state_dict(), tmp_path / "dptnet.pt")
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY_CFG.format(model_path=tmp_path / "dptnet.pt"))
    mix, _ = synth_batch(np.random.default_rng(1), 1, 2, 2600)
    save_audio(str(tmp_path / "mixture.wav"), mix[0], 8000)
    infer.main(["-y", str(cfg), "-a", str(tmp_path / "mixture.wav"), "-o", str(tmp_path / "out"), "--engine", engine,
                "--device", "cpu"])
    for s in (1, 2):
        audio, fs = read_audio(str(tmp_path / "out" / f"source_{s}.wav"))
        assert fs == 8000 and audio.shape == (1, 2600) and np.isfinite(audio).all()


def test_factory_builds_and_loads_dptnet(calibrated, tmp_path):
    from fqss_tpu_torch.models.factory import MODEL_NAMES, create_model, create_model_and_teacher, \
        create_pretrained_model

    *_, port, mix = calibrated
    assert "DPTNet" in MODEL_NAMES
    cfg = {"name": "DPTNet", "n_src": 2, "kernel_size": 2, "model_path": str(tmp_path / "dptnet.pt"),
           **{k: v for k, v in ARCH.items() if k not in ("n_srcs", "kernel_size")},
           "quantization": {**SPEC, "observer": True}}
    torch.save(port.state_dict(), cfg["model_path"])
    loaded = create_pretrained_model(cfg, observer=False)
    assert isinstance(loaded, DPTNet) and loaded.q.observer is False and not loaded.training
    np.testing.assert_array_equal(_forward(loaded, mix), _forward(port, mix))
    full = create_model({"name": "DPTNet", "n_src": 2, "kernel_size": 2, "quantization": {"qat": True}})
    assert (full.enc_dim, full.feature_dim, full.hidden_dim, full.layer) == (256, 64, 128, 6)
    student, teacher = create_model_and_teacher(cfg)
    assert student.q.qat and not teacher.q.qat and isinstance(teacher, DPTNet)
