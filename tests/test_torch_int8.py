"""The port's int8 serving slice against the JAX package: K4's plain version, ``serve/common.py`` and the engine.

* K4: ``int8_matmul_requant_ref`` against ``int8_matmul_requant_pallas`` in
  interpret mode on seeded numpy inputs with planted half-step ties. Both
  take the exact int32 product and the same float32 epilogue: bitwise equal.
* ``serve/common.py``: the host-side constants bitwise, ``requant`` bitwise,
  ``int8_matmul`` within 1e-6.
* The engine against JAX's ``ConvTasNetInt8Engine(use_pallas=True)`` run
  eagerly (``jax.disable_jit()``, its Pallas kernel in interpret mode) on the
  calibrated tiny model of ``tests/test_serve_int8.py``, in both compute
  dtypes (``JAX_BOUND``). A jitted engine is no steady reference: XLA's CPU
  compile flips a requantization tie that eager does not, on some hosts.
  Against the port's own fake-quant forward: f32 max <= 10 and mean <= 1.5
  steps, bf16 mean <= 2 steps (``tests/test_serve_int8.py:114-138``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from fqss_tpu.data import synth_batch
from fqss_tpu.models import ConvTasNet as JaxConvTasNet
from fqss_tpu.ops.pallas_quant import int8_matmul_requant_pallas
from fqss_tpu.quant import QuantSpec as JaxQuantSpec
from fqss_tpu.quant.calibration import run_observer
from fqss_tpu.serve import common as jax_common
from fqss_tpu.serve.convtasnet_int8 import ConvTasNetInt8Engine as JaxEngine
from fqss_tpu_torch.models.convert import convtasnet_from_jax
from fqss_tpu_torch.models.convtasnet import ConvTasNet
from fqss_tpu_torch.ops import int8_matmul as im
from fqss_tpu_torch.quant.spec import QuantSpec
from fqss_tpu_torch.serve import ConvTasNetInt8Engine, common, make_int8_engine
from fqss_tpu_torch.utils.audio import read_audio, save_audio

torch.set_num_threads(1)

ARCH = dict(n_srcs=2, kernel_size=16, stride=8, n_filters=64, bn_chan=24, hid_chan=48, n_blocks=3, n_repeats=2)
FQSS = dict(qat=True, n_splitter=2, n_combiner=2, out_quant=True)


# ---------------------------------------------------------------------------
# K4: the plain version against the Pallas kernel
# ---------------------------------------------------------------------------


def _k4_inputs(m, k, n, seed):
    """Random operands; the first 8 columns carry exact half-step ties of the out grid (delta 2^-6, mn -2)."""
    rng = np.random.default_rng(seed)
    xs = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (n, k)).astype(np.int8)  # [N, K]: the port's layout
    scale = (rng.uniform(0.5, 2.0, n) * 1e-4).astype(np.float32)
    corr = rng.normal(size=n).astype(np.float32) * 0.5
    delta, mn = np.float32(2.0**-6), np.float32(-2.0)
    ties = min(8, n)
    w[:ties] = 0
    w[np.arange(ties), np.arange(ties) % k] = 1  # acc = one activation, in [-128, 127]
    scale[:ties] = delta
    corr[:ties] = delta / 2  # (v - mn) / delta = acc + 128.5
    return xs, w, scale, corr, delta, mn


@pytest.mark.parametrize("alpha", [1.0, 0.25, 0.0])
@pytest.mark.parametrize("m,k,n", [(70, 48, 40), (1, 8, 8), (257, 128, 130)])
def test_k4_plain_version_equals_the_pallas_kernel(m, k, n, alpha):
    xs, w, scale, corr, delta, mn = _k4_inputs(m, k, n, m * k + n)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(int8_matmul_requant_pallas(
            jnp.asarray(xs), jnp.asarray(w.T), jnp.asarray(scale), jnp.asarray(corr), jnp.float32(alpha),
            jnp.float32(delta), jnp.float32(mn), interpret=True))
    got = im.int8_matmul_requant(*map(torch.from_numpy, (xs, w, scale, corr)), alpha, float(delta), float(mn))
    assert got.dtype == torch.int8 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)
    # the planted ties round half to even: acc + 128.5 -> the even neighbour (before the PReLU bends them)
    if alpha == 1.0:
        X = np.clip(np.round(xs[:, np.arange(min(8, n)) % k].astype(np.float32) + 128.5), 0, 255)
        np.testing.assert_array_equal(got.numpy()[:, : min(8, n)], (X - 128).astype(np.int8))


def test_k4_wrapper_takes_the_plain_version_on_the_cpu_and_counts_no_launch():
    xs, w, scale, corr, delta, mn = _k4_inputs(5, 16, 8, 0)
    args = (*map(torch.from_numpy, (xs, w, scale, corr)), 0.25, float(delta), float(mn))
    im.reset_launches()
    assert torch.equal(im.int8_matmul_requant(*args), im.int8_matmul_requant_ref(*args))
    assert im.LAUNCHES == {"int8_mm": 0}


# ---------------------------------------------------------------------------
# serve/common.py against fqss_tpu/serve/common.py
# ---------------------------------------------------------------------------


def test_host_constants_equal_the_jax_packages():
    rng = np.random.default_rng(1)
    qp = {"min_range": np.float32([-1.37]), "max_range": np.float32([2.11])}
    g, want_g = common.act_grid(qp["min_range"], qp["max_range"]), jax_common.act_grid(qp)
    assert g.delta == want_g.delta and g.mn == want_g.mn and g.delta.dtype == np.float32

    kernel = rng.normal(size=(1, 48, 56)).astype(np.float32) * 0.2  # JAX (k, K, N)
    wq = {"min_range": kernel.min(axis=(0, 1), keepdims=True), "max_range": kernel.max(axis=(0, 1), keepdims=True)}
    wq["max_range"][..., :5] = 0.0  # a zero-range channel takes the safe step
    wq["min_range"][..., :5] = 0.0
    bias = rng.normal(size=56).astype(np.float32)
    want = jax_common.int8_weight(kernel, wq, bias)
    port_w = torch.from_numpy(kernel.transpose(2, 1, 0).copy())  # [N, K, 1]
    got = common.int8_weight(port_w, wq["min_range"].transpose(2, 1, 0), wq["max_range"].transpose(2, 1, 0),
                             torch.from_numpy(bias))
    np.testing.assert_array_equal(got.w_int, want.w_int.T)
    np.testing.assert_array_equal(got.scale, want.scale)
    np.testing.assert_array_equal(got.sum_w, want.sum_w)
    np.testing.assert_array_equal(got.bias, want.bias)

    dw = rng.normal(size=(3, 1, 48)).astype(np.float32)  # a depthwise kernel (k, 1, C)
    dwq = {"min_range": dw.min(axis=(0, 1), keepdims=True), "max_range": dw.max(axis=(0, 1), keepdims=True)}
    np.testing.assert_array_equal(
        common.dequant_weight(dw.transpose(2, 1, 0), *(dwq[k].transpose(2, 1, 0) for k in ("min_range", "max_range"))),
        jax_common.dequant_weight(dw, dwq, ch_axis=2).transpose(2, 1, 0))


def test_requant_and_int8_matmul_equal_the_jax_packages():
    rng = np.random.default_rng(2)
    g = common.Grid(delta=np.float32(2.0**-7), mn=np.float32(-1.0))
    jg = jax_common.Grid(delta=g.delta, mn=g.mn)
    x = rng.normal(size=(3, 50, 20)).astype(np.float32)
    x[0, :40] = g.mn + (np.arange(-260, 260, 13)[:, None] + 0.5) * g.delta  # half-step ties, some outside
    for arr in (x, np.float32(1.7) * x):
        got = common.requant(torch.from_numpy(arr), g)
        want = jax_common.requant(jnp.asarray(arr), jg)
        np.testing.assert_array_equal(got.Xs.numpy(), np.asarray(want.Xs))
        np.testing.assert_array_equal(got.f32.numpy(), np.asarray(want.f32))

    kernel = rng.normal(size=(1, 20, 12)).astype(np.float32) * 0.3
    wq = {"min_range": kernel.min(axis=(0, 1)), "max_range": kernel.max(axis=(0, 1))}
    bias = rng.normal(size=12).astype(np.float32) * 0.1
    want = np.asarray(jax_common.int8_matmul(jax_common.requant(jnp.asarray(x), jg),
                                             jax_common.int8_weight(kernel, wq, bias)))
    got = common.int8_matmul(common.requant(torch.from_numpy(x), g),
                             common.int8_weight(torch.from_numpy(kernel[0].T.copy()), wq["min_range"], wq["max_range"],
                                                torch.from_numpy(bias)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def _prune(tree: dict, spec: dict) -> dict:
    """The variables of the FQSS model cut to a spec with fewer decoder parts (the engines read no other)."""
    tree = {c: dict(v) for c, v in tree.items()}
    for c in tree:
        dec = tree[c]["decoder"] = dict(tree[c].get("decoder", {}))
        if spec["n_combiner"] == 1:
            dec.pop("residual_error_block", None)
            dec.pop("activation_fake_quantize_residual", None)
        if not spec["out_quant"]:
            dec.pop("activation_fake_quantize", None)
            dec.pop("activation_fake_quantize_residual", None)
    return tree


def _models(variables: dict, spec: dict, mask_act: str = "relu"):
    """(JAX eval model, its variables, port model) for ``spec``, from the FQSS model's variables."""
    variables = _prune(variables, spec)
    jm = JaxConvTasNet(q=JaxQuantSpec(observer=False, **spec), mask_act=mask_act, **ARCH)
    port = ConvTasNet(q=QuantSpec(observer=False, **spec), mask_act=mask_act, **ARCH)
    port.load_state_dict(convtasnet_from_jax(variables), strict=True)
    return jm, variables, port.eval()


def _jax_engine_forward(jm, variables, mix, compute_dtype="float32"):
    engine = JaxEngine(jm, variables, compute_dtype=compute_dtype, use_pallas=True)
    with pltpu.force_tpu_interpret_mode(), jax.disable_jit():
        return np.asarray(engine._forward(jnp.asarray(mix)))


def _out_lsb(port: ConvTasNet) -> float:
    aq = port.decoder.activation_fake_quantize
    return float(aq.max_range.detach() - aq.min_range.detach()) / 255.0


def _snr_db(ref, est):
    return 10 * np.log10(np.sum(ref**2, -1) / np.maximum(np.sum((ref - est) ** 2, -1), 1e-30))


# The engine against JAX's eager engine, per compute dtype: (minimum SNR in dB per output, largest share of
# samples more than half an output step apart, largest mean |difference| in output steps). On the tiny model
# float32 reads 317.3-320.6 dB (the variants included) with no sample half a step apart; bfloat16 reads
# 46.4/46.7 dB on the first mixture and 319.6/320.0 on the second, with 0.0094 of the samples one step apart
# and a mean of 0.010 steps; its n_combiner=1 variant 317.3/318.0 dB. The bf16 difference starts at one output
# of the second block's residual conv: XLA's CPU compile of the Pallas K4 contracts acc * scale + corr into one
# fused multiply-add, the port rounds the product and the sum apart, and that value lies an ulp from a half
# step of its grid (149.49998 against 149.5 steps), so it rounds the other way and the flip cascades. The jitted engine (algsimp off) sits 39.3-50.4 dB from eager JAX in float32 on some
# hosts. A bf16 engine that rounds the conv outputs to bf16, leaves the weights or the activations unrounded,
# or computes in float32 reads about 28 dB, 0.6 and 0.73-0.87.
JAX_BOUND = {"float32": (100.0, 1e-3, 1e-3), "bfloat16": (40.0, 1e-2, 2e-2)}


def _assert_matches_jax(want, got, lsb, compute_dtype):
    snr_min, share_max, mean_max = JAX_BOUND[compute_dtype]
    snr, diff = _snr_db(want, got), np.abs(got - want) / lsb
    assert (snr >= snr_min).all(), snr
    assert (diff > 0.5).mean() <= share_max, (diff > 0.5).mean()
    assert diff.mean() <= mean_max, diff.mean()


@pytest.fixture(scope="module")
def calibrated():
    """(calibrated JAX variables of the FQSS model, mixtures [2, 4000])."""
    mix, _ = synth_batch(np.random.default_rng(3), 2, 2, 4000)
    obs = JaxConvTasNet(q=JaxQuantSpec(observer=True, **FQSS), **ARCH)
    variables = jax.jit(obs.init)(jax.random.PRNGKey(3), jnp.asarray(mix))  # eager init compiles op by op
    return jax.device_get(run_observer(obs, variables, jnp.asarray(mix), steps=4)), mix


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_engine_matches_the_jax_engine(calibrated, compute_dtype):
    variables, mix = calibrated
    jm, variables, port = _models(variables, FQSS)
    want = _jax_engine_forward(jm, variables, mix, compute_dtype)
    im.reset_launches()
    got = ConvTasNetInt8Engine(port, compute_dtype=compute_dtype)(torch.from_numpy(mix)).numpy()
    assert im.LAUNCHES == {"int8_mm": 0}  # CPU tensors: the plain version
    assert got.shape == want.shape == (2, 2, 4000)
    _assert_matches_jax(want, got, _out_lsb(port), compute_dtype)


def test_engine_agrees_with_the_fake_quant_forward(calibrated):
    variables, mix = calibrated
    port = _models(variables, FQSS)[2]
    x = torch.from_numpy(mix)
    with torch.no_grad():
        ref = port(x).numpy()
    lsb = _out_lsb(port)
    diff = np.abs(make_int8_engine(port, compute_dtype="float32")(x).numpy() - ref)
    assert diff.max() <= 10 * lsb and diff.mean() <= 1.5 * lsb, (diff.max() / lsb, diff.mean() / lsb)
    diff = np.abs(make_int8_engine(port)(x).numpy() - ref)  # bfloat16 operands for the float convs
    assert diff.mean() <= 2 * lsb, diff.mean() / lsb


def test_engine_decodes_the_residual_plane_with_the_trained_residual_decoder():
    """With ``train_res_dec`` the combiner's residual plane is decoded by its own trained weight, as JAX's engine
    does (``res_dec_kernel``); the shared decoder weight there would read far below JAX_BOUND."""
    from fqss_tpu_torch.serve.fold import fold_quantized_weights

    spec = dict(FQSS, train_res_dec=True)
    arch = dict(ARCH, n_blocks=2, n_repeats=1)
    mix, _ = synth_batch(np.random.default_rng(4), 1, 2, 2400)
    obs = JaxConvTasNet(q=JaxQuantSpec(observer=True, **spec), **arch)
    variables = jax.jit(obs.init)(jax.random.PRNGKey(4), jnp.asarray(mix))
    variables = jax.device_get(run_observer(obs, variables, jnp.asarray(mix), steps=4))
    assert "residual_decoder_kernel" in variables["params"]["decoder"]["residual_error_block"]
    jm = JaxConvTasNet(q=JaxQuantSpec(observer=False, **spec), **arch)
    port = ConvTasNet(q=QuantSpec(observer=False, **spec), **arch)
    port.load_state_dict(convtasnet_from_jax(variables), strict=True)
    port.eval()
    want = _jax_engine_forward(jm, variables, mix, "float32")
    got = ConvTasNetInt8Engine(port, compute_dtype="float32")(torch.from_numpy(mix)).numpy()
    assert got.shape == want.shape == (1, 2, 2400)
    _assert_matches_jax(want, got, _out_lsb(port), "float32")
    x = torch.from_numpy(mix)
    with torch.no_grad():
        assert torch.equal(fold_quantized_weights(port)(x), port(x))


@pytest.mark.parametrize("spec,mask_act,compute_dtype", [
    (dict(FQSS, n_combiner=1), "relu", "float32"),
    (dict(FQSS, n_combiner=1), "relu", "bfloat16"),
    (dict(FQSS, out_quant=False), "relu", "float32"),
    (FQSS, "sigmoid", "float32"),
])
def test_engine_variants_match_the_jax_engine(calibrated, spec, mask_act, compute_dtype):
    variables, mix = calibrated
    jm, pruned, port = _models(variables, spec, mask_act)
    want = _jax_engine_forward(jm, pruned, mix[:1, :2400], compute_dtype)
    got = ConvTasNetInt8Engine(port, compute_dtype=compute_dtype)(torch.from_numpy(mix[:1, :2400])).numpy()
    assert got.shape == want.shape
    # without out_quant the differences are measured in the FQSS model's output steps
    _assert_matches_jax(want, got, _out_lsb(port if spec["out_quant"] else _models(variables, FQSS)[2]),
                        compute_dtype)


@pytest.mark.parametrize("spec,error", [
    (dict(qat=True, out_quant=True, in_quant=True, in_act_n_bits=16), NotImplementedError),
    (dict(qat=True, out_quant=True, n_combiner=3), NotImplementedError),
    (dict(qat=True, out_quant=True, weight_n_bits=4), NotImplementedError),
    (dict(qat=False), ValueError),
])
def test_engine_refuses_what_the_jax_engine_refuses(spec, error):
    port = ConvTasNet(q=QuantSpec(**spec), **ARCH)
    with pytest.raises(error):
        ConvTasNetInt8Engine(port)


def test_engine_refuses_a_mask_it_cannot_serve():
    port = ConvTasNet(q=QuantSpec(**FQSS), mask_act="prelu", **ARCH)
    with pytest.raises(NotImplementedError, match="mask"):
        ConvTasNetInt8Engine(port)
    with pytest.raises(NotImplementedError, match="no int8 engine"):
        make_int8_engine(torch.nn.Linear(2, 2))


TINY_CFG = """
model_cfg:
  name: ConvTasNet
  model_path: null
  n_src: 2
  kernel_size: 16
  stride: 8
  n_filters: 32
  bn_chan: 8
  hid_chan: 16
  n_blocks: 2
  n_repeats: 1
  quantization: {qat: True, out_quant: True, n_splitter: 2, n_combiner: 2, observer: True}
testing_cfg: {segment_samples: 2000, overlap: 0.25}
"""


def test_infer_cli_int8_engine_on_cpu(tmp_path):
    from fqss_tpu_torch import infer

    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY_CFG)
    mix, _ = synth_batch(np.random.default_rng(0), 1, 2, 5000)
    save_audio(str(tmp_path / "mixture.wav"), mix[0], 8000)
    infer.main(["-y", str(cfg), "-a", str(tmp_path / "mixture.wav"), "-o", str(tmp_path / "out"), "--engine", "int8",
                "--device", "cpu"])
    for s in (1, 2):
        audio, fs = read_audio(str(tmp_path / "out" / f"source_{s}.wav"))
        assert fs == 8000 and audio.shape == (1, 5000) and np.isfinite(audio).all()


def test_k4_wrapper_holds_cpu_callers_to_what_the_kernel_takes():
    xs, w, scale, corr, delta, mn = _k4_inputs(6, 16, 8, 1)
    xs, w, scale, corr = map(torch.from_numpy, (xs, w, scale, corr))
    with pytest.raises(ValueError, match="contiguous"):
        im.int8_matmul_requant(xs.t().contiguous().t(), w, scale, corr, 1.0, float(delta), float(mn))
    with pytest.raises(TypeError):
        im.int8_matmul_requant(xs.float(), w, scale, corr, 1.0, float(delta), float(mn))
    with pytest.raises(ValueError):
        im.int8_matmul_requant(xs, w[:, :8].contiguous(), scale, corr, 1.0, float(delta), float(mn))
