"""bf16 compute (``QuantSpec.compute_dtype="bfloat16"``) on the port's serving path against the JAX package.

JAX rounds the operands of every product to bfloat16 and sums in float32
(``mxu_operands`` and ``preferred_element_type=float32``); the port rounds
the same operands (``nn/layers.py:mxu_operands``; K5, K3 and K8 on their bf16
routes, whose plain versions run here) and sums in float32. The products of
two bf16 values are exact in float32, so the two differ only in the order of
their float32 sums (and in XLA's exp and reciprocal by an ulp), which can
move a value across a rounding tie of the next grid or of the next bf16
rounding.

* the rounding itself bitwise equals ``astype(bfloat16)``;
* the plain bf16 versions of K5, K3 and K8 against JAX's composition: float
  outputs within 1e-5 of the sum of their terms' magnitudes (K8: rows where a
  softmax weight lies within 2 float32 ulps of a bf16 tie also within one bf16
  step of ``p |v|`` of those weights), outputs on a grid within one step, at
  most 1% of them more than half a step apart;
* each layer against JAX under that layer rule (jitted with XLA's algebraic
  simplifier off, which keeps eager JAX's divisions; the float attention
  within one bf16 step of its magnitude);
* ConvTasNet (n_splitter = n_combiner = 2, out_quant), DPTNet and the
  Sepformer, tiny and calibrated in JAX in bf16, against jitted JAX: SNR >= 20
  dB per output; folded ``torch.equal`` to fake_quant;
* a bf16 forward that needs a gradient raises ``NotImplementedError``;
* bf16 training has no reference: on the tiny ConvTasNet, DPTNet and
  Sepformer of the training tests, ``jax.grad`` of JAX's bf16 student raises
  (the VJP of a bf16 convolution with a float32 result), JAX's step with
  ``teacher_dtype="bfloat16"`` raises (the teacher's second convolution), and
  the port's bf16 KD step raises its refusal. These stand until JAX can take
  them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fqss_tpu.data import synth_batch
from fqss_tpu.models.convtasnet import ConvTasNet as JaxConvTasNet
from fqss_tpu.models.dptnet import DPTNet as JaxDPTNet
from fqss_tpu.models.sepformer import Sepformer as JaxSepformer
from fqss_tpu.nn import QConv1d as JaxQConv1d
from fqss_tpu.nn import QConvTr1dDecoder as JaxQConvTr1dDecoder
from fqss_tpu.nn import QDense as JaxQDense
from fqss_tpu.nn import QLinearDecoder as JaxQLinearDecoder
from fqss_tpu.nn.attention import QMultiheadAttention as JaxQMultiheadAttention
from fqss_tpu.nn.lstm import QLSTM as JaxQLSTM
from fqss_tpu.quant import QuantSpec as JaxQuantSpec
from fqss_tpu.quant.calibration import run_observer
from fqss_tpu.quant.fake_quant import linear_fake_quant as jax_linear_fake_quant
from fqss_tpu_torch.models.convert import convtasnet_from_jax, dptnet_from_jax, sepformer_from_jax
from fqss_tpu_torch.models.convtasnet import ConvTasNet
from fqss_tpu_torch.models.dptnet import DPTNet
from fqss_tpu_torch.models.sepformer import Sepformer
from fqss_tpu_torch.nn.attention import QMultiheadAttention
from fqss_tpu_torch.nn.io_layers import QConvTr1dDecoder, QLinearDecoder
from fqss_tpu_torch.nn.layers import QConv1d, QDense
from fqss_tpu_torch.nn.lstm import QLSTM
from fqss_tpu_torch.ops import attention as k8
from fqss_tpu_torch.ops import qat_dense as qd
from fqss_tpu_torch.ops import qmatmul as qm
from fqss_tpu_torch.quant.fake_quant import bf16_round
from fqss_tpu_torch.quant.spec import QuantSpec
from fqss_tpu_torch.serve.fold import fold_quantized_weights
from fqss_tpu_torch.train.state import TrainState
from fqss_tpu_torch.train.trainer import TrainConfig, make_optimizer, make_train_step

torch.set_num_threads(1)

ALGSIMP_OFF = {"xla_disable_hlo_passes": "algsimp"}
BF16 = dict(compute_dtype="bfloat16")
SPEC = dict(qat=True, n_splitter=2, n_combiner=2, out_quant=True, max_observations=2, **BF16)
FLOAT_RTOL = 1e-5  # a float output against the sum of its terms' magnitudes


def _input(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_bf16(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _snr_db(ref, est):
    return 10 * np.log10(np.sum(ref**2, -1) / np.maximum(np.sum((ref - est) ** 2, -1), 1e-30))


def _assert_within_one_lsb(got, want, lsb):
    diff = np.abs(got - want)
    assert diff.max() <= lsb * (1 + 1e-4), f"max diff {diff.max()} > 1 LSB {lsb}"
    assert np.mean(diff > 0.5 * lsb) <= 0.01, f"{np.mean(diff > 0.5 * lsb):.4f} of outputs moved by a grid step"


def _assert_float_close(got, want, terms):
    """Float outputs within FLOAT_RTOL of the sum of their terms' magnitudes (``terms``, same shape)."""
    excess = np.abs(got - want) - FLOAT_RTOL * terms
    assert excess.max() <= 0, f"{np.mean(excess > 0):.4f} of outputs beyond {FLOAT_RTOL} of sum |term|"


# ---------------------------------------------------------------------------
# The rounding
# ---------------------------------------------------------------------------


def test_bf16_round_bitwise_equals_jax_astype():
    tiny = np.finfo(np.float32).tiny
    special = np.float32([
        0.0, -0.0, np.inf, -np.inf, 1.0, -1.0,
        1.00390625, 1.01171875, -1.00390625, -1.01171875,  # ties: to even, down and up
        1.0039063, 1.0039062, 3.0e38, -3.0e38, np.finfo(np.float32).max,  # next to a tie; overflow to inf
        tiny, -tiny, tiny / 3, -tiny / 7, tiny * 2**-20, 1e-45,  # smallest normal, subnormals
    ])
    bits = np.random.default_rng(0).integers(0, 2**32, 20000, dtype=np.uint64).astype(np.uint32)
    rand = bits.view(np.float32)
    x = np.concatenate([special, rand[np.isfinite(rand)]])
    got = bf16_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(_jax_bf16(x)))
    nan = bf16_round(torch.tensor([float("nan")]))
    assert torch.isnan(nan).all()


# ---------------------------------------------------------------------------
# The plain versions of K5, K3 and K8 against JAX's composition
# ---------------------------------------------------------------------------


def _grids(n, seed):
    """Per-channel weight ranges [n] and an output range, as numpy float32."""
    rng = np.random.default_rng(seed)
    w_mx = rng.uniform(0.3, 0.6, n).astype(np.float32)
    return -w_mx, w_mx, np.float32([-2.5]), np.float32([3.1])


def _jax_weight_grid(w, mn, mx):  # w [N, K], one grid per row
    return jax_linear_fake_quant(jnp.asarray(w), jnp.asarray(mn)[:, None], jnp.asarray(mx)[:, None], 8, True, True)


def _jax_act_grid(y, mn, mx):
    return np.asarray(jax_linear_fake_quant(jnp.asarray(y), jnp.asarray(mn), jnp.asarray(mx), 8, False, False))


def _jax_dot_bf16(a, b):
    return jnp.dot(jnp.asarray(a).astype(jnp.bfloat16), jnp.asarray(b).astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32)


@pytest.mark.parametrize("w_grid", [True, False], ids=["wgrid", "nowgrid"])
@pytest.mark.parametrize("a_grid", [True, False], ids=["agrid", "noagrid"])
def test_k5_plain_bf16_matches_jax_composition(w_grid, a_grid):
    M, K, N = 37, 300, 24
    x, w, b = _input((M, K), 1), _input((N, K), 2) * 0.2, _input((N,), 3) * 0.1
    w_mn, w_mx, a_mn, a_mx = _grids(N, 4)
    wq = _jax_weight_grid(w, w_mn, w_mx) if w_grid else jnp.asarray(w)
    pre = np.asarray(_jax_dot_bf16(x, wq.T)) + b
    args = [torch.from_numpy(t) for t in (x, w, b)]
    grids = dict(w_mn=torch.from_numpy(w_mn), w_mx=torch.from_numpy(w_mx)) if w_grid else {}
    if a_grid:
        grids.update(a_mn=torch.from_numpy(a_mn), a_mx=torch.from_numpy(a_mx))
    qd.reset_launches()
    got = qd.qat_dense(*args, **grids, bf16=True).numpy()
    assert qd.LAUNCHES == {k: 0 for k in qd.LAUNCHES}  # CPU tensors: the plain version
    if a_grid:
        _assert_within_one_lsb(got, _jax_act_grid(pre, a_mn, a_mx), float(a_mx[0] - a_mn[0]) / 255)
    else:
        terms = np.abs(_jax_bf16(x)) @ np.abs(_jax_bf16(np.asarray(wq))).T + np.abs(b)
        _assert_float_close(got, pre, terms)


@pytest.mark.parametrize("w_grid", [True, False], ids=["wgrid", "nowgrid"])
@pytest.mark.parametrize("a_grid", [True, False], ids=["agrid", "noagrid"])
def test_k3_plain_bf16_matches_jax_composition(w_grid, a_grid):
    B, K, T, N = 2, 130, 45, 20
    x, w = _input((B, K, T), 5), _input((N, K), 6) * 0.2
    w_mn, w_mx, a_mn, a_mx = _grids(N, 7)
    wq = _jax_weight_grid(w, w_mn, w_mx) if w_grid else jnp.asarray(w)
    # JAX's layout: x [B T, K] @ wq^T [K, N]
    x_rows = np.swapaxes(x, 1, 2).reshape(B * T, K)
    pre = np.swapaxes(np.asarray(_jax_dot_bf16(x_rows, wq.T)).reshape(B, T, N), 1, 2)
    grids = dict(w_mn=torch.from_numpy(w_mn), w_mx=torch.from_numpy(w_mx)) if w_grid else {}
    if a_grid:
        grids.update(a_mn=torch.from_numpy(a_mn), a_mx=torch.from_numpy(a_mx))
    qm.reset_launches()
    got = qm.qmatmul(torch.from_numpy(x), torch.from_numpy(w), **grids, bf16=True).numpy()
    assert qm.LAUNCHES == {"qmatmul": 0, "qmatmul_bf16": 0}
    if a_grid:
        _assert_within_one_lsb(got, _jax_act_grid(pre, a_mn, a_mx), float(a_mx[0] - a_mn[0]) / 255)
    else:
        terms = np.abs(_jax_bf16(np.asarray(wq))) @ np.abs(_jax_bf16(x))
        _assert_float_close(got, pre, terms)


def _jax_attention_bf16(qs, k, v):
    """JAX's default attention composition under bf16 (``fqss_tpu/nn/attention.py:117-130``): the heads and the
    softmax weights."""
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    attn = jnp.einsum("bqd,bkd->bqk", bf(qs), bf(k), preferred_element_type=jnp.float32)
    p = jax.nn.softmax(attn, axis=-1)
    heads = jnp.einsum("bqk,bkd->bqd", p.astype(jnp.bfloat16), bf(v), preferred_element_type=jnp.float32)
    return np.asarray(heads), np.asarray(p)


def test_bf16_tie_mask_marks_weights_near_a_bf16_tie():
    p = np.float32([1.00390625, 0.5, 0.75])
    p_bits = _bits(p).copy()
    p_bits[1] = (p_bits[1] & 0xFFFF0000) | 0x8002  # two ulps above a tie
    p_bits[2] = (p_bits[2] & 0xFFFF0000) | 0x8003  # three
    mask = k8.bf16_tie_mask(torch.from_numpy(p_bits.view(np.float32)))
    assert mask.tolist() == [True, True, False]


@pytest.mark.parametrize("quantize", [True, False], ids=["grid", "float"])
def test_k8_plain_bf16_matches_jax_composition(quantize):
    BH, Lq, Lk, d = 6, 23, 31, 16
    qs, k, v = _input((BH, Lq, d), 8) * 0.7, _input((BH, Lk, d), 9), _input((BH, Lk, d), 10)
    heads, p = _jax_attention_bf16(qs, k, v)
    mn, mx = np.float32([-1.9]), np.float32([2.3])
    k8.reset_launches()
    got = k8.fused_attention(*(torch.from_numpy(t) for t in (qs, k, v)), torch.from_numpy(mn),
                             torch.from_numpy(mx), quantize=quantize, bf16=True).numpy()
    assert k8.LAUNCHES == {"attention": 0, "attention_bf16": 0}
    if quantize:
        _assert_within_one_lsb(got, _jax_act_grid(heads, mn, mx), float(mx[0] - mn[0]) / 255)
        return
    # the logits' rounding reaches the heads through the softmax: sum |p v| bounds it; a weight within 2 ulps of a
    # bf16 tie may round the other way (one bf16 step, at most 2^-7 p, of its term)
    pv = np.abs(_jax_bf16(p))[..., None] * np.abs(_jax_bf16(v))[:, None]  # [BH, Lq, Lk, d]
    near = k8.bf16_tie_mask(torch.from_numpy(np.array(p))).numpy()
    allowance = 2.0**-7 * (pv * near[..., None]).sum(2)
    excess = np.abs(got - heads) - FLOAT_RTOL * pv.sum(2) - allowance
    assert excess.max() <= 0, excess.max()


def test_k8_plain_bf16_rounds_the_normalised_softmax():
    """The bf16 route rounds exp(s - max) / sum, not an unnormalised weight: where the two roundings differ the
    heads do too."""
    qs, k, v = _input((2, 5, 8), 11), _input((2, 9, 8), 12), _input((2, 9, 8), 13)
    t = [torch.from_numpy(a) for a in (qs, k, v)]
    got = k8.fused_attention(*t, quantize=False, bf16=True)
    s = torch.matmul(bf16_round(t[0]), bf16_round(t[1]).transpose(-1, -2))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    unnormalised = torch.matmul(bf16_round(e), bf16_round(t[2])) / e.sum(-1, keepdim=True)
    want, _ = _jax_attention_bf16(qs, k, v)
    assert np.abs(got.numpy() - want).max() < np.abs(unnormalised.numpy() - want).max()


# ---------------------------------------------------------------------------
# Layers against JAX in bf16
# ---------------------------------------------------------------------------


def _jax_calibrated(make, x, spec=SPEC):
    """(variables after a 2-step observer pass, observer-free output) of a JAX layer under ``spec``, compiled with
    XLA's algebraic simplifier off (eager JAX's divisions)."""
    obs = make(JaxQuantSpec(**{**spec, "observer": True}))
    variables = jax.jit(obs.init)(jax.random.PRNGKey(0), *x)
    if spec.get("qat"):
        observe = jax.jit(lambda v, *a: obs.apply(v, *a, mutable=["qparams", "qstats"])[1])
        for _ in range(2):
            variables = {**variables, **observe(variables, *x)}
    apply = jax.jit(make(JaxQuantSpec(**{**spec, "observer": False})).apply).lower(variables, *x)
    return jax.device_get(variables), np.asarray(apply.compile(compiler_options=ALGSIMP_OFF)(variables, *x))


def _port_spec(**over):
    return QuantSpec(**{**SPEC, "observer": False, **over})


def _lsb(qparams):
    return float(qparams["max_range"][0] - qparams["min_range"][0]) / 255


def _load(module, state):
    module.load_state_dict(state, strict=True)
    return module.eval()


@pytest.mark.parametrize("kw", [dict(kernel_size=1, use_bias=False), dict(kernel_size=3, padding=1, nl="prelu")],
                         ids=["k3_route", "conv"])
def test_qconv1d_matches_jax_in_bf16(kw):
    x = _input((2, 24, 70), 14)
    variables, want = _jax_calibrated(lambda q: JaxQConv1d(features=20, q=q, **kw), (jnp.asarray(x.swapaxes(1, 2)),))
    conv = _load(QConv1d(24, 20, q=_port_spec(), **kw), convtasnet_from_jax(variables))
    qm.reset_launches()
    with torch.no_grad():
        got = conv(torch.from_numpy(x)).numpy()
    assert conv.fused == (kw["kernel_size"] == 1)
    _assert_within_one_lsb(got, want.swapaxes(1, 2), _lsb(variables["qparams"]["activation_fake_quantize"]))


def test_qdense_matches_jax_in_bf16():
    x = _input((2, 30, 40), 15)
    variables, want = _jax_calibrated(lambda q: JaxQDense(24, q=q), (jnp.asarray(x),))
    dense = _load(QDense(40, 24, q=_port_spec()), dptnet_from_jax(variables))
    with torch.no_grad():
        got = dense(torch.from_numpy(x)).numpy()
    _assert_within_one_lsb(got, want, _lsb(variables["qparams"]["activation_fake_quantize"]))


def test_qlstm_matches_jax_in_bf16():
    x = _input((3, 9, 24), 16)
    spec = dict(qat=True, max_observations=2, **BF16)
    variables, want = _jax_calibrated(lambda q: JaxQLSTM(32, bidirectional=True, q=q), (jnp.asarray(x),), spec)
    lstm = _load(QLSTM(24, 32, q=QuantSpec(observer=False, **spec)), dptnet_from_jax(variables))
    with torch.no_grad():
        got = lstm(torch.from_numpy(x)).numpy()
    _assert_within_one_lsb(got, want, _lsb(variables["qparams"]["activation_fake_quantize"]))


# The module's routes: serving (K8 with the head grid), a head quantizer with an observer (K8, then the quantizer),
# fix_attn_quant (the plain composition), and the float teacher (K8 without a grid).
MHA_ROUTES = {"serving": ({}, False), "observer": ({"observer": True}, False), "fix_attn_quant": ({}, True),
              "float": ({"qat": False}, False)}


@pytest.mark.parametrize("route", list(MHA_ROUTES))
def test_qmultiheadattention_matches_jax_in_bf16(route):
    over, fix = MHA_ROUTES[route]
    xn = _input((3, 25, 32), 17)
    x = jnp.asarray(xn)
    spec = {**SPEC, **({"qat": False} if route == "float" else {})}
    variables, want = _jax_calibrated(lambda q: JaxQMultiheadAttention(32, 4, q=q, fix_attn_quant=fix), (x, x, x),
                                      spec)
    if route == "observer":  # JAX's eval apply with observers present, past their window
        apply = jax.jit(JaxQMultiheadAttention(32, 4, q=JaxQuantSpec(**{**spec, "observer": True})).apply)
        want = np.asarray(apply.lower(variables, x, x, x).compile(compiler_options=ALGSIMP_OFF)(variables, x, x, x))
    mha = _load(QMultiheadAttention(32, 4, q=_port_spec(**over), fix_attn_quant=fix), dptnet_from_jax(variables))
    xt = torch.from_numpy(xn)
    with torch.no_grad():
        got = mha(xt, xt, xt).numpy()
    if route == "float":  # no grid: within a bf16 step of the outputs' magnitude, at most 1% beyond a quarter step
        step = 2.0**-8 * np.abs(want).max()
        assert np.abs(got - want).max() <= 2 * step and np.mean(np.abs(got - want) > 0.25 * step) <= 0.01
        return
    _assert_within_one_lsb(got, want, _lsb(variables["qparams"]["activation_fake_quantize"]))


def test_convtr_decoder_with_combiner_matches_jax_in_bf16():
    x = np.abs(_input((2, 40, 32), 18))  # a masked encoder output is non-negative; JAX's layout [B, M, F]
    variables, want = _jax_calibrated(lambda q: JaxQConvTr1dDecoder(features=1, kernel_size=8, stride=4, q=q),
                                      (jnp.asarray(x),), {**SPEC, "train_res_dec": True})
    dec = QConvTr1dDecoder(32, 1, 8, stride=4, q=_port_spec(train_res_dec=True))
    _load(torch.nn.ModuleDict({"decoder": dec}), sepformer_from_jax({k: {"decoder": v} for k, v in variables.items()}))
    with torch.no_grad():
        got = dec(torch.from_numpy(x).transpose(1, 2).contiguous()).numpy()  # [2, B, 1, L]
    qp = variables["qparams"]
    for plane, quantizer in enumerate(("activation_fake_quantize", "activation_fake_quantize_residual")):
        _assert_within_one_lsb(got[plane, :, 0], want[plane, ..., 0], _lsb(qp[quantizer]))


def test_linear_decoder_with_combiner_matches_jax_in_bf16():
    x = np.abs(_input((2, 2, 40, 16), 19))
    variables, want = _jax_calibrated(lambda q: JaxQLinearDecoder(features=2, use_bias=False, q=q),
                                      (jnp.asarray(x),))
    dec = _load(QLinearDecoder(16, 2, q=_port_spec()), dptnet_from_jax(variables))
    with torch.no_grad():
        got = dec(torch.from_numpy(x)).numpy()
    qp = variables["qparams"]
    _assert_within_one_lsb(got[0], want[0], _lsb(qp["activation_fake_quantize"]))
    _assert_within_one_lsb(got[1], want[1], _lsb(qp["activation_fake_quantize_residual"]))


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------

MODELS = {
    "ConvTasNet": (JaxConvTasNet, ConvTasNet, convtasnet_from_jax,
                   dict(n_srcs=2, kernel_size=16, stride=8, n_filters=32, bn_chan=8, hid_chan=16, n_blocks=2,
                        n_repeats=1), 1600),
    "DPTNet": (JaxDPTNet, DPTNet, dptnet_from_jax,
               dict(n_srcs=2, kernel_size=2, enc_dim=16, feature_dim=8, hidden_dim=16, layer=1, segment_size=20), 800),
    "Sepformer": (JaxSepformer, Sepformer, sepformer_from_jax,
                  dict(n_srcs=2, kernel_size=8, stride=4, n_filters=32, n_repeats=1, n_heads=4, chunk_size=20,
                       n_ffn=48, n_layers=1), 800),
}


@pytest.fixture(scope="module", params=list(MODELS))
def calibrated_bf16(request):
    """(name, JAX output jitted with algsimp off, port model in bf16, mixtures), calibrated in JAX in bf16."""
    jax_cls, cls, convert, arch, length = MODELS[request.param]
    spec = {**SPEC, "max_observations": 3}
    mix, _ = synth_batch(np.random.default_rng(0), 2, 2, length)
    x = jnp.asarray(mix)
    obs = jax_cls(q=JaxQuantSpec(**{**spec, "observer": True}), **arch)
    variables = run_observer(obs, jax.jit(obs.init)(jax.random.PRNGKey(0), x), x, steps=4)
    served = jax_cls(q=JaxQuantSpec(**{**spec, "observer": False}), **arch)
    want = np.asarray(jax.jit(served.apply).lower(variables, x).compile(compiler_options=ALGSIMP_OFF)(variables, x))
    port = cls(q=QuantSpec(**{**spec, "observer": False}), **arch)
    port.load_state_dict(convert(jax.device_get(variables)), strict=True)
    return request.param, want, port.eval(), mix


def _forward(model, mix):
    with torch.inference_mode():
        return model(torch.from_numpy(mix)).numpy()


def test_model_matches_jitted_jax_in_bf16(calibrated_bf16):
    name, want, port, mix = calibrated_bf16
    assert port.q.bf16
    for module in (qd, qm, k8):
        module.reset_launches()
    got = _forward(port, mix)
    assert all(v == 0 for module in (qd, qm, k8) for v in module.LAUNCHES.values())  # CPU: the plain versions
    assert got.shape == want.shape and np.isfinite(got).all()
    snr = _snr_db(want, got)
    print(f"{name} bf16 port vs jitted JAX: SNR {np.round(snr, 2).tolist()} dB")
    assert (snr >= 20).all(), f"{name}: port vs JAX SNR {snr} dB < 20 dB"


def test_folded_bitwise_equals_fake_quant_in_bf16(calibrated_bf16):
    _, _, port, mix = calibrated_bf16
    folded = fold_quantized_weights(port)
    assert folded.q.bf16 and not folded.q.weight_quant
    np.testing.assert_array_equal(_forward(folded, mix), _forward(port, mix))


def test_bf16_forward_with_a_gradient_is_refused(calibrated_bf16):
    _, _, port, mix = calibrated_bf16
    with pytest.raises(NotImplementedError, match="bf16 training"):
        port(torch.from_numpy(mix))  # parameters require gradients, and grad mode is on


@pytest.mark.parametrize("kernel", ["qat_dense", "fused_attention"])
def test_bf16_kernel_routes_refuse_a_gradient(kernel):
    x = torch.from_numpy(_input((4, 8, 16), 20)).requires_grad_()
    with pytest.raises(NotImplementedError, match="bf16 training"):
        if kernel == "qat_dense":
            qd.qat_dense(x[0], torch.ones(3, 16), torch.zeros(3), bf16=True)
        else:
            k8.fused_attention(x, x.detach(), x.detach(), quantize=False, bf16=True)


# ---------------------------------------------------------------------------
# bf16 training: the JAX package cannot take a bf16 gradient either
# ---------------------------------------------------------------------------

# The tiny models of tests/test_torch_train.py and tests/test_torch_train_models.py, with their spec.
TRAIN_MODELS = {
    "ConvTasNet": (JaxConvTasNet, ConvTasNet,
                   dict(n_srcs=2, kernel_size=16, stride=8, n_filters=32, bn_chan=8, hid_chan=16, n_blocks=2,
                        n_repeats=1)),
    "DPTNet": (JaxDPTNet, DPTNet,
               dict(n_srcs=2, kernel_size=2, enc_dim=16, feature_dim=8, hidden_dim=16, layer=1, segment_size=20)),
    "Sepformer": (JaxSepformer, Sepformer,
                  dict(n_srcs=2, kernel_size=8, stride=4, n_filters=32, n_repeats=1, n_heads=4, chunk_size=20,
                       n_ffn=48, n_layers=1)),
}
TRAIN_SPEC = dict(qat=True, n_splitter=2, n_combiner=2, out_quant=True, max_observations=3)
CONV_DTYPES = "requires arguments to have the same dtypes"  # lax.conv_general_dilated's TypeError


def _train_batch(t_len=800):
    mix, src = synth_batch(np.random.default_rng(0), 2, 2, t_len)
    return jnp.asarray(mix), jnp.asarray(src)


@pytest.mark.parametrize("name", list(TRAIN_MODELS))
def test_jax_cannot_differentiate_its_bf16_student(name):
    """``jax.grad`` of the bf16 student's KD loss fails in the VJP of its first bf16 convolution (operands in bf16,
    ``preferred_element_type=float32``: the cotangent comes back float32 beside a bf16 operand). Traced only."""
    from fqss_tpu.separation.losses import fqss_kd_loss

    jax_cls, _, arch = TRAIN_MODELS[name]
    jm = jax_cls(q=JaxQuantSpec(observer=True, **TRAIN_SPEC, **BF16), **arch)
    mix, src = _train_batch()
    variables = jax.eval_shape(jm.init, jax.random.PRNGKey(0), mix)

    def loss(params, v):
        est, _ = jm.apply({**v, "params": params}, mix, mutable=["qparams", "qstats"])
        return fqss_kd_loss(est[..., : src.shape[-1]], src, src, kd_lambda=0.1)[0]

    with pytest.raises(TypeError, match=CONV_DTYPES):
        jax.eval_shape(lambda v: jax.grad(loss)(v["params"], v), variables)


@pytest.mark.parametrize("name", list(TRAIN_MODELS))
def test_jax_cannot_step_with_a_bf16_teacher(name):
    """JAX's ``TrainConfig(teacher_dtype="bfloat16")`` step fails in the teacher's forward: ``mxu_operands`` leaves
    the float teacher's bf16 weight beside the float32 activation at its second convolution. Traced only."""
    from fqss_tpu.train import TrainConfig as JaxTrainConfig
    from fqss_tpu.train import create_train_state
    from fqss_tpu.train import make_optimizer as jax_make_optimizer
    from fqss_tpu.train import make_train_step as jax_make_train_step

    jax_cls, _, arch = TRAIN_MODELS[name]
    jm, jt = jax_cls(q=JaxQuantSpec(observer=True, **TRAIN_SPEC), **arch), jax_cls(**arch)
    mix, src = _train_batch()
    v = jax.eval_shape(jm.init, jax.random.PRNGKey(0), mix)
    tv = jax.eval_shape(jt.init, jax.random.PRNGKey(1), mix)
    cfg = JaxTrainConfig(teacher_dtype="bfloat16")
    tx = jax_make_optimizer(cfg)
    step = jax_make_train_step(jm, jt, tx, cfg, donate=False)
    with pytest.raises(TypeError, match=CONV_DTYPES):
        jax.eval_shape(lambda v, tp: step(create_train_state(v, tx, teacher_params=tp), mix, src), v, tv["params"])


@pytest.mark.parametrize("name", list(TRAIN_MODELS))
def test_port_refuses_a_bf16_kd_step(name):
    """The port's KD step of the bf16 student raises its refusal, as JAX's gradient raises."""
    _, cls, arch = TRAIN_MODELS[name]
    model = cls(q=QuantSpec(observer=True, **TRAIN_SPEC, **BF16), **arch)
    teacher = cls(**arch).requires_grad_(False).eval()
    state = TrainState(model, make_optimizer(TrainConfig(), [p for p in model.parameters() if p.requires_grad]),
                       teacher)
    mix, src = (torch.from_numpy(np.array(a)) for a in _train_batch())
    with pytest.raises(NotImplementedError, match="bf16 training"):
        make_train_step(TrainConfig())(state, mix, src)
    assert state.step == 0
