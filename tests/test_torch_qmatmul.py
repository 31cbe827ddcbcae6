"""The fused fake-quant matmul (K3) of the port against the JAX package, on the CPU.

* ``qmatmul_ref`` against JAX's Pallas ``qmatmul_pallas`` run eagerly
  (``jax.disable_jit()``) in interpret mode (as ``tests/test_pallas.py``
  runs it), act grid on and off, on shapes of several of its blocks in every
  axis and at ragged sizes, with planted half-step ties of both grids and
  rows that clip. The port's operands are NCT (``x [B, K, T]``, ``w [N, K]``,
  ``y [B, N, T]``) and are transposed to JAX's ``x [M, K] @ w [K, N]``. The
  port's layer rule (ROADMAP.md): the sums land in another order, so every
  output is within one LSB of the act grid, at most 1% of them a step apart,
  the planted ties and clipped rows exactly; without the act grid, within
  1e-5 of the sum of the terms' magnitudes.
* ``QConv1d``'s routing: a bias-free 1x1 layer without a nonlinearity takes
  ``qmatmul`` where no gradient is needed, and the same function as the
  differentiable composition (weight quantizer, ``F.conv1d``, act
  quantizer) where one is; other layers never take it; in train mode the
  observers' writes are the same on both routes; the folded model equals
  the fake-quant model bitwise.
* The slice: tiny FQSS-8bit DPTNet and Sepformer models calibrated in JAX,
  an eval forward at batch 1 and 2 through the K3 route against the JAX
  model compiled with XLA's algebraic simplifier off: SNR >= 20 dB per
  output (``tests/test_torch_dptnet.py``'s standard).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from fqss_tpu.data import synth_batch
from fqss_tpu.models.dptnet import DPTNet as JaxDPTNet
from fqss_tpu.models.sepformer import Sepformer as JaxSepformer
from fqss_tpu.ops.pallas_quant import qmatmul_pallas
from fqss_tpu.quant import QuantSpec as JaxQuantSpec
from fqss_tpu.quant.calibration import run_observer
from fqss_tpu_torch.models.convert import dptnet_from_jax, sepformer_from_jax
from fqss_tpu_torch.models.dptnet import DPTNet
from fqss_tpu_torch.models.sepformer import Sepformer
from fqss_tpu_torch.nn import layers
from fqss_tpu_torch.nn.layers import QConv1d
from fqss_tpu_torch.ops import qmatmul as qm
from fqss_tpu_torch.quant.spec import QuantSpec
from fqss_tpu_torch.serve.fold import fold_quantized_weights

torch.set_num_threads(1)

STEP = 2.0**-7
ALGSIMP_OFF = {"xla_disable_hlo_passes": "algsimp"}
TIE_ROWS = 5  # time steps 0-4 of batch row 0 carry the act grid's planted ties
CLIP_T = 5  # time step 5 of batch row 0 clips at both ends of the act grid


# ---------------------------------------------------------------------------
# K3: the plain version against the Pallas kernel
# ---------------------------------------------------------------------------


def _inputs(b, k, t, n, seed):
    """x [B, K, T], w [N, K], weight ranges [N], act ranges; output channel 0 carries the act grid's ties,
    channel 1 (where N > 1) weights on half steps of its weight grid."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, k, t)).astype(np.float32)
    w = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
    w_mn = (-np.abs(rng.standard_normal(n)) * 0.4 - 0.01).astype(np.float32)
    w_mx = (np.abs(rng.standard_normal(n)) * 0.4 + 0.01).astype(np.float32)
    # the act grid's step is STEP and mn a half step off it: an output of 5 (t + 1) steps is a half-step tie
    a_mn = np.float32([-128.5 * STEP])
    a_mx = np.float32([a_mn[0] + 255 * STEP])
    # channel 0: weight step STEP (max |range| 255/256), w[0, 0] = 5 steps, so y[0, 0, t] = 5 steps * x[0, 0, t]
    w_mn[0], w_mx[0] = -255 / 256, 255 / 256
    w[0] = 0.0
    w[0, 0] = 5 * STEP
    rows = min(t, TIE_ROWS)
    x[0, 0, :rows] = np.arange(1, rows + 1)
    if t > CLIP_T:
        x[0, :, CLIP_T] = 100.0 * np.sign(w[min(1, n - 1)] + 1e-9)  # far past both ends for most channels
        x[0, 0, CLIP_T] = -100.0  # channel 0: 100 * 5 steps below mn
    if n > 1:  # channel 1: step STEP, weights on half steps k + 0.5 (rounded half to even on the grid)
        w_mn[1], w_mx[1] = -255 / 256, 255 / 256
        w[1] = ((np.arange(k) % 40) - 20 + 0.5) * STEP
    return x, w, w_mn, w_mx, a_mn, a_mx


def _jax_qmatmul(x, w, w_mn, w_mx, a_mn, a_mx, act_quant):
    """qmatmul_pallas on JAX's layout, run eagerly in interpret mode; returned in the port's [B, N, T]."""
    b, k, t = x.shape
    xm = x.transpose(0, 2, 1).reshape(b * t, k)
    with pltpu.force_tpu_interpret_mode(), jax.disable_jit():
        y = qmatmul_pallas(*map(jnp.asarray, (xm, w.T, w_mn, w_mx, a_mn, a_mx)), act_quant=act_quant)
    return np.asarray(y).reshape(b, t, -1).transpose(0, 2, 1)


def _port_args(x, w, w_mn, w_mx, a_mn, a_mx, act_quant):
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (x, w, w_mn, w_mx, a_mn, a_mx)]
    if not act_quant:
        args[4] = args[5] = None
    return args


# (B, K, T, N): one block of JAX's (tm 256, tn 256, K padded to 128) tiles; several in every axis with ragged
# edges; a tiny ragged one; DPTNet's BN width (256 -> 64) and the Sepformer masker's (256 -> 256) at short T.
SHAPES = [(2, 24, 37, 33), (2, 264, 300, 260), (1, 7, 6, 3), (3, 256, 90, 64), (1, 256, 260, 256)]


@pytest.mark.parametrize("act_quant", [True, False])
@pytest.mark.parametrize("b,k,t,n", SHAPES)
def test_plain_version_equals_the_pallas_kernel(b, k, t, n, act_quant):
    inputs = _inputs(b, k, t, n, b + k + t + n)
    want = _jax_qmatmul(*inputs, act_quant)
    args = _port_args(*inputs, act_quant)
    got = qm.qmatmul_ref(*args).numpy()
    assert got.shape == want.shape == (b, n, t)
    if not act_quant:  # float32 sums in another order: within 1e-5 of the sum of the terms' magnitudes
        bound = np.abs(qm._weight_q(*args[1:4], 8, None).numpy()) @ np.abs(inputs[0])
        assert (np.abs(got - want) <= 1e-5 * bound + 1e-7).all()
        return
    diff = np.abs(got - want) / STEP
    assert diff.max() <= 1 + 1e-4 and (diff > 0.5).mean() <= 0.01, (diff.max(), (diff > 0.5).mean())
    rows = min(t, TIE_ROWS)
    a_mn = inputs[4][0]
    # the ties rounded half to even: mn + (5 (t + 1) + 128.5) steps -> the even neighbour
    X = np.round(5 * np.arange(1, rows + 1) + 128.5)
    np.testing.assert_array_equal(got[0, 0, :rows], want[0, 0, :rows])
    np.testing.assert_array_equal(got[0, 0, :rows], (a_mn + X * STEP).astype(np.float32))
    if t > CLIP_T:
        np.testing.assert_array_equal(got[0, :, CLIP_T], want[0, :, CLIP_T])
        assert got[0, 0, CLIP_T] == a_mn  # clipped at the grid's low end
        assert np.isin(got[0, :, CLIP_T], [a_mn, np.float32(a_mn + 255 * STEP)]).mean() > 0.5


def test_the_weight_grid_rounds_half_steps_to_even():
    x, w, w_mn, w_mx, a_mn, a_mx = _inputs(1, 16, 4, 2, 0)
    x[:] = 0.0
    x[0, :, 0] = np.eye(16)[3]  # y[0, 1, 0] = the on-grid weight w_q[1, 3]
    got = qm.qmatmul_ref(*_port_args(x, w, w_mn, w_mx, a_mn, a_mx, False)).numpy()
    want = _jax_qmatmul(x, w, w_mn, w_mx, a_mn, a_mx, False)
    k = (3 % 40) - 20 + 0.5  # w[1, 3] = -16.5 steps -> -16 steps (even)
    assert got[0, 1, 0] == want[0, 1, 0] == np.float32(np.round(k) * STEP)


def test_wrapper_takes_the_plain_version_on_the_cpu_and_counts_no_launch():
    args = _port_args(*_inputs(2, 24, 37, 33, 1), True)
    qm.reset_launches()
    assert torch.equal(qm.qmatmul(*args), qm.qmatmul_ref(*args))
    assert qm.LAUNCHES == {"qmatmul": 0, "qmatmul_bf16": 0}


def test_wrapper_holds_cpu_callers_to_what_the_kernel_takes():
    x, w, w_mn, w_mx, a_mn, a_mx = _port_args(*_inputs(2, 24, 37, 33, 2), True)
    with pytest.raises(ValueError, match="contiguous"):
        qm.qmatmul(x.transpose(1, 2).contiguous().transpose(1, 2), w, w_mn, w_mx, a_mn, a_mx)
    with pytest.raises(TypeError):
        qm.qmatmul(x.double(), w, w_mn, w_mx, a_mn, a_mx)
    with pytest.raises(ValueError, match="expected"):
        qm.qmatmul(x, w[:, :8].contiguous(), w_mn, w_mx, a_mn, a_mx)
    with pytest.raises(ValueError, match="both of its ranges"):
        qm.qmatmul(x, w, w_mn, None)
    with pytest.raises(ValueError, match="forward only"):
        qm.qmatmul(x.requires_grad_(), w, w_mn, w_mx, a_mn, a_mx)
    with pytest.raises(ValueError, match="no kernel"):
        qm.qmatmul(x.detach().to("meta"), w, w_mn, w_mx, a_mn, a_mx)


# ---------------------------------------------------------------------------
# QConv1d's routing
# ---------------------------------------------------------------------------


@pytest.fixture
def k3_calls(monkeypatch):
    """The number of QConv1d forwards that went through qmatmul."""
    calls = []

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return qm.qmatmul(*args, **kwargs)

    monkeypatch.setattr(layers, "qmatmul", counting)
    return calls


def _calibrated_conv(**kwargs):
    """A QConv1d whose ranges come from a 3-step observer window in train mode (the composition route)."""
    q = QuantSpec(qat=True, max_observations=3)
    conv = QConv1d(24, 16, q=q, generator=torch.Generator().manual_seed(0), **kwargs)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 24, 50)).astype(np.float32))
    conv.train()
    for _ in range(3):
        conv(x)
    return conv.eval(), x


def test_a_qualifying_layer_without_gradient_takes_k3(k3_calls):
    conv, x = _calibrated_conv(kernel_size=1, use_bias=False)
    assert conv.fused
    with torch.no_grad():
        y = conv(x)
    assert len(k3_calls) == 1
    with torch.enable_grad():  # no input or parameter requires a gradient: K3 too
        for p in conv.parameters():
            p.requires_grad_(False)
        assert torch.equal(conv(x), y)
    assert len(k3_calls) == 2


def test_with_gradient_the_layer_keeps_the_differentiable_composition(k3_calls):
    conv, x = _calibrated_conv(kernel_size=1, use_bias=False)
    with torch.no_grad():
        fused = conv(x)
    y = conv(x)  # the parameters require gradients
    assert len(k3_calls) == 1 and y.requires_grad
    y.square().sum().backward()
    assert conv.weight.grad is not None and conv.activation_fake_quantize.max_range.grad is not None
    aq = conv.activation_fake_quantize
    lsb = float(aq.max_range.detach() - aq.min_range.detach()) / 255
    diff = (y.detach() - fused).abs()  # F.conv1d and the product sum in other orders: one-step tie flips
    assert diff.max() <= lsb * (1 + 1e-4) and (diff > 0.5 * lsb).float().mean() <= 0.01


@pytest.mark.parametrize("kwargs", [dict(kernel_size=1), dict(kernel_size=1, use_bias=False, nl="relu"),
                                    dict(kernel_size=3, use_bias=False), dict(kernel_size=1, use_bias=False, stride=2),
                                    dict(kernel_size=1, use_bias=False, padding=1)])
def test_other_layers_never_take_k3(k3_calls, kwargs):
    conv, x = _calibrated_conv(**kwargs)
    assert not conv.fused
    with torch.no_grad():
        conv(x)
    assert k3_calls == []


def test_the_observers_write_the_same_ranges_on_both_routes(k3_calls):
    """In train mode without gradient (a calibration pass) K3 skips the grids inside the window and the
    observers' writes follow, as the composition's quantizer modules do."""
    q = QuantSpec(qat=True, max_observations=3)
    convs = [QConv1d(24, 16, 1, use_bias=False, q=q, generator=torch.Generator().manual_seed(1)) for _ in "ab"]
    rng = np.random.default_rng(6)
    for step in range(5):
        x = torch.from_numpy(rng.standard_normal((2, 24, 40)).astype(np.float32))
        with torch.no_grad():
            fused = convs[0].train()(x)
        composed = convs[1].train()(x).detach()
        aq = convs[1].activation_fake_quantize
        lsb = float(aq.max_range.detach() - aq.min_range.detach()) / 255
        assert (fused - composed).abs().max() <= (1e-5 if step < 3 else lsb * (1 + 1e-4)), step
    assert len(k3_calls) == 5
    state = [c.state_dict() for c in convs]
    for name, value in state[0].items():
        if "fake_quantize" in name:
            torch.testing.assert_close(value, state[1][name], rtol=1e-6, atol=1e-7, msg=name)


# ---------------------------------------------------------------------------
# The slice: tiny DPTNet and Sepformer through the K3 route against JAX
# ---------------------------------------------------------------------------

SPEC = dict(qat=True, n_splitter=2, n_combiner=2, out_quant=True, max_observations=3)
DPT_ARCH = dict(n_srcs=2, kernel_size=2, enc_dim=16, feature_dim=8, hidden_dim=16, layer=1, segment_size=20)
SEP_ARCH = dict(n_srcs=2, kernel_size=8, stride=4, n_filters=32, n_repeats=1, n_heads=4, chunk_size=20, n_ffn=48,
                n_layers=1)
MODELS = {"DPTNet": (JaxDPTNet, DPTNet, dptnet_from_jax, DPT_ARCH),
          "Sepformer": (JaxSepformer, Sepformer, sepformer_from_jax, SEP_ARCH)}


@pytest.fixture(scope="module", params=list(MODELS))
def calibrated(request):
    """(JAX eval model, calibrated JAX variables, port model, mixtures [2, 800])."""
    jax_cls, port_cls, convert, arch = MODELS[request.param]
    mix, _ = synth_batch(np.random.default_rng(7), 2, 2, 800)
    obs = jax_cls(q=JaxQuantSpec(observer=True, **SPEC), **arch)
    variables = jax.jit(obs.init)(jax.random.PRNGKey(7), jnp.asarray(mix))
    variables = jax.device_get(run_observer(obs, variables, jnp.asarray(mix), steps=4))
    port = port_cls(q=QuantSpec(observer=False, **SPEC), **arch)
    port.load_state_dict(convert(variables), strict=True)
    return jax_cls(q=JaxQuantSpec(observer=False, **SPEC), **arch), variables, port.eval(), mix


@pytest.mark.parametrize("batch", [1, 2])
def test_the_eval_forward_through_k3_matches_jax(calibrated, k3_calls, batch):
    jm, variables, port, mix = calibrated
    x = jnp.asarray(mix[:batch])
    want = np.asarray(jax.jit(jm.apply).lower(variables, x).compile(compiler_options=ALGSIMP_OFF)(variables, x))
    with torch.inference_mode():
        got = port(torch.from_numpy(mix[:batch])).numpy()
        folded = fold_quantized_weights(port)(torch.from_numpy(mix[:batch])).numpy()
    assert len(k3_calls) == 2  # DPTNet's BN, the Sepformer masker's conv1d: once a forward
    assert got.shape == want.shape == (batch, 2, 800)
    snr = 10 * np.log10(np.sum(want**2, -1) / np.maximum(np.sum((want - got) ** 2, -1), 1e-30))
    assert (snr >= 20).all(), f"port vs JAX SNR {snr} dB < 20 dB"
    np.testing.assert_array_equal(folded, got)
