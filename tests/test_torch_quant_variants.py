"""The quantizer variants against the JAX package: the mu-law grid, the MSE quantizer, its calibration and the
deploy-grid export.

* ``mulaw_fake_quant``: its values and its gradients in x, the ranges and ``mu`` against ``jax.grad`` (x = 0, |x|
  beyond the range, mu = 1 and mu != 1). The companding steps are ``log1p`` and ``pow`` of each package, which round
  their last bits otherwise: the codes on the inner grid agree, the values to 1e-6 relative, the gradients to 1e-4
  (the ranges' and mu's, sums over every element, to 1e-3).
* ``ActQuantizer(kind="mulaw")`` through its observer window and after it against JAX's module.
* ``MseActQuantizer``: ``hist``, ``val_min``, ``val_max``, ``n_iter`` and ``calibrated`` bitwise against JAX's over
  five observations, eager and jitted (a window that grows, one that stays, a constant batch, the first call), and
  the linspace, cumsum and interp helpers bitwise against ``jnp``'s.
* ``mse_minmax_range`` picks JAX's (min, max) bit for bit on 200 random histograms (at 20 x 20 candidates, where
  JAX's Python loop takes 10 ms) and on 4 at the default 100 x 100; ``calibrate_mse_quantizers`` and
  ``export_quantizer_grids`` against JAX's on a converted state; ``fix_range_to_include_zero`` and the frozen-grid
  replays against JAX's.
* The fused routes under an MSE quantizer (K5's and K3's plain versions, and the attention module) inside and after
  the window, against JAX's layers: the pre-activations inside it to 1e-5 relative, the quantized outputs after it
  within one LSB on at most 1% of the values.
* A tiny ConvTasNet with ``in_quant``, ``inout_nl_quant`` and ``act_quantizer: mse`` before and after its
  calibration against jitted JAX (>= 20 dB), its converter round trip and its KD step across the window's close
  against JAX's ``value_and_grad`` (1e-3 per gradient tensor, as ``tests/test_torch_train.py``).
* The int8 engines and a mu-law output grid: JAX's engine requantizes the mu-law plane onto the linear grid of its
  ranges and leaves its own fake-quant model (33-37 dB, where the linear grid reads above 130 dB); the port's engines
  refuse it and ``auto`` serves the folded model.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fqss_tpu.data import synth_batch
from fqss_tpu.models import ConvTasNet as JaxConvTasNet
from fqss_tpu.nn import QConv1d as JaxQConv1d
from fqss_tpu.nn import QDense as JaxQDense
from fqss_tpu.nn.attention import QMultiheadAttention as JaxQMultiheadAttention
from fqss_tpu.quant import QuantSpec as JaxQuantSpec
from fqss_tpu.quant import calibration as jax_calibration
from fqss_tpu.quant import export as jax_export
from fqss_tpu.quant import fake_quant as jax_fq
from fqss_tpu.quant.quantizers import ActQuantizer as JaxActQuantizer
from fqss_tpu.quant.quantizers import MseActQuantizer as JaxMseActQuantizer
from fqss_tpu.serve.convtasnet_int8 import ConvTasNetInt8Engine as JaxEngine
from fqss_tpu_torch.models import convert
from fqss_tpu_torch.models.convtasnet import ConvTasNet
from fqss_tpu_torch.models.convtasnet_music import ConvTasNetMusic
from fqss_tpu_torch.nn.attention import QMultiheadAttention
from fqss_tpu_torch.nn.layers import QConv1d, QDense
from fqss_tpu_torch.quant import fake_quant as fq
from fqss_tpu_torch.quant import histogram
from fqss_tpu_torch.quant.calibration import calibrate_mse_quantizers, has_pending_mse, mse_minmax_range
from fqss_tpu_torch.quant.export import export_quantizer_grids
from fqss_tpu_torch.quant.quantizers import ActQuantizer, MseActQuantizer
from fqss_tpu_torch.quant.spec import QuantSpec
from fqss_tpu_torch.serve import make_int8_engine
from fqss_tpu_torch.serve.autopath import auto_serving_model
from fqss_tpu_torch.train.state import TrainState
from fqss_tpu_torch.train.trainer import TrainConfig, make_optimizer, make_train_step

torch.set_num_threads(1)

ALGSIMP_OFF = {"xla_disable_hlo_passes": "algsimp"}
ARCH = dict(n_srcs=2, kernel_size=16, stride=8, n_filters=32, bn_chan=8, hid_chan=16, n_blocks=2, n_repeats=1)
SPEC = dict(qat=True, n_splitter=2, n_combiner=2, out_quant=True, in_quant=True, inout_nl_quant=True,
            act_quantizer="mse", max_observations=3)
T = 1600


def _snr_db(ref, est):
    return 10 * np.log10(np.sum(ref**2, -1) / np.maximum(np.sum((ref - est) ** 2, -1), 1e-30))


def _within_one_lsb(got, want, lsb):
    diff = np.abs(got - want)
    assert diff.max() <= lsb * (1 + 1e-4), f"max diff {diff.max()} > 1 LSB {lsb}"
    assert np.mean(diff > 0.5 * lsb) <= 0.01, f"{np.mean(diff > 0.5 * lsb):.4f} of values moved by a grid step"


# ---------------------------------------------------------------------------
# The mu-law grid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mu", [1.0, 3.7, 0.2])
def test_mulaw_fake_quant_and_its_gradients_match_jax(mu):
    rng = np.random.default_rng(int(mu * 10))
    x = (rng.standard_normal((2, 4, 300)) * 0.6).astype(np.float32)
    x[0, 0, :5] = [0.0, 1.5, -2.0, 0.8, -0.8]  # zero, beyond the range on both sides, at the range
    g = rng.standard_normal(x.shape).astype(np.float32)
    mn, mx, m = np.float32([-0.8]), np.float32([0.7]), np.float32([mu])

    def loss(*a):
        return jnp.sum(jax_fq.mulaw_fake_quant(a[0], a[1], a[2], a[3], 8) * g)

    want = np.asarray(jax_fq.mulaw_fake_quant(jnp.asarray(x), mn, mx, m, 8))
    want_g = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(*map(jnp.asarray, (x, mn, mx, m)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, mn, mx, m)]
    got = fq.mulaw_fake_quant(*ts, 8)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    # the inner grid's codes are equal: the values differ only in the expansion's last bits
    code = lambda y: np.round((np.sign(y) * np.log1p(mu * np.abs(y) / 0.8) / np.log1p(mu) + 1) * 127.5)
    np.testing.assert_array_equal(code(got.detach().numpy()), code(want))
    for name, t, w, tol in zip(("x", "min", "max", "mu"), ts, want_g, (1e-4, 1e-3, 1e-3, 1e-3)):
        w = np.asarray(w)
        assert np.abs(t.grad.numpy() - w).max() <= tol * max(np.abs(w).max(), 1.0), name


def test_mulaw_act_quantizer_through_its_window_matches_jax():
    rng = np.random.default_rng(1)
    xs = [(rng.standard_normal((2, 3, 40)) * (1 + k)).astype(np.float32) for k in range(5)]
    jq = JaxActQuantizer(kind="mulaw", max_observations=3)
    v = jq.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    v = {**v, "qparams": {**v["qparams"], "mu": jnp.float32([2.5])}}
    port = ActQuantizer(kind="mulaw", max_observations=3).train()
    with torch.no_grad():
        port.mu.fill_(2.5)
    for k, x in enumerate(xs):
        want, upd = jq.apply(v, jnp.asarray(x), mutable=["qparams", "qstats"])
        v = {**v, **upd}
        xt = torch.from_numpy(x).requires_grad_()
        got = port(xt)
        got.sum().backward()
        for name in ("min_range", "max_range", "mu"):
            np.testing.assert_array_equal(getattr(port, name).detach().numpy(), np.asarray(v["qparams"][name]))
        assert int(port.n_iter) == int(v["qstats"]["n_iter"]) == min(k + 1, 3)
        if k < 3:  # inside the window: the input, and no gradient for mu
            np.testing.assert_array_equal(got.detach().numpy(), x)
            assert float(port.mu.grad.abs().sum()) == 0
        else:
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
        port.zero_grad()


# ---------------------------------------------------------------------------
# The MSE observer
# ---------------------------------------------------------------------------


def _scenario(kind, rng):
    shape = (2, 3, 50)
    if kind == "grows":
        return [(rng.standard_normal(shape) * (1 + k)).astype(np.float32) for k in range(5)]
    if kind == "stays":
        first = rng.standard_normal(shape).astype(np.float32) * 4
        return [first] + [np.clip(rng.standard_normal(shape), -1, 1).astype(np.float32) for _ in range(4)]
    if kind == "constant":
        return [np.full(shape, 0.3, np.float32), np.full(shape, 0.3, np.float32),
                rng.standard_normal(shape).astype(np.float32), np.full(shape, -0.7, np.float32),
                rng.standard_normal(shape).astype(np.float32)]
    # the first call only, then the window closed
    return [(rng.standard_normal(shape) * 2 + 1).astype(np.float32)] * 5


@pytest.mark.parametrize("jit", [False, True])
@pytest.mark.parametrize("kind", ["grows", "stays", "constant", "first"])
def test_mse_observer_is_bitwise_jaxs(kind, jit):
    xs = _scenario(kind, np.random.default_rng(len(kind)))
    window = 1 if kind == "first" else 4
    jq = JaxMseActQuantizer(max_observations=window)
    v = jq.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    apply = lambda v, x: jq.apply(v, x, mutable=["qparams", "qstats"])
    apply = jax.jit(apply) if jit else apply
    port = MseActQuantizer(max_observations=window).train()
    for x in xs:
        want, upd = apply(v, jnp.asarray(x))
        v = {**v, **upd}
        got = port(torch.from_numpy(x)).detach()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))  # not calibrated: the input
        for name in ("hist", "val_min", "val_max", "n_iter", "calibrated"):
            np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(v["qstats"][name]), err_msg=name)
    assert int(port.n_iter) == min(5, window)


def test_histogram_helpers_are_bitwise_jnps():
    rng = np.random.default_rng(2)
    for _ in range(20):
        a, b = np.sort(rng.standard_normal(2).astype(np.float32) * np.float32(rng.random() * 10))
        np.testing.assert_array_equal(histogram.xla_linspace(torch.tensor(a), torch.tensor(b), 513).numpy(),
                                      np.asarray(jnp.linspace(a, b, 513)))
        h = (rng.random(512) * rng.integers(1, 1000, 512)).astype(np.float32)
        np.testing.assert_array_equal(histogram.xla_cumsum(torch.from_numpy(h)).numpy(), np.asarray(jnp.cumsum(h)))
        xp = np.sort(rng.standard_normal(513).astype(np.float32))
        xp[100:110] = xp[100]  # a flat stretch: the dx ~ 0 branch
        fp = np.cumsum(rng.random(513)).astype(np.float32)
        x = (rng.standard_normal(513) * 1.5).astype(np.float32)  # beyond both ends too
        x[:10] = xp[100]
        np.testing.assert_array_equal(histogram.xla_interp(*map(torch.from_numpy, (x, xp, fp))).numpy(),
                                      np.asarray(jnp.interp(x, xp, fp)))
    a, b, c = (rng.standard_normal(10000).astype(np.float32) for _ in range(3))
    exact = (a.astype(np.float64) * b + c).astype(np.float32)  # a double-rounded reference: equal but at ties
    got = histogram.fma32(*map(torch.from_numpy, (a, b, c))).numpy()
    assert np.mean(got == exact) > 0.999


# ---------------------------------------------------------------------------
# Calibration and export
# ---------------------------------------------------------------------------


def _histograms(rng, n):
    for k in range(n):
        kind = k % 4
        if kind == 0:
            h = rng.integers(0, 1000, 512).astype(np.float32)
        elif kind == 1:
            h = np.histogram(rng.standard_normal(5000) * rng.random(), 512)[0].astype(np.float32)
        elif kind == 2:
            h = (rng.random(512) * (rng.random(512) < 0.1) * 100).astype(np.float32)
        else:
            h = np.zeros(512, np.float32)
            h[rng.integers(0, 512, 3)] = rng.random(3) * 5
        lo, hi = sorted(rng.standard_normal(2) * rng.random() * 4)
        yield h, float(np.float32(lo)), float(np.float32(hi))


def test_mse_minmax_range_picks_jaxs_ranges_bit_for_bit():
    rng = np.random.default_rng(3)
    for h, lo, hi in _histograms(rng, 200):
        assert mse_minmax_range(h, lo, hi, n_grid=20) == jax_calibration.mse_minmax_range(h, lo, hi, n_grid=20)
    for h, lo, hi in _histograms(rng, 4):
        assert mse_minmax_range(h, lo, hi) == jax_calibration.mse_minmax_range(h, lo, hi)


@pytest.fixture(scope="module")
def observed():
    """(the tiny ConvTasNet under SPEC after 3 observer steps, mixtures): its MSE histograms pending."""
    mix, src = synth_batch(np.random.default_rng(0), 2, 2, T)
    return _observe(SPEC, mix), mix, src


def _observe(spec, mix):
    model = ConvTasNet(q=QuantSpec(**spec), generator=torch.Generator().manual_seed(0), **ARCH)
    with torch.no_grad():
        for k in range(3):
            model.train()(torch.from_numpy(mix * (1 + 0.2 * k)))
        for m in model.modules():  # a learned mu, as training would leave it
            if isinstance(m, ActQuantizer) and m.kind == "mulaw":
                m.mu.fill_(3.0)
    return model.eval()


def _calibrated(model, n_grid=100):
    out = ConvTasNet(q=model.q, **ARCH)
    out.load_state_dict(model.state_dict())
    assert calibrate_mse_quantizers(out, n_grid=n_grid) == sum(isinstance(m, MseActQuantizer) for m in out.modules())
    return out.eval()


def test_model_tree_holds_each_quantizer_kind_where_jax_does(observed):
    model = observed[0]
    kinds = {name: ("mse" if isinstance(m, MseActQuantizer) else m.kind) for name, m in model.named_modules()
             if isinstance(m, ActQuantizer)}
    assert kinds.pop("encoder.in_quantizer") == kinds.pop("decoder.activation_fake_quantize") == "mulaw"
    assert set(kinds.values()) == {"mse"} and len(kinds) > 20  # the residual plane's out grid is MSE too, as JAX's
    assert has_pending_mse(model) and not has_pending_mse(_calibrated(model))


def test_calibration_and_export_match_jax_on_a_converted_state(observed):
    model = observed[0]
    variables = convert.convtasnet_to_jax(model.state_dict())
    want = jax_calibration.calibrate_mse_quantizers(variables, n_grid=30)  # JAX's loop: 20 ms a quantizer
    port = _calibrated(model, n_grid=30)
    got = convert.convtasnet_to_jax(port.state_dict())
    for coll in ("qparams", "qstats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(want[coll])[0]:
            node = got[coll]
            for k in path:
                node = node[k.key]
            np.testing.assert_array_equal(node, np.asarray(leaf), err_msg=str(path))
    grids, want_grids = export_quantizer_grids(port), jax_export.export_quantizer_grids(want)
    kinds = []

    def compare(a, b, path=""):
        assert set(a) == set(b), path
        if "kind" in a:
            kinds.append(a["kind"])
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=f"{path}/{k}")
            return
        for k in a:
            compare(a[k], b[k], f"{path}/{k}")

    compare(grids, want_grids)
    assert kinds.count("mulaw") == 2 and "per_channel" in kinds and "per_tensor" in kinds


def test_fix_range_and_the_frozen_grid_replays_match_jax():
    rng = np.random.default_rng(5)
    mn = np.float32(rng.uniform(-2, 1, 64))
    mx = np.float32(mn + rng.uniform(0.01, 3, 64))
    mn[:3], mx[3:6] = [0.2, 0.5, 1.0], [-0.1, -0.5, -1.0]  # one-sided ranges
    got = fq.fix_range_to_include_zero(torch.from_numpy(mn), torch.from_numpy(mx), 8)
    want = jax_fq.fix_range_to_include_zero(jnp.asarray(mn), jnp.asarray(mx), 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    x = rng.standard_normal((3, 8, 50)).astype(np.float32)
    scales = np.float32(rng.uniform(0.005, 0.05, 8))
    np.testing.assert_array_equal(
        fq.torch_fake_quantize_per_channel(torch.from_numpy(x), torch.from_numpy(scales), torch.zeros(8), 1, -128,
                                           127).numpy(),
        np.asarray(jax_fq.torch_fake_quantize_per_channel(x, scales, np.zeros(8, np.int32), 1, -128, 127)))
    grid = jax_export.freeze_activation_grid(np.float32([-0.9]), np.float32([1.3]))
    np.testing.assert_array_equal(
        fq.torch_fake_quantize_per_tensor(torch.from_numpy(x), grid["scale"], grid["zero_point"], 0, 255).numpy(),
        np.asarray(jax_fq.torch_fake_quantize_per_tensor(x, grid["scale"], grid["zero_point"], 0, 255)))


# ---------------------------------------------------------------------------
# The fused routes under an MSE quantizer
# ---------------------------------------------------------------------------


LAYERS = {
    "qdense": (lambda q: QDense(20, 12, q=q, generator=torch.Generator().manual_seed(0)),
               lambda q: JaxQDense(12, q=q), (2, 30, 20), lambda x: (x,), lambda x: (x,)),
    "qconv1d_k3": (lambda q: QConv1d(20, 12, 1, use_bias=False, q=q, generator=torch.Generator().manual_seed(0)),
                   lambda q: JaxQConv1d(12, 1, use_bias=False, q=q), (2, 20, 30), lambda x: (x,),
                   lambda x: (jnp.swapaxes(x, 1, 2),)),
    "attention": (lambda q: QMultiheadAttention(16, 4, q=q, generator=torch.Generator().manual_seed(0)),
                  lambda q: JaxQMultiheadAttention(16, 4, q=q), (3, 25, 16), lambda x: (x, x, x),
                  lambda x: (x, x, x)),
}


@pytest.mark.parametrize("layer", list(LAYERS))
def test_fused_routes_under_an_mse_quantizer_match_jax(layer):
    make, make_jax, shape, args, jax_args = LAYERS[layer]
    spec = dict(qat=True, act_quantizer="mse", max_observations=2)
    port = make(QuantSpec(**spec))
    jm = make_jax(JaxQuantSpec(**spec))
    rng = np.random.default_rng(6)
    out = lambda y: np.swapaxes(np.asarray(y), 1, 2) if layer == "qconv1d_k3" else np.asarray(y)
    observe = None
    with torch.no_grad():
        for k in range(3):  # two observations, then the window is closed but nothing is calibrated
            x = (rng.standard_normal(shape) * (1 + k)).astype(np.float32)
            v = convert.dptnet_to_jax(port.state_dict())
            observe = observe or jax.jit(lambda v, *a: jm.apply(v, *a, mutable=["qparams", "qstats"])).lower(
                v, *jax_args(jnp.asarray(x))).compile(compiler_options=ALGSIMP_OFF)
            want, upd = observe(v, *jax_args(jnp.asarray(x)))
            got = port.train()(*args(torch.from_numpy(x))).numpy()
            np.testing.assert_allclose(got, out(want), rtol=1e-5, atol=1e-5)
            for path, leaf in jax.tree_util.tree_flatten_with_path(upd["qstats"])[0]:
                name = ".".join(p.key for p in path)
                if name.endswith(("val_min", "val_max", "n_iter", "calibrated")):
                    np.testing.assert_allclose(port.state_dict()[name].numpy(), np.asarray(leaf), rtol=1e-5)
                elif name.endswith("hist"):  # products summed in another order can move a value to the next bin
                    assert np.abs(port.state_dict()[name].numpy() - np.asarray(leaf)).sum() <= 4, name
        assert calibrate_mse_quantizers(port) > 0
        off = make(QuantSpec(**dict(spec, observer=False)))  # serving: K8's head grid in its epilogue
        off.load_state_dict(port.state_dict())
        v = convert.dptnet_to_jax(port.state_dict())
        x = rng.standard_normal(shape).astype(np.float32)
        apply = jax.jit(lambda v, *a: jm.apply(v, *a, mutable=["qstats"])[0]).lower(
            v, *jax_args(jnp.asarray(x))).compile(compiler_options=ALGSIMP_OFF)
        want = out(apply(v, *jax_args(jnp.asarray(x))))
        for module in (port.train(), port.eval(), off.eval()):  # calibrated: the flag is off, the grid fused
            got = module(*args(torch.from_numpy(x))).numpy()
            aq = port.activation_fake_quantize
            _within_one_lsb(got, want, float(aq.max_range.detach() - aq.min_range.detach()) / 255)


# ---------------------------------------------------------------------------
# The tiny model
# ---------------------------------------------------------------------------


_COMPILED = {}


def _jax_forward(variables, mix):
    """JAX's eval forward (no observation, no range write), compiled once with algsimp off."""
    x = jnp.asarray(mix)
    if "forward" not in _COMPILED:
        jm = JaxConvTasNet(q=JaxQuantSpec(**SPEC), **ARCH)
        apply = jax.jit(lambda v, x: jm.apply(v, x, mutable=["qstats"])[0])
        _COMPILED["forward"] = apply.lower(variables, x).compile(compiler_options=ALGSIMP_OFF)
    return np.asarray(_COMPILED["forward"](variables, x))


@pytest.mark.parametrize("calibrated", [False, True])
def test_tiny_convtasnet_matches_jax_before_and_after_calibration(observed, calibrated):
    model, mix, _ = observed
    model = _calibrated(model) if calibrated else model
    want = _jax_forward(convert.convtasnet_to_jax(model.state_dict()), mix)
    with torch.no_grad():
        got = model(torch.from_numpy(mix)).numpy()
    assert got.shape == want.shape == (2, 2, T)
    snr = _snr_db(want, got)
    assert (snr >= 20).all(), snr


def test_converter_round_trip_holds_the_new_entries(observed):
    model = observed[0]
    state = model.state_dict()
    variables = convert.convtasnet_to_jax(state)
    jm = JaxConvTasNet(q=JaxQuantSpec(**SPEC), **ARCH)
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x), jnp.zeros((1, T)))
    want_keys = {jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(
        {k: v for k, v in shapes.items() if k != "macs"})[0]}
    assert {jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(variables)[0]} == want_keys
    back = convert.convtasnet_from_jax(variables)
    assert back.keys() == state.keys()
    assert all(torch.equal(back[k], state[k]) for k in state)
    assert "encoder.in_quantizer.mu" in state and "masker.bottleneck_norm.activation_fake_quantize.hist" in state


def test_kd_step_across_the_window_close_matches_jax(observed):
    """Two steps: the last observation of the window (MSE sites give their inputs, their ranges no gradient), then
    the calibration and a step on the calibrated grids; each against JAX's value_and_grad of the same state. The
    model has linear in and out grids here: the mu-law expansion's last bits differ between XLA's and PyTorch's
    ``pow``/``log1p`` (and between jitted and eager JAX), which moves downstream grid ties (1e-4 on the loss, 2.7%
    on a PReLU slope's gradient); the mu-law gradients are held to JAX's at the function above."""
    from fqss_tpu.separation.losses import fqss_kd_loss

    _, mix, src = observed
    spec = dict(SPEC, inout_nl_quant=False, max_observations=4)  # one observation left in the window
    start = _observe(spec, mix)
    teacher = ConvTasNet(**ARCH, generator=torch.Generator().manual_seed(1)).eval().requires_grad_(False)
    tv = convert.convtasnet_to_jax(teacher.state_dict())
    jt = JaxConvTasNet(**ARCH)
    fest = jax.jit(jt.apply)(tv, jnp.asarray(mix))[..., :T]
    jm = JaxConvTasNet(q=JaxQuantSpec(**spec), **ARCH)
    state = TrainState(start, make_optimizer(TrainConfig(), [p for p in start.parameters() if p.requires_grad]),
                       teacher)
    step = make_train_step(TrainConfig(grad_clip=0.0))
    def loss_fn(tr, qstats):
        est, _ = jm.apply({**tr, "qstats": qstats}, jnp.asarray(mix), mutable=["qparams", "qstats"])
        return fqss_kd_loss(est[..., :T], fest, jnp.asarray(src), kd_lambda=0.1)[0]

    vg = None
    for k in range(2):
        v = convert.convtasnet_to_jax(start.state_dict())
        trainable = {"params": v["params"], "qparams": v["qparams"]}
        vg = vg or jax.jit(jax.value_and_grad(loss_fn)).lower(trainable, v["qstats"]).compile(
            compiler_options=ALGSIMP_OFF)
        want_loss, grads = vg(trainable, v["qstats"])
        want = convert.convtasnet_from_jax(jax.device_get(grads))
        start.zero_grad()
        metrics = step(state, torch.from_numpy(mix), torch.from_numpy(src))
        np.testing.assert_allclose(float(metrics["loss"]), float(want_loss), rtol=1e-5)
        whole = np.sqrt(sum(np.sum(g.numpy() ** 2) for g in want.values()))
        for name, p in start.named_parameters():
            w = want[name].numpy()
            if p.grad is None:
                assert not w.any(), name
                continue
            err = np.linalg.norm(p.grad.numpy() - w) / max(np.linalg.norm(w), 1e-4 * whole, 1e-30)
            assert err <= 1e-3, (k, name, err)
        mse = [m for m in start.modules() if isinstance(m, MseActQuantizer)]
        if k == 0:  # inside the window the MSE sites pass their inputs: no range gradient
            assert not any(m.min_range.grad is not None and m.min_range.grad.any() for m in mse)
            assert has_pending_mse(start) and calibrate_mse_quantizers(start) == len(mse)
        else:
            assert sum(m.max_range.grad is not None and bool(m.max_range.grad.any()) for m in mse) > len(mse) // 2


# ---------------------------------------------------------------------------
# The int8 engines and a mu-law output grid
# ---------------------------------------------------------------------------


def test_int8_engines_refuse_a_mulaw_output_grid_that_jaxs_engine_serves_wrongly():
    spec = dict(qat=True, n_splitter=2, n_combiner=2, out_quant=True, inout_nl_quant=True, max_observations=3)
    mix, _ = synth_batch(np.random.default_rng(0), 2, 2, T)
    port = ConvTasNet(q=QuantSpec(**spec), generator=torch.Generator().manual_seed(0), **ARCH)
    with torch.no_grad():
        for _ in range(4):
            port.train()(torch.from_numpy(mix))
        port.decoder.activation_fake_quantize.mu.fill_(4.0)
    port.eval()
    v = convert.convtasnet_to_jax(port.state_dict())
    jm = JaxConvTasNet(q=JaxQuantSpec(**dict(spec, observer=False)), **ARCH)
    x = jnp.asarray(mix)
    want = np.asarray(jax.jit(jm.apply).lower(v, x).compile(compiler_options=ALGSIMP_OFF)(v, x))
    served = np.asarray(JaxEngine(jm, v, compute_dtype="float32")(x))
    # JAX's engine leaves its model: 33-37 dB, a mean of 0.28 output steps (with a linear out grid the two agree to
    # a mean of 3e-6 steps, above 130 dB; JAX_BOUND of tests/test_torch_int8.py allows 1e-3); the port's fake-quant
    # model does not
    aq = port.decoder.activation_fake_quantize
    steps = np.abs(served - want).mean() / float(aq.max_range.detach() - aq.min_range.detach()) * 255
    assert (_snr_db(want, served) < 40).all() and steps > 0.1, (_snr_db(want, served), steps)
    with torch.no_grad():
        assert (_snr_db(want, port(torch.from_numpy(mix)).numpy()) > 100).all()
    with pytest.raises(NotImplementedError, match="mu-law"):
        make_int8_engine(port)
    music = ConvTasNetMusic(q=QuantSpec(**spec), n_filters=16, bn_chan=8, hid_chan=16, n_blocks=2, n_repeats=1)
    served = auto_serving_model(music)  # the family's int8 path gives way to the folded model
    assert type(served) is ConvTasNetMusic and served.q.weight_quant is False
