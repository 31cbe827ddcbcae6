"""The port's LSTM static and dynamic modes (``QLSTM(mode="static" | "dynamic")``, ``dynamic_act_quant``) against
the JAX package, on the CPU.

* ``dynamic_act_quant`` bitwise against JAX's on random, positive-only and constant tensors, both grids; its
  gradient against ``jax.grad`` within 1e-5 where JAX's is finite. On a constant tensor JAX's gradient is NaN (the
  unselected branch divides 0 by a zero grid step); the port's is the identity's.
* ``QLSTM`` uni- and bidirectional at batch 1 and 2, T 12, from a state whose weight and output observers are done:
  static with the sites' window closing inside the call (``site_n_iter`` 45) and closed (50), dynamic. A train-mode
  call against JAX's apply with the quant collections mutable, run eagerly (``jax.disable_jit``: the jitted scan
  contracts the grid's ``delta * C + mn`` into an FMA, an ulp that a tie turns into a step): the layer rule (every output within one LSB of the output grid, at most 1% more than
  half an LSB apart), and the static state written back: ``site_n_iter`` equal, ``site_min``/``site_max`` within
  1e-6 of their magnitude (JAX's jitted EMA may contract into an FMA).
* Gradients of the input, the weights, the biases and the site ranges (``gradient_based`` on and off) against
  ``jax.grad`` of the same call: whole-gradient cosine >= 0.999, each tensor within 1e-2 of the whole gradient's
  norm (a grid step flipped by a tie moves a range term by 1/Q). JAX's dynamic cell has NaN gradients (its first
  step's ``h @ w_hh`` is the constant 0), so its gradient reference is JAX's QLSTM with ``dynamic_act_quant``
  replaced by the same function with the port's guard.
* The plain static recurrence in its two parts (the window, the EMA, the rest: the kernel's path) bitwise equal to
  a one-scan recurrence written as JAX's (the observer flag per step through the carry), values and gradients.
* A tiny FQSS-8bit DPTNet in each mode: the serving forward >= 20 dB against JAX's; the fold bitwise equal to the
  fake-quant model; the static int8 engine against JAX's engine within ``tests/test_torch_int8.py``'s float32 ``JAX_BOUND``; a JAX ``.npz``
  export of the static model through ``load_pretrained_state`` and back through ``dptnet_to_jax`` unchanged.

A KD step in each mode: ``tests/test_torch_lstm_modes_train.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fqss_tpu.nn.lstm as jax_lstm
from fqss_tpu.data import synth_batch
from fqss_tpu.models.dptnet import DPTNet as JaxDPTNet
from fqss_tpu.quant import QuantSpec as JaxQuantSpec
from fqss_tpu.quant.calibration import run_observer
from fqss_tpu.quant.fake_quant import linear_fake_quant as jax_linear_fake_quant
from fqss_tpu.quant.quantizers import dynamic_act_quant as jax_dynamic_act_quant
from fqss_tpu.serve.dptnet_int8 import DPTNetInt8Engine as JaxEngine
from fqss_tpu_torch.models.convert import dptnet_from_jax, dptnet_to_jax
from fqss_tpu_torch.models.dptnet import DPTNet
from fqss_tpu_torch.nn.lstm import QLSTM
from fqss_tpu_torch.ops import lstm
from fqss_tpu_torch.quant.fake_quant import linear_fake_quant
from fqss_tpu_torch.quant.quantizers import dynamic_act_quant
from fqss_tpu_torch.quant.spec import QuantSpec
from fqss_tpu_torch.serve import DPTNetInt8Engine
from fqss_tpu_torch.serve.fold import fold_quantized_weights

torch.set_num_threads(1)

ALGSIMP_OFF = {"xla_disable_hlo_passes": "algsimp"}
B_MAX, T, C, H = 2, 12, 6, 8
GRAD = dict(cos=0.999, tensor_of_whole=1e-2)
ARCH = dict(n_srcs=2, kernel_size=2, enc_dim=16, feature_dim=8, hidden_dim=16, layer=1, segment_size=20)
SPEC = dict(qat=True, n_splitter=2, n_combiner=2, out_quant=True, max_observations=3)
# tests/test_torch_int8.py's float32 JAX_BOUND: (SNR per output, share of samples half a step apart, mean steps)
INT8_JAX_BOUND = (100.0, 1e-3, 1e-3)


def _compile(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=ALGSIMP_OFF)


def _jax_guarded_dynamic(x, n_bits=8, sym=False, factor=0.99):
    """JAX's ``dynamic_act_quant`` with the port's guard: the constant tensor's branch on a stand-in range."""
    mn, mx = jnp.min(x), jnp.max(x)
    flat = mn == mx
    lo, hi = jnp.where(flat, 0.0, factor * mn), jnp.where(flat, 1.0, factor * mx)
    return jnp.where(flat, x, jax_linear_fake_quant(x, lo, hi, n_bits, lo < 0, sym))


# ---------------------------------------------------------------------------
# dynamic_act_quant
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["normal", "positive", "constant", "tie"])
@pytest.mark.parametrize("sym", [False, True], ids=["uniform", "symmetric"])
def test_dynamic_act_quant_matches_jax(kind, sym):
    rng = np.random.default_rng(len(kind))
    x = {"normal": rng.standard_normal((3, 40)), "positive": np.abs(rng.standard_normal((3, 40))) + 0.1,
         "constant": np.full((4, 5), 0.3), "tie": np.array([0.1, -0.3, 0.5, 0.5, -0.3])}[kind].astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    want = np.asarray(jax_dynamic_act_quant(jnp.asarray(x), 8, sym))
    np.testing.assert_array_equal(dynamic_act_quant(torch.from_numpy(x), 8, sym).numpy(), want)
    if kind == "constant":
        np.testing.assert_array_equal(want, x)
    t = torch.from_numpy(x).requires_grad_(True)
    (dynamic_act_quant(t, 8, sym) * torch.from_numpy(ct)).sum().backward()
    jgrad = np.asarray(jax.grad(lambda a: (jax_dynamic_act_quant(a, 8, sym) * ct).sum())(jnp.asarray(x)))
    if kind == "constant" and not sym:
        assert np.isnan(jgrad).all()  # JAX's fault (module note); the port passes the cotangent through
        np.testing.assert_array_equal(t.grad.numpy(), ct)
        return
    np.testing.assert_allclose(t.grad.numpy(), jgrad, rtol=0, atol=1e-5)


def test_dynamic_act_quant_over_dims_quantizes_each_slice_alone():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 3, 10)).astype(np.float32))
    x[1] = 0.25  # a constant direction: the identity
    y = dynamic_act_quant(x, 8, dims=(1, 2))
    assert torch.equal(y[0], dynamic_act_quant(x[0], 8)) and torch.equal(y[1], x[1])


# ---------------------------------------------------------------------------
# QLSTM
# ---------------------------------------------------------------------------


def _input(seed=0):
    return np.random.default_rng(seed).standard_normal((B_MAX, T, C)).astype(np.float32)


_VARIABLES = {}


def _prepared(mode, bidirectional, gradient_based=True):
    """(JAX QLSTM, variables whose weight and output observers are done) at the input of :func:`_input`."""
    key = (mode, bidirectional, gradient_based)
    if key not in _VARIABLES:
        q = JaxQuantSpec(qat=True, observer=True, max_observations=2, lstm_mode=mode, gradient_based=gradient_based)
        jm = JaxQLSTM(H, bidirectional=bidirectional, mode=mode, q=q)
        x = jnp.asarray(_input())
        v = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(3), x))
        dirs = ("fw", "bw") if bidirectional else ("fw",)
        observe = jax.jit(lambda v: jm.apply(v, x, mutable=["qparams", "qstats"])[1])
        for _ in range(2):  # the one-shot weight observers and the output quantizer's two-step window
            if mode == "static":
                for d in dirs:
                    v["qstats"][d]["site_n_iter"] = np.int32(50)
            v = {**v, **jax.device_get(observe(v))}
        _VARIABLES[key] = (jm, v)
    return _VARIABLES[key]


JaxQLSTM = jax_lstm.QLSTM


def _start(v, mode, bidirectional, start):
    v = jax.tree_util.tree_map(np.array, v)
    if mode == "static":
        for d in ("fw", "bw") if bidirectional else ("fw",):
            v["qstats"][d]["site_n_iter"] = np.int32(start)
    return v


def _port(mode, bidirectional, v, gradient_based=True):
    m = QLSTM(C, H, bidirectional=bidirectional, mode=mode,
              q=QuantSpec(qat=True, observer=True, max_observations=2, gradient_based=gradient_based))
    m.load_state_dict(dptnet_from_jax(v), strict=True)
    return m.train()


CASES = [("static", 45), ("static", 50), ("dynamic", 0)]


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("bidirectional", [True, False], ids=["bi", "uni"])
@pytest.mark.parametrize("mode,start", CASES, ids=["static-window-closes", "static-closed", "dynamic"])
def test_qlstm_train_call_matches_jax(mode, start, bidirectional, batch):
    jm, v0 = _prepared(mode, bidirectional)
    v = _start(v0, mode, bidirectional, start)
    x = _input()[:batch]
    with jax.disable_jit():
        want, mutated = jm.apply(v, jnp.asarray(x), mutable=["qparams", "qstats"])
    want, mutated = np.asarray(want), jax.device_get(mutated)
    port = _port(mode, bidirectional, v)
    lstm.reset_launches()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert set(lstm.LAUNCHES.values()) == {0}  # CPU tensors: the plain versions
    assert got.shape == want.shape == (batch, T, (2 if bidirectional else 1) * H)
    aq = v["qparams"]["activation_fake_quantize"]
    lsb = float(aq["max_range"][0] - aq["min_range"][0]) / 255
    diff = np.abs(got - want)
    assert diff.max() <= lsb * (1 + 1e-4), diff.max() / lsb
    assert np.mean(diff > 0.5 * lsb) <= 0.01
    if mode != "static":
        return
    written = dptnet_from_jax({**v, **mutated})
    state = port.state_dict()
    for k, w in written.items():
        if k.endswith("site_n_iter"):
            assert int(state[k]) == int(w) == min(start + T, 50), k
        elif "site_" in k:
            np.testing.assert_allclose(state[k].numpy(), w.numpy(), rtol=1e-6, atol=0, err_msg=k)
    if start < 50:  # the window moved the ranges
        assert not np.array_equal(written["fw.site_min"].numpy(), v["qparams"]["fw"]["site_min"])


@pytest.mark.parametrize("mode,gradient_based", [("static", True), ("static", False), ("dynamic", True)])
def test_qlstm_gradients_match_jax_grad(mode, gradient_based, monkeypatch):
    monkeypatch.setattr(jax_lstm, "dynamic_act_quant", _jax_guarded_dynamic)
    jm, v0 = _prepared(mode, True, gradient_based)
    v = _start(v0, mode, True, 45)
    x = _input()
    ct = np.random.default_rng(9).standard_normal((B_MAX, T, 2 * H)).astype(np.float32)

    def loss(trainable, x):
        y, _ = jm.apply({**trainable, "qstats": v["qstats"]}, x, mutable=["qparams", "qstats"])
        return (y * ct).sum()

    trainable = {"params": v["params"], "qparams": v["qparams"]}
    jgrads = _compile(jax.grad(loss, argnums=(0, 1)), trainable, jnp.asarray(x))(trainable, jnp.asarray(x))
    want = dptnet_from_jax(jax.device_get(jgrads[0]))
    want["x"] = torch.from_numpy(np.array(jgrads[1]))
    port = _port(mode, True, v, gradient_based)
    xt = torch.from_numpy(x).requires_grad_(True)
    (port(xt) * torch.from_numpy(ct)).sum().backward()
    got = {k: p.grad for k, p in port.named_parameters()}
    got["x"] = xt.grad
    whole = np.sqrt(sum(float((w.double() ** 2).sum()) for w in want.values()))
    flat_got = torch.cat([(got[k] if got[k] is not None else torch.zeros_like(w)).flatten() for k, w in want.items()])
    flat_want = torch.cat([w.flatten() for w in want.values()])
    assert torch.isfinite(flat_got).all()
    assert float(flat_got.double() @ flat_want.double()) / (float(flat_got.double().norm()) * whole) >= GRAD["cos"]
    for k, w in want.items():
        g = got[k]
        if g is None:  # no gradient: a parameter without requires_grad (gradient_based off), or a range JAX stops
            assert not w.abs().any() or not gradient_based, k
            continue
        assert float((g - w).double().norm()) <= GRAD["tensor_of_whole"] * whole, k
    sites = [k for k in got if "site_" in k]
    if mode == "static":
        assert sites and all((got[k] is not None) == gradient_based for k in sites)
        if gradient_based:
            assert all(got[k].abs().sum() > 0 for k in sites)


def _one_scan(ih, w_hh, site_min, site_max, start, n_bits=8, observer=True):
    """The static recurrence as JAX's scan writes it: the observer flag per step through the carry."""
    B, G = ih.shape[1:]
    h, c = ih.new_zeros(B, G // 4), ih.new_zeros(B, G // 4)
    mn, mx, cnt, hs = site_min, site_max, start, []
    for ih_t in ih.unbind(0):
        obs = observer and start < 50 and cnt < 50
        seen = {}

        def q(s, v):
            seen[s] = (v.detach().amin(), v.detach().amax())
            return v if obs else linear_fake_quant(v, mn[s], mx[s], n_bits)

        h, c = lstm._cell(h, c, ih_t, w_hh, q)
        if obs:
            mn = 0.9 * mn + 0.1 * torch.stack([seen[s][0] for s in range(12)])
            mx = 0.9 * mx + 0.1 * torch.stack([seen[s][1] for s in range(12)])
            cnt += 1
        hs.append(h)
    return torch.stack(hs), mn, mx


@pytest.mark.parametrize("steps,start", [(12, 45), (12, 50), (3, 45), (12, 0), (60, 0)])
def test_two_part_static_recurrence_equals_one_scan_bitwise(steps, start):
    rng = np.random.default_rng(steps + start)
    Hs = 5
    ih = torch.from_numpy((rng.standard_normal((steps, 3, 4 * Hs)) * 0.7).astype(np.float32))
    w = torch.from_numpy((rng.uniform(-1, 1, (Hs, 4 * Hs)) / np.sqrt(Hs)).astype(np.float32))
    mn = torch.from_numpy(rng.uniform(-1.5, -0.2, 12).astype(np.float32))
    mx = torch.from_numpy(rng.uniform(0.2, 1.5, 12).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((steps, 3, Hs)).astype(np.float32))
    outs, grads = [], []
    for fn in (lambda *a: lstm.lstm_static_sequence_ref(*a, max(0, min(steps, 50 - start))),
               lambda *a: _one_scan(*a, start)):
        t = [a.clone().requires_grad_(True) for a in (ih, w, mn, mx)]
        hs, new_mn, new_mx = fn(*t)
        (hs * g).sum().backward()
        outs.append((hs.detach(), new_mn.detach(), new_mx.detach()))
        grads.append([a.grad for a in t])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    for a, b in zip(*grads):  # the ranges have no gradient where every step was observed
        assert (a is None and b is None) or torch.equal(a, b)
    assert torch.equal(lstm.lstm_static_sequence(ih, w, mn, mx, max(0, min(steps, 50 - start)))[0], outs[0][0])


@pytest.mark.parametrize("mode,spec,sites", [
    ("static", dict(qat=False), False),  # a float model runs the fused recurrence, as in JAX
    ("dynamic", dict(qat=False), False),
    ("static", dict(qat=True, act_quant=False), False),
    ("static", dict(qat=True), True),
])
def test_qlstm_builds_the_variables_jax_builds(mode, spec, sites):
    port = QLSTM(6, 8, mode=mode, q=QuantSpec(**spec))
    assert port.mode == (mode if sites or spec.get("act_quant", True) and spec["qat"] else "fused")
    jm = JaxQLSTM(8, mode=mode, q=JaxQuantSpec(**spec))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 3, 6)))
    want = {k: tuple(s.shape) for k, s in dptnet_from_jax(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)).items()}
    assert {k: tuple(t.shape) for k, t in port.state_dict().items()} == want
    assert any("site_" in k for k in want) == sites
    with pytest.raises(ValueError, match="lstm_mode"):
        QLSTM(6, 8, mode="fused_bidir", q=QuantSpec(**spec))


# ---------------------------------------------------------------------------
# The tiny DPTNet in each mode
# ---------------------------------------------------------------------------


_CALIBRATED = {}


def calibrated(mode):
    """(mode, JAX eval model, calibrated JAX variables, port eval model, mixtures [2, 600]), once a mode."""
    if mode not in _CALIBRATED:
        spec = dict(SPEC, lstm_mode=mode)
        mix, _ = synth_batch(np.random.default_rng(0), 2, 2, 600)
        obs = JaxDPTNet(q=JaxQuantSpec(observer=True, **spec), **ARCH)
        variables = jax.device_get(run_observer(obs, jax.jit(obs.init)(jax.random.PRNGKey(0), jnp.asarray(mix)),
                                                jnp.asarray(mix), steps=4))
        port = DPTNet(q=QuantSpec(observer=False, **spec), **ARCH)
        port.load_state_dict(dptnet_from_jax(variables), strict=True)
        _CALIBRATED[mode] = (mode, JaxDPTNet(q=JaxQuantSpec(observer=False, **spec), **ARCH), variables,
                             port.eval(), mix)
    return _CALIBRATED[mode]


def _snr_db(ref, est):
    return 10 * np.log10(np.sum(ref**2, -1) / np.maximum(np.sum((ref - est) ** 2, -1), 1e-30))


def _forward(model, mix):
    with torch.inference_mode():
        return model(torch.from_numpy(np.asarray(mix))).numpy()


@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_dptnet_forward_matches_jax_and_folds_bitwise(mode):
    mode, jm, variables, port, mix = calibrated(mode)
    x = jnp.asarray(mix)
    want = np.asarray(_compile(jm.apply, variables, x)(variables, x))
    got = _forward(port, mix)
    assert got.shape == want.shape == (2, 2, 600)
    assert (_snr_db(want, got) >= 20).all(), _snr_db(want, got)
    assert all(m.mode == mode for m in port.modules() if isinstance(m, QLSTM))
    if mode == "static":
        assert all(int(b) == 50 for n, b in port.named_buffers() if n.endswith("site_n_iter"))
    np.testing.assert_array_equal(_forward(fold_quantized_weights(port), mix), got)


def test_static_int8_engine_matches_the_jax_engine():
    mode, jm, variables, port, mix = calibrated("static")
    engine = JaxEngine(jm, variables, compute_dtype="float32")
    x = jnp.asarray(mix)
    want = np.asarray(_compile(engine._forward, x)(x))
    got = DPTNetInt8Engine(port, compute_dtype="float32")(torch.from_numpy(mix)).numpy()
    aq = port.decoder.activation_fake_quantize
    lsb = float(aq.max_range.detach() - aq.min_range.detach()) / 255
    snr, diff = _snr_db(want, got), np.abs(got - want) / lsb
    snr_min, share_max, mean_max = INT8_JAX_BOUND
    assert (snr >= snr_min).all(), snr
    assert (diff > 0.5).mean() <= share_max and diff.mean() <= mean_max, ((diff > 0.5).mean(), diff.mean())


def test_static_npz_export_loads_and_round_trips(tmp_path):
    from fqss_tpu.train.checkpoints import export_model

    from fqss_tpu_torch.models.factory import load_pretrained_state

    mode, jm, variables, port, mix = calibrated("static")
    path = str(tmp_path / "static.npz")
    export_model(path, variables)
    model = DPTNet(q=QuantSpec(observer=False, **dict(SPEC, lstm_mode=mode)), **ARCH)
    state = load_pretrained_state(model, path)
    model.load_state_dict(state, strict=True)
    want = dptnet_from_jax(variables)
    sites = [k for k in want if "site_" in k]
    assert len(sites) == 3 * 4  # min, max and count of 2 directions of the row and the column LSTM
    for k in want:
        assert torch.equal(state[k], want[k]), k
    back = dptnet_to_jax(model.state_dict())
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(a) for p, a in jax.tree_util.tree_flatten_with_path(t)[0]}
    a, b = flat(jax.device_get(variables)), flat(back)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    np.testing.assert_array_equal(_forward(model.eval(), mix), _forward(port, mix))
