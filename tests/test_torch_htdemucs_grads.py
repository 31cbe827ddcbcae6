"""The gradients of the port's HTDemucs layers against ``jax.grad`` of the JAX package, on the CPU.

* K5-bwd's GELU route: ``QDense(nl="gelu")`` (its plain backward, which the
  CPU takes) against ``jax.grad`` of JAX's ``QDense(nl="gelu")``, which
  XLA computes (``jnp.dot + b -> Nl("gelu") -> act quantizer``), on the
  steps inside the act observer's window, on the step that crosses it and
  after it, and with the act grid off. The JAX step is jitted with XLA's
  algebraic simplifier off (eager's divisions).
* Each HTDemucs layer with a gradient of its own: ``QConv2d`` (GELU; GLU
  with its GroupNorm), ``QConvTranspose1d``/``2d`` (GELU), ``QConv1d`` with
  its GroupNorm and GELU, ``GroupNormT`` (``GroupNorm1`` and its Const
  site), calibrated by a two-step JAX observer pass and run with the window
  closed.
* ``stft``/``istft`` and the model's ``_spec``/``_ispec`` (the reflect pad
  and the trims), and K8's autograd at head width 48 with ``Lq != Lk``
  against ``jax.grad`` through ``fused_attention``'s VJP with its Pallas
  forward in interpret mode (as ``tests/test_pallas_attention.py`` runs it).

Bound, for every gradient tensor: rtol 1e-4 and atol 1e-5 of the largest
magnitude of JAX's (``tests/test_torch_qat_dense.py``'s rule for dx). A range's
gradient is a sum of terms that nearly cancel (``tests/test_torch_music_train.py``),
over the layer's outputs (an act grid) or a channel's weights: it is held
within 1e-5 of the sum of its terms' magnitudes instead
(``ops.fake_quant.act_bwd_terms`` and ``weight_bwd_terms`` at the grid's
input, the weight's terms times ``2 / 255``, the step's share). An act
range's term takes ``round(u) - u`` of the grid's input ``u`` in steps,
and the two packages' ``u`` differ in the last bits (XLA's ``erfc``, conv
and GroupNorm sums round apart from PyTorch's), which moves the term by
``|g| |du| / 255``: an act range is also allowed ``|g| 2^-21 |v| / (mx -
mn)`` summed over the outputs (four float32 ulps of each input ``v``), and
``|g|`` summed over the outputs more than half a step apart (a rounding
tie put on its two sides).
"""

import importlib

import numpy as np
import pytest
import torch

import flax.linen
import jax
import jax.numpy as jnp

from fqss_tpu.models.htdemucs import HTDemucs as JaxHTDemucs
from fqss_tpu.models.htdemucs import _GroupNormT as JaxGroupNormT
from fqss_tpu.nn import layers as jax_layers
from fqss_tpu.quant import QuantSpec as JaxQuantSpec
from fqss_tpu_torch.models.convert import htdemucs_from_jax
from fqss_tpu_torch.models.htdemucs import GroupNormT, HTDemucs
from fqss_tpu_torch.nn import layers
from fqss_tpu_torch.ops import attention as k8
from fqss_tpu_torch.ops.fake_quant import act_bwd_terms, weight_bwd_terms
from fqss_tpu_torch.ops import qat_dense as qd
from fqss_tpu_torch.quant.spec import QuantSpec

torch.set_num_threads(1)

ALGSIMP_OFF = {"xla_disable_hlo_passes": "algsimp"}
TINY = dict(channels=8, nfft=512, t_layers=3, t_heads=4, segment=0.5, samplerate=8000)
RTOL, ATOL = 1e-4, 1e-5  # atol relative to the largest |gradient|


def _noalg(fn):
    return jax.jit(fn, compiler_options=ALGSIMP_OFF)


def _assert_grad(got, want, what, extra=0.0):
    """The rule, with ``extra`` (a scalar or an array broadcast to the gradient's shape) added to the atol."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want) - (RTOL * np.abs(want) + ATOL * np.abs(want).max() + extra)
    assert (err <= 0).all(), (what, float(err.max()), float(np.abs(got - want).max()))


def _nested(variables, scope):
    """``variables`` under the module path ``scope`` (dotted), as a model's tree holds them."""
    for name in reversed(scope.split(".")) if scope else ():
        variables = {col: {name: tree} for col, tree in variables.items()}
    return variables


def _state(variables, scope=None):
    """The port's state dict of a layer from its JAX variables, ``scope`` naming its place for the converter."""
    sd = htdemucs_from_jax(_nested(variables, scope))
    return {k.removeprefix(scope + "."): v for k, v in sd.items()} if scope else sd


def _act_range_tols(u, g, mn, mx, far):
    """{"min_range": tol, "max_range": tol} of an act grid at input ``u`` with output cotangent ``g`` (port
    tensors): 1e-5 of the sum of the terms' magnitudes, ``|g|`` times four ulps of ``u`` in steps over the outputs,
    and ``|g|`` over the outputs ``far`` (numpy mask, in ``g``'s layout) that sit more than half a step from
    JAX's."""
    _, p_mn, p_mx = act_bwd_terms(u.detach(), g, mn.detach().reshape(1), mx.detach().reshape(1), 8, 1.0)
    slack = float(g.abs().numpy()[far].sum()) + float((g.abs() * u.abs()).sum()) * 2.0**-21 / float((mx - mn).detach())
    return {"min_range": 1e-5 * float(p_mn.abs().sum()) + slack, "max_range": 1e-5 * float(p_mx.abs().sum()) + slack}


def _weight_range_tols(w, dwq, mn, mx, ch_axis):
    """Per channel: 1e-5 of the sum of the weight grid's terms' magnitudes times 2 / 255 (``route_range_grad``),
    in the ranges' shape."""
    _, terms = weight_bwd_terms(w, dwq, mn.detach(), mx.detach(), 8, ch_axis)
    dims = tuple(i for i in range(w.ndim) if i != ch_axis)
    return (1e-5 * terms.abs().sum(dims) * 2 / 255).reshape(mn.shape).numpy()


def _assert_range_grad(got, want, tol, what):
    assert abs(float(got) - float(want)) <= tol, (what, float(got), float(want), tol)


# ---------------------------------------------------------------------------
# K5-bwd's GELU route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act_quant", [True, False])
def test_dense_gelu_route_backward_matches_jax_grad(act_quant):
    """Four steps of ``QDense(nl="gelu")`` in ``train()`` mode, the act window two steps long: inside it (the
    grid skipped, ``gm = g gelu'(pre)``), the step that crosses it and one after; with ``act_quant`` False the act
    grid is off throughout. Outputs, updated state and every gradient (x, kernel, bias, the four ranges)."""
    spec = dict(qat=True, max_observations=2, observer=True, act_quant=act_quant)
    rng = np.random.default_rng(7)
    xs = [rng.standard_normal((2, 30, 20)).astype(np.float32) * (1 + i) for i in range(4)]
    g = rng.standard_normal((2, 30, 12)).astype(np.float32)
    jm = jax_layers.QDense(12, nl="gelu", q=JaxQuantSpec(**spec))
    variables = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(xs[0])))

    def loss(trainable, qstats, x):
        y, upd = jm.apply({**trainable, "qstats": qstats}, x, mutable=["qparams", "qstats"])
        return jnp.vdot(jnp.asarray(g), y), (y, upd)

    step = jax.jit(jax.value_and_grad(loss, argnums=(0, 2), has_aux=True)).lower(
        {"params": variables["params"], "qparams": variables["qparams"]}, variables["qstats"],
        jnp.asarray(xs[0])).compile(compiler_options=ALGSIMP_OFF)
    port = layers.QDense(20, 12, q=QuantSpec(**spec), nl="gelu")
    port.load_state_dict(_state(variables), strict=True)
    port.train()
    qd.reset_launches()
    for i, x in enumerate(xs):
        (_, (want, upd)), (want_g, want_dx) = step({"params": variables["params"], "qparams": variables["qparams"]},
                                                   variables["qstats"], jnp.asarray(x))
        aq, wq = port.activation_fake_quantize, port.weight_fake_quantize
        tx = torch.from_numpy(x).requires_grad_(True)
        port.zero_grad()
        got = port(tx)
        (got * torch.from_numpy(g)).sum().backward()
        want = np.asarray(want)
        far = np.zeros(want.shape, bool)
        if act_quant and i >= spec["max_observations"]:  # quantized: one LSB, at most 1% a step apart
            diff = np.abs(got.detach().numpy() - want) / (float((aq.max_range - aq.min_range).detach()) / 255)
            far = diff > 0.5
            assert diff.max() <= 1 + 1e-4 and far.mean() <= 0.01, (i, diff.max(), far.mean())
        else:  # inside the window or without an act grid: the float post-GELU value
            np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
        variables = jax.device_get({**variables, **upd})
        for k, v in port.state_dict().items():
            np.testing.assert_allclose(v.numpy(), _state(variables)[k].numpy(), rtol=1e-5, atol=1e-7,
                                       err_msg=f"{i} {k}")
        want_grads = _state(jax.device_get(want_g))
        tols = {}
        if act_quant:  # the act grid's input: the post-GELU value on the weights' grid of this step
            with torch.no_grad():
                u = qd.qat_dense_ref(tx.detach().reshape(-1, 20), port.weight, port.bias, wq.min_range.reshape(-1),
                                     wq.max_range.reshape(-1), gelu=True)
            tols = _act_range_tols(u, torch.from_numpy(g).reshape(-1, 12), aq.min_range, aq.max_range,
                                   far.reshape(-1, 12))
        for k, p in port.named_parameters():
            if k.startswith("activation"):
                _assert_range_grad(p.grad, want_grads[k], tols[k.split(".")[-1]], f"step {i} {k}")
            else:
                _assert_grad(p.grad.numpy(), want_grads[k].numpy(), f"step {i} {k}")
        _assert_grad(tx.grad.numpy(), want_dx, f"step {i} dx")
    assert qd.LAUNCHES["dense_mask_gelu"] == 0  # CPU tensors take the plain version


def test_dense_gelu_route_refuses_a_bf16_gradient():
    layer = layers.QDense(16, 24, q=QuantSpec(qat=True, observer=False, compute_dtype="bfloat16"), nl="gelu")
    with pytest.raises(NotImplementedError, match="bf16"):
        layer(torch.randn(2, 5, 16))
    with torch.no_grad():
        assert torch.isfinite(layer(torch.randn(2, 5, 16))).all()


def test_gelu_grad_is_the_derivative_jax_takes():
    from fqss_tpu_torch.nn.nonlin import gelu_grad

    x = np.linspace(-8, 8, 4001, dtype=np.float32)
    want = np.asarray(jax.vmap(jax.grad(lambda v: jax.nn.gelu(v, approximate=False)))(jnp.asarray(x)))
    np.testing.assert_allclose(gelu_grad(torch.from_numpy(x)).numpy(), want, rtol=2e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# The layers
# ---------------------------------------------------------------------------


def _x(shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.8).astype(np.float32)


GRAD_CASES = ["conv2d_gelu", "conv2d_glu_norm", "convtr1d_gelu", "convtr2d_gelu", "conv1d_norm_gelu", "groupnorm_t"]


def _grad_case(name):
    """(JAX maker, port maker, the JAX-layout input, converter scope, channels-last in the port)."""
    if name == "conv2d_gelu":
        return (lambda q: jax_layers.QConv2d(12, (8, 1), stride=(4, 1), padding=(2, 0), nl="gelu", q=q),
                lambda q: layers.QConv2d(6, 12, (8, 1), stride=(4, 1), padding=(2, 0), nl="gelu", q=q),
                _x((2, 40, 9, 6)), None, False)
    if name == "conv2d_glu_norm":
        return (lambda q: jax_layers.QConv2d(16, 3, padding=1, nl="glu", norm_groups=4, q=q),
                lambda q: layers.QConv2d(6, 16, 3, padding=1, nl="glu", norm_groups=4, q=q),
                _x((2, 12, 9, 6)), None, False)
    if name == "convtr1d_gelu":
        return (lambda q: jax_layers.QConvTranspose1d(6, 8, 4, nl="gelu", q=q),
                lambda q: layers.QConvTranspose1d(10, 6, 8, 4, nl="gelu", q=q), _x((2, 30, 10)), "conv_tr", False)
    if name == "convtr2d_gelu":
        return (lambda q: jax_layers.QConvTranspose2d(6, (8, 1), (4, 1), nl="gelu", q=q),
                lambda q: layers.QConvTranspose2d(10, 6, (8, 1), (4, 1), nl="gelu", q=q), _x((2, 7, 5, 10)),
                "conv_tr", False)
    if name == "conv1d_norm_gelu":
        return (lambda q: jax_layers.QConv1d(5, 3, dilation=2, padding=2, norm_groups=1, nl="gelu", q=q),
                lambda q: layers.QConv1d(8, 5, 3, dilation=2, padding=2, norm_groups=1, nl="gelu", q=q),
                _x((2, 50, 8)), None, False)
    return (lambda q: JaxGroupNormT(q=q), lambda q: GroupNormT(16, q=q), _x((2, 33, 16)) * 3 + 0.5,
            "crosstransformer.layer_0.norm_out", True)


@pytest.mark.parametrize("name", GRAD_CASES)
def test_layer_gradients_match_jax_grad(name):
    """The layer after a two-step observer pass, its window closed: ``jax.grad`` of ``<g, layer(x)>`` in the
    parameters, the ranges and x."""
    spec = dict(qat=True, n_splitter=2, n_combiner=2, out_quant=True, max_observations=2)
    make, port_make, x, scope, channels_last = _grad_case(name)
    obs = make(JaxQuantSpec(observer=True, **spec))
    variables = flax.linen.Module.init(obs, jax.random.PRNGKey(0), jnp.asarray(x))
    observe = _noalg(lambda v, x: obs.apply(v, x, mutable=["qparams", "qstats"]))
    for _ in range(2):
        _, upd = observe(variables, jnp.asarray(x))
        variables = {**variables, **upd}
    variables = jax.device_get(variables)
    served = make(JaxQuantSpec(observer=False, **spec))
    y0 = np.asarray(_noalg(served.apply)(variables, jnp.asarray(x)))  # the output's shape
    g = np.random.default_rng(3).standard_normal(y0.shape).astype(np.float32)

    def loss(trainable, x):
        y = served.apply({**variables, **trainable}, x)
        return jnp.vdot(jnp.asarray(g), y), y

    trainable = {"params": variables["params"], "qparams": variables["qparams"]}
    (want, y0), (want_g, want_dx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)).lower(
        trainable, jnp.asarray(x)).compile(compiler_options=ALGSIMP_OFF)(trainable, jnp.asarray(x))
    y0 = np.asarray(y0)  # the forward of the same compile as the gradient: the same rounding ties
    port = port_make(QuantSpec(observer=False, **spec))
    port.load_state_dict(_state(variables, scope), strict=True)

    def to_port(a):
        return torch.from_numpy(np.ascontiguousarray(a if channels_last else np.moveaxis(a, -1, 1)))

    def to_jax(t):
        return t.detach().numpy() if channels_last else np.moveaxis(t.detach().numpy(), 1, -1)

    def to_jax_mask(m):  # a JAX-layout mask in the port's layout
        return m if channels_last else np.moveaxis(m, -1, 1)

    seen = {}
    aq_port = port.const.activation_fake_quantize if name == "groupnorm_t" else port.activation_fake_quantize
    aq_port.register_forward_hook(lambda mod, args, out: seen.update(u=args[0].detach()))
    wq_port = getattr(port, "weight_fake_quantize", None)
    if wq_port is not None:  # the weight and its grid's cotangent
        def keep(mod, args, out):
            out.register_hook(lambda gr: seen.update(w=args[0].detach(), dwq=gr.detach()))

        wq_port.register_forward_hook(keep)
    tx = to_port(x).requires_grad_(True)
    y = port(tx)
    (y * to_port(g)).sum().backward()
    aq = variables["qparams"]
    aq = (aq["const"] if name == "groupnorm_t" else aq)["activation_fake_quantize"]
    lsb = (float(aq["max_range"][0]) - float(aq["min_range"][0])) / 255
    diff = np.abs(to_jax(y) - y0) / lsb
    far = diff > 0.5
    assert diff.max() <= 1 + 1e-4 and far.mean() <= 0.01, (diff.max(), far.mean())
    np.testing.assert_allclose(float((y * to_port(g)).sum().detach()), float(want), rtol=1e-4)
    tols = _act_range_tols(seen["u"], to_port(g), aq_port.min_range, aq_port.max_range, to_jax_mask(far))
    want_grads = _state(jax.device_get(want_g), scope)
    params = dict(port.named_parameters())
    assert set(params) == set(want_grads)
    for k, p in params.items():
        if p.grad is None:
            assert not np.any(want_grads[k].numpy()), k
        elif k.endswith(("min_range", "max_range")) and "weight" not in k:
            _assert_range_grad(p.grad, want_grads[k], tols[k.split(".")[-1]], k)
        elif k.endswith(("min_range", "max_range")):
            tol = _weight_range_tols(seen["w"], seen["dwq"], wq_port.min_range, wq_port.max_range, wq_port.ch_axis)
            _assert_grad(p.grad.numpy(), want_grads[k].numpy(), k, tol)
        else:
            _assert_grad(p.grad.numpy(), want_grads[k].numpy(), k)
    _assert_grad(to_jax(tx.grad), want_dx, "dx")


# ---------------------------------------------------------------------------
# STFT and K8
# ---------------------------------------------------------------------------


def test_stft_and_istft_gradients_match_jax_grad():
    from fqss_tpu_torch.ops import stft

    jax_stft = importlib.import_module("fqss_tpu.ops.stft")  # the package exports a function of that name
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 2000)).astype(np.float32)
    n_fft, hop = 512, 128
    frames = 2000 // hop + 1
    gr, gi = (rng.standard_normal((2, 3, n_fft // 2 + 1, frames)).astype(np.float32) for _ in range(2))
    want = jax.grad(lambda x: jnp.sum(jnp.real(jax_stft.stft(x, n_fft, hop)) * gr
                                      + jnp.imag(jax_stft.stft(x, n_fft, hop)) * gi))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    z = stft.stft(tx, n_fft, hop)
    (z.real * torch.from_numpy(gr) + z.imag * torch.from_numpy(gi)).sum().backward()
    _assert_grad(tx.grad.numpy(), want, "stft dx")

    zr, zi = (rng.standard_normal((2, 3, n_fft // 2 + 1, frames)).astype(np.float32) for _ in range(2))
    gy = rng.standard_normal((2, 3, 1900)).astype(np.float32)
    want_r, want_i = jax.grad(lambda a, b: jnp.sum(jax_stft.istft(a + 1j * b, n_fft, hop, length=1900) * gy),
                              argnums=(0, 1))(jnp.asarray(zr), jnp.asarray(zi))
    tr, ti = (torch.from_numpy(a).requires_grad_(True) for a in (zr, zi))
    (stft.istft(torch.complex(tr, ti), n_fft, hop, length=1900) * torch.from_numpy(gy)).sum().backward()
    _assert_grad(tr.grad.numpy(), want_r, "istft d real")
    _assert_grad(ti.grad.numpy(), want_i, "istft d imag")


@pytest.mark.parametrize("t", [4000, 700])
def test_spec_and_ispec_gradients_match_jax_grad(t):
    """The model's STFT with demucs's padding (``pad1d_reflect``) and trims, and its inverse."""
    jm, pm = JaxHTDemucs(**TINY), HTDemucs(**TINY)
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, 2, t)).astype(np.float32)
    spec_shape = (2, 2, 256, -(-t // 128))
    gr, gi = (rng.standard_normal(spec_shape).astype(np.float32) for _ in range(2))
    want = jax.grad(lambda x: jnp.sum(jnp.real(jm._spec(x)) * gr + jnp.imag(jm._spec(x)) * gi))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    z = pm._spec(tx)
    (z.real * torch.from_numpy(gr) + z.imag * torch.from_numpy(gi)).sum().backward()
    _assert_grad(tx.grad.numpy(), want, "_spec dx")
    gy = rng.standard_normal((2, 2, t)).astype(np.float32)
    want_r, want_i = jax.grad(lambda a, b: jnp.sum(jm._ispec(a + 1j * b, t) * gy), argnums=(0, 1))(
        jnp.asarray(gr), jnp.asarray(gi))
    tr, ti = (torch.from_numpy(a).requires_grad_(True) for a in (gr, gi))
    (pm._ispec(torch.complex(tr, ti), t) * torch.from_numpy(gy)).sum().backward()
    _assert_grad(tr.grad.numpy(), want_r, "_ispec d real")
    _assert_grad(ti.grad.numpy(), want_i, "_ispec d imag")


@pytest.mark.parametrize("lq,lk", [(70, 33), (33, 70)])
def test_k8_gradients_at_head_width_48_match_jax_grad(lq, lk):
    """K8's autograd (the plain composition's gradient, as JAX's ``custom_vjp``) in qs, k, v and the head grid's
    ranges, cross-attention at HTDemucs's head width."""
    from jax.experimental.pallas import tpu as pltpu

    from fqss_tpu.ops import pallas_attention

    rng = np.random.default_rng(lq + 2 * lk)
    qs = (rng.standard_normal((4, lq, 48)) * 0.2).astype(np.float32)
    k, v = (rng.standard_normal((4, lk, 48)).astype(np.float32) for _ in range(2))
    mn, mx = np.full((1,), -0.7, np.float32), np.full((1,), 1.3, np.float32)
    g = rng.standard_normal((4, lq, 48)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want_y, want = jax.value_and_grad(
            lambda *a: jnp.vdot(jnp.asarray(g), pallas_attention.fused_attention(*a, 8)), argnums=(0, 1, 2, 3, 4))(
            *(jnp.asarray(a) for a in (qs, k, v, mn, mx)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (qs, k, v, mn, mx)]
    y = k8.fused_attention(*leaves)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(float((y * torch.from_numpy(g)).sum().detach()), float(want_y), rtol=1e-4)
    for name, leaf, w in zip(("qs", "k", "v", "min_range", "max_range"), leaves, want):
        _assert_grad(leaf.grad.numpy(), np.asarray(w), name)


def test_every_c_entry_of_the_kernels_has_its_signature_declared(monkeypatch):
    """``ops._build.load`` declares the argument types of every ``extern "C"`` entry of ``csrc/*.cu``: ctypes
    cannot pass a float (``a_s`` of the mask passes) to an entry without them, which only a card would show."""
    import pathlib
    import re
    import types

    from fqss_tpu_torch.ops import _build

    csrc = pathlib.Path(_build.__file__).parent.parent / "csrc"
    names = {m for f in csrc.glob("*.cu") for m in re.findall(r'extern "C" \w+\*? (fqss_\w+)\(', f.read_text())}
    assert "fqss_qat_dense_bwd_mask_gelu" in names
    fake = types.SimpleNamespace(**{n: types.SimpleNamespace() for n in names})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: fake)
    _build.load(pathlib.Path("unused.so"))
    assert {n for n in names if not hasattr(getattr(fake, n), "argtypes")} == set()
