"""The port's fused attention core (K8's plain version and its routing) against the JAX package.

``fused_attention_ref`` is held against JAX's ``fused_attention`` (its Pallas
kernel run in interpret mode, as ``tests/test_pallas_attention.py`` runs it)
and ``_attention_xla``: the float heads within 1e-5, the quantized heads
within one grid step, at most 1% of them a step apart (the products sum in
another order, so a head can land on the other side of a rounding tie). The
``autograd.Function`` (the kernel's forward, the plain composition's
backward) gives JAX's gradients. ``QMultiheadAttention`` equals JAX's
module with ``pallas_attn=True`` on a shape its TPU gate sends to the
kernel, and takes one of its four routes through
``ops.attention.fused_attention_packed`` in each case.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fqss_tpu.nn.attention import QMultiheadAttention as JaxQMultiheadAttention
from fqss_tpu.ops import pallas_attention
from fqss_tpu.quant import QuantSpec as JaxQuantSpec
from fqss_tpu_torch.models.convert import dptnet_from_jax
from fqss_tpu_torch.nn import attention as port_attention
from fqss_tpu_torch.nn.attention import QMultiheadAttention
from fqss_tpu_torch.ops import attention as k8
from fqss_tpu_torch.quant.spec import QuantSpec

torch.set_num_threads(1)

ALGSIMP_OFF = {"xla_disable_hlo_passes": "algsimp"}
MN, MX = -0.7, 1.3
LSB = (MX - MN) / 255


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _operands(bh, lq, lk, d, seed=0):
    rng = np.random.default_rng(seed)
    qs = (rng.standard_normal((bh, lq, d)) * 0.3).astype(np.float32)
    k, v = (rng.standard_normal((bh, lk, d)).astype(np.float32) for _ in range(2))
    return qs, k, v


def _ranges():
    return np.full((1,), MN, np.float32), np.full((1,), MX, np.float32)


@pytest.mark.parametrize("lq,lk,d", [(250, 250, 32), (136, 200, 64), (34, 34, 32), (250, 250, 16)])
def test_plain_version_matches_the_jax_kernel(lq, lk, d):
    qs, k, v = _operands(3, lq, lk, d, seed=lq + d)
    mn, mx = _ranges()
    t = [torch.from_numpy(a) for a in (qs, k, v, mn, mx)]
    heads = k8.fused_attention_ref(*t[:3], quantize=False).numpy()
    j = [jnp.asarray(a) for a in (qs, k, v, mn, mx)]
    want_heads = jnp.einsum("bqk,bkd->bqd", jax.nn.softmax(jnp.einsum("bqd,bkd->bqk", j[0], j[1]), axis=-1), j[2])
    np.testing.assert_allclose(heads, np.asarray(want_heads), rtol=0, atol=1e-5)
    got = k8.fused_attention_ref(*t, n_bits=8).numpy()
    for want in (pallas_attention.fused_attention(*j, 8), pallas_attention._attention_xla(*j, 8)):
        diff = np.abs(got - np.asarray(want))
        assert diff.max() <= LSB * (1 + 1e-4), diff.max() / LSB
        assert np.mean(diff > 0.5 * LSB) <= 0.01, np.mean(diff > 0.5 * LSB)


def test_wrapper_takes_the_plain_version_on_the_cpu_and_counts_no_launch():
    qs, k, v = (torch.from_numpy(a) for a in _operands(2, 9, 13, 24))
    mn, mx = (torch.from_numpy(a) for a in _ranges())
    k8.reset_launches()
    for quantize in (False, True):
        got = k8.fused_attention(qs, k, v, mn, mx, 8, quantize=quantize)
        assert torch.equal(got, k8.fused_attention_ref(qs, k, v, mn, mx, 8, quantize=quantize))
    assert k8.LAUNCHES == {"attention": 0, "attention_bf16": 0}
    with pytest.raises(ValueError, match="one-element"):
        k8.fused_attention(qs, k, v, quantize=True)
    with pytest.raises(ValueError, match="contiguous"):
        k8.fused_attention(qs.transpose(0, 1).contiguous().transpose(0, 1), k, v, quantize=False)


def test_autograd_function_gradients_match_jax_grad():
    qs, k, v = _operands(2, 24, 24, 16, seed=5)
    mn, mx = np.full((1,), -0.9, np.float32), np.full((1,), 1.1, np.float32)
    g = np.random.default_rng(6).standard_normal((2, 24, 16)).astype(np.float32)

    def loss(*a):
        return jnp.sum(pallas_attention.fused_attention(*a, 8) * g)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a) for a in (qs, k, v, mn, mx)))
    t = [torch.from_numpy(a).requires_grad_(True) for a in (qs, k, v, mn, mx)]
    out = k8.fused_attention(*t, n_bits=8)
    assert type(out.grad_fn).__name__ == "_FusedAttentionBackward"  # through the autograd.Function
    (out * torch.from_numpy(g)).sum().backward()
    for name, a, b in zip(("qs", "k", "v", "mn", "mx"), t, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5, err_msg=name)


def test_qmultiheadattention_matches_jax_with_pallas_attn():
    """E 64, h 2 (d = 32), L 150: a shape JAX's gate sends to its Pallas kernel."""
    xn = np.random.default_rng(7).standard_normal((2, 150, 64)).astype(np.float32)
    x = jnp.asarray(xn)
    spec = dict(qat=True, n_splitter=2, n_combiner=2, out_quant=True, max_observations=2)
    obs = JaxQMultiheadAttention(64, 2, q=JaxQuantSpec(observer=True, **spec))
    variables = jax.jit(obs.init)(jax.random.PRNGKey(0), x, x, x)
    observe = jax.jit(lambda v_, a: obs.apply(v_, a, a, a, mutable=["qparams", "qstats"])[1])
    for _ in range(2):
        variables = {**variables, **observe(variables, x)}
    jm = JaxQMultiheadAttention(64, 2, q=JaxQuantSpec(observer=False, pallas_attn=True, **spec))
    want = np.asarray(jax.jit(jm.apply).lower(variables, x, x, x).compile(compiler_options=ALGSIMP_OFF)(
        variables, x, x, x))
    mha = QMultiheadAttention(64, 2, q=QuantSpec(observer=False, **spec))
    mha.load_state_dict(dptnet_from_jax(jax.device_get(variables)), strict=True)
    xt = torch.from_numpy(xn)
    with torch.no_grad():
        got = mha.eval()(xt, xt, xt).numpy()
    qp = variables["qparams"]["activation_fake_quantize"]
    lsb = float(qp["max_range"][0] - qp["min_range"][0]) / 255
    diff = np.abs(got - want)
    assert diff.max() <= lsb * (1 + 1e-4), diff.max() / lsb
    assert np.mean(diff > 0.5 * lsb) <= 0.01, np.mean(diff > 0.5 * lsb)


def _routes(monkeypatch):
    """Record each call of the module's ``fused_attention_packed`` (K8 on its in-projection's views) as its
    ``quantize`` flag."""
    calls = []

    def counted(*args, **kwargs):
        calls.append(kwargs.get("quantize", True))
        return k8.fused_attention_packed(*args, **kwargs)

    monkeypatch.setattr(port_attention, "fused_attention_packed", counted)
    return calls


@pytest.mark.parametrize("case,want", [
    ("float", [False]),  # no head quantizer: K8, grid off
    ("serving", [True]),  # head quantizer without an observer: the grid in K8's epilogue
    ("observer", [False]),  # with an observer: K8 grid off, then the quantizer module
    ("fix_attn_quant", []),  # the plain composition
])
def test_routes_through_the_kernel(monkeypatch, case, want):
    spec = {"float": QuantSpec(), "serving": QuantSpec(qat=True, observer=False),
            "observer": QuantSpec(qat=True, max_observations=2),
            "fix_attn_quant": QuantSpec(qat=True, observer=False)}[case]
    mha = QMultiheadAttention(16, 4, q=spec, fix_attn_quant=case == "fix_attn_quant",
                              generator=torch.Generator().manual_seed(0)).eval()
    calls = _routes(monkeypatch)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 11, 16)).astype(np.float32))
    with torch.no_grad():
        mha(x, x, x)
    assert calls == want


def test_eval_inside_the_observer_window_is_float_as_jax_default_path(monkeypatch):
    xn = np.random.default_rng(9).standard_normal((2, 20, 16)).astype(np.float32)
    x = jnp.asarray(xn)
    jm = JaxQMultiheadAttention(16, 4, q=JaxQuantSpec(qat=True, max_observations=2))
    variables = jax.jit(jm.init)(jax.random.PRNGKey(1), x, x, x)
    want = np.asarray(jax.jit(jm.apply)(variables, x, x, x))  # no mutable collections: every quantizer float
    float_jm = JaxQMultiheadAttention(16, 4, q=JaxQuantSpec())
    want_float = np.asarray(jax.jit(float_jm.apply)({"params": variables["params"]}, x, x, x))
    mha = QMultiheadAttention(16, 4, q=QuantSpec(qat=True, max_observations=2))
    mha.load_state_dict(dptnet_from_jax(jax.device_get(variables)), strict=True)
    calls = _routes(monkeypatch)
    xt = torch.from_numpy(xn)
    with torch.no_grad():
        got = mha.eval()(xt, xt, xt).numpy()
    assert calls == [False]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want_float, rtol=0, atol=1e-5)
    assert int(mha.activation_fake_quantize_head.n_iter) == 0  # eval wrote nothing


def test_pallas_flag_of_the_spec_does_not_change_the_port():
    """``pallas_attn`` is accepted and has no effect: the port routes every case by itself."""
    x = torch.from_numpy(np.random.default_rng(10).standard_normal((1, 7, 16)).astype(np.float32))
    outs = []
    for flag in (False, True):
        spec = dataclasses.replace(QuantSpec(qat=True, observer=False), pallas_attn=flag)
        mha = QMultiheadAttention(16, 4, q=spec, generator=torch.Generator().manual_seed(3)).eval()
        with torch.no_grad():
            outs.append(mha(x, x, x))
    assert torch.equal(*outs)
