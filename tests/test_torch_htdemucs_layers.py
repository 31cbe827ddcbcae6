"""The port's HTDemucs layers against the JAX package: the STFT, the nonlinearities, the layers and blocks, K8 at d 48.

Each JAX module is initialised and calibrated by a two-step observer pass,
carried across with ``htdemucs_from_jax``, and run by both packages on the
same numpy input (JAX channels-last, the port NCT/NCHW) at batch 1 and 2,
and in bf16. JAX runs jitted with the algebraic simplifier off (the pass
that turns the grids' divisions into multiplications by reciprocals; with
it off JAX divides as eager JAX does). Bounds:

* ``stft``/``istft``, ``_spec``/``_ispec``: within 2e-5 of JAX's (the FFTs
  are XLA's and PyTorch's; ``tests/test_htdemucs.py`` holds JAX to
  ``torch.stft`` by the same bound);
* each layer and block: every output within one LSB of its output grid, at
  most 1% of outputs more than half a step apart (``tests/test_torch_layers.py``'s
  rule: XLA's ``erfc`` and GroupNorm sums round apart from PyTorch's by an
  ulp, which can move a value across a rounding tie);
* K8's plain version against JAX's ``fused_attention`` (its Pallas kernel in
  interpret mode) at d 48, self and cross (Lq != Lk), as
  ``tests/test_torch_attention.py`` holds it.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import flax.linen
import jax
import jax.numpy as jnp

from fqss_tpu.models import demucs_blocks as jax_blocks
from fqss_tpu.models.htdemucs import HTDemucs as JaxHTDemucs
from fqss_tpu.nn import io_layers as jax_io
from fqss_tpu.nn import layers as jax_layers
from fqss_tpu.quant import QuantSpec as JaxQuantSpec
from fqss_tpu_torch.models import demucs_blocks as blocks
from fqss_tpu_torch.models.convert import htdemucs_from_jax
from fqss_tpu_torch.models.htdemucs import HTDemucs
from fqss_tpu_torch.nn import io_layers, layers
from fqss_tpu_torch.quant.spec import QuantSpec

torch.set_num_threads(1)

TINY = dict(channels=8, nfft=512, t_layers=3, t_heads=4, segment=0.5, samplerate=8000)
LAYER_SPEC = dict(qat=True, n_splitter=2, n_combiner=2, out_quant=True, max_observations=2)


def _noalg(fn):
    return jax.jit(fn, compiler_options={"xla_disable_hlo_passes": "algsimp"})


# ---------------------------------------------------------------------------
# STFT
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_fft,hop", [(512, 128), (256, 64), (500, 128)])
def test_stft_and_istft_match_jax(n_fft, hop):
    from fqss_tpu_torch.ops import stft

    jax_stft = importlib.import_module("fqss_tpu.ops.stft")  # the package exports a function of that name

    x = np.random.default_rng(0).standard_normal((2, 3, 4096)).astype(np.float32)
    want = np.asarray(jax_stft.stft(jnp.asarray(x), n_fft, hop))
    got = stft.stft(torch.from_numpy(x), n_fft, hop).numpy()
    assert got.shape == want.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    for length in (4000, None):
        want_y = np.asarray(jax_stft.istft(jnp.asarray(want), n_fft, hop, length=length))
        got_y = stft.istft(torch.from_numpy(np.array(want)), n_fft, hop, length=length).numpy()
        assert got_y.shape == want_y.shape
        np.testing.assert_allclose(got_y, want_y, rtol=0, atol=2e-5)
    np.testing.assert_array_equal(stft.hann_window(n_fft), jax_stft.hann_window(n_fft))


@pytest.mark.parametrize("t", [4000, 300, 700])
def test_spec_and_ispec_match_jax(t):
    """``_spec``/``_ispec`` with demucs's padding dance; 300 samples takes ``pad1d_reflect``'s short-input branch."""
    jm, pm = JaxHTDemucs(**TINY), HTDemucs(**TINY)
    x = np.random.default_rng(t).standard_normal((2, 2, t)).astype(np.float32)
    want = np.asarray(jm._spec(jnp.asarray(x)))
    got = pm._spec(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2, 256, -(-t // 128))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * max(1.0, scale))
    want_y = np.asarray(jm._ispec(jnp.asarray(want), t))
    got_y = pm._ispec(torch.from_numpy(np.array(want)), t).numpy()
    np.testing.assert_allclose(got_y, want_y, rtol=0, atol=2e-5)
    short = np.random.default_rng(1).standard_normal((1, 2, 5)).astype(np.float32)
    np.testing.assert_array_equal(blocks.pad1d_reflect(torch.from_numpy(short), 7, 9).numpy(),
                                  np.asarray(jax_blocks.pad1d_reflect(jnp.asarray(short), 7, 9)))


def test_gelu_and_glu_match_jax():
    from fqss_tpu.nn.nonlin import Nl as JaxNl
    from fqss_tpu_torch.nn.nonlin import Nl

    x = (np.random.default_rng(3).standard_normal((4, 6, 500)) * 3).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=False))
    got = Nl("gelu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)  # XLA's erfc and the C library's, an ulp or so apart
    glu = JaxNl("glu").apply({}, jnp.asarray(np.swapaxes(x, 1, 2)))  # JAX halves its last axis
    np.testing.assert_allclose(np.swapaxes(Nl("glu")(torch.from_numpy(x)).numpy(), 1, 2), np.asarray(glu),
                               rtol=1e-6, atol=1e-7)
    with pytest.raises(NotImplementedError, match="leaky_relu"):
        Nl("leaky_relu")


# ---------------------------------------------------------------------------
# Layers and blocks against eager JAX
# ---------------------------------------------------------------------------


def _calibrated(make, args, spec):
    """(variables after a two-step observer pass, the observer-free JAX output), jitted with the algebraic
    simplifier off (it would turn the grids' divisions into multiplications by reciprocals)."""
    arrays = [i for i, a in enumerate(args) if not isinstance(a, int)]

    def call(module, variables, *xs, **kw):
        full = list(args)
        for i, x in zip(arrays, xs):
            full[i] = x
        return module.apply(variables, *full, **kw)

    xs = [args[i] for i in arrays]
    obs = make(JaxQuantSpec(observer=True, **spec))
    # DConv has a field named ``init``, which hides the method
    variables = flax.linen.Module.init(obs, jax.random.PRNGKey(0), *args)
    step = _noalg(lambda v, *xs: call(obs, v, *xs, mutable=["qparams", "qstats"]))
    for _ in range(2):
        _, upd = step(variables, *xs)
        variables = {**variables, **upd}
    variables = jax.device_get(variables)
    served = make(JaxQuantSpec(observer=False, **spec))
    return variables, _noalg(lambda v, *xs: call(served, v, *xs))(variables, *xs)


def _assert_layer_rule(got, want, quantizer):
    lsb = (float(quantizer["max_range"][0]) - float(quantizer["min_range"][0])) / 255
    diff = np.abs(np.asarray(got) - np.asarray(want))
    assert got.shape == want.shape
    assert diff.max() <= lsb * (1 + 1e-4), f"max diff {diff.max() / lsb} LSB"
    assert np.mean(diff > 0.5 * lsb) <= 0.01, np.mean(diff > 0.5 * lsb)


def _load(module, variables, scope=None):
    if scope:
        variables = {col: {scope: tree} for col, tree in variables.items()}
    sd = htdemucs_from_jax(variables)
    if scope:
        sd = {k.removeprefix(scope + "."): v for k, v in sd.items()}
    module.load_state_dict(sd, strict=True)
    return module.eval()


def _nchw(x):  # JAX [B, H, W, C] or [B, T, C] -> the port's layout
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _jax_layout(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _x(shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.8).astype(np.float32)


LAYER_CASES = ["conv2d", "conv2d_glu_norm", "convtr1d", "convtr2d", "conv1d_norm", "dense_gelu", "embedding",
               "convtr2d_decoder", "dconv", "henc_freq", "henc_time", "hdec_freq", "hdec_time", "hdec_freq_last"]


def _layer_case(name, batch, q_kw):
    """(JAX maker, port maker, JAX args, port args, the output quantizer's qparams path, converter scope)."""
    if name == "conv2d":
        return (lambda q: jax_layers.QConv2d(12, (8, 1), stride=(4, 1), padding=(2, 0), nl="gelu", q=q),
                lambda q: layers.QConv2d(6, 12, (8, 1), stride=(4, 1), padding=(2, 0), nl="gelu", q=q),
                _x((batch, 40, 9, 6)), ("activation_fake_quantize",), None)
    if name == "conv2d_glu_norm":
        return (lambda q: jax_layers.QConv2d(16, 3, padding=1, nl="glu", norm_groups=4, q=q),
                lambda q: layers.QConv2d(6, 16, 3, padding=1, nl="glu", norm_groups=4, q=q),
                _x((batch, 12, 9, 6)), ("activation_fake_quantize",), None)
    if name == "convtr1d":
        return (lambda q: jax_layers.QConvTranspose1d(6, 8, 4, nl="gelu", q=q),
                lambda q: layers.QConvTranspose1d(10, 6, 8, 4, nl="gelu", q=q),
                _x((batch, 30, 10)), ("activation_fake_quantize",), "conv_tr")
    if name == "convtr2d":
        return (lambda q: jax_layers.QConvTranspose2d(6, (8, 1), (4, 1), nl="gelu", q=q),
                lambda q: layers.QConvTranspose2d(10, 6, (8, 1), (4, 1), nl="gelu", q=q),
                _x((batch, 7, 5, 10)), ("activation_fake_quantize",), "conv_tr")
    if name == "conv1d_norm":
        return (lambda q: jax_layers.QConv1d(5, 3, dilation=2, padding=2, norm_groups=1, nl="gelu", q=q),
                lambda q: layers.QConv1d(8, 5, 3, dilation=2, padding=2, norm_groups=1, nl="gelu", q=q),
                _x((batch, 50, 8)), ("activation_fake_quantize",), None)
    if name == "dense_gelu":
        return (lambda q: jax_layers.QDense(40, nl="gelu", q=q), lambda q: layers.QDense(16, 40, q=q, nl="gelu"),
                _x((batch, 33, 16)), ("activation_fake_quantize",), None)
    if name == "embedding":
        return (lambda q: jax_blocks.ScaledEmbedding(12, 8, q=q), lambda q: blocks.ScaledEmbedding(12, 8, q=q),
                np.arange(12), ("mul", "activation_fake_quantize"), "freq_emb")
    if name == "convtr2d_decoder":  # the last frequency decoder's, with its trained residual decoder
        res = dict(train_res_dec=True)
        return (lambda q: jax_io.QConvTr2dDecoder(8, (8, 1), (4, 1), q=dataclasses.replace(q, **res)),
                lambda q: io_layers.QConvTr2dDecoder(12, 8, (8, 1), (4, 1), q=dataclasses.replace(q, **res)),
                _x((batch, 6, 5, 12)), ("activation_fake_quantize",), "conv_tr")
    if name == "dconv":
        return (lambda q: jax_blocks.DConv(16, q=q), lambda q: blocks.DConv(16, q=q), _x((batch, 60, 16)),
                ("add_1", "activation_fake_quantize"), None)
    if name in ("henc_freq", "henc_time"):
        freq = name == "henc_freq"
        shape = (batch, 64, 7, 4) if freq else (batch, 202, 4)
        return (lambda q: jax_blocks.HEncLayer(16, freq=freq, q=q, is_input_layer=True),
                lambda q: blocks.HEncLayer(4, 16, freq=freq, q=q, is_input_layer=True),
                _x(shape), ("rewrite", "activation_fake_quantize"), None)
    freq = name != "hdec_time"
    last = name == "hdec_freq_last"
    shape = (batch, 16, 7, 16) if freq else (batch, 50, 16)
    length = 64 if freq else 199
    return (lambda q: jax_blocks.HDecLayer(16, 8, last=last, freq=freq, train_res_dec=last, q=q),
            lambda q: blocks.HDecLayer(16, 8, last=last, freq=freq, train_res_dec=last, q=q),
            (_x(shape), _x(shape, 1), length), ("conv_tr", "activation_fake_quantize"), None)


@pytest.mark.parametrize("name", LAYER_CASES)
@pytest.mark.parametrize("batch,dtype", [(1, "float32"), (2, "float32"), (2, "bfloat16")])
def test_layers_match_jax(name, batch, dtype):
    q_kw = dict(LAYER_SPEC, compute_dtype=dtype)
    make, port, x, out, scope = _layer_case(name, batch, q_kw)
    args = x if isinstance(x, tuple) else (x,)
    if name == "embedding" and batch == 1:
        args = (np.arange(5),)
    jargs = tuple(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args)
    variables, want = _calibrated(make, jargs, q_kw)
    module = _load(port(QuantSpec(**dict(q_kw, observer=False))), variables, scope)
    channels_last = name in ("embedding", "dense_gelu")
    pargs = tuple(a if not isinstance(a, np.ndarray) else (torch.from_numpy(a) if channels_last else _nchw(a))
                  for a in args)
    with torch.no_grad():
        got = module(*pargs)
    qp = variables["qparams"]
    for o in out:
        qp = qp[o]
    if name.startswith("hdec"):
        want = want[0]  # JAX's decoder returns (z, its transposed conv's input)
    if name in ("convtr2d_decoder", "hdec_freq_last"):  # stacked combiner planes, each on its own grid
        plane_q = (qp, (variables["qparams"]["conv_tr"] if name == "hdec_freq_last"
                        else variables["qparams"])["activation_fake_quantize_residual"])
        for i, pq in enumerate(plane_q):
            _assert_layer_rule(_jax_layout(got[i]), np.asarray(want[i]), pq)
        return
    got = got.numpy() if channels_last else _jax_layout(got)
    _assert_layer_rule(got, np.asarray(want), qp)


@pytest.mark.parametrize("observe", [True, False])
def test_dense_gelu_observes_the_post_gelu_value(observe):
    """``QDense(nl="gelu")`` through K5's plain GELU route inside the observer window (the output and the EMA write
    are of the post-GELU value, as JAX's quantizer sees it) and after it."""
    x = _x((2, 21, 16), 4)
    spec = dict(LAYER_SPEC, max_observations=3)
    jm = jax_layers.QDense(24, nl="gelu", q=JaxQuantSpec(observer=True, **spec))
    variables = jax.device_get(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    steps = 1 if observe else 4
    pm = _load(layers.QDense(16, 24, q=QuantSpec(observer=True, **spec), nl="gelu"), variables).train()
    for _ in range(steps):
        with jax.disable_jit():
            want, upd = jm.apply(variables, jnp.asarray(x), mutable=["qparams", "qstats"])
        variables = {**variables, **jax.device_get(upd)}
        with torch.no_grad():
            got = pm(torch.from_numpy(x)).numpy()
    qp = variables["qparams"]["activation_fake_quantize"]
    if observe:
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    else:
        _assert_layer_rule(got, np.asarray(want), qp)
    aq = pm.activation_fake_quantize
    np.testing.assert_allclose(aq.min_range.detach().numpy(), qp["min_range"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aq.max_range.detach().numpy(), qp["max_range"], rtol=1e-5, atol=1e-6)
    pm.weight.requires_grad_(True)  # with a gradient the route takes its backward (tests/test_torch_htdemucs_grads.py)
    pm(torch.from_numpy(x)).sum().backward()
    assert torch.isfinite(pm.weight.grad).all() and pm.weight.grad.any()


@pytest.mark.parametrize("lq,lk", [(70, 70), (70, 33), (33, 70)])
def test_k8_plain_version_matches_the_jax_kernel_at_head_width_48(lq, lk):
    from jax.experimental.pallas import tpu as pltpu

    from fqss_tpu.ops import pallas_attention
    from fqss_tpu_torch.ops import attention as k8

    rng = np.random.default_rng(lq + lk)
    qs = (rng.standard_normal((4, lq, 48)) * 0.2).astype(np.float32)
    k, v = (rng.standard_normal((4, lk, 48)).astype(np.float32) for _ in range(2))
    mn, mx = np.full((1,), -0.7, np.float32), np.full((1,), 1.3, np.float32)
    lsb = 2.0 / 255
    got = k8.fused_attention_ref(*(torch.from_numpy(a) for a in (qs, k, v, mn, mx))).numpy()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas_attention.fused_attention(*(jnp.asarray(a) for a in (qs, k, v, mn, mx)), 8))
    diff = np.abs(got - want)
    assert diff.max() <= lsb * (1 + 1e-4) and np.mean(diff > 0.5 * lsb) <= 0.01
    heads = k8.fused_attention_ref(*(torch.from_numpy(a) for a in (qs, k, v)), quantize=False).numpy()
    j = [jnp.asarray(a) for a in (qs, k, v)]
    want_heads = jnp.einsum("bqk,bkd->bqd", jax.nn.softmax(jnp.einsum("bqd,bkd->bqk", j[0], j[1]), axis=-1), j[2])
    np.testing.assert_allclose(heads, np.asarray(want_heads), rtol=0, atol=1e-5)
