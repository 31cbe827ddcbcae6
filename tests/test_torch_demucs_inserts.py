"""The legacy HDemucs's blocks in the port against the JAX package: BLSTM, LocalState, DConv with both inserts,
the EM Wiener filter, MultiWrap, the layers' legacy options, ``rescale_params`` and ``QBatchNorm``.

Each JAX module is initialised and calibrated by a two-step observer pass, carried across with
``htdemucs_from_jax`` and run by both packages on the same numpy input (JAX channels-last, the port NCT/NCHW).
Bounds:

* BLSTM (framed and unframed, fused; one static case) and DConv with its inserts against eager JAX
  (``jax.disable_jit``: the jitted scan contracts the grid into an FMA, ``tests/test_torch_lstm_modes.py``), by
  the layer rule: every output within one LSB of its output grid, at most 1% more than half a step apart;
* LocalState, whose output has no grid (its convs have no act quantizer), within 1e-5 of its largest value;
* ``wiener`` and ``apply_wiener_windowed`` on random stereo inputs: relative error <= 1e-5 (complex64 both);
* MultiWrap's encoder and decoder within 1e-5 of JAX's, and with the unsplit layer's weights in every band within
  2e-5 of the unsplit layer (``tests/test_hdemucs_legacy.py``'s invariant);
* the layers' legacy options (``empty``, ``inject``, ``pad=False``, ``context_freq=False``, ``gelu``/``tr_bias``
  off) by the layer rule against JAX jitted with the algebraic simplifier off;
* ``rescale_params`` within 1e-6, ``QBatchNorm`` in both modes (outputs by the layer rule, the running statistics
  within 1e-6) against flax.
"""

import numpy as np
import pytest
import torch

import flax.linen
import jax
import jax.numpy as jnp

from fqss_tpu.models import demucs_blocks as jax_blocks
from fqss_tpu.models import hdemucs as jax_hdemucs
from fqss_tpu.nn import layers as jax_layers
from fqss_tpu.ops import wiener as jax_wiener
from fqss_tpu.quant import QuantSpec as JaxQuantSpec
from fqss_tpu_torch.models import demucs_blocks as blocks
from fqss_tpu_torch.models import hdemucs
from fqss_tpu_torch.models.convert import htdemucs_from_jax, htdemucs_to_jax
from fqss_tpu_torch.nn import layers
from fqss_tpu_torch.ops import wiener
from fqss_tpu_torch.quant.spec import QuantSpec

torch.set_num_threads(1)

SPEC = dict(qat=True, n_splitter=2, n_combiner=2, out_quant=True, max_observations=2)


def _noalg(fn):
    return jax.jit(fn, compiler_options={"xla_disable_hlo_passes": "algsimp"})


def _x(shape, seed=0, scale=0.8):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _calibrated(make, args, spec, eager):
    """(variables after a two-step observer pass, the observer-free JAX output), eagerly or jitted with the
    algebraic simplifier off."""
    def run():
        obs = make(JaxQuantSpec(observer=True, **spec))
        variables = flax.linen.Module.init(obs, jax.random.PRNGKey(0), *args)  # DConv's field `init` hides it
        step = (lambda v: obs.apply(v, *args, mutable=["qparams", "qstats"])) if eager else \
            _noalg(lambda v: obs.apply(v, *args, mutable=["qparams", "qstats"]))
        for _ in range(2):
            _, upd = step(variables)
            variables = {**variables, **upd}
        variables = jax.device_get(variables)
        served = make(JaxQuantSpec(observer=False, **spec))
        out = served.apply(variables, *args) if eager else _noalg(lambda v: served.apply(v, *args))(variables)
        return variables, jax.device_get(out)

    if eager:
        with jax.disable_jit():
            return run()
    return run()


def _load(module, variables):
    module.load_state_dict(htdemucs_from_jax(variables), strict=True)
    return module.eval()


def _qparams(variables, *path):
    qp = variables["qparams"]
    for p in path:
        qp = qp[p]
    return qp


def _assert_layer_rule(got, want, quantizer):
    lsb = (float(np.ravel(quantizer["max_range"])[0]) - float(np.ravel(quantizer["min_range"])[0])) / 255
    diff = np.abs(np.asarray(got) - np.asarray(want))
    assert got.shape == want.shape
    assert diff.max() <= lsb * (1 + 1e-4), f"max diff {diff.max() / lsb} LSB"
    assert np.mean(diff > 0.5 * lsb) <= 0.01, np.mean(diff > 0.5 * lsb)


def _nct(x):  # JAX [B, T, C] / [B, H, W, C] -> the port's layout
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _jax_layout(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


# ---------------------------------------------------------------------------
# BLSTM, LocalState, DConv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t,mode,batch", [(43, "fused", 2), (43, "fused", 1), (15, "fused", 2), (15, "static", 2)])
def test_blstm_matches_eager_jax(t, mode, batch):
    """Framed (T 43 > 20 steps: 4 frames of 20, as the default model's index 4 cuts 431 into 4 of 200) and
    unframed, the skip's add grid."""
    spec = dict(SPEC, lstm_mode=mode)
    x = _x((batch, t, 8))
    variables, want = _calibrated(lambda q: jax_blocks.BLSTM(8, layers=2, max_steps=20, skip=True, q=q),
                                  (jnp.asarray(x),), spec, eager=True)
    port = _load(blocks.BLSTM(8, layers=2, max_steps=20, skip=True, q=QuantSpec(observer=False, **spec)), variables)
    assert port.lstm_0.mode == mode
    with torch.no_grad():
        got = _jax_layout(port(_nct(x)))
    _assert_layer_rule(got, want, _qparams(variables, "add", "activation_fake_quantize"))


def test_blstm_frames_and_stitching_match_jax_in_float():
    """The framing alone, no grid: T 201 (two frames, the second mostly padding) and 431, float within 1e-5."""
    for t in (201, 431):
        x = _x((2, t, 6), t)
        jm = jax_blocks.BLSTM(6, layers=2, max_steps=200, skip=False)
        variables = jax.device_get(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)))
        want = np.asarray(_noalg(lambda v, x: jm.apply(v, x))(variables, jnp.asarray(x)))
        port = _load(blocks.BLSTM(6, layers=2, max_steps=200, skip=False), variables)
        with torch.no_grad():
            got = _jax_layout(port(_nct(x)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("batch", [1, 2])
def test_local_state_matches_eager_jax(batch):
    x = _x((batch, 37, 16), batch)
    variables, want = _calibrated(lambda q: jax_blocks.LocalState(16, heads=4, ndecay=4, q=q), (jnp.asarray(x),),
                                  SPEC, eager=True)
    port = _load(blocks.LocalState(16, heads=4, ndecay=4, q=QuantSpec(observer=False, **SPEC)), variables)
    with torch.no_grad():
        got = _jax_layout(port(_nct(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_local_state_float_and_without_decay_match_jax():
    x = _x((2, 23, 8), 5)
    for ndecay in (4, 0):
        jm = jax_blocks.LocalState(8, heads=2, ndecay=ndecay)
        variables = jax.device_get(jm.init(jax.random.PRNGKey(2), jnp.asarray(x)))
        want = np.asarray(jm.apply(variables, jnp.asarray(x)))
        port = _load(blocks.LocalState(8, heads=2, ndecay=ndecay), variables)
        with torch.no_grad():
            got = _jax_layout(port(_nct(x)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("batch", [1, 2])
def test_dconv_with_both_inserts_matches_eager_jax(batch):
    """DConv(lstm, attn) as the model's deep layers run it (channels / compress = hidden), the last add's grid."""
    x = _x((batch, 24, 16), 7)
    make = lambda q: jax_blocks.DConv(16, compress=2, depth=2, init=1e-1, lstm=True, attn=True, q=q)  # noqa: E731
    variables, want = _calibrated(make, (jnp.asarray(x),), SPEC, eager=True)
    port = _load(blocks.DConv(16, compress=2, depth=2, init=1e-1, lstm=True, attn=True,
                              q=QuantSpec(observer=False, **SPEC)), variables)
    with torch.no_grad():
        got = _jax_layout(port(_nct(x)))
    _assert_layer_rule(got, want, _qparams(variables, "add_1", "activation_fake_quantize"))


# ---------------------------------------------------------------------------
# The EM Wiener filter
# ---------------------------------------------------------------------------


def _wiener_inputs(f, t, seed):
    rng = np.random.default_rng(seed)
    mix = (rng.standard_normal((f, t, 2)) + 1j * rng.standard_normal((f, t, 2))).astype(np.complex64) * 20
    mag = (np.abs(rng.standard_normal((f, t, 2, 4))) * 8).astype(np.float32)
    return mag, mix


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("n_iter,residual", [(1, False), (2, False), (1, True)])
def test_wiener_matches_jax(n_iter, residual):
    """The mixture is scaled above 10 (max |mix| / 10 > 1), so the scale is on."""
    mag, mix = _wiener_inputs(33, 17, n_iter + 2 * residual)
    want = np.asarray(jax_wiener.wiener(jnp.asarray(mag), jnp.asarray(mix), n_iter, residual))
    got = wiener.wiener(torch.from_numpy(mag), torch.from_numpy(mix), n_iter, residual)
    assert got.dtype == torch.complex64 and got.shape == want.shape
    assert _rel(got.numpy(), want) <= 1e-5


def test_windowed_wiener_matches_jax():
    """650 frames: windows of 300, 300 and 50, each scaled by its own max |mix|."""
    mag, mix = _wiener_inputs(9, 650, 11)
    mix[:, 300:600] *= 0.01  # the middle window's scale is 1
    want = np.asarray(jax_wiener.apply_wiener_windowed(jnp.asarray(mag), jnp.asarray(mix), 1))
    got = wiener.apply_wiener_windowed(torch.from_numpy(mag), torch.from_numpy(mix), 1).numpy()
    assert got.shape == want.shape == (9, 650, 2, 4)
    assert _rel(got, want) <= 1e-5


# ---------------------------------------------------------------------------
# MultiWrap
# ---------------------------------------------------------------------------

ENC_KW = dict(chout=8, kernel_size=8, stride=4, freq=True, norm=False, context=0, dconv_depth=1, dconv_comp=2.0)
DEC_KW = dict(chin=8, chout=4, kernel_size=8, stride=4, freq=True, norm=False, context=1, context_freq=False)


@pytest.mark.parametrize("ratios", [(0.4,), (0.3, 0.6)])
def test_multiwrap_encoder_matches_jax_and_the_unsplit_layer(ratios):
    x = _x((1, 64, 10, 4), 0, 1.0)
    mw = jax_hdemucs.MultiWrap(split_ratios=ratios, is_enc=True, layer_kw=ENC_KW, q=JaxQuantSpec())
    port = hdemucs.MultiWrap(ratios, True, dict(ENC_KW, chin=4), generator=torch.Generator().manual_seed(1)).eval()
    want = np.asarray(_noalg(lambda v, x: mw.apply(v, x))(htdemucs_to_jax(port.state_dict()), jnp.asarray(x)))
    with torch.no_grad():
        got = _jax_layout(port(_nct(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    # the unsplit layer's weights in every band give the unsplit layer
    base = blocks.HEncLayer(4, **{k: v for k, v in ENC_KW.items() if k != "chout"}, chout=8,
                            generator=torch.Generator().manual_seed(3))
    port.load_state_dict({f"band_{k}.{n}": v for k in range(len(ratios) + 1) for n, v in base.state_dict().items()})
    with torch.no_grad():
        np.testing.assert_allclose(port(_nct(x)).numpy(), base(_nct(x)).numpy(), rtol=0, atol=2e-5)


@pytest.mark.parametrize("last", [False, True])
def test_multiwrap_decoder_matches_jax_and_the_unsplit_layer(last):
    x, skip = _x((1, 16, 10, 8), 1, 1.0), _x((1, 16, 10, 8), 2, 1.0)
    mw = jax_hdemucs.MultiWrap(split_ratios=(0.5,), is_enc=False, layer_kw=dict(DEC_KW, last=last),
                               q=JaxQuantSpec())
    port = hdemucs.MultiWrap((0.5,), False, dict(DEC_KW, last=last), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        for k in range(2):
            getattr(port, f"band_{k}_bias").uniform_(-0.5, 0.5)  # off zero, so that the seam's bias shows
    want, want_pre = _noalg(lambda v, x, s: mw.apply(v, x, s, None))(htdemucs_to_jax(port.state_dict()),
                                                                      jnp.asarray(x), jnp.asarray(skip))
    with torch.no_grad():
        got, pre = port(_nct(x), _nct(skip))
    np.testing.assert_allclose(_jax_layout(got), np.asarray(want), rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(_jax_layout(pre), np.asarray(want_pre), rtol=0, atol=1e-5)
    # the unsplit layer's weights in every band, its transposed conv's bias in the bands' bias params
    base = blocks.HDecLayer(last=False, gelu=not last, **DEC_KW, generator=torch.Generator().manual_seed(4))
    sd = {n: v for n, v in base.state_dict().items() if n != "conv_tr.bias"}
    port.load_state_dict({**{f"band_{k}.{n}": v for k in range(2) for n, v in sd.items()},
                          **{f"band_{k}_bias": base.conv_tr.bias.detach() for k in range(2)}})
    with torch.no_grad():
        got, _ = port(_nct(x), _nct(skip))
        np.testing.assert_allclose(got.numpy(), base(_nct(x), _nct(skip), None).numpy(), rtol=0, atol=2e-5)


# ---------------------------------------------------------------------------
# The layers' legacy options
# ---------------------------------------------------------------------------


def _option_case(name):
    """(JAX maker, port module maker, JAX args, port args, the output quantizer's path)."""
    if name == "henc_empty":
        return (lambda q: jax_blocks.HEncLayer(12, freq=False, empty=True, q=q),
                lambda q: blocks.HEncLayer(4, 12, freq=False, empty=True, q=q),
                (_x((2, 101, 4)),), ("conv", "activation_fake_quantize"))
    if name == "henc_inject":  # the merge: kernel = the frequency rows, no padding, the time branch added
        return (lambda q: jax_blocks.HEncLayer(8, kernel_size=8, stride=4, pad=False, freq=True, norm=True,
                                               dconv_comp=2.0, q=q),
                lambda q: blocks.HEncLayer(4, 8, kernel_size=8, stride=4, pad=False, freq=True, norm=True,
                                           dconv_comp=2.0, q=q),
                (_x((2, 8, 21, 4)), _x((2, 21, 8), 1)), ("rewrite", "activation_fake_quantize"))
    if name == "henc_time_norm":  # the merged time layer's shape: kernel 4, stride 2, GroupNorm
        return (lambda q: jax_blocks.HEncLayer(16, kernel_size=4, stride=2, freq=False, norm=True, dconv_comp=2.0,
                                               q=q),
                lambda q: blocks.HEncLayer(8, 16, kernel_size=4, stride=2, freq=False, norm=True, dconv_comp=2.0,
                                           q=q),
                (_x((2, 41, 8)),), ("rewrite", "activation_fake_quantize"))
    if name == "hdec_empty":
        return (lambda q: jax_blocks.HDecLayer(8, 4, empty=True, freq=False, q=q),
                lambda q: blocks.HDecLayer(8, 4, empty=True, freq=False, q=q),
                (_x((2, 30, 8)), None, 118), ("conv_tr", "activation_fake_quantize"))
    return (lambda q: jax_blocks.HDecLayer(8, 4, pad=False, gelu=False, tr_bias=False, context_freq=False, q=q),
            lambda q: blocks.HDecLayer(8, 4, pad=False, gelu=False, tr_bias=False, context_freq=False, q=q),
            (_x((2, 7, 9, 8)), _x((2, 7, 9, 8), 2), None), ("conv_tr", "activation_fake_quantize"))


@pytest.mark.parametrize("name", ["henc_empty", "henc_inject", "henc_time_norm", "hdec_empty", "hdec_band"])
def test_layer_options_match_jax(name):
    make, port_make, args, out = _option_case(name)
    jargs = tuple(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args)
    variables, want = _calibrated(make, jargs, SPEC, eager=False)
    port = _load(port_make(QuantSpec(observer=False, **SPEC)), variables)
    pargs = tuple(_nct(a) if isinstance(a, np.ndarray) else a for a in args)
    with torch.no_grad():
        got = port.pair(*pargs) if name.startswith("hdec") else port(*pargs)
    if name.startswith("hdec"):
        got, want = got[0], want[0]  # (z, the transposed conv's input)
    _assert_layer_rule(_jax_layout(got), np.asarray(want), _qparams(variables, *out))


# ---------------------------------------------------------------------------
# rescale_params and QBatchNorm
# ---------------------------------------------------------------------------


def test_rescale_params_matches_jax():
    """On a DConv with both inserts and a frequency HEncLayer (conv, dense, 2-D and transposed kernels)."""
    for module in (blocks.DConv(16, compress=2, depth=2, lstm=True, attn=True, generator=torch.Generator()),
                   blocks.HDecLayer(8, 4, freq=True, generator=torch.Generator().manual_seed(1))):
        state = module.state_dict()
        params = htdemucs_to_jax(state)["params"]
        want = htdemucs_from_jax({"params": jax.device_get(jax_blocks.rescale_params(params))})
        got = blocks.rescale_params(state)
        assert got.keys() == want.keys() == state.keys()
        moved = 0
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=0, err_msg=k)
            moved += not torch.equal(got[k], state[k])
        assert moved >= 4  # kernels and their biases move; the LSTMs' w_ih/w_hh are not kernels and keep theirs
        if "layer_0_lstm.lstm_0.fw.w_ih" in state:
            assert torch.equal(got["layer_0_lstm.lstm_0.fw.w_ih"], state["layer_0_lstm.lstm_0.fw.w_ih"])


@pytest.mark.parametrize("use_running_average", [False, True])
def test_qbatchnorm_matches_flax(use_running_average):
    x = _x((4, 20, 6), 9, 2.0) + 0.5
    spec = dict(SPEC, observer=False)  # the grid on the given range from the first call
    jm = jax_layers.QBatchNorm(q=JaxQuantSpec(**spec))
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), use_running_average=False))
    variables["params"] = {"norm": {"scale": np.linspace(0.5, 1.5, 6, dtype=np.float32),
                                    "bias": np.linspace(-0.2, 0.3, 6, dtype=np.float32)}}
    variables["batch_stats"] = {"norm": {"mean": np.full(6, 0.1, np.float32), "var": np.full(6, 1.5, np.float32)}}
    variables["qparams"]["activation_fake_quantize"] = {"min_range": np.float32(-3.0), "max_range": np.float32(3.0)}
    want, upd = jm.apply(variables, jnp.asarray(x), use_running_average=use_running_average,
                         mutable=["batch_stats", "qparams", "qstats"])
    port = layers.QBatchNorm(6, q=QuantSpec(**spec))
    with torch.no_grad():
        port.norm.weight.copy_(torch.from_numpy(variables["params"]["norm"]["scale"]))
        port.norm.bias.copy_(torch.from_numpy(variables["params"]["norm"]["bias"]))
        port.norm.running_mean.fill_(0.1)
        port.norm.running_var.fill_(1.5)
        aq = port.activation_fake_quantize
        aq.min_range.fill_(-3.0)
        aq.max_range.fill_(3.0)
    port.train()
    with torch.no_grad():
        got = _jax_layout(port(_nct(x), use_running_average=use_running_average))
    _assert_layer_rule(got, np.asarray(want), {"min_range": -3.0, "max_range": 3.0})
    stats = upd["batch_stats"]["norm"]
    np.testing.assert_allclose(port.norm.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(port.norm.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-6, atol=1e-7)
    if use_running_average:
        assert np.all(port.norm.running_mean.numpy() == np.float32(0.1))
