"""The port's HTDemucs model and its int8 engine against the JAX package.

The tiny models of the JAX tests (``TINY`` of ``tests/test_htdemucs.py``,
and a ``bottom_channels`` variant as in ``tests/test_htdemucs_parity.py``)
take the port's seeded init, are calibrated by four observer steps (the
window of three, then one quantized step: JAX's for the TINY QAT model, the
port's for the other), carried across with ``htdemucs_from_jax`` (and its
inverse, :func:`to_jax`) and run by both packages on the same synthetic
stems. JAX runs jitted with
the algebraic simplifier off. Bounds:

* the model: SNR >= 20 dB per output, in ``train=True`` and
  ``train=False`` (the input right-padded to the segment), float and QAT;
  through the observer window in ``train()`` mode, >= 40 dB on the three
  steps whose activations are not quantized (the splitter's LSB plane
  carries the input's last bits 256 times larger, so the FFTs' ulps show),
  the counters equal, the EMA ranges within 2e-2 and 90% of them within
  1e-3 (an activation's extreme can sit where the LSB plane flipped);
* the folded model ``torch.equal`` to the fake-quant one;
* the int8 engine's transformer block against JAX's ``HTDemucsInt8Engine``
  block run eagerly on the same boundary tensors, in both compute dtypes,
  by ``tests/test_torch_int8.py``'s ``JAX_BOUND``; the whole engine against
  the port's own fake-quant forward (float32: the same grid values but for
  rare ties), and its K4 sites: 44 at the config's 5 layers, 10 of them with
  the GELU epilogue.

The whole models are chaotic at the grid level: XLA's FFT and PyTorch's
differ in the last bits, which moves a value across a rounding tie of the
first encoder's grids here and there, and the difference grows through the
net. So the model is held by SNR, and the blocks by the layer rule
(``tests/test_torch_htdemucs_layers.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fqss_tpu.data import synthetic as jax_synthetic
from fqss_tpu.models.htdemucs import HTDemucs as JaxHTDemucs
from fqss_tpu.quant import QuantSpec as JaxQuantSpec
from fqss_tpu_torch.models.convert import htdemucs_from_jax
from fqss_tpu_torch.models.htdemucs import HTDemucs
from fqss_tpu_torch.ops import int8_matmul as im
from fqss_tpu_torch.quant.quantizers import ActQuantizer, WeightQuantizer
from fqss_tpu_torch.quant.spec import QuantSpec
from fqss_tpu_torch.serve import HTDemucsInt8Engine, common, fold_quantized_weights, make_int8_engine

torch.set_num_threads(1)

TINY = dict(channels=8, nfft=512, t_layers=3, t_heads=4, segment=0.5, samplerate=8000)
BOTTOM = dict(TINY, bottom_channels=16)
SPEC = dict(qat=True, n_splitter=2, n_combiner=2, out_quant=True, max_observations=3)
T = 4000
OBSERVE_STEPS = 4

# tests/test_torch_int8.py:JAX_BOUND: (minimum SNR in dB per output, largest share of values more than half an output
# step apart, largest mean |difference| in output steps).
JAX_BOUND = {"float32": (100.0, 1e-3, 1e-3), "bfloat16": (40.0, 1e-2, 2e-2)}


def _noalg(fn):
    return jax.jit(fn, compiler_options={"xla_disable_hlo_passes": "algsimp"})


def _snr_db(ref, est):
    return 10 * np.log10(np.sum(ref**2, -1) / np.maximum(np.sum((ref - est) ** 2, -1), 1e-30))


def to_jax(port, jax_model, x):
    """The JAX variables of ``jax_model`` holding ``port``'s state: :func:`htdemucs_from_jax` run on a tree of element
    indices gives each port tensor's place in JAX's leaves (no JAX compile: the tree's shapes come from tracing)."""
    shapes = jax.eval_shape(lambda x: jax_model.init(jax.random.PRNGKey(0), x, train=True), jnp.asarray(x))
    leaves, tree = jax.tree_util.tree_flatten(shapes)
    sizes = np.cumsum([0] + [leaf.size for leaf in leaves])
    index = jax.tree_util.tree_unflatten(tree, [np.arange(a, b).reshape(leaf.shape)
                                                for a, b, leaf in zip(sizes[:-1], sizes[1:], leaves)])
    flat = np.zeros(sizes[-1])
    state = port.state_dict()
    places = htdemucs_from_jax(index)
    assert places.keys() == state.keys()
    for key, place in places.items():
        flat[place.numpy().ravel()] = state[key].double().numpy().ravel()
    return jax.tree_util.tree_unflatten(tree, [flat[a:b].reshape(leaf.shape).astype(leaf.dtype)
                                               for a, b, leaf in zip(sizes[:-1], sizes[1:], leaves)])


def _observer_steps(jm, variables, mix):
    """[(output, variables)] after each of OBSERVE_STEPS observer steps of the JAX model."""
    step = _noalg(lambda v, x: jm.apply(v, x, train=True, mutable=["qparams", "qstats"]))
    steps, v = [], variables
    for _ in range(OBSERVE_STEPS):
        out, upd = step(v, jnp.asarray(mix))
        v = {**v, **jax.device_get(upd)}
        steps.append((np.asarray(out), v))
    return steps


@pytest.fixture(scope="module")
def models():
    """{name: (JAX eval model, variables, port eval model)} for "float" and "qat" (TINY) and "bottom" (QAT), the
    TINY QAT model's initial variables and JAX's observer steps from them, and the mixtures [2, 2, T].

    The weights are the port's seeded init. The "qat" model is calibrated by JAX's observer steps, the "bottom"
    one by the port's (four calls in ``train()`` mode), each then carried to the other package."""
    mix = jax_synthetic.synth_music_batch(np.random.default_rng(0), 2, T).sum(axis=1)
    out = {}
    for name, arch, spec in (("float", TINY, {}), ("qat", TINY, SPEC), ("bottom", BOTTOM, SPEC)):
        port = HTDemucs(q=QuantSpec(observer=True, **spec), **arch, generator=torch.Generator().manual_seed(0))
        jm = JaxHTDemucs(q=JaxQuantSpec(observer=True, **spec), **arch)
        if name == "bottom":
            with torch.no_grad():
                for _ in range(OBSERVE_STEPS):
                    port.train()(torch.from_numpy(mix))
        variables = to_jax(port, jm, mix)
        if name == "qat":
            init = variables
            steps = _observer_steps(jm, init, mix)
            variables = steps[-1][1]
        served = HTDemucs(q=QuantSpec(observer=False, **spec), **arch)
        served.load_state_dict(htdemucs_from_jax(variables), strict=True)
        out[name] = (JaxHTDemucs(q=JaxQuantSpec(observer=False, **spec), **arch), variables, served.eval())
    return out, init, steps, mix


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,train", [("float", True), ("float", False), ("qat", True), ("qat", False),
                                        ("bottom", False)])
def test_model_matches_jitted_jax(models, name, train):
    models, *_, mix = models
    jax_eval, variables, port = models[name]
    x = mix if train else mix[..., :3500]  # train=False pads to the 4000-sample segment and cuts back
    want = np.asarray(_noalg(lambda v, x: jax_eval.apply(v, x, train=train))(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(np.ascontiguousarray(x)), train=train).numpy()
    assert got.shape == want.shape == (2, 4, 2, x.shape[-1])
    snr = _snr_db(want, got)
    assert (snr >= 20).all(), f"port vs jitted JAX SNR {snr.min()} dB < 20 dB"


def test_model_matches_jax_through_the_observer_window(models):
    """The QAT model in ``train()`` mode from its initial ranges: the first three calls inside the act observers'
    window (outputs unquantized, EMA ranges written, the weight observers' one shot on the first), the fourth
    quantized; the counters, flags and ranges after them equal JAX's."""
    _, init, steps, mix = models
    port = HTDemucs(q=QuantSpec(observer=True, **SPEC), **TINY)
    port.load_state_dict(htdemucs_from_jax(init), strict=True)
    port.train()
    for i, (want, _) in enumerate(steps):
        with torch.no_grad():
            got = port(torch.from_numpy(mix)).numpy()
        snr = _snr_db(want, got)
        assert (snr >= (40 if i < SPEC["max_observations"] else 20)).all(), (i, snr.min())
    sd = htdemucs_from_jax(steps[-1][1])
    close = []
    for key, value in port.state_dict().items():
        if key.endswith(("n_iter", "observed")):
            assert torch.equal(value, sd[key].to(value.dtype)), key
        elif key.endswith(("min_range", "max_range")):
            np.testing.assert_allclose(value.numpy(), sd[key].numpy(), rtol=2e-2, atol=1e-4, err_msg=key)
            close.append(np.allclose(value.numpy(), sd[key].numpy(), rtol=1e-3, atol=1e-5))
    assert np.mean(close) >= 0.9, np.mean(close)


def test_converter_covers_every_leaf(models):
    models, *_ = models
    for name in ("float", "qat", "bottom"):
        _, variables, port = models[name]
        sd = htdemucs_from_jax(variables)
        leaves = sum(len(jax.tree_util.tree_leaves(variables.get(c, {}))) for c in ("params", "qparams", "qstats"))
        assert len(sd) == leaves == len(port.state_dict()), name
        for k, v in port.state_dict().items():
            assert tuple(sd[k].shape) == tuple(v.shape), k


def test_quantizer_sites_equal_jax_scopes(models):
    models, *_ = models
    _, variables, port = models["bottom"]
    scopes = {tuple(k.key for k in path[:-1])
              for path, _ in jax.tree_util.tree_flatten_with_path(variables["qparams"])[0]}
    weight = sum(s[-1].startswith("weight_fake_quantize") for s in scopes)
    assert sum(isinstance(m, WeightQuantizer) for m in port.modules()) == weight
    assert sum(isinstance(m, ActQuantizer) for m in port.modules()) == len(scopes) - weight


@pytest.mark.parametrize("name", ["qat", "bottom"])
def test_folded_model_bitwise_equals_fake_quant(models, name):
    models, *_, mix = models
    port = models[name][2]
    folded = fold_quantized_weights(port)
    assert not any(isinstance(m, WeightQuantizer) for m in folded.modules())
    assert folded.decoders[-1].conv_tr.residual_error_block.weight_fake_quantize_dec is None
    x = torch.from_numpy(mix[..., :3000])
    with torch.no_grad():
        for train in (True, False):
            assert torch.equal(folded(x, train=train), port(x, train=train))


@pytest.mark.parametrize("batch", [1, 2])
def test_every_quantizer_input_is_contiguous(models, batch):
    """The CUDA kernels take contiguous tensors only: hold every call site to that on the CPU."""
    models, *_, mix = models
    model = HTDemucs(q=QuantSpec(observer=True, **SPEC), **BOTTOM)
    model.load_state_dict(models["bottom"][2].state_dict())
    seen = []
    for m in model.modules():
        if isinstance(m, (ActQuantizer, WeightQuantizer)):
            m.register_forward_pre_hook(lambda mod, args: seen.append(args[0].is_contiguous()))
    x = torch.from_numpy(mix[:batch])
    with torch.no_grad():
        model.train()(x)  # the attn/softmax sites run too
        model.eval()(x, train=False)
        fold_quantized_weights(model)(x)
    assert len(seen) > 300 and all(seen)


def test_factory_builds_htdemucs_with_the_jax_keys(models, tmp_path):
    from fqss_tpu_torch.models.factory import MODEL_NAMES, create_model, create_pretrained_model

    models, *_, mix = models
    port = models["qat"][2]
    cfg = {"name": "HTDemucs", "sources": ["drums", "bass", "other", "vocals"], "audio_channels": 2, **TINY,
           "quantization": {**SPEC, "observer": True}}
    assert "HTDemucs" in MODEL_NAMES
    model = create_model(cfg)
    assert isinstance(model, HTDemucs) and model.nfft == 512 and model.q.n_splitter == 2 and model.t_layers == 3
    ckpt = tmp_path / "htdemucs.pt"
    torch.save(port.state_dict(), ckpt)
    loaded = create_pretrained_model({**cfg, "model_path": str(ckpt)}, observer=False)
    with torch.no_grad():
        assert torch.equal(loaded(torch.from_numpy(mix)), port(torch.from_numpy(mix)))
    legacy = create_model({"name": "HDemucsLegacy"})  # the JAX factory's sixth family, at JAX's defaults
    assert type(legacy).__name__ == "HDemucs" and (legacy.nfft, legacy.depth, legacy.n_srcs) == (4096, 6, 4)


# ---------------------------------------------------------------------------
# The int8 engine
# ---------------------------------------------------------------------------


def _boundary(port, mix):
    """The transformer's inputs (x [B, C, Fr, T1], xt [B, C, T2]) in the fake-quant forward on ``mix``."""
    seen = []
    real = port._transformer
    port._transformer = lambda x, xt: seen.append((x, xt)) or real(x, xt)
    try:
        with torch.no_grad():
            port(torch.from_numpy(mix), train=False)
    finally:
        del port._transformer
    return seen[0]


@pytest.mark.parametrize("name", ["qat", "bottom"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_int8_transformer_block_matches_the_jax_engine(models, name, compute_dtype):
    from fqss_tpu.serve.htdemucs_int8 import HTDemucsInt8Engine as JaxEngine

    models, *_, mix = models
    jax_eval, variables, port = models[name]
    x, xt = _boundary(port, mix)
    engine = JaxEngine(jax_eval, variables, compute_dtype=compute_dtype)
    with jax.disable_jit():
        want_x, want_xt = engine._transformer(jnp.asarray(x.permute(0, 2, 3, 1).numpy()),
                                              jnp.asarray(xt.transpose(1, 2).numpy()))
    got_x, got_xt = make_int8_engine(port, compute_dtype=compute_dtype)._transformer(x, xt)
    snr_min, share_max, mean_max = JAX_BOUND[compute_dtype]
    last = port.crosstransformer.layers[-1]
    for got, want, layer, down in ((got_x.permute(0, 2, 3, 1), want_x, last[0], "channel_downsampler"),
                                   (got_xt.transpose(1, 2), want_xt, last[1], "channel_downsampler_t")):
        aq = (getattr(port, down) if port.bottom_channels else layer.norm_out.const).activation_fake_quantize
        lsb = float(aq.max_range.detach() - aq.min_range.detach()) / 255
        got, want = got.numpy(), np.asarray(want)
        diff = np.abs(got - want) / lsb
        snr = _snr_db(want.reshape(want.shape[0], -1), got.reshape(got.shape[0], -1))
        assert (snr >= snr_min).all(), snr.min()
        assert (diff > 0.5).mean() <= share_max and diff.mean() <= mean_max, ((diff > 0.5).mean(), diff.mean())


@pytest.mark.parametrize("name", ["qat", "bottom"])
def test_int8_engine_runs_its_sites_on_k4_and_agrees_with_the_fake_quant_forward(models, name):
    models, *_, mix = models
    port = models[name][2]
    x = torch.from_numpy(mix)
    with torch.no_grad():
        ref = port(x, train=False).numpy()
    sites = []
    real = common.Int8Site.__call__
    common.Int8Site.__call__ = lambda self, qa: sites.append((tuple(self.w.shape), self.nl)) or real(self, qa)
    im.reset_launches()
    try:
        engine = make_int8_engine(port, compute_dtype="float32")
        assert isinstance(engine, HTDemucsInt8Engine) and not engine.bf16
        got = engine(x, train=False).numpy()
    finally:
        common.Int8Site.__call__ = real
    assert im.LAUNCHES == {"int8_mm": 0}  # CPU tensors: the plain version
    # self (qkv, out, linear1, linear2) and cross (q, kv, out, linear1, linear2) pairs of layers, the channel samplers
    E = 16 if name == "bottom" else 64
    assert len(sites) == 26 + (4 if name == "bottom" else 0)
    assert sum(nl == "gelu" for _, nl in sites) == 6 and all(w == (4 * E, E) for w, nl in sites if nl == "gelu")
    aq = port.decoders[-1].conv_tr.activation_fake_quantize
    lsb = float(aq.max_range.detach() - aq.min_range.detach()) / 255
    assert (_snr_db(ref, got) >= 60).all(), _snr_db(ref, got).min()
    assert np.mean(np.abs(got - ref) > 0.5 * lsb) <= 1e-3
    with torch.no_grad():
        bf16 = make_int8_engine(port, compute_dtype="bfloat16")(x, train=False).numpy()
    assert (_snr_db(ref, bf16) >= 15).all(), _snr_db(ref, bf16).min()


def test_int8_engine_counts_44_launches_at_the_config_depth():
    """The config's 5 transformer layers (3 self pairs, 2 cross pairs): 24 + 20 K4 sites, 10 with the GELU."""
    model = HTDemucs(q=QuantSpec(**SPEC), **dict(TINY, t_layers=5)).eval()
    sites = []
    real = common.Int8Site.__call__
    common.Int8Site.__call__ = lambda self, qa: sites.append(self.nl) or real(self, qa)
    try:
        HTDemucsInt8Engine(model, compute_dtype="float32")(torch.zeros(1, 2, 1000), train=False)
    finally:
        common.Int8Site.__call__ = real
    assert len(sites) == 44 and sites.count("gelu") == 10


@pytest.mark.parametrize("spec,kw,error", [
    (dict(SPEC, weight_n_bits=4), {}, NotImplementedError),
    (dict(qat=False), {}, ValueError),
    (SPEC, dict(t_layers=0), NotImplementedError),
])
def test_int8_engine_refuses_what_it_cannot_serve(spec, kw, error):
    with pytest.raises(error):
        HTDemucsInt8Engine(HTDemucs(q=QuantSpec(**spec), **{**TINY, **kw}))
