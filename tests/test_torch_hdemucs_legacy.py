"""The port's legacy hybrid Demucs (``HDemucsLegacy``) against the JAX package's ``HDemucs``.

The tiny config of the JAX tests (``tests/test_hdemucs_legacy.py:72-75``: 4 channels, nfft 1024, depth 6, BLSTM and
LocalState from index 4, dconv_comp 2, 8 kHz, 0.5 s) takes the port's seeded init; a QAT model is calibrated by the
port's observer window (three calls in ``train()`` mode, then one quantized call) and carried across with
``htdemucs_from_jax`` on a tree of element indices (:func:`to_jax`, no JAX init is compiled). JAX runs jitted with the
algebraic simplifier off. Bounds:

* the float models (cac, ratio mask, EM Wiener with ``multi_freqs``): within 1e-4 of the largest output value. The
  ratio mask is held so on a white-noise mixture: it multiplies the model's magnitudes by the mixture's phase
  ``z / |z|``, and the synthetic stems' band-limited spectrum puts 9% of its bins below 1e-6, where that phase is
  the FFTs' round-off (XLA's and PyTorch's differ there by up to 0.7 of a unit circle); on those stems it is held
  by SNR >= 20 dB, as the QAT models;
* the QAT models: SNR >= 20 dB per output (ROADMAP "Rules for new tests");
* the fold ``torch.equal``, ``--engine auto`` the folded model, the converter every leaf both ways, the JAX
  ``.npz`` export loaded and served bitwise equal to its source, the factory's keys, the refusals JAX makes (the
  int8 engine, a reference ``.pth``, ``multi_freqs`` with a combiner), MUSDB ``val`` on JAX's non-HTDemucs branch.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fqss_tpu.data import synthetic as jax_synthetic
from fqss_tpu.models.hdemucs import HDemucs as JaxHDemucs
from fqss_tpu.quant import QuantSpec as JaxQuantSpec
from fqss_tpu.train.checkpoints import export_model
from fqss_tpu_torch.models.convert import htdemucs_from_jax, htdemucs_to_jax
from fqss_tpu_torch.models.hdemucs import HDemucs
from fqss_tpu_torch.quant.quantizers import ActQuantizer, WeightQuantizer
from fqss_tpu_torch.quant.spec import QuantSpec
from fqss_tpu_torch.serve import fold_quantized_weights, make_int8_engine
from fqss_tpu_torch.serve.autopath import auto_serving_model

torch.set_num_threads(1)

TINY = dict(channels=4, nfft=1024, depth=6, norm_starts=4, dconv_lstm=4, dconv_attn=4, dconv_comp=2.0,
            samplerate=8000, segment=0.5)
SPEC = dict(qat=True, n_splitter=2, n_combiner=2, out_quant=True, max_observations=3)
T = 4000
WIENER = dict(cac=False, wiener_iters=1, multi_freqs=(0.5,))
# name: (spec, output-stage keywords)
CASES = {"float": ({}, {}), "ratio": ({}, dict(cac=False, wiener_iters=-1)), "wiener": ({}, WIENER),
         "qat": (SPEC, {}), "qat_ratio": (SPEC, dict(cac=False, wiener_iters=-1)),
         "qat_wiener": (dict(SPEC, n_combiner=1), WIENER)}


def _noalg(fn):
    return jax.jit(fn, compiler_options={"xla_disable_hlo_passes": "algsimp"})


def _snr_db(ref, est):
    return 10 * np.log10(np.sum(ref**2, -1) / np.maximum(np.sum((ref - est) ** 2, -1), 1e-30))


def _index_tree(jax_model, x):
    shapes = jax.eval_shape(lambda x: jax_model.init(jax.random.PRNGKey(0), x), jnp.asarray(x))
    leaves, tree = jax.tree_util.tree_flatten(shapes)
    sizes = np.cumsum([0] + [leaf.size for leaf in leaves])
    index = jax.tree_util.tree_unflatten(tree, [np.arange(a, b).reshape(leaf.shape)
                                                for a, b, leaf in zip(sizes[:-1], sizes[1:], leaves)])
    return index, leaves, tree, sizes


def to_jax(port, jax_model, x):
    """The JAX variables of ``jax_model`` holding ``port``'s state: :func:`htdemucs_from_jax` run on a tree of element
    indices gives each port tensor's place in JAX's leaves."""
    index, leaves, tree, sizes = _index_tree(jax_model, x)
    flat = np.zeros(sizes[-1])
    state = port.state_dict()
    places = htdemucs_from_jax(index)
    assert places.keys() == state.keys()
    for key, place in places.items():
        flat[place.numpy().ravel()] = state[key].double().numpy().ravel()
    return jax.tree_util.tree_unflatten(tree, [flat[a:b].reshape(leaf.shape).astype(leaf.dtype)
                                               for a, b, leaf in zip(sizes[:-1], sizes[1:], leaves)])


def _port(name, observer=False):
    spec, kw = CASES[name]
    return HDemucs(q=QuantSpec(observer=observer, **spec), generator=torch.Generator().manual_seed(0), **TINY, **kw)


@pytest.fixture(scope="module")
def stems_mix():
    return jax_synthetic.synth_music_batch(np.random.default_rng(0), 2, T).sum(axis=1).astype(np.float32)


@pytest.fixture(scope="module")
def served(stems_mix):
    """{name: the port's served model (eval, observer off)}: the QAT ones after the port's observer window and one
    quantized call on the stems."""
    out = {}
    for name, (spec, _) in CASES.items():
        model = _port(name, observer=True)
        if spec:
            with torch.no_grad():
                for _ in range(4):
                    model.train()(torch.from_numpy(stems_mix))
        served = _port(name)
        served.load_state_dict(model.state_dict())
        out[name] = served.eval()
    return out


def _jax_forward(name, port, x):
    spec, kw = CASES[name]
    jm = JaxHDemucs(q=JaxQuantSpec(observer=False, **spec), **TINY, **kw)
    return np.asarray(_noalg(lambda v, x: jm.apply(v, x))(to_jax(port, jm, x), jnp.asarray(x)))


@pytest.mark.parametrize("name", list(CASES))
def test_model_matches_jitted_jax(served, stems_mix, name):
    port = served[name]
    x = stems_mix
    if name == "ratio":  # white noise: every bin far above the FFTs' round-off (module note)
        x = (np.random.default_rng(1).standard_normal((2, 2, T)) * 0.2).astype(np.float32)
    want = _jax_forward(name, port, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 4, 2, T)
    if name.startswith("qat"):
        assert _snr_db(want, got).min() >= 20, _snr_db(want, got)
    else:
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), np.abs(got - want).max() / np.abs(want).max()


def test_ratio_mask_on_band_limited_stems_is_held_by_snr(served, stems_mix):
    want = _jax_forward("ratio", served["ratio"], stems_mix)
    with torch.no_grad():
        got = served["ratio"](torch.from_numpy(stems_mix)).numpy()
    assert _snr_db(want, got).min() >= 20, _snr_db(want, got)


@pytest.mark.parametrize("name", ["qat", "qat_ratio", "qat_wiener"])
def test_folded_and_auto_bitwise_equal_fake_quant(served, stems_mix, name):
    port = served[name]
    x = torch.from_numpy(stems_mix)
    folded, auto = fold_quantized_weights(port), auto_serving_model(port)
    for model in (folded, auto):
        assert type(model) is HDemucs and model.q.weight_quant is False
        assert not any(isinstance(m, WeightQuantizer) for m in model.modules())
    with torch.no_grad():
        y = port(x)
        assert torch.equal(folded(x), y) and torch.equal(auto(x), y)


@pytest.mark.parametrize("batch", [1, 2])
def test_every_quantizer_and_lstm_input_is_contiguous(served, stems_mix, batch):
    """The CUDA kernels take contiguous tensors only: the quantizers', the QLSTMs' (K7 reads ``ih`` as written) and
    the QDense layers' (K5) inputs, at batch 1 and 2."""
    from fqss_tpu_torch.nn.layers import QDense
    from fqss_tpu_torch.nn.lstm import QLSTM

    model = _port("qat", observer=True)
    model.load_state_dict(served["qat"].state_dict())
    seen = []
    for m in model.modules():
        if isinstance(m, (ActQuantizer, WeightQuantizer, QLSTM, QDense)):
            m.register_forward_pre_hook(lambda mod, args: seen.append(args[0].is_contiguous()))
    with torch.no_grad():
        x = torch.from_numpy(stems_mix[:batch])
        model.train()(x)
        model.eval()(x)
        fold_quantized_weights(model)(x)
    assert len(seen) > 500 and all(seen)


def test_converter_covers_every_leaf_both_ways(stems_mix):
    for name in ("qat", "qat_wiener", "float"):
        spec, kw = CASES[name]
        jm = JaxHDemucs(q=JaxQuantSpec(**spec), **TINY, **kw)
        index, leaves, tree, sizes = _index_tree(jm, stems_mix)
        places = htdemucs_from_jax(index)
        state = _port(name).state_dict()
        assert places.keys() == state.keys()
        assert all(places[k].shape == state[k].shape for k in state)
        got = np.sort(np.concatenate([p.numpy().ravel() for p in places.values()]))
        np.testing.assert_array_equal(got, np.arange(sizes[-1]))  # every JAX leaf element exactly once
        back = htdemucs_to_jax(places)
        flat_back = jax.tree_util.tree_leaves(back)
        assert jax.tree_util.tree_structure(back) == tree
        for a, b in zip(flat_back, jax.tree_util.tree_leaves(index)):
            np.testing.assert_array_equal(a, b)


# The factory's tiny model: JAX's factory keys only (fqss_tpu/models/factory.py:91-93), so dconv_comp and the
# insert depths stay at JAX's defaults.
FACTORY_TINY = {"name": "HDemucsLegacy", "sources": ["drums", "bass", "other", "vocals"], "channels": 4, "nfft": 1024,
                "samplerate": 8000, "segment": 0.5, "quantization": SPEC}


def _factory_model(stems_mix, seed=5):
    """FACTORY_TINY from ``create_model`` on a seeded generator, after its observer window and one quantized call."""
    from fqss_tpu_torch.models.factory import create_model

    model = create_model(FACTORY_TINY, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for _ in range(4):
            model.train()(torch.from_numpy(stems_mix))
    return model


def test_factory_builds_hdemucs_legacy_with_the_jax_keys(stems_mix, tmp_path):
    from fqss_tpu_torch.models.factory import MODEL_NAMES, create_model, create_pretrained_model

    assert "HDemucsLegacy" in MODEL_NAMES
    default = create_model({"name": "HDemucsLegacy"})
    assert type(default) is HDemucs and (default.nfft, default.depth, default.n_srcs, default.cac) == (4096, 6, 4,
                                                                                                       True)
    assert default.plan[4]["last_freq"] and default.plan[4]["chout_z"] == 768 and default.plan[5]["chout_z"] == 1536
    cfg = {**FACTORY_TINY, "audio_channels": 2, "depth": 6, "cac": False, "wiener_iters": 1, "multi_freqs": [0.5],
           "multi_freqs_depth": 2,
           "norm_starts": 0, "dconv_comp": 2.0,  # not JAX's factory keys: ignored
           "quantization": {**SPEC, "n_combiner": 1}}
    model = create_model(cfg)
    assert (model.nfft, model.multi_freqs, model.cac, model.wiener_iters, model.q.n_splitter) == (1024, (0.5,), False,
                                                                                                  1, 2)
    assert model.norm_starts == 4 and not model.plan[3]["norm"]
    assert model.encoder_4.dconv.layer_0_lstm.lstm_0.fw.w_hh.shape[0] == 64 // 4  # dconv_comp stays 4
    source = _factory_model(stems_mix)
    ckpt = tmp_path / "hdemucs.pt"
    torch.save(source.state_dict(), ckpt)
    loaded = create_pretrained_model({**FACTORY_TINY, "model_path": str(ckpt)}, observer=False)
    assert loaded.q.observer is False and not loaded.training
    x = torch.from_numpy(stems_mix)
    with torch.no_grad():
        assert torch.equal(loaded(x), source.eval()(x))


def test_jax_npz_export_loads_and_serves_equal_to_its_source(stems_mix, tmp_path):
    from fqss_tpu_torch.models.factory import create_pretrained_model

    source = _factory_model(stems_mix).eval()
    jm = JaxHDemucs(q=JaxQuantSpec(**SPEC), **{k: FACTORY_TINY[k] for k in ("channels", "nfft", "samplerate",
                                                                            "segment")})
    variables = to_jax(source, jm, stems_mix)
    path = str(tmp_path / "hdemucs.npz")
    export_model(path, variables)
    loaded = create_pretrained_model({**FACTORY_TINY, "model_path": path}, observer=False)
    want = htdemucs_from_jax(jax.device_get(variables))
    got = loaded.state_dict()
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    x = torch.from_numpy(stems_mix)
    with torch.no_grad():
        assert torch.equal(loaded(x), source(x))


def test_int8_engine_and_reference_pth_are_refused_as_jax_refuses_them(served, tmp_path):
    from fqss_tpu import serve as jax_serve
    from fqss_tpu_torch.models.factory import create_pretrained_model

    jm = JaxHDemucs(q=JaxQuantSpec(**SPEC), **TINY)
    with pytest.raises(NotImplementedError) as jax_err:
        jax_serve.make_int8_engine(jm, {})
    with pytest.raises(NotImplementedError) as port_err:
        make_int8_engine(served["qat"])
    assert str(port_err.value) == str(jax_err.value) == "no int8 engine for HDemucs; use fold_quantized_weights"
    ref = tmp_path / "reference.pth"
    torch.save({"state_dict": {"model.encoder.0.conv.weight": torch.zeros(48, 8, 8, 1)}}, ref)
    with pytest.raises(NotImplementedError, match="^torch import not yet wired for HDemucs$"):
        create_pretrained_model({**FACTORY_TINY, "model_path": str(ref)})


def test_multi_freqs_with_a_combiner_is_refused_as_jax_fails(stems_mix):
    jm = JaxHDemucs(q=JaxQuantSpec(**SPEC), **TINY, **WIENER)
    with pytest.raises(ValueError):
        jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x), jnp.asarray(stems_mix))
    with pytest.raises(ValueError, match="n_combiner"):
        HDemucs(q=QuantSpec(**SPEC), **TINY, **WIENER)


def test_val_takes_jaxs_non_htdemucs_branch(stems_mix, tmp_path):
    """MUSDB NSDR through ``val.evaluate``: the forward is called with no ``train`` keyword on unpadded chunks of
    ``segment_samples`` (``fqss_tpu/train/validate_musdb.py:45-63``), and the scores are finite."""
    from fqss_tpu_torch import val
    from fqss_tpu_torch.data.musdb import make_mini_musdb

    root = make_mini_musdb(str(tmp_path / "musdb"), n_train=0, n_test=2, sample_rate=8000, seconds=1.0)
    ckpt = tmp_path / "hdemucs.pt"
    torch.save(_factory_model(stems_mix).state_dict(), ckpt)
    conf = {"model_cfg": {**FACTORY_TINY, "model_path": str(ckpt)}, "dataset_cfg": {"name": "musdbhq"},
            "testing_cfg": {"test_dir": root, "NSDR": True, "segment_samples": 3000, "overlap": 0.25}}
    calls = []
    real_forward = HDemucs.forward

    def forward(self, mix, *args, **kwargs):
        calls.append((mix.shape[-1], args, kwargs))
        return real_forward(self, mix, *args, **kwargs)

    HDemucs.forward = forward
    try:
        scores = val.evaluate(conf, "auto", device="cpu")
    finally:
        HDemucs.forward = real_forward
    assert calls and all(length == 3000 and not args and not kwargs for length, args, kwargs in calls)
    assert set(scores) == {"nsdr", "nsdr_drums", "nsdr_bass", "nsdr_other", "nsdr_vocals"}
    assert np.isfinite(list(scores.values())).all()
