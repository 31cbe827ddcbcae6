"""The port's ConvTasNet-music slice against the JAX package: host code, the model, its losses and its int8 engine.

A tiny FQSS-8bit ConvTasNet-music (n_filters 16, bn 8, hid 16, 2 blocks x 1
repeat, stereo, 4 stems, n_splitter = n_combiner = 2, out_quant, the test
configuration of ``tests/test_musdb.py``) is initialised and calibrated in
JAX, converted with ``convtasnet_music_from_jax`` and run by both packages
on the same numpy stems. Bounds:

* host code (the splitter without normalisation, the synthetic stems, the
  WAV reads, the MUSDB sets, the augmentation transform on JAX's draws,
  ``aggregate_frames``): equal, bit for bit;
* each block (depthwise-separable conv, conv block, mask generator) against
  eager JAX: within one LSB of its output grid, at most 1% of values a step
  apart (``tests/test_torch_layers.py``'s rule); eager, because jitted JAX
  rounds the weight grid's step by a reciprocal;
* the whole model against JAX jitted with the algebraic simplifier off (the
  pass that makes that rewrite): SNR >= 20 dB per output;
* the losses to rtol 1e-5;
* the int8 engine against JAX's ``ConvTasNetMusicInt8Engine`` run eagerly,
  by ``tests/test_torch_int8.py``'s ``JAX_BOUND`` (it reads ~303 dB in both
  compute dtypes).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fqss_tpu.data import synthetic as jax_synthetic
from fqss_tpu.models.convtasnet_music import ConvTasNetMusic as JaxMusic
from fqss_tpu.models.convtasnet_music import ConvBlock as JaxConvBlock
from fqss_tpu.models.convtasnet_music import DepthwiseSeparableConv as JaxDSConv
from fqss_tpu.models.convtasnet_music import MaskGenerator as JaxMaskGenerator
from fqss_tpu.quant import QuantSpec as JaxQuantSpec
from fqss_tpu.quant.calibration import run_observer
from fqss_tpu_torch.data import synthetic
from fqss_tpu_torch.models.convert import convtasnet_music_from_jax
from fqss_tpu_torch.models.convtasnet_music import ConvBlock, ConvTasNetMusic, DepthwiseSeparableConv, MaskGenerator
from fqss_tpu_torch.ops import int8_matmul as im
from fqss_tpu_torch.quant.quantizers import ActQuantizer, WeightQuantizer
from fqss_tpu_torch.quant.spec import QuantSpec
from fqss_tpu_torch.serve import ConvTasNetMusicInt8Engine, fold_quantized_weights, make_int8_engine

torch.set_num_threads(1)

ARCH = dict(n_filters=16, bn_chan=8, hid_chan=16, n_blocks=2, n_repeats=1)
SPEC = dict(qat=True, n_splitter=2, n_combiner=2, out_quant=True, max_observations=3)
SOURCES = ("drums", "bass", "other", "vocals")
T = 2000


def _noalg(fn):
    return jax.jit(fn, compiler_options={"xla_disable_hlo_passes": "algsimp"})


def _snr_db(ref, est):
    return 10 * np.log10(np.sum(ref**2, -1) / np.maximum(np.sum((ref - est) ** 2, -1), 1e-30))


@pytest.fixture(scope="module")
def calibrated():
    """(JAX eval model, calibrated variables, port model, mixtures [2, 2, T])."""
    mix = jax_synthetic.synth_music_batch(np.random.default_rng(0), 2, T).sum(axis=1)
    jm = JaxMusic(q=JaxQuantSpec(observer=True, **SPEC), **ARCH)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(mix))
    variables = jax.device_get(run_observer(jm, variables, jnp.asarray(mix), steps=4))
    port = ConvTasNetMusic(q=QuantSpec(observer=False, **SPEC), **ARCH)
    port.load_state_dict(convtasnet_music_from_jax(variables), strict=True)
    return JaxMusic(q=JaxQuantSpec(observer=False, **SPEC), **ARCH), variables, port.eval(), mix


def _forward(model, x):
    with torch.inference_mode():
        return model(torch.from_numpy(np.asarray(x))).numpy()


# ---------------------------------------------------------------------------
# Host code
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_splitter", [1, 2, 3])
@pytest.mark.parametrize("normalize", [False, True])
def test_preprocess_equals_jax(n_splitter, normalize):
    from fqss_tpu.separation.splitter import preprocess as jax_preprocess
    from fqss_tpu_torch.separation.splitter import preprocess

    x = np.random.default_rng(1).uniform(-0.7, 0.9, (3, 2, 1001)).astype(np.float32) * 3.7
    want = np.asarray(jax_preprocess(jnp.asarray(x), n_splitter, normalize=normalize))
    np.testing.assert_array_equal(preprocess(torch.from_numpy(x), n_splitter, normalize=normalize).numpy(), want)


@pytest.mark.parametrize("name,args", [
    ("synth_band_sources", (3, 1001)),
    ("synth_band_batch", (2, 777)),
    ("synth_music_batch", (2, 901)),
    ("synth_music_batch_hard", (3, 1200)),
])
def test_synthetic_generators_equal_jax(name, args):
    kw = {}
    if name == "synth_music_batch_hard":
        name, kw = "synth_music_batch", dict(band_disjoint=False, n_stems=5)
    got = getattr(synthetic, name)(np.random.default_rng(5), *args, **kw)
    want = getattr(jax_synthetic, name)(np.random.default_rng(5), *args, **kw)
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_wav_info_and_segment_reads_equal_jax(tmp_path):
    from fqss_tpu.native import read_wav_segment as jax_read_wav_segment
    from fqss_tpu.utils.audio import wav_info as jax_wav_info
    from fqss_tpu_torch.utils.audio import read_audio, read_wav_segment, save_audio, wav_info

    stems = synthetic.synth_music_batch(np.random.default_rng(2), 1, 3000)[0]
    for name, wav in (("stereo.wav", stems[0]), ("mono.wav", stems[1, 0])):
        path = str(tmp_path / name)
        save_audio(path, wav, 8000)
        assert wav_info(path) == jax_wav_info(path) == (3000, 8000, 1 if wav.ndim == 1 else 2)
        for offset, n in ((0, 3000), (17, 500), (2900, 300), (100, -1)):
            got, sr = read_wav_segment(path, offset, n)
            want, want_sr = jax_read_wav_segment(path, offset, n)
            assert sr == want_sr == 8000
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, read_audio(path)[0][:, offset: offset + n if n >= 0 else None])


def test_mini_musdb_and_datasets_equal_jax(tmp_path):
    from fqss_tpu.data import musdb as jax_musdb
    from fqss_tpu_torch.data import musdb

    root, jax_root = str(tmp_path / "port"), str(tmp_path / "jax")
    musdb.make_mini_musdb(root, n_train=3, n_test=1, sample_rate=8000, seconds=0.5, seed=3)
    jax_musdb.make_mini_musdb(jax_root, n_train=3, n_test=1, sample_rate=8000, seconds=0.5, seed=3)
    for sub, _, files in os.walk(root):
        for f in files:
            rel = os.path.relpath(os.path.join(sub, f), root)
            assert open(os.path.join(root, rel), "rb").read() == open(os.path.join(jax_root, rel), "rb").read(), rel
    meta = musdb.build_metadata(os.path.join(root, "train"), SOURCES)
    assert meta == jax_musdb.build_metadata(os.path.join(root, "train"), SOURCES)
    for kw in (dict(length=1500, stride=700), dict(length=5000, stride=None), dict()):
        ws = musdb.Wavset(os.path.join(root, "train"), meta, SOURCES, sample_rate=8000, **kw)
        jws = jax_musdb.Wavset(os.path.join(root, "train"), meta, SOURCES, sample_rate=8000, **kw)
        assert len(ws) == len(jws) > 0
        for i in range(len(ws)):
            np.testing.assert_array_equal(ws[i], jws[i])
    meta_file = str(tmp_path / "musdbhq.json")
    sets = musdb.get_musdb_wav_datasets(root, 1000, 8000, 2000, SOURCES, metadata_file=meta_file)
    assert os.path.exists(meta_file)  # written, then read by the JAX loader below
    want = jax_musdb.get_musdb_wav_datasets(root, 1000, 8000, 2000, SOURCES, metadata_file=meta_file)
    for ws, jws in zip(sets, want):
        assert len(ws) == len(jws) > 0 and ws.sources == jws.sources
        for i in range(len(ws)):
            np.testing.assert_array_equal(ws[i], jws[i])
    assert sets[1][0].shape == (5, 2, 4000)  # the validation track whole, the mixture first


def _jax_draws(rng, shape, shift, flip_channels, flip_sign, scale, remix_group_size):
    """The values ``augment_batch(rng, ...)`` draws (fqss_tpu/data/musdb.py:222-258), in apply_augment's form."""
    b, s, c, _ = shape
    k_shift, k_sign, k_flip, k_scale, k_remix = jax.random.split(rng, 5)
    draws = {}
    if shift > 0:
        draws["offsets"] = jax.random.randint(k_shift, (b, s, 1, 1), 0, shift)[..., 0, 0]
    if flip_sign:
        draws["signs"] = jax.random.randint(k_sign, (b, s, 1, 1), 0, 2)[..., 0, 0]
    if flip_channels and c == 2:
        draws["left"] = jax.random.randint(k_flip, (b, s, 1, 1), 0, 2)[..., 0, 0]
    if scale is not None:
        draws["gains"] = jax.random.uniform(k_scale, (b, s, 1, 1), minval=scale[0], maxval=scale[1])[..., 0, 0]
    g = remix_group_size or b
    if b % g == 0 and b > 1:
        draws["perm"] = jnp.argsort(jax.random.uniform(k_remix, (b // g, g, s, 1, 1)), axis=1)[..., 0, 0]
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


@pytest.mark.parametrize("shape,kw", [
    ((4, 4, 2, 1000), dict(shift=100, flip_channels=True, flip_sign=True, scale=(0.25, 1.25), remix_group_size=4)),
    ((4, 4, 2, 1000), dict(shift=100, flip_channels=True, flip_sign=True, scale=(0.25, 1.25), remix_group_size=2)),
    ((2, 4, 2, 500), dict(shift=80, flip_channels=True, flip_sign=True, scale=(0.25, 1.25), remix_group_size=0)),
    ((3, 4, 1, 500), dict(shift=0, flip_channels=True, flip_sign=False, scale=None, remix_group_size=2)),
])
def test_apply_augment_equals_augment_batch_on_its_draws(shape, kw):
    from fqss_tpu.data.musdb import augment_batch
    from fqss_tpu_torch.data.musdb import apply_augment, draw_augment

    wav = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    rng = jax.random.PRNGKey(7)
    want = np.asarray(augment_batch(rng, jnp.asarray(wav), **kw))
    got = apply_augment(torch.from_numpy(wav), **_jax_draws(rng, shape, **kw), shift=kw["shift"]).numpy()
    np.testing.assert_array_equal(got, want)
    # the port's own draws: the same values the same way, in their ranges, reproducible from the seed
    draws = draw_augment(torch.Generator().manual_seed(3), shape, **kw)
    assert {k for k, v in draws.items() if v is not None} == set(_jax_draws(rng, shape, **kw))
    again = draw_augment(torch.Generator().manual_seed(3), shape, **kw)
    assert all(v is None or torch.equal(v, again[k]) for k, v in draws.items())
    if draws["gains"] is not None:
        assert bool(((draws["gains"] >= 0.25) & (draws["gains"] < 1.25)).all())
    if draws["perm"] is not None:
        assert torch.equal(draws["perm"].sort(dim=1).values,
                           torch.arange(draws["perm"].shape[1])[None, :, None].expand_as(draws["perm"]))
    out = apply_augment(torch.from_numpy(wav), **draws, shift=kw["shift"])
    assert out.shape == (*shape[:3], shape[3] - kw["shift"])


def test_aggregate_frames_equals_jax():
    from fqss_tpu.separation.bss_eval import aggregate_frames as jax_aggregate_frames
    from fqss_tpu_torch.separation.bss_eval import aggregate_frames

    rng = np.random.default_rng(4)
    scores = {k: rng.normal(size=(4, 9)).astype(np.float32) for k in ("SDR", "ISR", "SIR", "SAR")}
    scores["SDR"][1, ::3] = np.nan  # silent frames
    got, want = aggregate_frames(scores), jax_aggregate_frames(scores)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("kd_lambda,kind,weights", [
    (0.1, "pow10", None), (0.1, "exp", None), (0.3, "exp", [1.0, 2.0, 0.5, 1.0]), (0.0, "exp", [1.0, 2.0, 0.5, 1.0]),
    (0.0, "pow10", None),
])
def test_music_losses_equal_jax(kd_lambda, kind, weights):
    from fqss_tpu.separation.losses import music_kd_l1_loss as jax_loss
    from fqss_tpu.separation.losses import nsdr_db as jax_nsdr
    from fqss_tpu_torch.separation.losses import music_kd_l1_loss, nsdr_db

    rng = np.random.default_rng(6)
    sources = rng.normal(size=(3, 4, 2, 500)).astype(np.float32)
    wavs = (sources + 0.3 * rng.normal(size=sources.shape)).astype(np.float32)
    fwavs = (sources + 0.1 * rng.normal(size=sources.shape)).astype(np.float32)
    got = music_kd_l1_loss(*map(torch.from_numpy, (wavs, fwavs, sources)), kd_lambda, kind,
                           source_weights=None if weights is None else torch.tensor(weights))
    want = jax_loss(*map(jnp.asarray, (wavs, fwavs, sources)), kd_lambda, kind,
                    source_weights=None if weights is None else jnp.asarray(weights))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(nsdr_db(torch.from_numpy(sources), torch.from_numpy(wavs)).numpy(),
                               np.asarray(jax_nsdr(jnp.asarray(sources), jnp.asarray(wavs))), rtol=1e-5)


# ---------------------------------------------------------------------------
# Blocks and the model
# ---------------------------------------------------------------------------


def _assert_within_one_lsb(got, want, qparams):
    lsb = (float(qparams["max_range"][0]) - float(qparams["min_range"][0])) / 255
    diff = np.abs(got - want)
    assert diff.max() <= lsb * (1 + 1e-4), f"max diff {diff.max()} > 1 LSB {lsb}"
    assert np.mean(diff > 0.5 * lsb) <= 0.01, np.mean(diff > 0.5 * lsb)


BLOCK_SPEC = dict(SPEC, max_observations=2)


@pytest.mark.parametrize("block", ["dsconv", "conv_block", "mask_generator"])
def test_blocks_match_eager_jax(block):
    x = np.random.default_rng(0).standard_normal((2, 150, 8 if block != "mask_generator" else 16)).astype(np.float32)
    if block == "dsconv":
        x = x.repeat(2, axis=-1)  # 16 hidden channels

        def make(q):
            return JaxDSConv(16, 8, 3, 2, 2, q=q)

        def port(q):
            return DepthwiseSeparableConv(16, 8, 3, 2, 2, q=q)
        out = ("pointwise", "activation_fake_quantize")
    elif block == "conv_block":

        def make(q):
            return JaxConvBlock(8, 16, 3, 4, 4, q=q)

        def port(q):
            return ConvBlock(8, 16, 3, 4, 4, q=q)
        out = ("add", "activation_fake_quantize")
    else:

        def make(q):
            return JaxMaskGenerator(16, 8, 16, 3, 2, 1, 4, q=q)

        def port(q):
            return MaskGenerator(16, 8, 16, 3, 2, 1, 4, q=q)
        out = ("mask_conv", "activation_fake_quantize")
    obs = make(JaxQuantSpec(observer=True, **BLOCK_SPEC))
    variables = obs.init(jax.random.PRNGKey(0), jnp.asarray(x))
    for _ in range(2):
        _, upd = obs.apply(variables, jnp.asarray(x), mutable=["qparams", "qstats"])
        variables = {**variables, **upd}
    variables = jax.device_get(variables)
    with jax.disable_jit():
        want = np.asarray(make(JaxQuantSpec(observer=False, **BLOCK_SPEC)).apply(variables, jnp.asarray(x)))
    module = port(QuantSpec(observer=False, **BLOCK_SPEC))
    module.load_state_dict(convtasnet_music_from_jax(variables), strict=True)
    with torch.no_grad():
        got = module.eval()(torch.from_numpy(np.ascontiguousarray(np.swapaxes(x, 1, 2)))).numpy()
    if block == "mask_generator":  # port [B, C, N, K], JAX [B, C, K, N]
        got = np.swapaxes(got, -1, -2)
    else:
        got = np.swapaxes(got, 1, 2)
    qp = variables["qparams"]
    _assert_within_one_lsb(got, want, qp[out[0]][out[1]])


def test_channel_layer_norm_matches_flax():
    from fqss_tpu.nn import QLayerNorm as JaxQLayerNorm
    from fqss_tpu_torch.nn.layers import QLayerNorm

    x = (np.random.default_rng(2).standard_normal((2, 40, 16)) * 3 + 1).astype(np.float32)
    variables = JaxQLayerNorm(epsilon=1e-8).init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(lambda a: a + np.random.default_rng(3).normal(size=a.shape).astype(np.float32),
                                    jax.device_get(variables))
    with jax.disable_jit():
        want = np.asarray(JaxQLayerNorm(epsilon=1e-8).apply(params, jnp.asarray(x)))
    ln = QLayerNorm(16, epsilon=1e-8, dim=1)
    ln.load_state_dict(convtasnet_music_from_jax(params), strict=True)
    with torch.no_grad():
        got = ln(torch.from_numpy(np.ascontiguousarray(np.swapaxes(x, 1, 2)))).numpy()
    np.testing.assert_allclose(np.swapaxes(got, 1, 2), want, rtol=1e-5, atol=1e-5)


def test_model_matches_jitted_jax(calibrated):
    jax_eval, variables, port, mix = calibrated
    want = np.asarray(_noalg(jax_eval.apply)(variables, jnp.asarray(mix)))
    got = _forward(port, mix)
    assert got.shape == want.shape == (2, 4, 2, T)
    snr = _snr_db(want, got)
    assert (snr >= 20).all(), f"port vs jitted JAX SNR {snr} dB < 20 dB"


def test_quantizer_sites_equal_jax_scopes(calibrated):
    _, variables, port, _ = calibrated
    leaves = jax.tree_util.tree_flatten_with_path(variables["qparams"])[0]
    scopes = {tuple(k.key for k in path[:-1]) for path, _ in leaves}
    jax_weight = sum(s[-1] == "weight_fake_quantize" for s in scopes)
    # encoder, bottleneck, 3 a block (conv1x1, depthwise, pointwise), mask conv, decoder and its residual encoder
    assert sum(isinstance(m, WeightQuantizer) for m in port.modules()) == jax_weight == 5 + 3 * 2
    # encoder, layer norm, bottleneck, 6 a block, mask conv, mul, decoder, residual latent and plane
    assert sum(isinstance(m, ActQuantizer) for m in port.modules()) == len(scopes) - jax_weight == 8 + 6 * 2


@pytest.mark.parametrize("batch", [1, 2])
def test_every_quantizer_input_is_contiguous(calibrated, batch):
    """The CUDA kernels take contiguous tensors only: hold every call site to that on the CPU."""
    *_, port, mix = calibrated
    model = ConvTasNetMusic(q=QuantSpec(observer=True, **SPEC), **ARCH)
    model.load_state_dict(port.state_dict())
    seen = []
    for m in model.modules():
        if isinstance(m, (ActQuantizer, WeightQuantizer)):
            m.register_forward_pre_hook(lambda mod, args: seen.append(args[0].is_contiguous()))
    x = torch.from_numpy(mix[:batch])
    with torch.no_grad():
        model.train()(x)
        model.eval()(x)
        fold_quantized_weights(model)(x)
    assert len(seen) > 40 and all(seen)


def test_k3_takes_the_bias_free_1x1_convs_without_a_gradient(calibrated, monkeypatch):
    from fqss_tpu_torch.nn import layers

    *_, port, mix = calibrated
    calls = []
    real = layers.qmatmul
    monkeypatch.setattr(layers, "qmatmul", lambda x, w, **kw: calls.append(tuple(x.shape)) or real(x, w, **kw))
    _forward(port, mix)
    assert calls == [(2, 16, 199)] + [(2, 16, 199)] * 2  # bottleneck, then each block's pointwise
    port.train()
    try:
        port(torch.from_numpy(mix)).sum().backward()  # with a gradient: F.conv1d and the quantizer kernels
    finally:
        port.eval()
        port.zero_grad(set_to_none=True)
    assert len(calls) == 3


def test_folded_engine_bitwise_equals_fake_quant(calibrated):
    *_, port, mix = calibrated
    folded = fold_quantized_weights(port)
    assert not any(isinstance(m, WeightQuantizer) for m in folded.modules())
    np.testing.assert_array_equal(_forward(folded, mix), _forward(port, mix))


def test_factory_builds_the_music_model_and_its_float_teacher(calibrated, tmp_path):
    from fqss_tpu_torch.models.factory import (MODEL_NAMES, create_model, create_model_and_teacher,
                                               create_pretrained_model)

    *_, port, mix = calibrated
    cfg = {"name": "ConvTasNetMusic", "sources": list(SOURCES), "audio_channels": 2, "kernel_size": 20, "stride": 10,
           "conv_kernel": 3, "mask_act": "relu", **ARCH, "quantization": {**SPEC, "observer": True}}
    assert "ConvTasNetMusic" in MODEL_NAMES
    student, teacher = create_model_and_teacher(cfg, generator=torch.Generator().manual_seed(0))
    assert isinstance(student, ConvTasNetMusic) and student.q.n_splitter == 2 and student.q.observer
    assert isinstance(teacher, ConvTasNetMusic) and not teacher.q.qat and not teacher.training
    assert student.encoder.conv.weight.shape == (16, 4, 20) and teacher.encoder.conv.weight.shape == (16, 2, 20)
    assert not any(isinstance(m, (ActQuantizer, WeightQuantizer)) for m in teacher.modules())
    ckpt = tmp_path / "music.pt"
    torch.save(port.state_dict(), ckpt)
    loaded = create_pretrained_model({**cfg, "model_path": str(ckpt)}, observer=False)
    np.testing.assert_array_equal(_forward(loaded, mix), _forward(port, mix))
    small = create_model({**cfg, "n_blocks": 1, "quantization": {"qat": False}})
    assert len(small.separator.blocks) == 1 and not small.q.qat


# ---------------------------------------------------------------------------
# The int8 engine
# ---------------------------------------------------------------------------

# tests/test_torch_int8.py:JAX_BOUND: (minimum SNR in dB per output, largest share of samples more than half an output
# step apart, largest mean |difference| in output steps).
JAX_BOUND = {"float32": (100.0, 1e-3, 1e-3), "bfloat16": (40.0, 1e-2, 2e-2)}


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_int8_engine_matches_the_jax_engine(calibrated, compute_dtype):
    from fqss_tpu.serve.convtasnet_music_int8 import ConvTasNetMusicInt8Engine as JaxEngine

    jax_eval, variables, port, mix = calibrated
    with jax.disable_jit():
        want = np.asarray(JaxEngine(jax_eval, variables, compute_dtype=compute_dtype)._forward(jnp.asarray(mix)))
    im.reset_launches()
    engine = make_int8_engine(port, compute_dtype=compute_dtype)
    assert isinstance(engine, ConvTasNetMusicInt8Engine)
    got = engine(torch.from_numpy(mix)).numpy()
    assert im.LAUNCHES == {"int8_mm": 0}  # CPU tensors: the plain version
    assert got.shape == want.shape == (2, 4, 2, T)
    aq = port.decoder.activation_fake_quantize
    lsb = float(aq.max_range.detach() - aq.min_range.detach()) / 255
    snr_min, share_max, mean_max = JAX_BOUND[compute_dtype]
    diff = np.abs(got - want) / lsb
    assert (_snr_db(want, got) >= snr_min).all(), _snr_db(want, got)
    assert (diff > 0.5).mean() <= share_max and diff.mean() <= mean_max, ((diff > 0.5).mean(), diff.mean())


def test_int8_engine_runs_83_site_products_at_full_depth_and_agrees_with_the_fake_quant_forward(calibrated):
    from fqss_tpu_torch.serve import common

    *_, port, mix = calibrated
    x = torch.from_numpy(mix)
    with torch.no_grad():
        ref = port(x).numpy()
    aq = port.decoder.activation_fake_quantize
    lsb = float(aq.max_range.detach() - aq.min_range.detach()) / 255
    diff = np.abs(ConvTasNetMusicInt8Engine(port, compute_dtype="float32")(x).numpy() - ref)
    assert diff.max() <= 10 * lsb and diff.mean() <= 1.5 * lsb, (diff.max() / lsb, diff.mean() / lsb)
    sites = []
    real = common.Int8Site.__call__
    common.Int8Site.__call__ = lambda self, qa: sites.append(tuple(self.w.shape)) or real(self, qa)
    try:
        full = ConvTasNetMusic(q=QuantSpec(observer=False, **SPEC), n_filters=16, bn_chan=8, hid_chan=16)
        ConvTasNetMusicInt8Engine(full.eval(), compute_dtype="float32")(x[:1, :, :400])
    finally:
        common.Int8Site.__call__ = real
    # bottleneck, conv1x1 and pointwise of 4 x 10 blocks, the mask conv, the decoder: K4's launches on the card
    assert len(sites) == 83
    assert sites[0] == (8, 16) and sites[-2] == (64, 8) and sites[-1] == (40, 16)


def test_auto_serves_the_music_model_on_its_int8_engine_with_float32_products(calibrated):
    from fqss_tpu_torch.serve import auto_serving_model, best_path

    *_, port, mix = calibrated
    assert best_path(port) == "int8"
    engine = auto_serving_model(port)
    assert isinstance(engine, ConvTasNetMusicInt8Engine) and not engine.bf16
    want = ConvTasNetMusicInt8Engine(port, compute_dtype="float32")(torch.from_numpy(mix))
    assert torch.equal(engine(torch.from_numpy(mix)), want)


@pytest.mark.parametrize("spec,kw,error", [
    (dict(SPEC, n_combiner=3), {}, NotImplementedError),
    (dict(SPEC, weight_n_bits=4), {}, NotImplementedError),
    (dict(qat=False), {}, ValueError),
    (SPEC, dict(mask_act="prelu"), NotImplementedError),
])
def test_int8_engine_refuses_what_it_cannot_serve(spec, kw, error):
    with pytest.raises(error):
        ConvTasNetMusicInt8Engine(ConvTasNetMusic(q=QuantSpec(**spec), **ARCH, **kw))
