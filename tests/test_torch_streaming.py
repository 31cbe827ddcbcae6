"""Streaming serving and ``--engine auto`` of the port, on the CPU.

* The port's ``StreamingSeparator`` against JAX's on the same deterministic
  numpy ``apply_fn``: bit-identical outputs over JAX's push schedules
  (``tests/test_streaming.py``), in stereo, with ``align_sources`` and
  across ``reset``; the latency bound; a push after ``flush`` raises.
* A drained stream of a tiny port ConvTasNet equals the port's own offline
  ``ola_infer(chunk_batch=1)`` within 1e-5, through the fake_quant, folded
  and int8 engines (JAX's test's bound: the same forward on the same
  windows, the OLA sums in another order), and through the tiny DPTNet and
  Sepformer, whose bias-free 1x1 convs take K3's plain version.
* ``python -m fqss_tpu_torch.infer --stream`` on the CPU with every engine.
* ``serve/autopath.py``: the table, unknown families, ``auto`` bitwise equal
  to the folded model, and the ``infer``/``val`` CLIs with ``--engine auto``.
"""

import numpy as np
import pytest
import torch

from fqss_tpu.serve.streaming import StreamingSeparator as JaxStreamingSeparator
from fqss_tpu_torch import infer
from fqss_tpu_torch.data.synthetic import synth_batch
from fqss_tpu_torch.models.convtasnet import ConvTasNet
from fqss_tpu_torch.models.dptnet import DPTNet
from fqss_tpu_torch.models.sepformer import Sepformer
from fqss_tpu_torch.quant.spec import QuantSpec
from fqss_tpu_torch.separation.ola import ola_infer
from fqss_tpu_torch.serve import (BEST_PATHS, StreamingSeparator, auto_serving_model, best_path,
                                  fold_quantized_weights, make_int8_engine)
from fqss_tpu_torch.utils.audio import read_audio, save_audio

torch.set_num_threads(1)

SEG, OVERLAP = 512, 0.25


def _numpy_model(x):
    """A deterministic separator of numpy windows [1, T] -> [1, 2, T]: two nonlinear functions of the input."""
    x = np.asarray(x, np.float32)
    return np.stack([np.tanh(3 * x) * 0.5, x * x - 0.25 * x], axis=1)


def _drain(stream, mix, push_sizes):
    outs, off = [], 0
    for n in push_sizes:
        outs.append(stream.push(mix[..., off: off + n]))
        off += n
    outs.append(stream.flush())
    return np.concatenate(outs, axis=-1)


@pytest.mark.parametrize("push_sizes", [[5000], [700, 1300, 3000], [64] * 78 + [8]])
def test_stream_is_bit_identical_to_the_jax_separator(push_sizes):
    mix = np.random.default_rng(0).uniform(-1, 1, sum(push_sizes)).astype(np.float32)
    want = _drain(JaxStreamingSeparator(_numpy_model, n_srcs=2, segment=SEG, overlap=OVERLAP), mix, push_sizes)
    got = _drain(StreamingSeparator(_numpy_model, n_srcs=2, segment=SEG, overlap=OVERLAP, device=None), mix,
                 push_sizes)
    assert got.shape == want.shape == (2, mix.shape[-1]) and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_stereo_stream_is_bit_identical_to_the_jax_separator():
    def stereo(x):  # [1, 2, T] -> [1, S, 2, T]
        x = np.asarray(x)
        return np.stack([_numpy_model(x[:, 0]), _numpy_model(x[:, 1])], axis=2)

    mix = np.random.default_rng(2).uniform(-1, 1, (2, 3000)).astype(np.float32)
    kw = dict(n_srcs=2, segment=SEG, overlap=OVERLAP, channels=2)
    want = _drain(JaxStreamingSeparator(stereo, **kw), mix, [1700, 1300])
    got = _drain(StreamingSeparator(stereo, device=None, **kw), mix, [1700, 1300])
    assert got.shape == (2, 2, 3000)
    np.testing.assert_array_equal(got, want)


def test_align_sources_is_bit_identical_to_the_jax_separator_and_undoes_the_flips():
    """A separator that swaps its sources on every call (JAX's test): with alignment both separators emit the
    same streams, source 0 tracking f1; without it they interleave."""
    f1 = lambda p: np.sin(2 * np.pi * 0.01 * p)  # noqa: E731
    f2 = lambda p: np.cos(2 * np.pi * 0.003 * p)  # noqa: E731

    def flipper():
        calls = {"n": 0}

        def fn(x):
            p = np.asarray(x)[0]
            calls["n"] += 1
            return np.stack((f1(p), f2(p)) if calls["n"] % 2 else (f2(p), f1(p)))[None]
        return fn

    mix = np.arange(SEG * 4, dtype=np.float32)
    for align in (True, False):
        kw = dict(n_srcs=2, segment=SEG, overlap=0.5, align_sources=align)
        want = _drain(JaxStreamingSeparator(flipper(), **kw), mix, [mix.size])
        got = _drain(StreamingSeparator(flipper(), device=None, **kw), mix, [mix.size])
        np.testing.assert_array_equal(got, want)
        err = float(np.mean((got[0] - f1(mix)) ** 2))
        assert (err < 1e-6) if align else (err > 1e-3), (align, err)


def test_reset_starts_a_new_stream_as_the_jax_separator_does():
    calls = []

    def fwd(x):
        calls.append(np.shape(x))
        return _numpy_model(x)

    mix = np.random.default_rng(7).uniform(-1, 1, 1500).astype(np.float32)
    stream = StreamingSeparator(fwd, n_srcs=2, segment=SEG, overlap=OVERLAP, device=None)
    first = _drain(stream, mix, [1500])
    stream.reset()
    second = _drain(stream, mix, [400, 1100])
    jax_stream = JaxStreamingSeparator(fwd, n_srcs=2, segment=SEG, overlap=OVERLAP)
    _drain(jax_stream, mix, [700])  # state that reset must clear
    jax_stream.reset()
    np.testing.assert_array_equal(first, second)
    np.testing.assert_array_equal(second, _drain(jax_stream, mix, [400, 1100]))
    assert all(s == (1, SEG) for s in calls)  # one fixed window shape


def test_latency_is_bounded_and_memory_is_a_window():
    rng = np.random.default_rng(1)
    stream = StreamingSeparator(_numpy_model, n_srcs=2, segment=SEG, overlap=OVERLAP, device=None)
    fed = emitted = 0
    for _ in range(12):
        n = int(rng.integers(100, 500))
        emitted += stream.push(rng.uniform(-1, 1, n).astype(np.float32)).shape[-1]
        fed += n
        assert fed - emitted <= stream.latency_samples == SEG
    assert stream._mix.shape[-1] <= SEG + 500


def test_flush_then_push_raises():
    stream = StreamingSeparator(_numpy_model, n_srcs=2, segment=SEG, device=None)
    stream.push(np.zeros(100, np.float32))
    stream.flush()
    with pytest.raises(RuntimeError):
        stream.push(np.zeros(10, np.float32))
    with pytest.raises(RuntimeError):
        stream.flush()
    with pytest.raises(ValueError, match="channels"):
        StreamingSeparator(_numpy_model, n_srcs=2, segment=SEG, device=None).push(np.zeros((2, 10), np.float32))


# ---------------------------------------------------------------------------
# Port models: a drained stream equals offline OLA
# ---------------------------------------------------------------------------

FQSS = dict(qat=True, n_splitter=2, n_combiner=2, out_quant=True)
CONVTASNET = dict(n_srcs=2, kernel_size=16, stride=8, n_filters=32, bn_chan=16, hid_chan=32, n_blocks=2,
                  n_repeats=1)


def _calibrated(cls, arch, seed=0):
    """A tiny port model whose ranges come from a 3-step observer window, then in eval mode without observer."""
    obs = cls(q=QuantSpec(observer=True, max_observations=3, **FQSS), generator=torch.Generator().manual_seed(seed),
              **arch)
    mix, _ = synth_batch(np.random.default_rng(seed), 2, 2, SEG)
    obs.train()
    with torch.no_grad():
        for _ in range(3):
            obs(torch.from_numpy(mix))
    model = cls(q=QuantSpec(observer=False, **FQSS), **arch)
    model.load_state_dict(obs.state_dict())
    return model.eval()


@pytest.fixture(scope="module")
def convtasnet():
    return _calibrated(ConvTasNet, CONVTASNET)


SERVING_ENGINES = {"fake_quant": lambda m: m, "folded": fold_quantized_weights,
                   "int8": lambda m: make_int8_engine(m, compute_dtype="float32")}


def _stream_vs_ola(apply_fn, mix, pushes):
    ref = ola_infer(apply_fn, mix, n_srcs=2, segment=SEG, overlap=OVERLAP, chunk_batch=1, device="cpu")
    got = _drain(StreamingSeparator(apply_fn, n_srcs=2, segment=SEG, overlap=OVERLAP, device="cpu"), mix[0], pushes)
    assert got.shape == ref.shape == (2, mix.shape[-1])
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("engine", list(SERVING_ENGINES))
def test_a_drained_stream_equals_offline_ola(convtasnet, engine):
    mix, _ = synth_batch(np.random.default_rng(3), 1, 2, 1800)
    _stream_vs_ola(SERVING_ENGINES[engine](convtasnet), mix, [900, 900])


@pytest.mark.parametrize("cls,arch", [
    (DPTNet, dict(n_srcs=2, kernel_size=2, enc_dim=16, feature_dim=8, hidden_dim=16, layer=1, segment_size=20)),
    (Sepformer, dict(n_srcs=2, kernel_size=8, stride=4, n_filters=32, n_repeats=1, n_heads=4, chunk_size=20,
                     n_ffn=48, n_layers=1)),
])
def test_a_drained_stream_of_a_k3_model_equals_offline_ola(cls, arch):
    mix, _ = synth_batch(np.random.default_rng(4), 1, 2, 1300)
    _stream_vs_ola(fold_quantized_weights(_calibrated(cls, arch)), mix, [300, 1000])


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

TINY_CFG = """
model_cfg:
  name: ConvTasNet
  model_path: {ckpt}
  n_src: 2
  kernel_size: 16
  stride: 8
  n_filters: 32
  bn_chan: 16
  hid_chan: 32
  n_blocks: 2
  n_repeats: 1
  quantization: {{qat: True, out_quant: True, n_splitter: 2, n_combiner: 2, observer: True}}
testing_cfg: {{segment_samples: {segment}, overlap: 0.25}}
"""


@pytest.fixture(scope="module")
def request_files(tmp_path_factory, convtasnet):
    root = tmp_path_factory.mktemp("stream")
    ckpt = root / "model.pt"
    torch.save(convtasnet.state_dict(), ckpt)
    cfg = root / "tiny.yaml"
    cfg.write_text(TINY_CFG.format(ckpt=ckpt, segment=SEG))
    mix, _ = synth_batch(np.random.default_rng(5), 1, 2, 1700)
    wav = root / "mixture.wav"
    save_audio(str(wav), mix[0], 8000)
    return root, cfg, wav


@pytest.mark.parametrize("engine", infer.ENGINES)
def test_stream_cli_on_cpu(request_files, tmp_path, engine):
    root, cfg, wav = request_files
    infer.main(["-y", str(cfg), "-a", str(wav), "-o", str(tmp_path), "--engine", engine, "--stream", "300",
                "--device", "cpu"])
    conf = infer.load_config(str(cfg))
    apply_fn = infer.load_engine(conf["model_cfg"], engine, "cpu")
    mix, _ = read_audio(str(wav))
    ref = ola_infer(apply_fn, mix, n_srcs=2, segment=SEG, overlap=OVERLAP, chunk_batch=1, device="cpu")
    _, lib = infer.stream_file(apply_fn, conf, str(wav), 300, str(tmp_path / "lib"), device="cpu")
    np.testing.assert_allclose(lib, ref, atol=1e-5)
    for s in (1, 2):
        audio, fs = read_audio(str(tmp_path / f"source_{s}.wav"))
        want, _ = read_audio(str(tmp_path / "lib" / f"source_{s}.wav"))
        assert fs == 8000 and audio.shape == (1, 1700) and np.isfinite(audio).all()
        np.testing.assert_array_equal(audio, want)


def test_stream_cli_needs_a_segment_length(request_files, tmp_path):
    root, cfg, wav = request_files
    no_segment = tmp_path / "no_segment.yaml"
    no_segment.write_text(cfg.read_text().replace(f"segment_samples: {SEG}", "segment_samples: null"))
    with pytest.raises(SystemExit, match="segment_samples"):
        infer.main(["-y", str(no_segment), "-a", str(wav), "--stream", "300", "--device", "cpu"])


# ---------------------------------------------------------------------------
# --engine auto
# ---------------------------------------------------------------------------


def test_the_table_holds_the_fastest_engine_measured_per_family():
    assert BEST_PATHS == {"ConvTasNet": "folded", "DPTNet": "fake_quant", "Sepformer": "folded",
                          "ConvTasNetMusic": "int8", "HTDemucs": "folded"}
    for cls, arch in ((ConvTasNet, CONVTASNET), (DPTNet, dict(enc_dim=16, feature_dim=8, hidden_dim=16, layer=1)),
                      (Sepformer, dict(n_filters=32, n_heads=4, n_repeats=1, n_layers=1, n_ffn=48))):
        assert best_path(cls(q=QuantSpec(**FQSS), **arch)) == BEST_PATHS[cls.__name__]


def test_an_unknown_family_gets_the_folded_path():
    class Sub(ConvTasNet):  # a subclass keeps its base's entry
        pass

    class Other(torch.nn.Module):
        q = QuantSpec(**FQSS)

    assert best_path(Sub(q=QuantSpec(**FQSS), **CONVTASNET)) == "folded"
    assert best_path(Other()) == "folded"


def test_auto_is_bitwise_the_folded_model(convtasnet):
    x = torch.from_numpy(synth_batch(np.random.default_rng(6), 2, 2, 1000)[0])
    served = auto_serving_model(convtasnet)
    assert served is not convtasnet and served.q.weight_quant is False
    with torch.inference_mode():
        assert torch.equal(served(x), fold_quantized_weights(convtasnet)(x))
        assert torch.equal(served(x), convtasnet(x))
    dpt = _calibrated(DPTNet, dict(n_srcs=2, kernel_size=2, enc_dim=16, feature_dim=8, hidden_dim=16, layer=1,
                                   segment_size=20))
    assert auto_serving_model(dpt) is dpt  # the table's fake_quant: the model itself, bitwise the folded one
    with torch.inference_mode():
        assert torch.equal(dpt(x), fold_quantized_weights(dpt)(x))


def test_infer_and_val_clis_serve_auto_on_cpu(request_files, tmp_path, capsys):
    from fqss_tpu_torch import val
    from fqss_tpu_torch.data.librimix import make_mini_librimix

    root, cfg, wav = request_files
    infer.main(["-y", str(cfg), "-a", str(wav), "-o", str(tmp_path / "out"), "--engine", "auto", "--device", "cpu"])
    for s in (1, 2):
        audio, fs = read_audio(str(tmp_path / "out" / f"source_{s}.wav"))
        assert fs == 8000 and audio.shape == (1, 1700) and np.isfinite(audio).all()
    make_mini_librimix(str(tmp_path / "mini"), n_train=1, n_val=1, seconds=0.5, seed=8)
    val_cfg = tmp_path / "val.yaml"
    test_dir = tmp_path / "mini" / "test"
    val_cfg.write_text(cfg.read_text().replace("testing_cfg: {", f"testing_cfg: {{test_dir: {test_dir}, ")
                       + "dataset_cfg: {name: librimix, resample: 1}\n")
    val.main(["-y", str(val_cfg), "--device", "cpu", "--engine", "auto", "--limit", "1", "--no-stoi"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    values = dict(item.split("=") for item in line.split(","))
    assert list(values) == ["SI-SDR", "SI-SDR-imp", "SDR", "STOI"]
    assert all(np.isfinite(float(values[k])) for k in ("SI-SDR", "SI-SDR-imp", "SDR")), line
