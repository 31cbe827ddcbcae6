"""The port's evaluation path and host-side copies against the JAX package.

Metrics on seeded arrays to rtol 1e-4 (float32 sums in other orders; the
SDR's 512-tap solve in another LAPACK), STOI and the OLA re-alignment
exactly, ``val_librimix`` to 1e-3 dB given the same numpy forward, the
config loader, and the LibriMix loader on a mini set.
"""

import glob
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fqss_tpu.separation import metrics as jax_metrics
from fqss_tpu.separation.stoi import stoi as jax_stoi
from fqss_tpu_torch.data import synth_batch
from fqss_tpu_torch.separation import metrics
from fqss_tpu_torch.separation.ola import ola_infer
from fqss_tpu_torch.separation.stoi import stoi
from fqss_tpu_torch.train.validate import read_librimix_files, val_librimix

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(seed, shape=(2, 3, 2000), noise=0.3):
    rng = np.random.default_rng(seed)
    target = rng.normal(size=shape).astype(np.float32)
    est = (0.8 * target + noise * rng.normal(size=shape)).astype(np.float32)
    return est, target


@pytest.mark.parametrize("name", ["si_snr_db", "snr_db", "nsisdr_db", "sdr_db"])
def test_metrics_equal_the_jax_packages(name):
    est, target = _pair(0)
    got = getattr(metrics, name)(torch.from_numpy(est), torch.from_numpy(target)).numpy()
    want = np.asarray(getattr(jax_metrics, name)(jnp.asarray(est), jnp.asarray(target)))
    assert got.shape == want.shape == (2, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_swap_channel_order_stoi_and_metric_evaluation_equal_the_jax_packages():
    _, src = synth_batch(np.random.default_rng(1), 1, 2, 16000)
    clean = src[0]
    rng = np.random.default_rng(2)
    sep = (clean[::-1] + 0.05 * rng.normal(size=clean.shape)).astype(np.float32)  # swapped outputs
    np.testing.assert_array_equal(metrics.swap_channel_order(sep, clean),
                                  jax_metrics.swap_channel_order(sep, clean))
    value = stoi(sep[0], clean[1], 8000)
    assert np.isfinite(value) and value == jax_stoi(sep[0], clean[1], 8000)
    got = metrics.metric_evaluation(sep, clean, sample_rate=8000)
    want = jax_metrics.metric_evaluation(sep, clean, sample_rate=8000)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def _chunk_fn(seed):
    """A deterministic numpy 'model' whose source order flips from chunk to chunk."""
    def fn(x: np.ndarray) -> np.ndarray:
        out = np.stack([0.7 * x, 0.3 * x + 0.01], axis=1)  # [K, 2, T]
        flip = np.random.default_rng(seed + int(abs(x).sum() * 1e3) % 7).random(x.shape[0]) < 0.5
        out[flip] = out[flip][:, ::-1]
        return out.astype(np.float32)
    return fn


def test_ola_infer_with_a_target_equals_the_jax_packages():
    from fqss_tpu.separation.ola import ola_infer as jax_ola_infer

    mix, src = synth_batch(np.random.default_rng(3), 1, 2, 2500)
    fn = _chunk_fn(0)
    want = jax_ola_infer(lambda x: fn(np.asarray(x)), mix, n_srcs=2, segment=800, target=src[0], chunk_batch=2)
    got = ola_infer(lambda x: torch.from_numpy(fn(x.numpy())), mix, n_srcs=2, segment=800, target=src[0],
                    chunk_batch=2)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def mini_set(tmp_path_factory):
    from fqss_tpu_torch.data.librimix import make_mini_librimix

    root = tmp_path_factory.mktemp("mini")
    make_mini_librimix(str(root), n_train=4, n_val=3, seconds=0.5, seed=4)
    return root


def test_val_librimix_equals_the_jax_packages(mini_set):
    from fqss_tpu.train.validate import val_librimix as jax_val_librimix

    cfg = ({"n_src": 2}, {}, {"test_dir": str(mini_set / "test"), "segment_samples": 1600, "overlap": 0.25})
    fn = _chunk_fn(1)
    want = jax_val_librimix(None, {}, *cfg, apply_fn=lambda x: fn(np.asarray(x)))
    got = val_librimix(lambda x: torch.from_numpy(fn(x.numpy())), *cfg)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert [len(f) for f in read_librimix_files(str(mini_set / "test"), 2)[1]] == [3, 3]
    with pytest.raises(FileNotFoundError):
        read_librimix_files(str(mini_set / "train"), 2)


def test_librimix_loader_gives_the_jax_packages_arrays(tmp_path):
    from fqss_tpu.data import librimix as jax_librimix
    from fqss_tpu_torch.data import librimix

    librimix.make_mini_librimix(str(tmp_path / "port"), n_train=5, n_val=2, seconds=0.5, seed=6)
    jax_librimix.make_mini_librimix(str(tmp_path / "jax"), n_train=5, n_val=2, seconds=0.5, seed=6)
    for split in ("train", "val"):
        names = sorted(os.listdir(tmp_path / "port" / split / "wav"))
        assert names == sorted(os.listdir(tmp_path / "jax" / split / "wav"))
        for name in names:
            assert (tmp_path / "port" / split / "wav" / name).read_bytes() == \
                (tmp_path / "jax" / split / "wav" / name).read_bytes()
    kwargs = dict(task="sep_clean", sample_rate=8000, resample=0.5, n_src=2, segment=0.25, seed=2)
    port = librimix.LibriMix(str(tmp_path / "port" / "train"), **kwargs)
    ref = jax_librimix.LibriMix(str(tmp_path / "jax" / "train"), **kwargs)
    assert len(port) == len(ref) == 5
    got = list(librimix.batch_iterator(port, 2, seed=3))
    want = list(jax_librimix.batch_iterator(ref, 2, seed=3))
    assert len(got) == len(want) == 2
    for (gm, gs), (wm, ws) in zip(got, want):
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_array_equal(gs, ws)


def test_load_config_equals_the_jax_packages_on_every_config():
    from fqss_tpu.utils.config import load_config as jax_load_config
    from fqss_tpu_torch.utils.config import load_config, load_config_str

    paths = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))
    assert len(paths) >= 5
    for path in paths:
        assert load_config(path) == jax_load_config(path), path
    text = "a: 2\nwork: !ref <a>/x\nm: !new:pkg.Cls {k: !ref <a>}\n"
    assert load_config_str(text) == {"a": 2, "work": "2/x", "m": {"k": 2, "_target_": "pkg.Cls"}}


def test_val_cli_int8_engine_on_cpu(mini_set, tmp_path, capsys):
    from fqss_tpu_torch import val

    cfg = tmp_path / "val.yaml"
    cfg.write_text(f"""
model_cfg:
  name: ConvTasNet
  model_path: null
  n_src: 2
  kernel_size: 16
  stride: 8
  n_filters: 32
  bn_chan: 8
  hid_chan: 16
  n_blocks: 2
  n_repeats: 1
  quantization: {{qat: True, out_quant: True, n_splitter: 2, n_combiner: 2, observer: True}}
dataset_cfg: {{name: librimix, resample: 1}}
testing_cfg: {{test_dir: {mini_set / "test"}, segment_samples: 2000, overlap: 0.25}}
""")
    val.main(["-y", str(cfg), "--device", "cpu", "--engine", "int8", "--limit", "2"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    values = dict(item.split("=") for item in line.split(","))
    assert list(values) == ["SI-SDR", "SI-SDR-imp", "SDR", "STOI"]
    assert all(np.isfinite(float(v)) for v in values.values()), line


def test_bss_eval_equals_the_jax_packages():
    from fqss_tpu.separation.bss_eval import bss_eval_images_framewise as jax_bss_eval
    from fqss_tpu_torch.separation.bss_eval import bss_eval_images_framewise

    est, ref = _pair(5, shape=(2, 1, 1500), noise=0.5)
    est[1, :, :700] = 0.0
    ref[1, :, :700] = 0.0  # a silent first frame of source 1: NaN, as museval skips it
    got = bss_eval_images_framewise(ref, est, window=700, filter_length=64)
    want = jax_bss_eval(ref, est, window=700, filter_length=64)
    for k in ("SDR", "ISR", "SIR", "SAR"):
        assert got[k].shape == want[k].shape == (2, 2)
        # Above 100 dB an error energy is float32 round-off (source 0's interference in frame 0, where
        # source 1 is silent): both sides must sit there, at whatever value the round-off gives.
        floor = want[k] > 100
        assert (got[k][floor] > 100).all(), k
        np.testing.assert_allclose(got[k][~floor], want[k][~floor], rtol=1e-3, atol=1e-3, equal_nan=True)
    assert np.isnan(got["SDR"][1, 0]) and got["SIR"][0, 0] > 100


def test_save_results_equals_the_jax_packages(mini_set, tmp_path):
    import csv

    from fqss_tpu.train.validate import save_results as jax_save_results
    from fqss_tpu_torch.train.validate import save_results

    cfg = ({"n_src": 2}, {}, {"test_dir": str(mini_set / "test"), "segment_samples": 1600, "overlap": 0.25})
    (tmp_path / "port").mkdir()
    got = save_results(lambda x: torch.stack([0.7 * x, 0.3 * x + 0.01], dim=1), *cfg, str(tmp_path / "port"))
    with open(tmp_path / "port" / "test_results.csv") as fh:
        rows = list(csv.DictReader(fh))
    assert [r["snt_id"] for r in rows] == ["test_0.wav", "test_1.wav", "test_2.wav", "avg"]
    assert set(got) == {"sdr", "sdr_i", "si-snr", "si-snr_i"}

    class Apply:  # the JAX report jits ``model.apply(variables, x)``: the same forward as a stand-in module
        def apply(self, variables, x):
            return jnp.stack([0.7 * x, 0.3 * x + 0.01], axis=1)

    want = jax_save_results(Apply(), {}, *cfg, str(tmp_path))
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3, err_msg=k)
