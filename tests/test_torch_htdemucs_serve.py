"""The port's HTDemucs serving pieces: centre-padded OLA, the MUSDB evaluation CLI, and K4's and K5's GELU routes.

* ``ola_infer(center_pad_to=...)`` (demucs's TensorChunk) equal to JAX's
  bit for bit with a numpy forward on both sides;
* ``python -m fqss_tpu_torch.val`` on a mini MUSDB with a tiny HTDemucs on
  the CPU, fake_quant and int8 (NSDR, and BSS Eval v4's table), int8
  within 0.5 dB of fake_quant;
* K4's plain GELU route against the JAX engine's composition
  ``requant(gelu(int8_matmul(...)))`` on the same float32 values: within one
  output step (XLA's ``erfc`` and PyTorch's an ulp apart can move a value
  across a rounding tie), at most 1% a step apart;
* the refusals that stay: a GELU ``QDense`` or K5 call that needs a
  gradient, a ``QDense`` nonlinearity other than the GELU, an HTDemucs file
  separation through ``infer``.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fqss_tpu_torch.data.musdb import make_mini_musdb
from fqss_tpu_torch.models.htdemucs import HTDemucs
from fqss_tpu_torch.nn.layers import QDense
from fqss_tpu_torch.ops import int8_matmul as im
from fqss_tpu_torch.ops import qat_dense as qd
from fqss_tpu_torch.quant.spec import QuantSpec
from fqss_tpu_torch.separation.ola import ola_infer

torch.set_num_threads(1)

SR = 8000
TINY = dict(channels=8, nfft=512, t_layers=3, t_heads=4, segment=0.5, samplerate=SR)
SPEC = dict(qat=True, n_splitter=2, n_combiner=2, out_quant=True)


def _numpy_forward(x: np.ndarray) -> np.ndarray:
    """A deterministic [K, C, T] -> [K, 4, C, T] forward whose output at a sample depends on its chunk and position."""
    ramp = np.linspace(-1.0, 1.0, x.shape[-1], dtype=np.float32)
    return np.stack([x * (i + 1) + np.float32(0.1 * i) * ramp + x.sum(-1, keepdims=True) * np.float32(1e-3)
                     for i in range(4)], axis=1).astype(np.float32)


@pytest.mark.parametrize("length,segment,pad_to,chunk_batch", [(10000, 3000, 4000, 2), (10000, 3000, 3000, 3),
                                                              (2500, 3000, 4000, 2), (7001, 2000, 2600, 8)])
def test_center_padded_ola_equals_jax(length, segment, pad_to, chunk_batch):
    from fqss_tpu.separation.ola import ola_infer as jax_ola_infer

    mix = np.random.default_rng(length).standard_normal((2, length)).astype(np.float32)
    want = jax_ola_infer(lambda x: jnp.asarray(_numpy_forward(np.asarray(x))), mix, n_srcs=4, segment=segment,
                         chunk_batch=chunk_batch, center_pad_to=pad_to)
    got = ola_infer(lambda x: torch.from_numpy(_numpy_forward(x.numpy())), mix, n_srcs=4, segment=segment,
                    chunk_batch=chunk_batch, center_pad_to=pad_to)
    assert got.shape == want.shape == (4, 2, length)
    np.testing.assert_array_equal(got, want)
    from torch_ddp_cases import one_rank_mesh

    with one_rank_mesh() as mesh:  # sharded over a one-rank group: the same blocks, the same separation
        np.testing.assert_array_equal(ola_infer(lambda x: torch.from_numpy(_numpy_forward(x.numpy())), mix, n_srcs=4,
                                                segment=segment, chunk_batch=chunk_batch, center_pad_to=pad_to,
                                                mesh=mesh), got)


def _val_conf(root, model_path, nsdr):
    return {"model_cfg": {"name": "HTDemucs", "model_path": model_path, "sources": ["drums", "bass", "other", "vocals"],
                          "audio_channels": 2, **TINY, "quantization": {**SPEC, "observer": True}},
            "dataset_cfg": {"name": "musdbhq", "musdb_root": root, "sample_rate": SR},
            "testing_cfg": {"test_dir": root, "NSDR": nsdr, "segment_samples": 3000, "overlap": 0.25}}


def test_val_cli_scores_htdemucs_on_musdb_with_fake_quant_and_int8(tmp_path, capsys):
    from fqss_tpu_torch.val import evaluate
    from fqss_tpu_torch.val import main as val_main

    root = make_mini_musdb(str(tmp_path / "musdb"), n_train=1, n_test=1, sample_rate=SR, seconds=1.0)
    model = HTDemucs(q=QuantSpec(observer=True, **SPEC), **TINY, generator=torch.Generator().manual_seed(1))
    mix = torch.from_numpy(np.random.default_rng(2).uniform(-0.5, 0.5, (2, 2, 4000)).astype(np.float32))
    with torch.no_grad():
        for _ in range(3):  # calibrate the act ranges
            model.train()(mix)
    ckpt = str(tmp_path / "htdemucs.pt")
    torch.save(model.state_dict(), ckpt)
    scores = {}
    for nsdr in (True, False):
        cfg = tmp_path / f"cfg_{nsdr}.json"
        cfg.write_text(json.dumps(_val_conf(root, ckpt, nsdr)))
        for engine in ("fake_quant", "int8"):
            val_main(["-y", str(cfg), "--engine", engine, "--device", "cpu"])
            lines = capsys.readouterr().out.strip().splitlines()
            if nsdr:
                assert lines[-1].startswith("NSDR=") and "NSDR_VOCALS=" in lines[-1]
            else:
                assert lines[-4].startswith("SDR=") and [line.split("=")[0] for line in lines[-3:]] == [
                    "ISR", "SIR", "SAR"]
        if nsdr:
            conf = _val_conf(root, ckpt, nsdr)
            scores = {engine: evaluate(conf, engine, "cpu") for engine in ("fake_quant", "folded", "int8", "auto")}
    assert scores["folded"] == scores["fake_quant"]
    assert all(np.isfinite(v) for m in scores.values() for v in m.values())
    assert abs(scores["int8"]["nsdr"] - scores["fake_quant"]["nsdr"]) <= 0.5, scores


def test_k4_gelu_plain_route_matches_the_jax_engine_composition():
    from fqss_tpu.serve import common as jax_common

    rng = np.random.default_rng(9)
    m, k, n = 300, 48, 96
    xs = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (n, k)).astype(np.int8)
    scale = (rng.uniform(0.5, 2.0, n) * 2e-4).astype(np.float32)
    corr = (rng.normal(size=n) * 0.5).astype(np.float32)
    delta, mn = np.float32(3.0 / 255), np.float32(-0.4)
    im.reset_launches()
    got = im.int8_matmul_requant(*(torch.from_numpy(a) for a in (xs, w, scale, corr)), 1.0, delta, mn, nl="gelu")
    assert im.LAUNCHES == {"int8_mm": 0} and im.GELU_LAUNCHES == {"int8_mm": 0}  # CPU tensors: the plain version
    acc = xs.astype(np.int64) @ w.astype(np.int64).T
    v = jnp.asarray(acc.astype(np.float32) * scale + corr)
    want = jax_common.requant(jax.nn.gelu(v, approximate=False), jax_common.Grid(delta=delta, mn=mn))
    steps = np.abs(got.numpy().astype(np.int32) - np.asarray(want.Xs).astype(np.int32))
    assert steps.max() <= 1 and np.mean(steps > 0) <= 0.01, (steps.max(), np.mean(steps > 0))


def test_gelu_routes_refuse_a_gradient_and_other_nonlinearities():
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.standard_normal((5, 8)).astype(np.float32))
    w, b = torch.from_numpy(rng.standard_normal((6, 8)).astype(np.float32)).requires_grad_(True), torch.zeros(6)
    with pytest.raises(NotImplementedError, match="bf16"):  # only the bf16 route refuses a gradient now
        qd.qat_dense(x, w, b, gelu=True, bf16=True)
    with torch.no_grad():
        y = qd.qat_dense(x, w, b, gelu=True)
    np.testing.assert_array_equal(y.numpy(), qd.qat_dense_ref(x, w.detach(), b, gelu=True).numpy())
    y = qd.qat_dense(x, w, b, gelu=True)  # float32 with a gradient: K5-bwd's GELU route (its plain version on CPU tensors)
    np.testing.assert_array_equal(y.detach().numpy(), qd.qat_dense_ref(x, w.detach(), b, gelu=True).numpy())
    y.sum().backward()
    w2 = w.detach().clone().requires_grad_(True)
    torch.nn.functional.gelu(x @ w2.t() + b).sum().backward()
    np.testing.assert_allclose(w.grad.numpy(), w2.grad.numpy(), rtol=1e-5, atol=1e-6)
    with pytest.raises(NotImplementedError, match="GELU only"):
        QDense(8, 6, nl="relu")


def test_infer_refuses_an_htdemucs_file_separation(tmp_path):
    from fqss_tpu_torch.infer import main as infer_main
    from fqss_tpu_torch.utils.audio import save_audio

    wav = str(tmp_path / "mix.wav")
    save_audio(wav, np.zeros((2, 800), np.float32), SR)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(_val_conf(str(tmp_path), None, True)))
    with pytest.raises(NotImplementedError, match="HTDemucs"):  # music file separation is not ported
        infer_main(["-y", str(cfg), "-a", wav, "--device", "cpu"])
