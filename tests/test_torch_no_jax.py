"""The port runs without JAX: a static check of its imports, import checks and the CLI, in fresh processes.

``tests/conftest.py`` imports jax into the test process, so every check that
JAX stays out runs in a subprocess.
"""

import ast
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fqss_tpu_torch.data import synth_batch
from fqss_tpu_torch.utils.audio import read_audio, resample_audio, save_audio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IMPORT_ALL = """
import importlib, pkgutil, sys
import fqss_tpu_torch
for mod in pkgutil.walk_packages(fqss_tpu_torch.__path__, "fqss_tpu_torch."):
    importlib.import_module(mod.name)
import chip_smoke
loaded = sorted(m for m in ("jax", "flax", "yaml", "pandas", "fqss_tpu") if m in sys.modules)
print("LOADED", loaded)
print("MODULES", sorted(m for m in sys.modules if m.startswith("fqss_tpu_torch")))
"""
# The training and serving slices' modules, named so that a rename cannot drop them from the walk unnoticed.
TRAINING_MODULES = ("fqss_tpu_torch.data.synthetic", "fqss_tpu_torch.utils.audio", "fqss_tpu_torch.quant.ste",
                    "fqss_tpu_torch.separation.losses", "fqss_tpu_torch.train.state", "fqss_tpu_torch.train.trainer", "fqss_tpu_torch.train.checkpoints",
                    "fqss_tpu_torch.train.recipes", "fqss_tpu_torch.train.__main__", "fqss_tpu_torch.utils.logging")
SERVING_MODULES = tuple(f"fqss_tpu_torch.{m}" for m in (
    "serve.common", "serve.convtasnet_int8", "ops.int8_matmul", "separation.metrics", "separation.stoi",
    "separation.bss_eval", "train.validate", "val", "utils.config", "data.librimix", "data.augment",
    "ops.lstm", "nn.lstm", "nn.attention", "models.dptnet", "serve.dptnet_int8", "ops.attention", "models.sepformer",
    "serve.sepformer_int8", "ops.qat_dense"))
# The music slice's modules.
MUSIC_MODULES = tuple(f"fqss_tpu_torch.{m}" for m in (
    "models.convtasnet_music", "serve.convtasnet_music_int8", "data.musdb", "train.recipes_music",
    "train.validate_musdb"))
# The HTDemucs slice's modules.
HTDEMUCS_MODULES = tuple(f"fqss_tpu_torch.{m}" for m in (
    "ops.stft", "nn.nonlin", "nn.io_layers", "models.demucs_blocks", "models.htdemucs", "serve.htdemucs_int8",
    "separation.ola"))
# The data-parallel slice's modules.
PARALLEL_MODULES = ("fqss_tpu_torch.parallel", "fqss_tpu_torch.parallel.mesh")


def jax_package_imports(path: str) -> list[str]:
    """Every import of ``jax``, ``flax`` or the JAX package ``fqss_tpu`` in a Python file, at any depth."""
    found = []
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = [node.module]
        else:
            continue
        found += [f"{path}:{node.lineno}: {name}" for name in names
                  if name.split(".")[0] in ("fqss_tpu", "jax", "jaxlib", "flax")]
    return found


def test_port_and_chip_smoke_import_nothing_of_jax_or_the_jax_package():
    files = sorted(glob.glob(os.path.join(REPO, "fqss_tpu_torch", "**", "*.py"), recursive=True))
    files += [os.path.join(REPO, "chip_smoke.py"), *sorted(glob.glob(os.path.join(REPO, "tests", "torch_*_cases.py")))]
    assert len(files) > 40
    assert os.path.join(REPO, "fqss_tpu_torch", "parallel", "mesh.py") in files
    assert [hit for path in files for hit in jax_package_imports(path)] == []


def test_the_static_import_check_finds_imports_at_any_depth(tmp_path):
    src = tmp_path / "mod.py"
    src.write_text("import fqss_tpu_torch.ops\nfrom fqss_tpu_torch import serve\n"
                   "def f():\n    from fqss_tpu.utils.config import load_config\n"
                   "    if True:\n        import jax.numpy as jnp, os\n"
                   "class C:\n    def g(self):\n        from fqss_tpu import data\n")
    assert [hit.split(": ")[1] for hit in jax_package_imports(str(src))] == ["fqss_tpu.utils.config", "jax.numpy",
                                                                            "fqss_tpu"]


def _run(args, cwd=REPO, timeout=240):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_port_and_chip_smoke_import_no_jax_flax_or_yaml():
    proc = _run(["-c", IMPORT_ALL])
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout
    for mod in TRAINING_MODULES + SERVING_MODULES + MUSIC_MODULES + HTDEMUCS_MODULES + PARALLEL_MODULES:
        assert f"'{mod}'" in proc.stdout, mod


def test_synth_batch_equals_the_jax_packages():
    from fqss_tpu.data.synthetic import synth_batch as jax_package_synth_batch

    for args in ((2, 2, 3000), (1, 3, 1001)):
        got = synth_batch(np.random.default_rng(7), *args)
        want = jax_package_synth_batch(np.random.default_rng(7), *args)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_audio_helpers_equal_the_jax_packages(tmp_path):
    from fqss_tpu.utils import audio as jax_package_audio

    mix, src = synth_batch(np.random.default_rng(3), 1, 2, 4000)
    for name, wav in (("mono.wav", mix[0]), ("stereo.wav", src[0])):
        save_audio(str(tmp_path / name), wav, 16000)
        jax_package_audio.save_audio(str(tmp_path / f"ref_{name}"), wav, 16000)
        assert (tmp_path / name).read_bytes() == (tmp_path / f"ref_{name}").read_bytes()
        got, want = read_audio(str(tmp_path / name)), jax_package_audio.read_audio(str(tmp_path / name))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] == 16000
        np.testing.assert_array_equal(resample_audio(got[0], 16000, 8000),
                                      jax_package_audio.resample_audio(want[0], 16000, 8000))


def test_chip_smoke_model_cfg_equals_the_config_file():
    import yaml

    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    with open(os.path.join(REPO, "configs", "convtasnet_2spks_8k.yaml")) as f:
        assert chip_smoke.MODEL_CFG == yaml.safe_load(f)["model_cfg"]


def test_chip_smoke_dptnet_model_cfg_equals_the_config_file():
    import yaml

    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    with open(os.path.join(REPO, "configs", "dptnet_2spks_8k.yaml")) as f:
        assert chip_smoke.DPTNET_CFG == yaml.safe_load(f)["model_cfg"]


def test_chip_smoke_sepformer_model_cfg_equals_the_config_file():
    import yaml

    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    with open(os.path.join(REPO, "configs", "sepformer_2spks_8k.yaml")) as f:
        assert chip_smoke.SEPFORMER_CFG == yaml.safe_load(f)["model_cfg"]


def test_chip_smoke_music_model_cfg_equals_the_config_file():
    import yaml

    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    with open(os.path.join(REPO, "configs", "convtasnet_music.yaml")) as f:
        conf = yaml.safe_load(f)
    assert chip_smoke.MUSIC_CFG == conf["model_cfg"]
    assert chip_smoke.MUSIC_SEG == conf["testing_cfg"]["segment_samples"]
    assert chip_smoke.MUSIC_SR == conf["dataset_cfg"]["sample_rate"]
    assert chip_smoke.MUSIC_TRAIN_SEG == conf["dataset_cfg"]["segment"] * conf["dataset_cfg"]["sample_rate"]
    assert chip_smoke.MUSIC_AUGMENT == conf["dataset_cfg"]["augmentation"]


def test_chip_smoke_without_a_card_fails_and_prints_no_result():
    proc = _run(["chip_smoke.py"])
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
    assert "no CUDA device" in proc.stderr


TINY_CFG = """
work_dir: {work_dir}
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
  quantization:
    qat: True
    out_quant: True
    n_splitter: 2
    n_combiner: 2
    observer: True
testing_cfg:
  segment_samples: 2000
  overlap: 0.25
"""


@pytest.fixture
def tiny_request(tmp_path):
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY_CFG.format(work_dir=tmp_path / "runs"))
    mix, _ = synth_batch(np.random.default_rng(0), 1, 2, 5000)
    wav = tmp_path / "mixture.wav"
    save_audio(str(wav), mix[0], 8000)
    return cfg, wav


def test_infer_cli_on_cpu(tmp_path, tiny_request):
    cfg, wav = tiny_request
    out = tmp_path / "out"
    proc = _run(["-m", "fqss_tpu_torch.infer", "-y", str(cfg), "-a", str(wav), "-o", str(out),
                 "--engine", "folded", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    for s in (1, 2):
        audio, fs = read_audio(str(out / f"source_{s}.wav"))
        assert fs == 8000 and audio.shape == (1, 5000)
        assert np.isfinite(audio).all()


@pytest.mark.parametrize("args,message", [
    (["--device", "cuda"], "CUDA is not available"),
    (["--device", "cpu", "--engine", "int4"], "invalid choice"),
    (["--device", "cpu", "--stream", "0"], "positive push size"),
])
def test_infer_cli_refuses_what_it_cannot_do(tiny_request, args, message):
    if args[1] == "cuda" and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg, wav = tiny_request
    proc = _run(["-m", "fqss_tpu_torch.infer", "-y", str(cfg), "-a", str(wav), *args])
    assert proc.returncode != 0
    assert message in proc.stderr
