"""Single-file separation CLI on PyTorch (the port of ``infer.py``).

Usage: python -m fqss_tpu_torch.infer -y cfg.yaml -a mixture.wav [-o out_dir] [--device cuda]

Writes one WAV per separated source. The model runs on ``--device``
(default ``cuda``, which must be present; pass ``--device cpu`` to run the
plain PyTorch versions of the kernels on the CPU). TF32 is turned off: it
would move values off the 8-bit grids.

:func:`load_engine` and :func:`separate_file` are the same path as a
library: build the serving model once, then serve one file per call.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Callable, Mapping

import numpy as np
import torch

from fqss_tpu_torch.models.factory import create_pretrained_model
from fqss_tpu_torch.separation.ola import ola_infer
from fqss_tpu_torch.serve.fold import fold_quantized_weights
from fqss_tpu_torch.utils.audio import normalize_audio, read_audio, resample_audio, save_audio

ENGINES = ("fake_quant", "folded")


def disable_tf32() -> None:
    """Full float32 for convolutions and matrix products (TF32 leaves the 8-bit grids)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    return device


def load_engine(model_cfg: Mapping[str, Any], engine: str = "fake_quant",
                device: torch.device | str = "cuda") -> Callable[[torch.Tensor], torch.Tensor]:
    """The serving forward ``[K, T] -> [K, S, T]`` for ``engine`` on ``device``."""
    if engine in ("int8", "auto"):
        raise NotImplementedError(f"--engine {engine} is not ported yet (ROADMAP.md, queue 2: the int8 "
                                  "engine's kernel); use --engine folded")
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; choose from {ENGINES}")
    disable_tf32()
    model = create_pretrained_model(model_cfg, observer=False, device=device)
    if engine == "folded":
        model = fold_quantized_weights(model)
    return model


def separate_file(apply_fn: Callable[[torch.Tensor], torch.Tensor], conf: Mapping[str, Any], audio_path: str,
                  output_dir: str | None = None, normalize: bool = False,
                  device: torch.device | str = "cuda") -> tuple[str, np.ndarray]:
    """Separate one WAV file with OLA; returns (output directory, [S, T] sources)."""
    model_cfg = conf["model_cfg"]
    dataset_cfg = conf.get("dataset_cfg", {})
    testing_cfg = conf.get("testing_cfg", {})
    wav, fs = read_audio(audio_path)
    resample = dataset_cfg.get("resample", 1)
    if resample != 1:
        wav = resample_audio(wav, fs, int(fs * resample))
        fs = int(fs * resample)
    if normalize:
        wav = normalize_audio(wav)
    n_srcs = model_cfg.get("n_src", 1)
    out = ola_infer(apply_fn, wav, n_srcs=n_srcs, segment=testing_cfg.get("segment_samples"),
                    overlap=testing_cfg.get("overlap", 0.25), device=device)
    out_dir = output_dir or os.path.join(
        conf.get("work_dir", "."), "inference", os.path.splitext(os.path.basename(audio_path))[0]
    )
    os.makedirs(out_dir, exist_ok=True)
    for s in range(n_srcs):
        save_audio(os.path.join(out_dir, f"source_{s + 1}.wav"), out[s], fs)
    return out_dir, out


def argument_handler(argv=None):
    parser = argparse.ArgumentParser(prog="python -m fqss_tpu_torch.infer")
    parser.add_argument("--yml_path", "-y", type=str, required=True, help="YML configuration file")
    parser.add_argument("--audio_path", "-a", type=str, required=True, help="Input mixture WAV")
    parser.add_argument("--output_dir", "-o", type=str, default=None, help="Output directory")
    parser.add_argument("--normalize", action="store_true", help="Peak-normalize the input")
    parser.add_argument("--engine", choices=[*ENGINES, "int8", "auto"], default="fake_quant",
                        help="Serving path: per-forward fake-quant, or weight-folded fake-quant "
                        "(bitwise identical, weights pre-quantized). int8 and auto are not ported yet.")
    parser.add_argument("--stream", type=int, default=None, metavar="PUSH",
                        help="Streaming serving (not ported yet)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = argument_handler(argv)
    if args.stream:
        raise NotImplementedError("--stream is not ported yet (serve/streaming.py, ROADMAP.md queue 1)")
    from fqss_tpu.utils.config import load_config  # yaml is needed by the CLI only

    conf = load_config(args.yml_path)
    device = resolve_device(args.device)
    apply_fn = load_engine(conf["model_cfg"], args.engine, device)
    out_dir, _ = separate_file(apply_fn, conf, args.audio_path, args.output_dir, args.normalize, device)
    print(f"Wrote {conf['model_cfg'].get('n_src', 1)} sources to {out_dir}")


if __name__ == "__main__":
    main()
