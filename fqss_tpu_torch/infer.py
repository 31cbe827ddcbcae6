"""Single-file separation CLI on PyTorch (the port of ``infer.py``).

Usage: python -m fqss_tpu_torch.infer -y cfg.yaml -a mixture.wav [-o out_dir] [--device cuda]
           [--engine fake_quant|folded|int8|auto] [--stream PUSH]

Writes one WAV per separated source. The model runs on ``--device``
(default ``cuda``, which must be present; pass ``--device cpu`` to run the
plain PyTorch versions of the kernels on the CPU). TF32 is turned off: it
would move values off the 8-bit grids. ``--engine`` picks the serving path:
the per-forward fake-quant model, its weight-folded copy, the int8 engine
(``serve/*_int8.py``, bf16 operands for its float products), or ``auto``,
the family's fastest of these on the H100 (``serve/autopath.py``).
``--stream PUSH`` separates the file as a live stream, by pushes of PUSH
samples through ``serve/streaming.py`` (windows of
``testing_cfg.segment_samples``); a drained stream equals the offline OLA
with one chunk a call.

:func:`load_engine`, :func:`separate_file` and :func:`stream_file` are the
same path as a library: build the serving model once, then serve one file
per call. Under ``torchrun --standalone --nproc_per_node=N -m
fqss_tpu_torch.infer ...`` the file's overlap-add is sharded over the N
ranks and rank 0 writes the sources (a stream is one process's).
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Callable, Mapping

import numpy as np
import torch

from fqss_tpu_torch.models.factory import create_pretrained_model
from fqss_tpu_torch.parallel import mesh as dp
from fqss_tpu_torch.separation.ola import ola_infer
from fqss_tpu_torch.serve import StreamingSeparator, auto_serving_model, fold_quantized_weights, make_int8_engine
from fqss_tpu_torch.utils.audio import normalize_audio, read_audio, resample_audio, save_audio
from fqss_tpu_torch.utils.config import load_config

ENGINES = ("fake_quant", "folded", "int8", "auto")


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
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; choose from {ENGINES}")
    disable_tf32()
    model = create_pretrained_model(model_cfg, observer=False, device=device)
    if engine == "folded":
        return fold_quantized_weights(model)
    if engine == "int8":
        return make_int8_engine(model)
    if engine == "auto":
        return auto_serving_model(model)
    return model


def _read_mixture(conf: Mapping[str, Any], audio_path: str, normalize: bool) -> tuple[np.ndarray, int]:
    """The mixture [C, T] as the config's dataset resamples it, and its rate. Refuses a music model: its file
    separation (stereo stems, by the config's ``sources``) is not ported yet."""
    name = conf["model_cfg"]["name"]
    if name in ("ConvTasNetMusic", "HTDemucs"):
        raise NotImplementedError(f"separating a file with {name} is not ported yet (ROADMAP.md, queue 1); "
                                  "val scores it on MUSDB")
    wav, fs = read_audio(audio_path)
    resample = conf.get("dataset_cfg", {}).get("resample", 1)
    if resample != 1:
        wav = resample_audio(wav, fs, int(fs * resample))
        fs = int(fs * resample)
    if normalize:
        wav = normalize_audio(wav)
    return wav, fs


def _write_sources(conf: Mapping[str, Any], audio_path: str, output_dir: str | None, out: np.ndarray,
                   fs: int) -> str:
    out_dir = output_dir or os.path.join(
        conf.get("work_dir", "."), "inference", os.path.splitext(os.path.basename(audio_path))[0]
    )
    os.makedirs(out_dir, exist_ok=True)
    for s in range(out.shape[0]):
        save_audio(os.path.join(out_dir, f"source_{s + 1}.wav"), out[s], fs)
    return out_dir


def separate_file(apply_fn: Callable[[torch.Tensor], torch.Tensor], conf: Mapping[str, Any], audio_path: str,
                  output_dir: str | None = None, normalize: bool = False,
                  device: torch.device | str = "cuda", mesh: dp.Mesh | None = None) -> tuple[str | None, np.ndarray]:
    """Separate one WAV file with OLA (sharded over ``mesh``'s ranks, which all call); returns (output directory,
    [S, T] sources). Rank 0 writes the sources; another rank returns None for the directory."""
    testing_cfg = conf.get("testing_cfg", {})
    wav, fs = _read_mixture(conf, audio_path, normalize)
    out = ola_infer(apply_fn, wav, n_srcs=conf["model_cfg"].get("n_src", 1),
                    segment=testing_cfg.get("segment_samples"), overlap=testing_cfg.get("overlap", 0.25),
                    device=device, mesh=mesh)
    if mesh is not None and not mesh.is_main:
        return None, out
    return _write_sources(conf, audio_path, output_dir, out, fs), out


def stream_file(apply_fn: Callable[[torch.Tensor], torch.Tensor], conf: Mapping[str, Any], audio_path: str,
                push: int, output_dir: str | None = None, normalize: bool = False,
                device: torch.device | str = "cuda") -> tuple[str, np.ndarray]:
    """Separate one WAV file as a live stream, by pushes of ``push`` samples through
    :class:`~fqss_tpu_torch.serve.streaming.StreamingSeparator` in windows of ``testing_cfg.segment_samples``;
    returns (output directory, [S, T] sources). Raises SystemExit without a segment length."""
    testing_cfg = conf.get("testing_cfg", {})
    segment = testing_cfg.get("segment_samples")
    if not segment:
        raise SystemExit("--stream needs testing_cfg.segment_samples")
    if push <= 0:
        raise SystemExit(f"--stream needs a positive push size, got {push}")
    wav, fs = _read_mixture(conf, audio_path, normalize)
    channels = wav.shape[0]
    stream = StreamingSeparator(apply_fn, n_srcs=conf["model_cfg"].get("n_src", 1), segment=int(segment),
                                overlap=testing_cfg.get("overlap", 0.25), channels=channels, device=device)
    pieces = [stream.push(wav[:, i: i + push] if channels > 1 else wav[0, i: i + push])
              for i in range(0, wav.shape[-1], push)]
    pieces.append(stream.flush())
    out = np.concatenate(pieces, axis=-1)
    return _write_sources(conf, audio_path, output_dir, out, fs), out


def argument_handler(argv=None):
    parser = argparse.ArgumentParser(prog="python -m fqss_tpu_torch.infer")
    parser.add_argument("--yml_path", "-y", type=str, required=True, help="YML configuration file")
    parser.add_argument("--audio_path", "-a", type=str, required=True, help="Input mixture WAV")
    parser.add_argument("--output_dir", "-o", type=str, default=None, help="Output directory")
    parser.add_argument("--normalize", action="store_true", help="Peak-normalize the input")
    parser.add_argument("--engine", choices=ENGINES, default="fake_quant",
                        help="Serving path: per-forward fake-quant, weight-folded fake-quant "
                        "(bitwise identical, weights pre-quantized), the int8 engine "
                        "(int8 products), or auto: the model family's fastest of these on the H100.")
    parser.add_argument("--stream", type=int, default=None, metavar="PUSH",
                        help="Streaming serving: feed the file in pushes of PUSH samples "
                        "(needs testing_cfg.segment_samples)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = argument_handler(argv)
    conf = load_config(args.yml_path)
    mesh = dp.init_distributed(args.device)
    try:
        if mesh is not None and args.stream is not None:
            raise SystemExit("--stream separates in one process; run it without torchrun")
        device = mesh.device if mesh is not None else resolve_device(args.device)
        apply_fn = load_engine(conf["model_cfg"], args.engine, device)
        if args.stream is not None:
            out_dir, _ = stream_file(apply_fn, conf, args.audio_path, args.stream, args.output_dir, args.normalize,
                                     device)
        else:
            out_dir, _ = separate_file(apply_fn, conf, args.audio_path, args.output_dir, args.normalize, device, mesh)
        if mesh is None or mesh.is_main:
            print(f"Wrote {conf['model_cfg'].get('n_src', 1)} sources to {out_dir}")
    finally:
        dp.shutdown()


if __name__ == "__main__":
    main()
