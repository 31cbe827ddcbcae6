"""Evaluation CLI on PyTorch (the port of ``val.py``; reference: val.py:184-226).

Usage: python -m fqss_tpu_torch.val -y cfg.yaml [--limit N] [--no-stoi]
           [--engine fake_quant|folded|int8|auto] [--device cuda]

Separates every mixture of ``testing_cfg.test_dir`` (the LibriMix test
layout: ``mix_clean/``, ``s1/``, ``s2/``) by overlap-add with the chosen
serving engine on ``--device`` (default ``cuda``; ``--device cpu`` runs the
kernels' plain versions) and prints the mean SI-SDR, its improvement over
the mixture, SDR and STOI. :func:`evaluate` is the same run as a library
call on a config dict. MUSDB evaluation comes with the music slices.
"""

from __future__ import annotations

import argparse
from typing import Any, Mapping

import torch

from fqss_tpu_torch.infer import ENGINES, load_engine, resolve_device
from fqss_tpu_torch.quant.spec import QuantSpec
from fqss_tpu_torch.train.validate import val_librimix
from fqss_tpu_torch.utils.config import load_config


def evaluate(conf: Mapping[str, Any], engine: str = "fake_quant", device: torch.device | str = "cuda",
             limit: int | None = None, compute_stoi: bool = True) -> dict[str, float]:
    """Score ``engine`` on the config's test set: ``{"si_sdr", "si_sdr_imp", "sdr", "stoi"}`` means."""
    model_cfg, dataset_cfg, testing_cfg = conf["model_cfg"], conf["dataset_cfg"], conf["testing_cfg"]
    q = QuantSpec.from_config(model_cfg.get("quantization"))
    # (The reference's check tested n_splitter twice, val.py:207; both are checked here.)
    if not q.qat and (q.n_splitter > 1 or q.n_combiner > 1):
        raise ValueError("No support for splitter/combiner with non QAT model.")
    if dataset_cfg["name"] == "musdbhq":
        raise NotImplementedError("MUSDB evaluation is not ported yet (the music slices, ROADMAP.md queue 1)")
    if dataset_cfg["name"] != "librimix":
        raise ValueError("Dataset {} is not supported!".format(dataset_cfg["name"]))
    apply_fn = load_engine(model_cfg, engine, device)
    values = val_librimix(apply_fn, model_cfg, dataset_cfg, testing_cfg, limit=limit, compute_stoi=compute_stoi,
                          device=device)
    return dict(zip(("si_sdr", "si_sdr_imp", "sdr", "stoi"), values))


def argument_handler(argv=None):
    parser = argparse.ArgumentParser(prog="python -m fqss_tpu_torch.val")
    parser.add_argument("--yml_path", "-y", type=str, required=True, help="YML configuration file")
    parser.add_argument("--limit", type=int, default=None, help="Evaluate at most N items")
    parser.add_argument("--no-stoi", action="store_true", help="Skip STOI (slow on host)")
    parser.add_argument("--engine", choices=ENGINES, default="fake_quant",
                        help="Serving path: per-forward fake-quant, weight-folded (bitwise identical), the "
                        "int8 engine, or auto: the model family's fastest of these on the H100.")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = argument_handler(argv)
    conf = load_config(args.yml_path)
    m = evaluate(conf, args.engine, resolve_device(args.device), args.limit, not args.no_stoi)
    print("SI-SDR={:0.2f},SI-SDR-imp={:0.2f},SDR={:0.2f},STOI={:0.3f}".format(
        m["si_sdr"], m["si_sdr_imp"], m["sdr"], m["stoi"]))


if __name__ == "__main__":
    main()
