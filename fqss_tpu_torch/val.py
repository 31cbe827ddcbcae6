"""Evaluation CLI on PyTorch (the port of ``val.py``; reference: val.py:184-226).

Usage: python -m fqss_tpu_torch.val -y cfg.yaml [--limit N] [--no-stoi]
           [--engine fake_quant|folded|int8|auto] [--device cuda]

Separates every mixture of ``testing_cfg.test_dir`` by overlap-add with the
chosen serving engine on ``--device`` (default ``cuda``; ``--device cpu``
runs the kernels' plain versions). On LibriMix (``dataset_cfg.name:
librimix``; ``mix_clean/``, ``s1/``, ``s2/``) it prints the mean SI-SDR, its
improvement over the mixture, SDR and STOI; on MUSDB18-HQ (``musdbhq``;
``test/<track>/``) the mean and per-stem NSDR when ``testing_cfg.NSDR`` is
set, else BSS Eval v4's SDR and its ISR/SIR/SAR table (val.py:83-95).
:func:`evaluate` is the same run as a library call on a config dict.

Under ``torchrun --standalone --nproc_per_node=N -m fqss_tpu_torch.val ...``
each file's overlap-add is sharded over the N ranks (``chunk_batch`` chunks
a rank) and the files' scores are split over them and summed; rank 0
prints. A plain ``python -m`` runs one process.
"""

from __future__ import annotations

import argparse
from typing import Any, Mapping

import torch

from fqss_tpu_torch.infer import ENGINES, load_engine, resolve_device
from fqss_tpu_torch.parallel import mesh as dp
from fqss_tpu_torch.quant.spec import QuantSpec
from fqss_tpu_torch.train.validate import val_librimix
from fqss_tpu_torch.train.validate_musdb import SOURCES, val_musdbhq, val_musdbhq_nsdr
from fqss_tpu_torch.utils.config import load_config


def evaluate(conf: Mapping[str, Any], engine: str = "fake_quant", device: torch.device | str = "cuda",
             limit: int | None = None, compute_stoi: bool = True, mesh: dp.Mesh | None = None) -> dict[str, Any]:
    """Score ``engine`` on the config's test set (with ``mesh``: every rank calls, the OLA sharded over the ranks,
    on ``mesh.device``).

    LibriMix: ``{"si_sdr", "si_sdr_imp", "sdr", "stoi"}`` means. MUSDB18-HQ: ``{"nsdr", "nsdr_<stem>"...}`` with
    ``testing_cfg.NSDR``, else ``{"sdr", "sdr_<stem>"..., "ISR", "SIR", "SAR"}``, the last three
    ``{stem: median}``. ``compute_stoi`` applies to LibriMix only.
    """
    model_cfg, dataset_cfg, testing_cfg = conf["model_cfg"], conf["dataset_cfg"], conf["testing_cfg"]
    q = QuantSpec.from_config(model_cfg.get("quantization"))
    # (The reference's check tested n_splitter twice, val.py:207; both are checked here.)
    if not q.qat and (q.n_splitter > 1 or q.n_combiner > 1):
        raise ValueError("No support for splitter/combiner with non QAT model.")
    if dataset_cfg["name"] not in ("librimix", "musdbhq"):
        raise ValueError("Dataset {} is not supported!".format(dataset_cfg["name"]))
    if mesh is not None:
        device = mesh.device
    apply_fn = load_engine(model_cfg, engine, device)
    if dataset_cfg["name"] == "musdbhq":
        sources = tuple(model_cfg.get("sources", SOURCES))
        if testing_cfg.get("NSDR", False):
            vals = val_musdbhq_nsdr(apply_fn, model_cfg, testing_cfg, limit=limit, mesh=mesh, device=device)
            return dict(zip(("nsdr", *(f"nsdr_{s}" for s in sources)), vals))
        vals, full = val_musdbhq(apply_fn, model_cfg, testing_cfg, limit=limit, return_full=True, mesh=mesh,
                                 device=device)
        return {**dict(zip(("sdr", *(f"sdr_{s}" for s in sources)), vals)),
                **{k: full[k] for k in ("ISR", "SIR", "SAR")}}
    values = val_librimix(apply_fn, model_cfg, dataset_cfg, testing_cfg, limit=limit, compute_stoi=compute_stoi,
                          device=device, mesh=mesh)
    return dict(zip(("si_sdr", "si_sdr_imp", "sdr", "stoi"), values))


def report(m: Mapping[str, Any]) -> str:
    """The line(s) the reference's val.py prints for :func:`evaluate`'s result (val.py:83-95)."""
    if "si_sdr" in m:
        return "SI-SDR={:0.2f},SI-SDR-imp={:0.2f},SDR={:0.2f},STOI={:0.3f}".format(
            m["si_sdr"], m["si_sdr_imp"], m["sdr"], m["stoi"])
    kind = "nsdr" if "nsdr" in m else "sdr"
    stems = [k for k in m if k.startswith(f"{kind}_")]
    lines = [",".join([f"{kind.upper()}={m[kind]:0.2f}"] + [f"{k.upper()}={m[k]:0.2f}" for k in stems])]
    for metric in ("ISR", "SIR", "SAR"):  # the full BSS Eval v4 table
        if metric in m:
            lines.append(metric + "=" + ",".join(f"{s}:{v:0.2f}" for s, v in m[metric].items()))
    return "\n".join(lines)


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
    mesh = dp.init_distributed(args.device)
    try:
        device = mesh.device if mesh is not None else resolve_device(args.device)
        result = evaluate(conf, args.engine, device, args.limit, not args.no_stoi, mesh=mesh)
        if mesh is None or mesh.is_main:
            print(report(result))
    finally:
        dp.shutdown()


if __name__ == "__main__":
    main()
