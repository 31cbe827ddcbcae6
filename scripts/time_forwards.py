#!/usr/bin/env python3
"""Time the serving forwards and KD train steps of a checkout of this repository, on one NVIDIA GPU.

Usage: python3 scripts/time_forwards.py [ROOT] [--parts PART ...]

Imports ``chip_smoke`` and the port from ROOT (default: the checkout this
script lies in), builds its kernels there, and times by CUDA events, each
after warm-up, with ``chip_smoke.py``'s models and seeded weights:

* ``dptnet``: the full-width DPTNet, fake_quant and the float32 int8 engine,
  8 x 4 s (5 forwards each), and a streamed window's forward (phase 38's: a
  16000-sample window at batch 1 through the fake_quant model, which
  ``--engine auto`` serves; median of 14);
* ``sepformer``: the Sepformer, fake_quant and float32 int8, 8 x 4 s, and a
  streamed window's forward (folded, which ``auto`` serves; median of 14);
* ``convtasnet``: the ConvTasNet fake_quant forward and the float32 int8
  engine, 32 x 12 s (3 forwards each), and a streamed window's forward
  (folded; median of 14);
* ``steps``: KD train steps (student and float teacher from
  ``create_model_and_teacher``, the observer window closed first): the
  Sepformer at 1 x 4 s and 8 x 4 s (median of 5 steps), the ConvTasNet at
  16 x 3 s (phase 11's shape; mean of 5).

Prints one JSON line of milliseconds. To compare two commits on one card,
unpack the other with ``git archive`` into a gitignored directory and run
both in turns in one call: ``for r in OLD . . OLD; do python3
scripts/time_forwards.py $r; done``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

PARTS = ("dptnet", "sepformer", "convtasnet", "steps")
parser = argparse.ArgumentParser(prog="python3 scripts/time_forwards.py")
parser.add_argument("root", nargs="?", default=os.path.join(os.path.dirname(__file__), ".."))
parser.add_argument("--parts", nargs="*", choices=PARTS, default=list(PARTS))
ARGS = parser.parse_args()
ROOT = os.path.abspath(ARGS.root)
os.chdir(ROOT)
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (the models, sizes and timing of the checkout at ROOT)
from fqss_tpu_torch.infer import disable_tf32  # noqa: E402
from fqss_tpu_torch.models.factory import create_model_and_teacher  # noqa: E402
from fqss_tpu_torch.serve import fold_quantized_weights, make_int8_engine  # noqa: E402
from fqss_tpu_torch.train.trainer import TrainConfig, make_train_step  # noqa: E402

WINDOW = 16000  # phase 38's window (the configs' segment)


def forward_ms(engine, x: torch.Tensor, n: int) -> float:
    def forward():
        with torch.inference_mode():
            return engine(x)
    return cs.cuda_ms(forward, n)


def window_p50(engine, x: torch.Tensor) -> float:
    """The median of 14 forwards of a streamed window (x's first WINDOW samples at batch 1)."""
    window = x[:1, :WINDOW].contiguous()

    def forward():
        with torch.inference_mode():
            return engine(window)
    return cs.median_ms(forward, 14)[0]


def step_ms(dev, cfg: dict, batch: int, seg: int, seed: int, n: int, median: bool) -> float:
    """A KD step of ``batch`` x ``seg`` samples after the observer window (3 steps) and one more."""
    model, teacher = create_model_and_teacher(cfg, generator=torch.Generator().manual_seed(seed))
    state = cs.new_train_state(model.to(dev), teacher.to(dev))
    step = make_train_step(TrainConfig())
    mix, src = cs.synth_batch(np.random.default_rng(seed), batch, 2, seg)
    x, s = torch.from_numpy(mix).to(dev), torch.from_numpy(src).to(dev)
    for _ in range(4):
        step(state, x, s)
    ms = cs.median_ms(lambda: step(state, x, s), n)[0] if median else cs.cuda_ms(lambda: step(state, x, s), n)
    if state.skipped:
        raise AssertionError(f"{state.skipped} train steps skipped")
    return ms


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("time_forwards: no CUDA device")
    disable_tf32()
    dev = torch.device("cuda", 0)
    out = {"root": ROOT, "device": torch.cuda.get_device_name(0)}
    if "dptnet" in ARGS.parts:
        mix, _ = cs.synth_batch(np.random.default_rng(18), cs.DPT_BATCH, 2, cs.DPT_SEG)
        model, x = cs.build_served_dptnet(dev, mix[:2]), torch.from_numpy(mix).to(dev)
        out["dptnet_fake_quant"] = forward_ms(model, x, 5)
        out["dptnet_int8_float32"] = forward_ms(make_int8_engine(model, compute_dtype="float32"), x, 5)
        out["dptnet_window_p50"] = window_p50(model, x)
        del model
        torch.cuda.empty_cache()
    if "sepformer" in ARGS.parts:
        mix, _ = cs.synth_batch(np.random.default_rng(25), cs.SEP_BATCH, 2, cs.SEP_SEG)
        model, x = cs.build_served_sepformer(dev, mix[:2]), torch.from_numpy(mix).to(dev)
        out["sepformer_fake_quant"] = forward_ms(model, x, 5)
        out["sepformer_int8_float32"] = forward_ms(make_int8_engine(model, compute_dtype="float32"), x, 5)
        out["sepformer_window_p50"] = window_p50(fold_quantized_weights(model), x)
        del model
        torch.cuda.empty_cache()
    if "convtasnet" in ARGS.parts:
        mix, _ = cs.synth_batch(np.random.default_rng(0), cs.BATCH, 2, cs.SEG)
        model, x = cs.build_served_model(dev, mix[:4]), torch.from_numpy(mix).to(dev)
        out["convtasnet_fake_quant"] = forward_ms(model, x, 3)
        out["convtasnet_int8_float32"] = forward_ms(make_int8_engine(model, compute_dtype="float32"), x, 3)
        out["convtasnet_window_p50"] = window_p50(fold_quantized_weights(model), x)
        del model
        torch.cuda.empty_cache()
    if "steps" in ARGS.parts:
        sep_cfg = cs.train_cfg(cs.SEPFORMER_CFG)
        out["sepformer_step_1x4s"] = step_ms(dev, sep_cfg, 1, cs.SEP_TRAIN_SEG, 35, 5, median=True)
        torch.cuda.empty_cache()
        out["sepformer_step_8x4s"] = step_ms(dev, sep_cfg, 8, cs.SEP_TRAIN_SEG, 35, 5, median=True)
        torch.cuda.empty_cache()
        out["convtasnet_step_16x3s"] = step_ms(dev, cs.TRAIN_CFG, cs.TRAIN_BATCH, cs.TRAIN_SEG, 11, 5, median=False)
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
