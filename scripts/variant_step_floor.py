#!/usr/bin/env python3
"""How far the flagship's KD step parts between the card and the CPU under the quantizer variants, and each device
from itself.

Usage: python3 scripts/variant_step_floor.py [--out FILE]

For each configuration (``chip_smoke.py``'s TRAIN_CFG: linear grids; with ``act_quantizer: mse``; with it and a
linear ``in_quant``; with ``in_quant`` and ``inout_nl_quant``: the mu-law I/O grids; with both: phase 69's
VARIANT_CFG) it trains the full-width flagship as ``chip_smoke.py`` phase 69 does (KD steps of 16 x 3 s through a
3-step window, the host's MSE calibration, more steps), then runs phase 10's post-window step of 1 x 1 s from that
state on the card, on the card again, on the card with the mixture times (1 + 2^-22), on the card with cuDNN's
benchmarked algorithms (its convolutions summed in other orders), on the CPU, on the CPU with the mixture times
(1 + 2^-22) and on the CPU on one thread. It prints each configuration's losses, 1 - the whole-gradient cosine of
card vs CPU, of each device against its own perturbed or re-summed step and of the card against its repeat, the
same distances over the weights alone and over the quantizer ranges alone, and the 15 parameters whose gradients
part most between card and CPU. ``--out``
writes them all as JSON.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402  (phase 69's model, steps and helpers)

PERTURB = 2.0**-22
QUANT = cs.TRAIN_CFG["quantization"]
CONFIGS = {
    "linear": cs.TRAIN_CFG,
    "mse": {**cs.TRAIN_CFG, "quantization": {**QUANT, "act_quantizer": "mse"}},
    "mse+in_quant": {**cs.TRAIN_CFG, "quantization": {**QUANT, "act_quantizer": "mse", "in_quant": True}},
    "mulaw": {**cs.TRAIN_CFG, "quantization": {**QUANT, "in_quant": True, "inout_nl_quant": True}},
    "mse+mulaw": cs.VARIANT_CFG,
}


def step_grads(state: cs.TrainState, device, mix, src, benchmark: bool = False,
               threads: int | None = None) -> tuple[float, dict]:
    """One step's loss and gradients; ``benchmark``: cuDNN picks its fastest convolution algorithms (other sums in
    other orders); ``threads``: the CPU's thread count for the step (other splits of its sums)."""
    st = cs.new_train_state(copy.deepcopy(state.model).to(device), copy.deepcopy(state.teacher).to(device))
    was, torch.backends.cudnn.benchmark = torch.backends.cudnn.benchmark, benchmark
    n = torch.get_num_threads()
    torch.set_num_threads(threads or n)
    try:
        metrics = cs.make_train_step(cs.TrainConfig())(st, torch.from_numpy(mix).to(device),
                                                       torch.from_numpy(src).to(device))
    finally:
        torch.backends.cudnn.benchmark = was
        torch.set_num_threads(n)
    return float(metrics["loss"]), {n: p.grad.double().cpu() for n, p in st.model.named_parameters()
                                    if p.grad is not None}


def one_minus_cos(a: dict, b: dict, names: list[str]) -> float:
    va, vb = (torch.cat([g[n].flatten() for n in names]) for g in (a, b))
    return 1 - float(va @ vb / (va.norm() * vb.norm()))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", help="write the distances as JSON to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("variant_step_floor: no CUDA device")
    dev, cpu = torch.device("cuda", 0), torch.device("cpu")
    cs.infer.disable_tf32()
    mix, src = cs.synth_batch(np.random.default_rng(10), 1, 2, cs.SR)
    pairs = {"card_vs_cpu": ("card", "cpu"), "card_own": ("card", "card_perturbed"),
             "card_repeat": ("card", "card_repeat"), "cpu_own": ("cpu", "cpu_perturbed"),
             "card_algos": ("card", "card_benchmark"), "cpu_threads": ("cpu", "cpu_1_thread")}
    out = {}
    for label, cfg in CONFIGS.items():
        state, _ = cs.variant_state(dev, cfg)
        after = cs.TrainState(copy.deepcopy(state.model).cpu(), None, copy.deepcopy(state.teacher).cpu())
        del state
        torch.cuda.empty_cache()
        runs = {name: step_grads(after, device, mix * np.float32(scale), src, **kw)
                for name, device, scale, kw in (("card", dev, 1.0, {}), ("card_perturbed", dev, 1 + PERTURB, {}),
                                                ("card_repeat", dev, 1.0, {}),
                                                ("card_benchmark", dev, 1.0, {"benchmark": True}),
                                                ("cpu", cpu, 1.0, {}), ("cpu_perturbed", cpu, 1 + PERTURB, {}),
                                                ("cpu_1_thread", cpu, 1.0, {"threads": 1}))}
        names = sorted(runs["card"][1])
        ranges = [n for n in names if n.endswith(("min_range", "max_range", ".mu"))]
        weights = [n for n in names if n not in ranges]
        dist = {f"{k}{suffix}": one_minus_cos(runs[a][1], runs[b][1], subset)
                for k, (a, b) in pairs.items()
                for suffix, subset in (("", names), ("_weights", weights), ("_ranges", ranges))}
        rows = sorted(((n, float(runs["card"][1][n].norm()),
                        *(float((runs[a][1][n] - runs[b][1][n]).norm()) for a, b in pairs.values())) for n in names),
                      key=lambda r: -r[2])
        print(f"== {label}: losses " + ", ".join(f"{k} {v[0]:.6f}" for k, v in runs.items()), flush=True)
        print("1 - whole-gradient cosine: " + ", ".join(f"{k} {v:.3e}" for k, v in dist.items()), flush=True)
        print("parameter, |g|, then |difference| " + ", ".join(pairs))
        for r in rows[:15]:
            print(f"{r[0]} {r[1]:.3e} " + " ".join(f"{v:.3e}" for v in r[2:]))
        out[label] = {"losses": {k: v[0] for k, v in runs.items()}, "one_minus_cos": dist, "rows": rows[:40]}
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh)


if __name__ == "__main__":
    main()
