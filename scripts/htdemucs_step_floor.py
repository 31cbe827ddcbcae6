#!/usr/bin/env python3
"""How far the htdemucs KD step's gradients part between the card and the CPU, and each device from itself.

Usage: python3 scripts/htdemucs_step_floor.py [--out FILE]

Builds the full-width HTDemucs of ``chip_smoke.py`` phase 62 (HTDEMUCS_CFG,
seeded weights, an observer window of 3 steps) and its float teacher, takes
four htdemucs KD steps of 2 x 2 s on the card so that the window closes, and
then runs one more step of 1 x 1 s of stems from that state on the card, on
the card again, on the card with the stems times (1 + 2^-22), on the CPU and
on the CPU with the stems times (1 + 2^-22), each with the same augmentation
draws. It prints each step's loss, 1 - the whole-gradient cosine of card vs
CPU, of each device against its own perturbed step and of the card against
its repeat, and the 40 parameters whose gradients part most between card and
CPU beside the same distances. ``--out`` writes them all as JSON.
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

import chip_smoke as cs  # noqa: E402  (the htdemucs phases' model, step and helpers)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", help="write the distances as JSON to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("htdemucs_step_floor: no CUDA device")
    dev = torch.device("cuda", 0)
    cs.infer.disable_tf32()
    cfg = cs.TrainConfig(lr=3e-4, grad_clip=0.0)
    step = cs.make_music_train_step(cfg, cs.HTD_AUGMENT, weight_kind="exp", is_htdemucs=True,
                                    source_weights=np.ones(len(cs.HTDEMUCS_CFG["sources"]), np.float32))
    state = cs.htdemucs_train_state(dev, cfg)
    gen = torch.Generator().manual_seed(62)
    for seed in range(4):
        step(state, torch.from_numpy(cs.music_stems(620 + seed, 2, 2 * cs.HTD_SR)).to(dev), gen)
    after = cs.TrainState(copy.deepcopy(state.model).cpu(), None, copy.deepcopy(state.teacher).cpu())
    src = cs.music_stems(64, 1, cs.HTD_SR)
    runs = {}
    cpu = torch.device("cpu")
    for name, device, scale in (("card", dev, 1.0), ("card_perturbed", dev, 1 + cs.MUSIC_PERTURB),
                                ("card_repeat", dev, 1.0), ("cpu", cpu, 1.0),
                                ("cpu_perturbed", cpu, 1 + cs.MUSIC_PERTURB)):
        st = cs.new_train_state(copy.deepcopy(after.model).to(device), copy.deepcopy(after.teacher).to(device))
        metrics = step(st, torch.from_numpy(src * np.float32(scale)).to(device), torch.Generator().manual_seed(52))
        runs[name] = (float(metrics["loss"]), {n: p.grad.double().cpu() for n, p in st.model.named_parameters()
                                               if p.grad is not None})
        print(f"{name}: loss {runs[name][0]:.9f}", flush=True)

    def one_minus_cos(a: dict, b: dict) -> float:
        va, vb = (torch.cat([g[n].flatten() for n in sorted(a)]) for g in (a, b))
        return 1 - float(va @ vb / (va.norm() * vb.norm()))

    pairs = {"card_vs_cpu": ("card", "cpu"), "card_own": ("card", "card_perturbed"),
             "card_repeat": ("card", "card_repeat"), "cpu_own": ("cpu", "cpu_perturbed")}
    distances = {k: one_minus_cos(runs[a][1], runs[b][1]) for k, (a, b) in pairs.items()}
    print("1 - whole-gradient cosine: " + ", ".join(f"{k} {v:.3e}" for k, v in distances.items()))
    rows = [(n, float(runs["card"][1][n].norm()),
             *(float((runs[a][1][n] - runs[b][1][n]).norm()) for a, b in pairs.values())) for n in runs["card"][1]]
    rows.sort(key=lambda r: -r[2])
    print("parameter, |g|, then |difference| " + ", ".join(pairs))
    for r in rows[:40]:
        print(f"{r[0]} {r[1]:.3e} " + " ".join(f"{v:.3e}" for v in r[2:]))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"one_minus_cos": distances, "rows": rows}, fh)


if __name__ == "__main__":
    main()
