#!/usr/bin/env python3
"""Where the time of the port's KD train step goes, on one NVIDIA GPU.

Usage: python3 scripts/profile_torch_train.py [--model dptnet|sepformer] [--batch B]

Builds the full-width student and float teacher of ``chip_smoke.py``'s phase
33 (the config's ``model_cfg`` through ``create_model_and_teacher``, the
observer window cut to 3 steps), takes 4 KD steps of B x 3 s (DPTNet) or
B x 4 s (the Sepformer) so that the window is closed, times 3 more with CUDA
events and traces one with ``torch.profiler``: the device time by the
operator that launched it, the union of the kernel intervals (busy time)
against the step's wall time, and the step's kernel launches. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402  (the training path's configs and helpers)
from fqss_tpu_torch.infer import disable_tf32  # noqa: E402
from fqss_tpu_torch.models.factory import create_model_and_teacher  # noqa: E402
from fqss_tpu_torch.train.trainer import TrainConfig, make_train_step  # noqa: E402
from profile_torch_engines import TOP, busy_ms  # noqa: E402


def main() -> None:
    parser = argparse.ArgumentParser(prog="python3 scripts/profile_torch_train.py")
    parser.add_argument("--model", choices=("dptnet", "sepformer"), default="sepformer")
    parser.add_argument("--batch", type=int, default=1)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: no CUDA device")
    dev = torch.device("cuda", 0)
    disable_tf32()
    cfg, seg = ((chip_smoke.DPTNET_CFG, chip_smoke.DPT_TRAIN_SEG) if args.model == "dptnet"
                else (chip_smoke.SEPFORMER_CFG, chip_smoke.SEP_TRAIN_SEG))
    model, teacher = create_model_and_teacher(chip_smoke.train_cfg(cfg), generator=torch.Generator().manual_seed(33))
    state = chip_smoke.new_train_state(model.to(dev), teacher.to(dev))
    step = make_train_step(TrainConfig())
    mix, src = chip_smoke.synth_batch(np.random.default_rng(35), args.batch, 2, seg)
    x, s = torch.from_numpy(mix).to(dev), torch.from_numpy(src).to(dev)
    for _ in range(chip_smoke.TRAIN_MODELS_WINDOW + 1):
        step(state, x, s)
    ms = chip_smoke.cuda_ms(lambda: step(state, x, s), 3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, x, s)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.time_range.end - e.time_range.start for e in kernels) / 1e3
    busy = busy_ms(events)
    print(torch.cuda.get_device_name(0))
    print(f"== {args.model} KD train step {args.batch} x {seg // chip_smoke.SR} s: {ms:.1f} ms (CUDA events, 3 after "
          f"warm-up); profiled step: wall {wall:.1f} ms, {len(kernels)} kernels, device time {device_ms:.1f} ms, busy "
          f"(union) {busy:.1f} ms, idle {1 - busy / wall:.1%} of the wall")
    # device time by the operator that launched it (its own kernels, not its children's)
    rows = [(getattr(r, "self_device_time_total", 0) / 1e3, r.count, r.key) for r in prof.key_averages()]
    for total, count, key in sorted(rows, reverse=True)[:TOP]:
        if total > 0:
            print(f"   {total:9.2f} ms {total / device_ms:6.1%} {count:5d} x  {key[:100]}")


if __name__ == "__main__":
    main()
