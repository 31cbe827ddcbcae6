#!/usr/bin/env python3
"""Where the device time of the port's serving engines goes, on one NVIDIA GPU.

Usage: python3 scripts/profile_torch_engines.py [--model convtasnet|dptnet|sepformer|music|htdemucs] [--show OP ...]

Builds the full-width FQSS-8bit model of ``chip_smoke.py`` (seeded weights):
the ConvTasNet of phase 3 at 32 x 12 s, ranges from a 3-step observer pass,
the DPTNet of phase 18 at 8 x 4 s, ranges from the config's 50-step
observer window (``chip_smoke.DPT_OBSERVE_STEPS``), or the Sepformer of
phase 25 at 8 x 4 s, ranges from its config's 50-step window
(``chip_smoke.SEP_OBSERVE_STEPS``), or ConvTasNet-music of phase 44 at one
OLA batch of 8 x 441,000 stereo samples, ranges from its config's 50-step
window (``chip_smoke.MUSIC_OBSERVE``), or HTDemucs of phase 54 at one OLA
batch of 8 x 343,980 stereo samples (``train=False``: padded to 441,000),
ranges from its config's 50-step window (``chip_smoke.HTD_OBSERVE``). Then for each engine (fake_quant,
folded, int8 with float32 and with bfloat16 float products) it times
forwards with CUDA events and traces one with ``torch.profiler``: the device
time by the operator that launched it, the union of the kernel intervals
(busy time) against the profiled forward's wall time, and the forward's
kernel launches. ``--show`` names operators (e.g. ``aten::copy_``) printed
even when they fall below the top 15. Needs a CUDA device; prints one block
per engine.
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

import chip_smoke  # noqa: E402  (the main path's model, sizes and timing helpers)
from fqss_tpu_torch.infer import disable_tf32  # noqa: E402
from fqss_tpu_torch.serve import fold_quantized_weights, make_int8_engine  # noqa: E402


def busy_ms(events) -> float:
    """The union of the device kernels' intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    total, end = 0, None
    for start, stop in spans:
        if end is None or start > end:
            total += stop - start
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total / 1e3


TOP = 15  # operators listed per engine


def main() -> None:
    parser = argparse.ArgumentParser(prog="python3 scripts/profile_torch_engines.py")
    parser.add_argument("--model", choices=("convtasnet", "dptnet", "sepformer", "music", "htdemucs"), default="convtasnet")
    parser.add_argument("--show", nargs="*", default=[], help="operators to print wherever they rank")
    args = parser.parse_args()
    model = args.model
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_engines: no CUDA device")
    dev = torch.device("cuda", 0)
    disable_tf32()
    if model == "convtasnet":
        batch, seg = chip_smoke.BATCH, chip_smoke.SEG
        mix, _ = chip_smoke.synth_batch(np.random.default_rng(0), batch, 2, seg)
        served = chip_smoke.build_served_model(dev, mix[:4])
    elif model == "dptnet":
        batch, seg = chip_smoke.DPT_BATCH, chip_smoke.DPT_SEG
        mix, _ = chip_smoke.synth_batch(np.random.default_rng(18), batch, 2, seg)
        served = chip_smoke.build_served_dptnet(dev, mix[:2])
    elif model == "sepformer":
        batch, seg = chip_smoke.SEP_BATCH, chip_smoke.SEP_SEG
        mix, _ = chip_smoke.synth_batch(np.random.default_rng(25), batch, 2, seg)
        served = chip_smoke.build_served_sepformer(dev, mix[:2])
    elif model == "music":
        batch, seg = chip_smoke.MUSIC_BATCH, chip_smoke.MUSIC_SEG
        mix = chip_smoke.music_mix(45, batch, seg)
        served = chip_smoke.build_served_music(dev)
    else:
        batch, seg = chip_smoke.HTD_BATCH, chip_smoke.HTD_SEG
        mix = chip_smoke.htdemucs_mix(55, batch, seg)
        served = chip_smoke.build_served_htdemucs(dev)
    sr = {"music": chip_smoke.MUSIC_SR, "htdemucs": chip_smoke.HTD_SR}.get(model, chip_smoke.SR)
    kwargs = {"train": False} if model == "htdemucs" else {}  # HTDemucs serves as evaluation runs it
    x = torch.from_numpy(mix).to(dev)
    builders = {
        "fake_quant": lambda: served,
        "folded": lambda: fold_quantized_weights(served),
        "int8_float32": lambda: make_int8_engine(served, compute_dtype="float32"),
        "int8_bfloat16": lambda: make_int8_engine(served, compute_dtype="bfloat16"),
    }
    print(torch.cuda.get_device_name(0))
    for name, build in builders.items():
        engine = build()

        def forward():
            with torch.inference_mode():
                return engine(x, **kwargs)

        ms = chip_smoke.cuda_ms(forward, 3)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            forward()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = prof.events()
        kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        device_ms = sum(e.time_range.end - e.time_range.start for e in kernels) / 1e3
        busy = busy_ms(events)
        print(f"== {model} {name}: {ms:.1f} ms per forward of {batch} x {seg / sr:g} s "
              f"(CUDA events, 3 after 1 warm-up); profiled forward: wall {wall:.1f} ms, {len(kernels)} kernels, "
              f"device time {device_ms:.1f} ms, busy (union) {busy:.1f} ms, idle {1 - busy / wall:.1%} of the wall")
        # device time by the operator that launched it (its own kernels, not its children's)
        rows = [(getattr(r, "self_device_time_total", 0) / 1e3, r.count, r.key) for r in prof.key_averages()]
        ranked = sorted(rows, reverse=True)
        shown = ranked[:TOP] + [r for r in ranked[TOP:] if r[2] in args.show]
        for total, count, key in shown:
            if total > 0 or key in args.show:
                print(f"   {total:9.2f} ms {total / device_ms:6.1%} {count:5d} x  {key[:100]}")
        del engine
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
