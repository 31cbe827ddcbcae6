#!/usr/bin/env python3
"""How far ConvTasNet-music's card and CPU forwards part, and how far the card parts from itself, on one NVIDIA GPU.

Usage: python3 scripts/music_noise_floor.py [--out FILE]

Builds the full-width ConvTasNet-music of ``chip_smoke.py`` phase 44
(``configs/convtasnet_music.yaml``'s model, seeded weights, ranges from the
config's 50-step observer window) and runs one 10 s stereo chunk through it
on the card, on the CPU on the same weights, and on the card again with the
chunk times (1 + 2^-22). For every activation quantizer (and every K3 conv,
whose grid the kernel applies) it prints the share of outputs more than half
a grid step apart and the SNR, card against CPU and card against its own
perturbed run, then the same distances at the output. Then a depth sweep:
for models of 1, 3, 6, 10, 20 and 40 blocks (the same width), the fake-quant
forward's and the int8 engines' card-vs-CPU SNR on 1 x 2 s. ``--out`` also
writes the per-layer lines to FILE.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the music phases' model, sizes and helpers)
from fqss_tpu_torch.infer import disable_tf32  # noqa: E402
from fqss_tpu_torch.nn.layers import QConv1d  # noqa: E402
from fqss_tpu_torch.quant.quantizers import ActQuantizer  # noqa: E402
from fqss_tpu_torch.serve import make_int8_engine  # noqa: E402

DEPTHS = ({"n_repeats": 1, "n_blocks": 1}, {"n_repeats": 1, "n_blocks": 3}, {"n_repeats": 1, "n_blocks": 6},
          {"n_repeats": 1}, {"n_repeats": 2}, {})


def record_outputs(model) -> dict:
    """Hooks that keep each quantized output of ``model``'s last forward on the CPU, by module name."""
    seen = {}
    for name, m in model.named_modules():
        if isinstance(m, ActQuantizer) or (isinstance(m, QConv1d) and m.fused):
            key = f"{name}(K3)" if isinstance(m, QConv1d) else name
            m.register_forward_hook(lambda mod, args, out, key=key: seen.__setitem__(key, out.detach().float().cpu()))
    return seen


def grid_step(model, key: str) -> float:
    q = model.get_submodule(key[:-4] + ".activation_fake_quantize" if key.endswith("(K3)") else key)
    return float(q.max_range.detach() - q.min_range.detach()) / 255


def distance(ref: torch.Tensor, other: torch.Tensor, step: float) -> str:
    d = (other - ref).abs()
    snr = 10 * torch.log10(ref.pow(2).sum() / d.pow(2).sum().clamp_min(1e-30)).item()
    return f"{(d > 0.5 * step).float().mean().item():.2e} apart, {snr:.1f} dB"


def main() -> None:
    parser = argparse.ArgumentParser(prog="python3 scripts/music_noise_floor.py")
    parser.add_argument("--out", default=None, help="also write the per-layer lines to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("music_noise_floor: no CUDA device")
    dev = torch.device("cuda", 0)
    disable_tf32()
    out = open(args.out, "w") if args.out else None

    def emit(line: str) -> None:
        print(line, flush=True)
        if out is not None:
            print(line, file=out, flush=True)

    emit(torch.cuda.get_device_name(0))
    served = chip_smoke.build_served_music(dev)
    cpu = chip_smoke.music_on_cpu(served)
    x = torch.from_numpy(chip_smoke.music_mix(45, 1, chip_smoke.MUSIC_SEG))
    card_seen, cpu_seen = record_outputs(served), record_outputs(cpu)
    with torch.inference_mode():
        y_own = served((x * (1 + chip_smoke.MUSIC_PERTURB)).to(dev)).cpu()
        own_seen = dict(card_seen)
        y_card, y_cpu = served(x.to(dev)).cpu(), cpu(x)
    step = chip_smoke.out_step(served)
    emit(f"output (1 x {chip_smoke.MUSIC_SEG}, rms {y_cpu.pow(2).mean().sqrt().item() / step:.2f} steps): card vs CPU "
         f"{distance(y_cpu, y_card, step)}; card vs card x (1 + 2^-22) {distance(y_card, y_own, step)}")
    for key in card_seen:
        s = grid_step(served, key)
        emit(f"{key:60s} card vs CPU {distance(cpu_seen[key], card_seen[key], s)}; card vs card x (1 + 2^-22) "
             f"{distance(card_seen[key], own_seen[key], s)}")
    del served, cpu, card_seen, cpu_seen, own_seen
    torch.cuda.empty_cache()

    x2 = torch.from_numpy(chip_smoke.music_mix(45, 1, chip_smoke.MUSIC_CPU_SEG)).to(dev)
    for arch in DEPTHS:
        served = chip_smoke.build_served_music(dev, **arch)
        cpu = chip_smoke.music_on_cpu(served)
        step = chip_smoke.out_step(served)
        with torch.inference_mode():
            line = [f"{len(served.separator.blocks):2d} blocks: fake_quant card vs CPU "
                    f"{distance(cpu(x2.cpu()), served(x2).cpu(), step)}"]
        for dtype in ("float32", "bfloat16"):
            want = make_int8_engine(cpu, compute_dtype=dtype)(x2.cpu())
            line.append(f"int8 {dtype} {distance(want, make_int8_engine(served, compute_dtype=dtype)(x2).cpu(), step)}")
        emit("; ".join(line))
        del served, cpu
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
