#!/usr/bin/env python3
"""Time the serving forwards of a checkout of this repository, on one NVIDIA GPU.

Usage: python3 scripts/time_forwards.py [ROOT]

Imports ``chip_smoke`` and the port from ROOT (default: the checkout this
script lies in), builds its kernels there, and times by CUDA events the
full-width forwards of ``chip_smoke.py``'s models with their seeded weights:
DPTNet (fake_quant and the float32 int8 engine, 8 x 4 s, 5 forwards), the
Sepformer (the same, 8 x 4 s) and the ConvTasNet's float32 int8 engine
(32 x 12 s, 3 forwards), each after one warm-up. Prints one JSON line of
milliseconds per forward. To compare two commits on one card, unpack the
other with ``git archive`` into a gitignored directory and run both in turns
in one call: ``for r in OLD . . OLD; do python3 scripts/time_forwards.py $r;
done``.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.join(os.path.dirname(__file__), ".."))
os.chdir(ROOT)
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402  (the models, sizes and timing of the checkout at ROOT)
from fqss_tpu_torch.infer import disable_tf32  # noqa: E402
from fqss_tpu_torch.serve import make_int8_engine  # noqa: E402


def forward_ms(engine, x: torch.Tensor, n: int) -> float:
    def forward():
        with torch.inference_mode():
            return engine(x)
    return cs.cuda_ms(forward, n)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("time_forwards: no CUDA device")
    disable_tf32()
    dev = torch.device("cuda", 0)
    out = {"root": ROOT, "device": torch.cuda.get_device_name(0)}
    mix, _ = cs.synth_batch(np.random.default_rng(18), cs.DPT_BATCH, 2, cs.DPT_SEG)
    model, x = cs.build_served_dptnet(dev, mix[:2]), torch.from_numpy(mix).to(dev)
    out["dptnet_fake_quant"] = forward_ms(model, x, 5)
    out["dptnet_int8_float32"] = forward_ms(make_int8_engine(model, compute_dtype="float32"), x, 5)
    del model
    torch.cuda.empty_cache()
    mix, _ = cs.synth_batch(np.random.default_rng(25), cs.SEP_BATCH, 2, cs.SEP_SEG)
    model, x = cs.build_served_sepformer(dev, mix[:2]), torch.from_numpy(mix).to(dev)
    out["sepformer_fake_quant"] = forward_ms(model, x, 5)
    out["sepformer_int8_float32"] = forward_ms(make_int8_engine(model, compute_dtype="float32"), x, 5)
    del model
    torch.cuda.empty_cache()
    mix, _ = cs.synth_batch(np.random.default_rng(0), cs.BATCH, 2, cs.SEG)
    model, x = cs.build_served_model(dev, mix[:4]), torch.from_numpy(mix).to(dev)
    out["convtasnet_int8_float32"] = forward_ms(make_int8_engine(model, compute_dtype="float32"), x, 3)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
