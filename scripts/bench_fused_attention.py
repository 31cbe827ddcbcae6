#!/usr/bin/env python3
"""Time the fused attention core (K8, ``csrc/attention.cu``) against another version of that source, on one
NVIDIA GPU.

Usage: python3 scripts/bench_fused_attention.py --baseline DIR [--out FILE.json]

``DIR`` holds the other ``attention.cu`` (for example an earlier commit's, from ``git show``), built into a
library of its own and called through the C interface it declares: ``fqss_fused_attention(q, k, v, mn, mx, out,
BH, Lq, Lk, d, quantize, n_bits, stream)`` over contiguous ``[BH, L, d]``. At the shapes of ``chip_smoke.py``'s
phase 24 (the Sepformer's intra- and inter-chunk attention and DPTNet's row and column attention at 8 x 4 s,
recomputed from the models) and ``ATTN_ODD``, on phase 24's seeded operands without the planted query, it holds
both versions' float heads to the plain version within ``ATTN_REL_TOL`` of their largest magnitude and their
quantized heads to the plain grid of their own float heads, then times them in turns (baseline, current,
current, baseline) by CUDA events: the baseline over ``[BH, L, d]``, the current kernel through the packed entry
on an in-projection's views, as QMultiheadAttention calls it (and through the ``[BH, L, d]`` entry). It prints
the times, the ratios, the shares of the float32 bound, of the 3xTF32 bound and of the bound of the current
kernel's route (``chip_smoke.attention_route_bound``), and the sums per Sepformer and per DPTNet forward.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402  (phase 24's shapes, operands, bounds and timing)
from fqss_tpu_torch.infer import disable_tf32  # noqa: E402
from fqss_tpu_torch.models.factory import create_pretrained_model  # noqa: E402
from fqss_tpu_torch.ops import _build  # noqa: E402
from fqss_tpu_torch.ops import attention as k8  # noqa: E402
from fqss_tpu_torch.ops import fake_quant as fq  # noqa: E402

TURNS = ("baseline", "current", "current", "baseline")


def baseline_library(directory: Path) -> ctypes.CDLL:
    """The other source's library, with the C interface it declares."""
    lib = ctypes.CDLL(str(_build.build((directory / "attention.cu",), "libfqss_attention_baseline").path))
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.fqss_fused_attention.argtypes = [p, p, p, p, p, p, i64, i64, i64, i32, i32, i32, p]
    lib.fqss_fused_attention.restype = i32
    return lib


def baseline_call(lib: ctypes.CDLL, qs, k, v, mn, mx, quantize: bool):
    out = torch.empty_like(qs)

    def call() -> torch.Tensor:
        rc = lib.fqss_fused_attention(qs.data_ptr(), k.data_ptr(), v.data_ptr(), mn.data_ptr(), mx.data_ptr(),
                                      out.data_ptr(), qs.shape[0], qs.shape[1], k.shape[1], qs.shape[2],
                                      int(quantize), 8, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline attention launch failed with error {rc}")
        return out
    return call


def hold(name: str, version: str, heads: torch.Tensor, quantized: torch.Tensor, ref: torch.Tensor, mn, mx) -> float:
    """The float heads within ATTN_REL_TOL of the plain version's largest magnitude, the quantized ones the plain
    grid of their own float heads; returns the float heads' relative distance."""
    err = (heads - ref).abs().max().item() / ref.abs().max().item()
    if not err <= cs.ATTN_REL_TOL:
        raise AssertionError(f"{version} K8 {name}: float heads {err:.3g} of max |heads| from the plain version's")
    if not torch.equal(quantized, fq.act_fake_quant_ref(heads, mn, mx, 8)):
        raise AssertionError(f"{version} K8 {name}: the epilogue is not the plain grid of its own float heads")
    return err


def main() -> None:
    parser = argparse.ArgumentParser(prog="python3 scripts/bench_fused_attention.py")
    parser.add_argument("--baseline", type=Path, required=True, help="directory with the other attention.cu")
    parser.add_argument("--out", type=Path, help="write the readings as JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_fused_attention: no CUDA device")
    disable_tf32()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    old = baseline_library(args.baseline.resolve())
    _build.library()
    shapes = [*cs.sepformer_attention_shapes(create_pretrained_model(cs.SEPFORMER_CFG, observer=False)),
              *cs.dptnet_attention_shapes(create_pretrained_model(cs.DPTNET_CFG, observer=False)),
              ("odd", *cs.ATTN_ODD, 0, None, 1)]
    gen = torch.Generator(device=dev).manual_seed(24)
    rows, totals = [], {}
    for name, bh, lq, lk, d, per_forward, model, h in shapes:
        qs = torch.randn(bh, lq, d, device=dev, generator=gen) * 0.3
        k, v = (torch.randn(bh, lk, d, device=dev, generator=gen) for _ in range(2))
        views = cs.packed_views(qs, k, v, h)
        with torch.no_grad():
            ref = k8.fused_attention_ref(qs, k, v, quantize=False)
            mn, mx = ref.min().reshape(1), ref.max().reshape(1)
            errs = {"baseline": hold(name, "baseline", baseline_call(old, qs, k, v, mn, mx, False)().clone(),
                                     baseline_call(old, qs, k, v, mn, mx, True)(), ref, mn, mx),
                    "current": hold(name, "current", cs.heads_of(k8.fused_attention_packed(*views, quantize=False), h),
                                    cs.heads_of(k8.fused_attention_packed(*views, mn, mx, 8), h), ref, mn, mx)}
            fns = {"baseline": baseline_call(old, qs, k, v, mn, mx, True),
                   "current": lambda: k8.fused_attention_packed(*views, mn, mx, 8)}
            got = {n: [] for n in fns}
            for turn in TURNS:
                got[turn].append(cs.cuda_ms(fns[turn], 10))
            ms = {n: sum(t) / len(t) for n, t in got.items()}
            ms["current [BH, L, d] entry"] = cs.cuda_ms(lambda: k8.fused_attention(qs, k, v, mn, mx, 8), 10)
        moved, ops = cs.attention_bound(bh, lq, lk, d)
        b, tb, rb = cs.bound_of(moved, ops, cs.F32_OPS_S), cs.route_bound(moved, ops), cs.attention_route_bound(moved, ops)
        row = dict(shape=f"{name} BH {bh} x Lq {lq} x Lk {lk} x d {d}", plan=str(k8.plan(bh, lq, lk, d)), model=model,
                   per_forward=per_forward, errors=errs, bytes=moved, ops=ops, **ms, **b, **rb,
                   tf32x3_bound_ms=tb["route_bound_ms"])
        rows.append(row)
        print(f"{row['shape']} ({row['plan']}): baseline {ms['baseline']:.4f} ms, current {ms['current']:.4f} ms "
              f"({ms['baseline'] / ms['current']:.3f}x; [BH, L, d] entry {ms['current [BH, L, d] entry']:.4f} ms); "
              f"float32 bound {b['bound_ms']:.4f} ms by {b['bound_by']}: baseline {b['bound_ms'] / ms['baseline']:.1%}, "
              f"current {b['bound_ms'] / ms['current']:.1%}; 3xTF32 bound {tb['route_bound_ms']:.4f} ms: current "
              f"{tb['route_bound_ms'] / ms['current']:.1%}; the route's bound {rb['route_bound_ms']:.4f} ms by "
              f"{rb['route_bound_by']}: current {rb['route_bound_ms'] / ms['current']:.1%}; float heads from the "
              f"plain version: baseline {errs['baseline']:.2e}, current {errs['current']:.2e} of max |heads|",
              flush=True)
        if per_forward:
            t = totals.setdefault(model, {"baseline": 0.0, "current": 0.0, "bytes": 0, "ops": 0, "launches": 0})
            for key, val in (("baseline", ms["baseline"]), ("current", ms["current"]), ("bytes", moved), ("ops", ops)):
                t[key] += per_forward * val
            t["launches"] += per_forward
        del qs, k, v, views, ref
        torch.cuda.empty_cache()
    for model, t in totals.items():
        b, tb = cs.bound_of(t["bytes"], t["ops"], cs.F32_OPS_S), cs.route_bound(t["bytes"], t["ops"])
        rb = cs.attention_route_bound(t["bytes"], t["ops"])
        t.update(**b, **rb, tf32x3_bound_ms=tb["route_bound_ms"])
        print(f"{model} forward ({t['launches']} launches): baseline {t['baseline']:.3f} ms, current "
              f"{t['current']:.3f} ms ({t['baseline'] / t['current']:.3f}x); float32 bound {b['bound_ms']:.3f} ms "
              f"({b['bound_ms'] / t['baseline']:.1%} / {b['bound_ms'] / t['current']:.1%}), 3xTF32 bound "
              f"{tb['route_bound_ms']:.3f} ms ({tb['route_bound_ms'] / t['current']:.1%} current), the route's "
              f"{rb['route_bound_ms']:.3f} ms ({rb['route_bound_ms'] / t['current']:.1%} current)", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"device": smi, "rows": rows, "totals": totals}, indent=1))


if __name__ == "__main__":
    main()
