#!/usr/bin/env python3
"""Time the fused QAT dense kernels (K5, K5-bwd, K3) of ``csrc/qat_dense.cu``
against another version of that source, on one NVIDIA GPU.

Usage: python3 scripts/bench_qat_dense.py [--baseline OLD.cu] [--out FILE.json]

Builds the kernel library from ``fqss_tpu_torch/csrc`` and, with
``--baseline``, a second library from the same sources with ``qat_dense.cu``
replaced by ``OLD.cu`` (it must keep the C interface). At the shapes of
``chip_smoke.py``'s phases 31 and 37 (the QDense layers of one DPTNet and one
Sepformer KD step at the training batch, the Sepformer's 8 x 4 s serving
shapes, and K3's two 1x1 convolutions of the 8 x 4 s serving forwards) it
times K5 (``qat_dense``, both grids on), K5-bwd (``qat_dense_bwd``: mask,
dx, dwq and K2-bwd) and K3 (``qmatmul``) through the port's own wrappers,
each library in turn (baseline, current, current, baseline): the call's time
by CUDA events over 10 back-to-back calls (which the host sets where a call's
kernels take less than its Python), and its device time, the sum of its
kernels' durations in a ``torch.profiler`` trace of 5 calls. It prints each,
the ratios and the achieved rates. The baseline's outputs are held to the
current one's within ``DENSE_RTOL`` of the sum of the terms' magnitudes
first. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402  (the shapes, cases and timing of phases 31 and 37)
from fqss_tpu_torch.infer import disable_tf32  # noqa: E402
from fqss_tpu_torch.ops import _build  # noqa: E402
from fqss_tpu_torch.ops import qat_dense as qd  # noqa: E402
from fqss_tpu_torch.ops import qmatmul as qm  # noqa: E402

# K3's (B, K, T, N) in the 8 x 4 s serving forwards (phase 37 reads them from the models): DPTNet's BN and the
# Sepformer masker's conv1d.
K3_SHAPES = (("DPTNet BN", 8, 256, 31999, 64), ("Sepformer masker conv1d", 8, 256, 3999, 256))
TURNS = ("baseline", "current", "current", "baseline")


def device_ms(fn, n: int) -> float:
    """The summed kernel time of one fn() call, from a profiler trace of n calls."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()) / n / 1e3


def timed(libs: dict, fn, n: int) -> dict:
    """Milliseconds of fn() (CUDA events) and its device time ("device_" + name) with each library in the order
    of TURNS, averaged per library."""
    times = {name: [] for name in libs}
    dev = {name: [] for name in libs}
    for name in (TURNS if len(libs) == 2 else ("current",)):
        _build._lib = libs[name]
        times[name].append(cs.cuda_ms(fn, n))
        dev[name].append(device_ms(fn, 5))
    _build._lib = libs["current"]
    return {**{name: sum(v) / len(v) for name, v in times.items()},
            **{f"device_{name}": sum(v) / len(v) for name, v in dev.items()}}


def agree(libs: dict, fn, bound: torch.Tensor) -> float:
    """The largest |baseline - current| / (DENSE_RTOL sum |term|) of fn()'s first output."""
    if len(libs) == 1:
        return 0.0
    outs = {}
    for name, lib in libs.items():
        _build._lib = lib
        out = fn()
        outs[name] = out[0] if isinstance(out, tuple) else out
    _build._lib = libs["current"]
    return ((outs["baseline"] - outs["current"]).abs() / (cs.DENSE_RTOL * bound).clamp_min(1e-30)).max().item()


def main() -> None:
    parser = argparse.ArgumentParser(prog="python3 scripts/bench_qat_dense.py")
    parser.add_argument("--baseline", type=Path, help="another qat_dense.cu to time against the current one")
    parser.add_argument("--out", type=Path, help="write the readings as JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_qat_dense: no CUDA device")
    disable_tf32()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    libs = {"current": _build.library()}
    if args.baseline is not None:
        sources = tuple(args.baseline.resolve() if s.name == "qat_dense.cu" else s for s in _build.SOURCES)
        libs["baseline"] = _build.load(_build.build(sources, "libfqss_baseline").path)
    gen = torch.Generator(device=dev).manual_seed(8)
    shapes = cs.dense_train_shapes(cs.DPT_TRAIN_SEG, cs.SEP_TRAIN_SEG)
    serving = [(f"Sepformer {name} 8 x 4 s", cs.SEP_BATCH * m, k, n, 0) for name, m, k, n, _ in
               (s for s in shapes if s[0] in ("Sepformer ffn_in", "Sepformer ffn_out"))]
    rows, totals = [], {}
    for name, m, k, n, per_forward in [*shapes, *serving]:
        x, w, b, w_mn, w_mx, a_mn, a_mx = cs.dense_case(dev, m, k, n, gen)
        g = torch.randn(m, n, device=dev, generator=gen)
        wq = qd._weight_q(w, w_mn, w_mx, 8, None)
        # (timed call, the call whose first output the two libraries are held to each other on: the act grid off,
        # so that a rounding flip of the act mask does not count, and the bound of that output)
        kernels = {"K5": (lambda: qd.qat_dense(x, w, b, w_mn, w_mx, a_mn, a_mx),
                          lambda: qd.qat_dense(x, w, b, w_mn, w_mx), x.abs() @ wq.abs().t()),
                   "K5-bwd": (lambda: qd.qat_dense_bwd(x, w, b, g, w_mn, w_mx, a_mn, a_mx),
                              lambda: qd.qat_dense_bwd(x, w, b, g, w_mn, w_mx), g.abs() @ wq.abs())}
        (fb, fo), (bb, bo) = cs.dense_bounds(m, k, n)
        for kernel, (fn, held, bound) in kernels.items():
            err = agree(libs, held, bound)
            ms = timed(libs, fn, 10)
            ops = fo if kernel == "K5" else bo
            rows.append(dict(kernel=kernel, shape=name, m=m, k=k, n=n, per_forward=per_forward, ops=ops,
                             bytes=fb if kernel == "K5" else bb, agree=err, **ms))
            totals.setdefault(kernel, {}).update(
                {lib: totals.get(kernel, {}).get(lib, 0.0) + per_forward * t for lib, t in ms.items()})
        del x, w, b, g, wq
        torch.cuda.empty_cache()
    for name, bb_, k, t, n in K3_SHAPES:
        x, w, w_mn, w_mx, a_mn, a_mx = cs.qmatmul_case(dev, bb_, k, t, n, gen)
        wq = qd._weight_q(w, w_mn, w_mx, 8, None)
        err = agree(libs, lambda: qm.qmatmul(x, w, w_mn, w_mx, None, None), wq.abs() @ x.abs())
        ms = timed(libs, lambda: qm.qmatmul(x, w, w_mn, w_mx, a_mn, a_mx), 10)
        nbytes, ops = cs.qmatmul_bound(bb_, k, t, n)
        rows.append(dict(kernel="K3", shape=name, b=bb_, k=k, t=t, n=n, per_forward=1, ops=ops, bytes=nbytes,
                         agree=err, **ms))
        totals.setdefault("K3", {}).update({lib: totals.get("K3", {}).get(lib, 0.0) + v for lib, v in ms.items()})
        del x, w, wq
        torch.cuda.empty_cache()
    for row in rows:
        line = (f"{row['kernel']} {row['shape']}: current {row['current']:.4f} ms, device {row['device_current']:.4f} "
                f"({row['ops'] / row['device_current'] / 1e9:.1f} TFLOP/s)")
        if "baseline" in row:
            line += (f"; baseline {row['baseline']:.4f} ms, device {row['device_baseline']:.4f} "
                     f"({row['ops'] / row['device_baseline'] / 1e9:.1f} TFLOP/s); baseline / current "
                     f"{row['baseline'] / row['current']:.3f}, device "
                     f"{row['device_baseline'] / row['device_current']:.3f}; "
                     f"outputs within {row['agree']:.3f} of DENSE_RTOL sum |term| of each other")
        print(line, flush=True)
    for kernel, t in totals.items():
        line = (f"{kernel} per DPTNet + Sepformer step or forward: current {t['current']:.3f} ms, device "
                f"{t['device_current']:.3f}")
        if "baseline" in t:
            line += (f"; baseline {t['baseline']:.3f} ms, device {t['device_baseline']:.3f}; baseline / current "
                     f"{t['baseline'] / t['current']:.3f}, device {t['device_baseline'] / t['device_current']:.3f}")
        print(line, flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"device": smi, "rows": rows, "totals": totals}, indent=1))


if __name__ == "__main__":
    main()
