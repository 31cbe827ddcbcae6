#!/usr/bin/env python3
"""Time the LSTM recurrence (K7/K6, ``csrc/lstm.cu``) and the int8 requantizing
matmul (K4, ``csrc/int8_matmul.cu``) against other versions of those sources,
on one NVIDIA GPU.

Usage: python3 scripts/bench_lstm_int8.py --baseline DIR [--lstm-only] [--out FILE.json]

``DIR`` holds the other ``lstm.cu`` and ``int8_matmul.cu`` (for example an
earlier commit's, from ``git show``); they are built into a library of their
own and called through the C interface they had before the cluster and
persistent routes: ``fqss_lstm_recurrence`` (any H) and
``fqss_int8_matmul_requant`` without the grid argument; an ``lstm.cu`` that
has the cluster route (``fqss_lstm_cluster``) is called there, on the plan the
current wrapper takes. At the shapes of
``chip_smoke.py``'s phases 12 (ConvTasNet's int8 engine), 17 (DPTNet's row and
column LSTMs at 8 x 4 s and those of a streamed 16000-sample window at batch
1), 22 (the DPTNet int8 engine) and 29 (the Sepformer int8 engine), it first
holds the two versions' outputs to each other (``torch.equal``: the two LSTM
kernels sum in the same order, and K4's outputs are exact), then times each in
turns (baseline, current, current, baseline) by CUDA events and prints the
times, the ratios, the share of each bound and the sums per forward. Both K4
kernels are called through ctypes into preallocated outputs, without the
wrapper, whose host time would set the time of the smallest launches.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402  (the shapes, cases, bounds and timing of phases 12, 17, 22 and 29)
from fqss_tpu_torch.infer import disable_tf32  # noqa: E402
from fqss_tpu_torch.models.factory import create_pretrained_model  # noqa: E402
from fqss_tpu_torch.ops import _build  # noqa: E402
from fqss_tpu_torch.ops import int8_matmul as im  # noqa: E402
from fqss_tpu_torch.ops import lstm as lk  # noqa: E402

TURNS = ("baseline", "current", "current", "baseline")


def baseline_library(directory: Path) -> ctypes.CDLL:
    """The other sources' library, with the C interface they declare."""
    lib = ctypes.CDLL(str(_build.build((directory / "lstm.cu", directory / "int8_matmul.cu"),
                                       "libfqss_baseline").path))
    p, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    lib.fqss_lstm_recurrence.argtypes = [p, p, p, p, p, p, i32, i64, i64, i64, p]
    lib.fqss_lstm_recurrence.restype = i32
    lib.fqss_int8_matmul_requant.argtypes = [p, p, p, p, i32, f32, f32, f32, f32, f32, f32, f32, i64, p, i64, i64,
                                             i64, p]
    lib.fqss_int8_matmul_requant.restype = i32
    if hasattr(lib, "fqss_lstm_cluster"):
        lib.fqss_lstm_cluster.argtypes = [p, p, p, p, p, p, i32, i64, i64, i64, i32, i32, p]
        lib.fqss_lstm_cluster.restype = i32
    return lib


def baseline_lstm(lib: ctypes.CDLL, ih: list, w: list) -> list:
    T, B, G = ih[0].shape
    outs = [torch.empty(T, B, G // 4, device=ih[0].device) for _ in ih]
    ptrs = (ih[0].data_ptr(), w[0].data_ptr(), outs[0].data_ptr(), ih[-1].data_ptr(), w[-1].data_ptr(),
            outs[-1].data_ptr(), len(ih), T, B, G // 4)
    stream = torch.cuda.current_stream().cuda_stream
    if hasattr(lib, "fqss_lstm_cluster"):  # the cluster route, on the current wrapper's plan
        p = lk.launch_plan(ih[0].device, B, G // 4, len(ih))
        rc = lib.fqss_lstm_cluster(*ptrs, p.cluster, p.rows, stream)
    else:
        rc = lib.fqss_lstm_recurrence(*ptrs, stream)
    if rc != 0:
        raise RuntimeError(f"baseline LSTM launch failed with error {rc}")
    return outs


def int8_launch(lib: ctypes.CDLL, xs, w, scale, corr, alpha, delta, mn, nl, *grid):
    """A call of lib's fqss_int8_matmul_requant into a preallocated output, bypassing the wrapper's checks (its
    host time, ~30 us, would set the time of the smallest launches); ``grid``: the current kernel's blocks."""
    deltas, mns = im._grids(delta, mn, w.shape[0])
    grids = [x for pair in zip(deltas, mns) for x in pair] + [1.0, 0.0] * (im.MAX_GRIDS - len(deltas))
    out = torch.empty(xs.shape[0], w.shape[0], dtype=torch.int8, device=xs.device)
    args = (xs.data_ptr(), w.data_ptr(), scale.data_ptr(), corr.data_ptr(), im.NLS.index(nl), alpha, *grids,
            w.shape[0] // len(deltas), out.data_ptr(), xs.shape[0], w.shape[0], xs.shape[1], *grid,
            torch.cuda.current_stream().cuda_stream)

    def call() -> torch.Tensor:
        rc = lib.fqss_int8_matmul_requant(*args)
        if rc != 0:
            raise RuntimeError(f"int8 launch failed with error {rc}")
        return out
    return call


def in_turns(fns: dict, n: int) -> dict:
    """Milliseconds of each of fns["baseline"] and fns["current"], timed in the order of TURNS, averaged."""
    got = {name: [] for name in fns}
    for name in TURNS:
        got[name].append(cs.cuda_ms(fns[name], n))
    return {name: sum(v) / len(v) for name, v in got.items()}


def main() -> None:
    parser = argparse.ArgumentParser(prog="python3 scripts/bench_lstm_int8.py")
    parser.add_argument("--baseline", type=Path, required=True, help="directory with the other lstm.cu and "
                        "int8_matmul.cu")
    parser.add_argument("--out", type=Path, help="write the readings as JSON here")
    parser.add_argument("--lstm-only", action="store_true", help="time the LSTM kernels alone (a baseline "
                        "int8_matmul.cu of PR 9 or later takes the grid argument, which this script does not pass)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_lstm_int8: no CUDA device")
    disable_tf32()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    old = baseline_library(args.baseline.resolve())
    _build.library()
    dpt = create_pretrained_model(cs.DPTNET_CFG, observer=False)
    sep = create_pretrained_model(cs.SEPFORMER_CFG, observer=False)
    shapes = cs.dpt_lstm_shapes(cs.DPT_BATCH, cs.DPT_SEG, dpt)
    stream = [(f"stream {side}", T, B, H) for side, T, B, H in cs.dpt_lstm_shapes(1, cs.STREAM_SEGMENT, dpt)]
    gen = torch.Generator(device=dev).manual_seed(9)
    rows, totals = [], {}
    for side, T, B, H in [*shapes, *stream]:
        ih = [torch.randn(T, B, 4 * H, device=dev, generator=gen) * 0.5 for _ in range(2)]
        w = [(torch.rand(H, 4 * H, device=dev, generator=gen) * 2 - 1) / math.sqrt(H) for _ in range(2)]
        for kernel, dirs in (("K7", 2), ("K6", 1)):
            new = (lambda: lk.bilstm_sequence(ih[0], ih[1], w[0], w[1])) if dirs == 2 else \
                (lambda: (lk.lstm_sequence(ih[0], w[0]),))
            with torch.no_grad():
                if not all(torch.equal(a, b) for a, b in zip(new(), baseline_lstm(old, ih[:dirs], w[:dirs]))):
                    raise AssertionError(f"{kernel} {side}: the two versions differ")
                ms = in_turns({"baseline": lambda: baseline_lstm(old, ih[:dirs], w[:dirs]), "current": new}, 10)
            b = cs.bound_of(*cs.lstm_bound(dirs, T, B, H), cs.F32_OPS_S)
            per_forward = dpt.layer if kernel == "K7" and not side.startswith("stream") else 0
            rows.append(dict(kernel=kernel, shape=f"{side} T {T} x B' {B} x H {H}", per_forward=per_forward,
                             plan=str(lk.launch_plan(dev, B, H, dirs)), **ms, **b))
        del ih, w
        torch.cuda.empty_cache()
    one = (cs.INT8_TIE_DELTA, cs.INT8_TIE_MN)
    int8_cases = {} if args.lstm_only else {
        "ConvTasNet": [(cs.INT8_ROWS, k, n, "prelu", 0.25, one, f"{k} -> {n}", per_forward)
                       for k, n, per_forward in cs.INT8_SHAPES],
        "DPTNet": cs.dptnet_int8_cases(dpt, shapes), "Sepformer": cs.sepformer_int8_cases(sep)}
    for engine, cases in int8_cases.items():
        for m, k, n, nl, alpha, grids, what, per_forward in cases:
            xs, w, scale, corr = cs.int8_case(dev, m, k, n, gen)
            if nl != "prelu":
                scale = scale * 0.05
            call = (xs, w, scale, corr, alpha, *grids)
            fns = {"baseline": int8_launch(old, *call, nl),
                   "current": int8_launch(_build.library(), *call, nl, im._blocks(dev, m, n, k))}
            want = im.int8_matmul_requant(*call, nl=nl)
            if not (torch.equal(want, fns["baseline"]()) and torch.equal(want, fns["current"]())):
                raise AssertionError(f"K4 {engine} {what}: the two versions differ")
            ms = in_turns(fns, 20)
            moved, ops = cs.int8_bound(m, k, n)
            rows.append(dict(kernel=f"K4 {engine}", shape=f"{what} [{m},{k}] x [{n},{k}] {nl}",
                             per_forward=per_forward, bytes=moved, **ms, **cs.bound_of(moved, ops, cs.INT8_OPS_S)))
            del xs, w, scale, corr, call, fns, want
            torch.cuda.empty_cache()
    for row in rows:
        line = (f"{row['kernel']} {row['shape']}: baseline {row['baseline']:.4f} ms, current {row['current']:.4f} ms "
                f"({row['baseline'] / row['current']:.3f}x; {row['bound_ms'] / row['current']:.1%} of its "
                f"{row['bound_ms']:.4f} ms bound by {row['bound_by']}")
        line += f", {row['bytes'] / row['current'] / 1e6:.0f} GB/s)" if "bytes" in row else f"; {row['plan']})"
        print(line, flush=True)
        if row["per_forward"]:
            t = totals.setdefault(row["kernel"], {"baseline": 0.0, "current": 0.0, "bound_ms": 0.0, "launches": 0})
            for key in ("baseline", "current", "bound_ms"):
                t[key] += row["per_forward"] * row[key]
            t["launches"] += row["per_forward"]
    for kernel, t in totals.items():
        print(f"{kernel} per forward ({t['launches']} launches): baseline {t['baseline']:.3f} ms, current "
              f"{t['current']:.3f} ms ({t['baseline'] / t['current']:.3f}x), bound {t['bound_ms']:.3f} ms "
              f"({t['bound_ms'] / t['current']:.1%})", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"device": smi, "rows": rows, "totals": totals}, indent=1))


if __name__ == "__main__":
    main()
