#!/usr/bin/env python3
"""Print how far the port's DPTNet int8 engine is from the JAX package's, on the CPU.

Usage: JAX_PLATFORMS=cpu python scripts/dptnet_int8_vs_jax.py     (from the repository root)

Runs the comparison of ``tests/test_torch_dptnet.py`` (its tiny calibrated
DPTNet, the JAX engine compiled with XLA's algebraic simplifier off) for
each compute dtype, and prints the SNR of each output in dB, the share of
samples more than half an output step apart and the mean |difference| in
output steps: the readings that the test's ``JAX_BOUND`` is set from. It
also prints the fake-quant forwards' distance, port against JAX, for
comparison. Takes about 30 s.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "tests")]

import test_torch_dptnet as t  # noqa: E402


def report(name: str, want: np.ndarray, got: np.ndarray, lsb: float) -> None:
    diff = np.abs(got - want) / lsb
    print(f"{name}: SNR {' '.join(f'{v:.2f}' for v in t._snr_db(want, got).ravel())} dB, "
          f"{(diff > 0.5).mean():.5f} of samples > 0.5 step apart, mean {diff.mean():.6f} steps", flush=True)


def main() -> None:
    jm, variables, port, mix = t.calibrated.__wrapped__()
    lsb, x = t._out_lsb(port), jnp.asarray(mix)
    want = np.asarray(jax.jit(jm.apply).lower(variables, x).compile(compiler_options=t.ALGSIMP_OFF)(variables, x))
    report("fake-quant forward", want, t._forward(port, mix), lsb)
    for dtype in ("float32", "bfloat16"):
        engine = t.JaxEngine(jm, variables, compute_dtype=dtype)
        want = np.asarray(jax.jit(engine._forward).lower(x).compile(compiler_options=t.ALGSIMP_OFF)(x))
        got = t.DPTNetInt8Engine(port, compute_dtype=dtype)(torch.from_numpy(mix)).numpy()
        report(f"int8 engine {dtype}", want, got, lsb)


if __name__ == "__main__":
    main()
