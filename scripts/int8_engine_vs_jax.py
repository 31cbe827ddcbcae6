#!/usr/bin/env python3
"""Print how far the port's int8 engine is from the JAX package's, on the CPU.

Usage: JAX_PLATFORMS=cpu python scripts/int8_engine_vs_jax.py     (from the repository root)

Runs the comparison of ``tests/test_torch_int8.py`` (its tiny calibrated
ConvTasNet, the JAX engine with its Pallas kernel in interpret mode and XLA's
algebraic simplifier off) for each variant and compute dtype there, and
prints per case the SNR of each output in dB, the share of samples more than
half an output step apart and the mean |difference| in output steps: the
readings that the test's ``JAX_BOUND`` is set from. Takes about 40 s.
"""

import os
import sys

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_ROOT, os.path.join(_ROOT, "tests")]

import test_torch_int8 as t  # noqa: E402

CASES = (
    (t.FQSS, "relu", None),
    (dict(t.FQSS, n_combiner=1), "relu", 2400),
    (dict(t.FQSS, out_quant=False), "relu", 2400),
    (t.FQSS, "sigmoid", 2400),
)


def main() -> None:
    variables, mix = t.calibrated.__wrapped__()
    lsb = t._out_lsb(t._models(variables, t.FQSS)[2])
    for spec, mask_act, length in CASES:
        jm, pruned, port = t._models(variables, spec, mask_act)
        x = mix if length is None else mix[:1, :length]
        for dtype in ("float32", "bfloat16"):
            want = t._jax_engine_forward(jm, pruned, x, dtype)
            got = t.ConvTasNetInt8Engine(port, compute_dtype=dtype)(torch.from_numpy(x)).numpy()
            diff = np.abs(got - want) / lsb
            print(f"n_combiner={spec['n_combiner']} out_quant={spec['out_quant']} mask={mask_act} {dtype}: "
                  f"SNR {' '.join(f'{v:.2f}' for v in t._snr_db(want, got).ravel())} dB, "
                  f"{(diff > 0.5).mean():.5f} of samples > 0.5 step apart, mean {diff.mean():.6f} steps", flush=True)


if __name__ == "__main__":
    main()
