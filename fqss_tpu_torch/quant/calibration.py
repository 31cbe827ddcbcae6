"""Host-side calibration: the MSE-optimal range search of the MSE quantizer (``fqss_tpu/quant/calibration.py``).

The device accumulates a running histogram in each :class:`~fqss_tpu_torch.quant.quantizers.MseActQuantizer`
during its observer window; after ``max_observations`` observations :func:`calibrate_mse_quantizers` searches the
N x N (min, max) candidates of each histogram for the least histogram-weighted quantization MSE on the host, writes
the winners into the quantizer's ranges and sets its ``calibrated`` flag (the reference's ``mse_minmax_range``,
qat_quant.py:291-326).

:func:`mse_minmax_range` picks what the JAX package's Python loop over the candidates picks, bit for bit: the same
float64 candidates and errors (each error a numpy sum over one row of bins, pairwise as the loop's), the first
minimum in the loop's order, and only the candidates the loop reaches before its ``break`` (``max <= min``). It
evaluates the candidates in chunks of ``_CHUNK`` instead of one at a time.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch import nn

from fqss_tpu_torch.quant.quantizers import MseActQuantizer

_CHUNK = 512  # candidates evaluated together: [512, bins] float64 arrays
# MseActQuantizer.max_observations default: the observer window after which the reference's MSE quantizer
# calibrates itself (qat_quant.py:306-326).
DEFAULT_OBSERVER_WINDOW = 50


def mse_quantizers(model: nn.Module) -> list[tuple[str, MseActQuantizer]]:
    """``(name, quantizer)`` of every MSE quantizer in ``model``'s tree."""
    return [(name, m) for name, m in model.named_modules() if isinstance(m, MseActQuantizer)]


def has_pending_mse(model: nn.Module) -> bool:
    """Whether ``model`` holds an MSE quantizer not yet calibrated: the recipes calibrate when the window closes,
    the factory on the import of a state saved inside the window."""
    return any(not bool(q.calibrated) for _, q in mse_quantizers(model))


def run_observer(model: nn.Module, x: torch.Tensor, steps: int = 55, **kwargs) -> nn.Module:
    """Run the observer window: ``steps`` forwards of ``x`` in ``train()`` mode without gradients, then the model's
    mode as it was. The standalone calibration entry point (``fqss_tpu/quant/calibration.py:run_observer``)."""
    was_training = model.training
    model.train()
    with torch.no_grad():
        for _ in range(steps):
            model(x, **kwargs)
    model.train(was_training)
    return model


def _linear_quantize_np(x: np.ndarray, mn, mx, n_bits: int) -> np.ndarray:
    """The uniform (asymmetric) grid in numpy, for a column of candidate ``mn``/``mx`` against a row of values (every
    candidate has ``mx > mn``, so JAX's branch for an empty range is never taken)."""
    qmax = 2**n_bits - 1
    delta = (mx - mn) / qmax
    return delta * np.clip(np.round((x - mn) / delta), 0, qmax) + mn


def mse_minmax_range(hist: np.ndarray, val_min: float, val_max: float, n_bits: int = 8,
                     n_grid: int = 100) -> tuple[float, float]:
    """The MSE-optimal (min, max) of a histogram over [val_min, val_max] (qat_quant.py:291-304: N x N candidates,
    histogram-weighted MSE); the JAX package's choice bit for bit (module docstring)."""
    n_bins = len(hist)
    bins = np.linspace(val_min, val_max, n_bins, endpoint=False)
    weights = hist / max(hist.sum(), 1e-12)
    delta = 0.5 * (val_max - val_min) / n_grid
    # the candidates in the loop's order, each min with the maxes it reaches before its `break`
    mns, mxs = [], []
    for i in range(n_grid):
        mn_i = val_min + delta * i
        for j in range(n_grid):
            mx_j = val_max - delta * j
            if mx_j <= mn_i:
                break
            mns.append(mn_i)
            mxs.append(mx_j)
    best = (val_min, val_max, np.inf)
    mns, mxs = np.array(mns), np.array(mxs)
    for start in range(0, len(mns), _CHUNK):
        mn, mx = mns[start:start + _CHUNK, None], mxs[start:start + _CHUNK, None]
        err = np.sum((bins - _linear_quantize_np(bins, mn, mx, n_bits)) ** 2 * weights, axis=1)
        k = int(np.argmin(err))  # the first of equal minima, as the loop's strict `<`
        if err[k] < best[2]:
            best = (float(mns[start + k]), float(mxs[start + k]), float(err[k]))
    return best[0], best[1]


def calibrate_mse_quantizers(model: nn.Module, n_bits: int = 8, n_grid: int = 100) -> int:
    """Calibrate every MSE quantizer of ``model`` that holds a histogram and is not calibrated: its ranges become
    :func:`mse_minmax_range` of the histogram (float32), and ``calibrated`` is set. Returns how many it calibrated.
    Call once after the observer window; the quantizers then quantize. The searches run in a pool of threads (numpy
    leaves the interpreter lock in its array operations); each is the same computation as alone."""
    pending = [q for _, q in mse_quantizers(model) if not bool(q.calibrated)]
    hists = [(q, q.hist.detach().cpu().numpy(), float(q.val_min), float(q.val_max)) for q in pending]
    hists = [h for h in hists if h[1].sum() > 0]

    def search(item):
        _, hist, lo, hi = item
        return mse_minmax_range(hist, lo, hi, n_bits=n_bits, n_grid=n_grid)

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        ranges = list(pool.map(search, hists))
    with torch.no_grad():
        for (q, *_), (mn, mx) in zip(hists, ranges):
            q.min_range.fill_(float(np.float32(mn)))
            q.max_range.fill_(float(np.float32(mx)))
            q.calibrated.fill_(True)
    return len(hists)
