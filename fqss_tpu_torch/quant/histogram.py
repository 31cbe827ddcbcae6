"""The MSE quantizer's histogram observer, with the JAX package's arithmetic (``fqss_tpu/quant/quantizers.py:
MseActQuantizer``).

JAX re-bins the running histogram through ``jnp.linspace``, ``jnp.cumsum`` and ``jnp.interp``, which XLA compiles
in ways of its own; the port copies each so that the histograms agree bit for bit on the CPU:

* ``jnp.linspace(a, b, n)`` is ``a * (1 - s) + b * s`` with ``s = k / (n - 1)``, and XLA's CPU compile contracts it
  into ``fma(b, s, a * (1 - s))`` (:func:`xla_linspace`); ``torch.linspace`` rounds its points otherwise.
* ``jnp.cumsum`` is a reduce-window that XLA rewrites into a scan over blocks of 16: each block summed in order,
  the blocks' totals scanned the same way, then added to the blocks after them (:func:`xla_cumsum`).
* ``jnp.interp`` takes ``fp[i-1] + (delta / dx) * df`` as one FMA, keeps ``fp[i-1]`` where ``|dx|`` is at most
  ``spacing(eps)``, and clamps to ``fp[0]``/``fp[-1]`` outside ``xp`` (:func:`xla_interp`).

:func:`fma32` is a float32 FMA in float64 arithmetic: the product is exact in float64, the sum is rounded to odd,
and the one rounding to float32 is then exact. A batch's bins are counted in integers, and the bin index is
truncated as ``astype(int32)`` truncates. These are plain PyTorch operations on any device: the histogram is small
(512 bins), and JAX leaves it to XLA too. Every sum is written out in its order, so the card gives the CPU's
histogram (``chip_smoke.py`` phase 69 holds the counts and the window bitwise, the re-binned histogram within 1e-5
of the count).
"""

from __future__ import annotations

import numpy as np
import torch

from fqss_tpu_torch.parallel import mesh as dp

Tensor = torch.Tensor

N_BINS = 512
_SCAN_BLOCK = 16  # XLA's reduce-window rewrite on the CPU
_INTERP_EPS = float(np.spacing(np.finfo(np.float32).eps))


def fma32(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """``a * b + c`` for float32 operands with one rounding, as a fused multiply-add gives it."""
    a64, b64, c64 = a.double(), b.double(), c.double()
    p = a64 * b64  # exact: two 24-bit significands
    s = p + c64
    bc = s - p
    e = (p - (s - bc)) + (c64 - bc)  # s + e is p + c exactly (TwoSum)
    bits = s.view(torch.int64)
    odd = (e != 0) & ((bits & 1) == 0)  # inexact on an even neighbour: round to odd, toward the exact sum
    step = torch.where((e > 0) == (s > 0), 1, -1)
    s = torch.where(odd, (bits + step).view(torch.float64), s)
    return s.float()


def xla_linspace(start: Tensor, stop: Tensor, num: int) -> Tensor:
    """``jnp.linspace(start, stop, num)`` of two float32 scalars, bit for bit as the JAX package computes it."""
    div = num - 1
    step = torch.arange(div, device=start.device, dtype=torch.float32) / div  # exact: div is a power of two here
    head = fma32(stop.reshape(1), step, start.reshape(1) * (1 - step))
    return torch.cat([head, stop.reshape(1)])


def xla_cumsum(v: Tensor) -> Tensor:
    """``jnp.cumsum`` of a float32 vector, in the order of XLA's CPU scan."""
    n = v.numel()
    if n <= _SCAN_BLOCK:
        cols = list(v.unbind())
        for k in range(1, n):
            cols[k] = cols[k - 1] + cols[k]
        return torch.stack(cols)
    pad = -n % _SCAN_BLOCK
    blocks = torch.cat([v, v.new_zeros(pad)]).reshape(-1, _SCAN_BLOCK)
    cols = list(blocks.unbind(1))
    for k in range(1, _SCAN_BLOCK):
        cols[k] = cols[k - 1] + cols[k]
    inner = torch.stack(cols, 1)
    carry = xla_cumsum(inner[:, -1].contiguous())
    carry = torch.cat([carry.new_zeros(1), carry[:-1]])
    return (inner + carry[:, None]).reshape(-1)[:n]


def xla_interp(x: Tensor, xp: Tensor, fp: Tensor) -> Tensor:
    """``jnp.interp(x, xp, fp)`` with its rules and its arithmetic."""
    i = torch.searchsorted(xp, x, right=True).clamp(1, xp.numel() - 1)
    lo_x, lo_f = xp[i - 1], fp[i - 1]
    df = fp[i] - lo_f
    dx = xp[i] - lo_x
    delta = x - lo_x
    dx0 = dx.abs() <= _INTERP_EPS
    f = torch.where(dx0, lo_f, fma32(delta / torch.where(dx0, torch.ones_like(dx), dx), df, lo_f))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def observe(x: Tensor, hist: Tensor, val_min: Tensor, val_max: Tensor, first: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """One observation of ``x``: the window grown to ``x``'s min/max (taken as it is where ``first``), the running
    histogram re-binned onto the new window by its CDF, and ``x``'s counts added. Returns ``(hist, val_min,
    val_max)``; the caller keeps them only where the quantizer observes."""
    xf = x.detach().float().reshape(-1)
    bmin, bmax = dp.extremes(xf.min(), xf.max())  # the global batch's, under a mesh
    nmin = torch.where(first, bmin, torch.minimum(val_min, bmin))
    nmax = torch.where(first, bmax, torch.maximum(val_max, bmax))
    n_bins = hist.numel()
    old_edges = xla_linspace(val_min, val_max, n_bins + 1)
    new_edges = xla_linspace(nmin, nmax, n_bins + 1)
    old_cdf = torch.cat([hist.new_zeros(1), xla_cumsum(hist)])
    rebinned = torch.diff(xla_interp(new_edges, old_edges, old_cdf))
    return rebinned + dp.sum_counts(bin_counts(xf, nmin, nmax, n_bins)).float(), nmin, nmax


def bin_counts(x: Tensor, lo: Tensor, hi: Tensor, n_bins: int = N_BINS) -> Tensor:
    """How many values of ``x`` fall in each of ``n_bins`` equal bins over [lo, hi], in int64: the bin index
    truncated as ``astype(int32)`` truncates, and clipped to the bins."""
    xf = x.detach().float().reshape(-1)
    width = (hi - lo) / n_bins  # exact: a power of two
    idx = ((xf - lo) / torch.where(width > 0, width, torch.ones_like(width))).to(torch.int32)  # truncates
    idx = idx.clamp(0, n_bins - 1).long()
    return torch.zeros(n_bins, dtype=torch.int64, device=x.device).index_add_(0, idx, torch.ones_like(idx))
