"""Int8 matrix product with a requantizing epilogue: wrapper, plain version and launch counter.

The CUDA kernel in ``csrc/int8_matmul.cu`` replaces the TPU kernel of the
int8 serving engine, ``fqss_tpu/ops/pallas_quant.py:int8_matmul_requant_pallas``
(``_qmm8_kernel``)::

    out = int8(clip(round((prelu(float(xs @ w.T) * scale + corr, alpha) - mn) / delta), 0, 255) - 128)

with ``nl="tanh"`` or ``nl="sigmoid"`` in the PReLU's place (the TPU kernel
has only the PReLU; the JAX engines apply the other two to the dequantized
product outside it, as DPTNet's gated output does).

``xs`` is ``[M, K]`` int8 (channels-last activations, shifted by -128 from
the ``[0, 255]`` grid), ``w`` is ``[N, K]`` int8 (the port's conv weight
``[Cout, Cin, 1]`` squeezed; the JAX function takes its transpose),
``scale``/``corr`` are ``[N]`` float32 and ``corr`` already holds the bias.
``alpha`` is the PReLU slope (1 = identity, 0 = ReLU) and ``(delta, mn)`` the
next activation grid, all float32 values given as Python floats. ``delta``
and ``mn`` may also be sequences of up to three grids, each taking an equal
share of the N columns in order: the Sepformer engine requantizes its
attention in-projection's Q, K and V thirds to their own grids in one launch.

A CUDA tensor launches the kernel, or the wrapper raises: there is no
fallback. A CPU tensor takes the plain version :func:`int8_matmul_requant_ref`,
which the kernel equals bit for bit; the wrapper holds both devices to the
kernel's dtypes, shapes and contiguity. ``LAUNCHES["int8_mm"]`` counts the
kernel's launches.
"""

from __future__ import annotations

from typing import Sequence

import torch

from fqss_tpu_torch.ops import _build

Tensor = torch.Tensor

LAUNCHES = {"int8_mm": 0}
NLS = ("prelu", "tanh", "sigmoid")  # the epilogue's nonlinearities, in the kernel's numbering
MAX_GRIDS = 3  # output grids one launch takes (csrc/int8_matmul.cu:kMaxGrids)


def reset_launches() -> None:
    LAUNCHES["int8_mm"] = 0


def int8_product(xs: Tensor, w: Tensor) -> Tensor:
    """``xs @ w.T`` of int8 ``[M, K]`` and ``[N, K]`` as float32: exact in float64, then rounded once."""
    return (xs.double() @ w.double().t()).float()


def _grids(delta: float | Sequence[float], mn: float | Sequence[float], n: int) -> tuple[list[float], list[float]]:
    """The output grids as two lists of floats, each grid taking ``n / len`` columns."""
    deltas = [float(x) for x in delta] if isinstance(delta, (list, tuple)) else [float(delta)]
    mns = [float(x) for x in mn] if isinstance(mn, (list, tuple)) else [float(mn)]
    if not 1 <= len(deltas) <= MAX_GRIDS or len(mns) != len(deltas) or n % len(deltas):
        raise ValueError(f"int8_matmul_requant: {len(deltas)} step sizes and {len(mns)} minima for {n} columns; "
                         f"1 to {MAX_GRIDS} grids expected, each taking an equal share of the columns")
    return deltas, mns


def int8_matmul_requant_ref(xs: Tensor, w: Tensor, scale: Tensor, corr: Tensor, alpha: float,
                            delta: float | Sequence[float], mn: float | Sequence[float], nl: str = "prelu") -> Tensor:
    """Plain version: the exact product, then the epilogue as separate float32 operations.

    The division is by a tensor: on CUDA PyTorch divides by a Python number
    through its reciprocal, which can differ from IEEE division by one ulp."""
    deltas, mns = _grids(delta, mn, w.shape[0])
    v = int8_product(xs, w) * scale + corr
    if nl == "tanh":
        v = torch.tanh(v)
    elif nl == "sigmoid":
        v = torch.sigmoid(v)
    else:
        v = torch.where(v >= 0, v, alpha * v)
    if len(deltas) == 1:
        X = torch.round((v - mns[0]) / torch.full((1,), deltas[0], device=v.device))
    else:  # per-column grids: each grid's value repeated over its share of the columns
        cols = w.shape[0] // len(deltas)
        step = torch.tensor(deltas, device=v.device).repeat_interleave(cols)
        X = torch.round((v - torch.tensor(mns, device=v.device).repeat_interleave(cols)) / step)
    return (X.clamp(0, 255) - 128).to(torch.int8)


def _check(xs: Tensor, w: Tensor, scale: Tensor, corr: Tensor) -> None:
    if xs.ndim != 2 or w.ndim != 2 or xs.shape[1] != w.shape[1]:
        raise ValueError(f"int8_matmul_requant: xs [M, K] and w [N, K] expected, got {tuple(xs.shape)} and "
                         f"{tuple(w.shape)}")
    n = w.shape[0]
    for name, t, dtype in (("xs", xs, torch.int8), ("w", w, torch.int8), ("scale", scale, torch.float32),
                           ("corr", corr, torch.float32)):
        if t.device != xs.device:
            raise ValueError(f"int8_matmul_requant: {name} is on {t.device}, xs on {xs.device}")
        if t.dtype != dtype:
            raise TypeError(f"int8_matmul_requant: {name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"int8_matmul_requant: the kernel takes contiguous tensors ({name} is not)")
    if scale.shape != (n,) or corr.shape != (n,):
        raise ValueError(f"int8_matmul_requant: scale and corr must be [{n}], got {tuple(scale.shape)} and "
                         f"{tuple(corr.shape)}")


def int8_matmul_requant(xs: Tensor, w: Tensor, scale: Tensor, corr: Tensor, alpha: float,
                        delta: float | Sequence[float], mn: float | Sequence[float], nl: str = "prelu") -> Tensor:
    """``[M, K] x [N, K] -> [M, N]`` int8, requantized to the grid ``(delta, mn)`` or to one grid per equal
    share of the columns (module docstring)."""
    if xs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_matmul_requant: no kernel for device {xs.device}")
    if nl not in NLS:
        raise ValueError(f"int8_matmul_requant: nl must be one of {NLS}, got {nl!r}")
    _check(xs, w, scale, corr)  # on the CPU too, so that the CPU tests hold callers to what the kernel takes
    deltas, mns = _grids(delta, mn, w.shape[0])
    if xs.device.type == "cpu":
        return int8_matmul_requant_ref(xs, w, scale, corr, alpha, delta, mn, nl)
    m, n = xs.shape[0], w.shape[0]
    out = torch.empty(m, n, dtype=torch.int8, device=xs.device)
    if out.numel() == 0:
        return out
    grids = [x for pair in zip(deltas, mns) for x in pair]
    grids += [1.0, 0.0] * (MAX_GRIDS - len(deltas))
    with torch.cuda.device(xs.device):
        rc = _build.library().fqss_int8_matmul_requant(
            xs.data_ptr(), w.data_ptr(), scale.data_ptr(), corr.data_ptr(), NLS.index(nl), alpha, *grids,
            n // len(deltas), out.data_ptr(), m, n, xs.shape[1], torch.cuda.current_stream(xs.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_matmul_requant: CUDA launch failed with error {rc}")
    LAUNCHES["int8_mm"] += 1
    return out
