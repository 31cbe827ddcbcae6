"""Int8 matrix product with a requantizing epilogue: wrapper, plain version and launch counter.

The CUDA kernel in ``csrc/int8_matmul.cu`` replaces the TPU kernel of the
int8 serving engine, ``fqss_tpu/ops/pallas_quant.py:int8_matmul_requant_pallas``
(``_qmm8_kernel``)::

    out = int8(clip(round((prelu(float(xs @ w.T) * scale + corr, alpha) - mn) / delta), 0, 255) - 128)

with ``nl="tanh"``, ``nl="sigmoid"`` or ``nl="gelu"`` (the exact GELU,
:func:`fqss_tpu_torch.nn.nonlin.gelu`) in the PReLU's place (the TPU kernel
has only the PReLU; the JAX engines apply the others to the dequantized
product outside it, as DPTNet's gated output and HTDemucs's FFN do).

``xs`` is ``[M, K]`` int8 (channels-last activations, shifted by -128 from
the ``[0, 255]`` grid), ``w`` is ``[N, K]`` int8 (the port's conv weight
``[Cout, Cin, 1]`` squeezed; the JAX function takes its transpose),
``scale``/``corr`` are ``[N]`` float32 and ``corr`` already holds the bias.
``alpha`` is the PReLU slope (1 = identity, 0 = ReLU) and ``(delta, mn)`` the
next activation grid, all float32 values given as Python floats. ``delta``
and ``mn`` may also be sequences of up to three grids, each taking an equal
share of the N columns in order: the Sepformer engine requantizes its
attention in-projection's Q, K and V thirds to their own grids in one launch.

On the card the kernel's blocks are persistent: :func:`grid` gives the
launch as many blocks as fit co-resident (asked of the card once a device,
N tile and K), each keeping one N tile of the weight in shared memory and
walking the M tiles. K is at most 2560.

A CUDA tensor launches the kernel, or the wrapper raises: there is no
fallback. A CPU tensor takes the plain version :func:`int8_matmul_requant_ref`,
which the kernel equals bit for bit; the wrapper holds both devices to the
kernel's dtypes, shapes and contiguity. ``LAUNCHES["int8_mm"]`` counts the
kernel's launches, ``GELU_LAUNCHES["int8_mm"]`` those of them with the GELU
epilogue.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from fqss_tpu_torch.nn.nonlin import gelu
from fqss_tpu_torch.ops import _build

Tensor = torch.Tensor

LAUNCHES = {"int8_mm": 0}
GELU_LAUNCHES = {"int8_mm": 0}  # the launches of LAUNCHES["int8_mm"] with the GELU epilogue
NLS = ("prelu", "tanh", "sigmoid", "gelu")  # the epilogue's nonlinearities, in the kernel's numbering
MAX_GRIDS = 3  # output grids one launch takes (csrc/int8_matmul.cu:kMaxGrids)


def reset_launches() -> None:
    LAUNCHES["int8_mm"] = GELU_LAUNCHES["int8_mm"] = 0


# The kernel's tiles and shared memory (csrc/int8_matmul.cu): 128-row M tiles, N tiles of 128 columns (64 where
# N <= 64 or the 128-column weight tile is too deep to fit), a 3-stage ring of 128 x 128-byte stages.
SMEM_BYTES = 232448  # the most shared memory a block may have on sm_90
TILE_M = 128


def smem_bytes(tile_n: int, k: int) -> int:
    """Shared memory of one block: the weight tile (rows padded to 16 mod 128 bytes), the ring, the output tile
    and six floats a column."""
    return tile_n * (-(-k // 128) * 128 + 16) + 3 * TILE_M * 144 + TILE_M * (tile_n + 16) + 24 * tile_n


def tile_n(n: int, k: int) -> int:
    """The kernel's N tile at (N, K); 0 where no weight tile of depth K fits."""
    if n > 64 and smem_bytes(128, k) <= SMEM_BYTES:
        return 128
    return 64 if smem_bytes(64, k) <= SMEM_BYTES else 0


def grid(m: int, n: int, k: int, sms: int, blocks_per_sm: int) -> int:
    """The persistent launch's blocks: as many as fit co-resident, a multiple of the N tiles, and no more than
    there are tiles. Block b takes N tile b % n_tiles and the M tiles b // n_tiles + i * (blocks // n_tiles)."""
    n_tiles, m_tiles = -(-n // tile_n(n, k)), -(-m // TILE_M)
    return n_tiles * max(1, min(m_tiles, sms * blocks_per_sm // n_tiles))


_CORESIDENT: dict[tuple[int, int, int], tuple[int, int]] = {}


def _blocks(device: torch.device, m: int, n: int, k: int) -> int:
    """The launch's blocks on ``device``; (SMs, blocks an SM) are asked of the card once a device, N tile and K."""
    key = (device.index, tile_n(n, k), k)
    if key not in _CORESIDENT:
        got = ctypes.c_int(0)
        rc = _build.library().fqss_int8_matmul_blocks_per_sm(n, k, ctypes.byref(got))
        if rc != 0 or got.value < 1:
            raise RuntimeError(f"int8_matmul_requant: occupancy query failed with error {rc} ({got.value} blocks)")
        _CORESIDENT[key] = (torch.cuda.get_device_properties(device).multi_processor_count, got.value)
    return grid(m, n, k, *_CORESIDENT[key])


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
    elif nl == "gelu":
        v = gelu(v)
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
    m, n, k = xs.shape[0], w.shape[0], xs.shape[1]
    if tile_n(n, k) == 0:
        raise ValueError(f"int8_matmul_requant: K = {k} exceeds the kernel's shared memory (at most 2560)")
    out = torch.empty(m, n, dtype=torch.int8, device=xs.device)
    if out.numel() == 0:
        return out
    grids = [x for pair in zip(deltas, mns) for x in pair]
    grids += [1.0, 0.0] * (MAX_GRIDS - len(deltas))
    with torch.cuda.device(xs.device):
        rc = _build.library().fqss_int8_matmul_requant(
            xs.data_ptr(), w.data_ptr(), scale.data_ptr(), corr.data_ptr(), NLS.index(nl), alpha, *grids,
            n // len(deltas), out.data_ptr(), m, n, k, _blocks(xs.device, m, n, k),
            torch.cuda.current_stream(xs.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_matmul_requant: CUDA launch failed with error {rc}")
    LAUNCHES["int8_mm"] += 1
    if nl == "gelu":
        GELU_LAUNCHES["int8_mm"] += 1
    return out
