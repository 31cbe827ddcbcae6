"""Shared primitives of the int8 serving engine (``fqss_tpu/serve/common.py``).

After QAT every activation-quantizer output lies on its 8-bit uniform grid
``y = delta * X + mn`` with integer ``X in [0, 255]``, and every weight-
quantizer output on a per-out-channel symmetric grid ``w = s_w[c] * W``
with ``W in [-128, 127]``. A matmul of grid values is therefore computable
exactly in int8/int32:

    out[n] = delta * s_w[n] * dot(X - 128, W)[n]
           + (mn + 128 * delta) * s_w[n] * sum_k(W[n, k]) + bias[n]

This module holds the frozen-grid containers (:class:`Grid`,
:class:`Int8Weight`), the int8 activation carrier (:class:`QAct`, channels
last, 1 byte an element between stages) and the host-side preparation
(:func:`act_grid`, :func:`int8_weight`, :func:`dequant_weight`), computed in
numpy float32 with the JAX package's expressions, so that the constants are
bitwise the JAX engine's. Weights are in the port's layout: a 1x1 conv
weight ``[N, K, 1]`` or ``[N, K]`` (the JAX kernel's transpose).

The device-side pieces (:func:`requant`, :func:`int8_matmul`, :func:`gn1`,
:func:`layer_norm`, the convolutions) are plain PyTorch, as the JAX engines
leave them to XLA; :class:`Int8Site` runs a product of grid values through
the int8 kernel (K4, :mod:`fqss_tpu_torch.ops.int8_matmul`), fused with the
dequantization, the nonlinearity and the requantization.
Every division by a grid step is IEEE division by a one-element tensor on
the device: on CUDA PyTorch divides by a Python number through its
reciprocal, which can differ by one ulp and move a value across a rounding
tie.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from fqss_tpu_torch.ops.int8_matmul import int8_matmul_requant, int8_product
from fqss_tpu_torch.quant.fake_quant import bf16_round

Tensor = torch.Tensor


@dataclasses.dataclass
class Grid:
    """Frozen per-tensor activation grid: y = delta * X + mn, X in [0, 255]."""

    delta: np.float32
    mn: np.float32
    _steps: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def step_on(self, device: torch.device) -> Tensor:
        """``delta`` as a one-element tensor on ``device``, made once per device."""
        step = self._steps.get(device)
        if step is None:
            step = self._steps[device] = torch.full((1,), float(self.delta), device=device)
        return step


@dataclasses.dataclass
class Int8Weight:
    """Per-out-channel symmetric int8 weight of a 1x1 conv / dense layer, K-major."""

    w_int: np.ndarray  # [N, K] int8
    scale: np.ndarray  # [N] f32, s_w
    sum_w: np.ndarray  # [N] f32, sum_k W[n, k]
    bias: np.ndarray | None  # [N] f32
    _tensors: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def on(self, device: torch.device) -> dict[str, Tensor]:
        """The arrays as tensors on ``device`` (``bias`` only where there is one), copied once per device."""
        t = self._tensors.get(device)
        if t is None:
            arrays = {"w_int": self.w_int, "scale": self.scale, "sum_w": self.sum_w}
            if self.bias is not None:
                arrays["bias"] = self.bias
            t = self._tensors[device] = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
        return t


def quantizer_grid(quantizer, n_bits: int = 8) -> Grid:
    """The :class:`Grid` of an activation quantizer module's ranges."""
    return act_grid(quantizer.min_range, quantizer.max_range, n_bits)


def act_grid(min_range, max_range, n_bits: int = 8) -> Grid:
    """Freeze an activation quantizer's ranges into a :class:`Grid`.

    float32 arithmetic throughout: the fake-quant path computes
    ``delta = (mx - mn) / 255`` in float32, and a step that differs in the
    last bit shifts round() tie boundaries, flipping occasional one-LSB
    requant results against the QAT forward.
    """
    mn = np.float32(_numpy(min_range).reshape(-1)[0])
    mx = np.float32(_numpy(max_range).reshape(-1)[0])
    delta = np.float32(mx - mn) / np.float32(2**n_bits - 1)
    return Grid(delta=np.float32(delta), mn=mn)


def int8_weight(weight, min_range, max_range, bias, n_bits: int = 8) -> Int8Weight:
    """weight: ``[N, K(, 1)]`` 1x1 conv weight; its per-channel weight ranges; bias: ``[N]`` or None."""
    w = _numpy(weight).reshape(weight.shape[0], -1)  # [N, K]
    mn = _numpy(min_range).reshape(-1)
    mx = _numpy(max_range).reshape(-1)
    max_abs = np.maximum(np.abs(mn), np.abs(mx))  # [N]
    scale = 2.0 * max_abs / (2**n_bits - 1)
    safe = np.where(scale > 0, scale, 1.0)
    w_int = np.clip(np.round(w / safe[:, None]), -(2 ** (n_bits - 1)), 2 ** (n_bits - 1) - 1)
    return Int8Weight(
        w_int=w_int.astype(np.int8),
        scale=scale.astype(np.float32),
        sum_w=w_int.sum(axis=1).astype(np.float32),
        bias=None if bias is None else _numpy(bias),
    )


def dequant_weight(weight, min_range, max_range, n_bits: int = 8) -> np.ndarray:
    """Fold the weight fake-quant once (host-side) for the float convs.

    The ranges keep the keepdims layout of the channel axis, so the grid
    broadcasts against the weight."""
    w = _numpy(weight)
    max_abs = np.maximum(np.abs(_numpy(min_range)), np.abs(_numpy(max_range)))
    delta = 2.0 * max_abs / (2**n_bits - 1)
    delta = np.where(delta > 0, delta, 1.0)
    q = np.clip(np.round(w / delta), -(2 ** (n_bits - 1)), 2 ** (n_bits - 1) - 1)
    return (delta * q).astype(np.float32)


def _numpy(x) -> np.ndarray:
    if isinstance(x, Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


class QAct:
    """A quantized activation stored as the int8 plane Xs = X - 128, channels last.

    One byte an element at every producer/consumer boundary; the float32
    view (exactly the fake-quant output) is rebuilt by the consumer.
    """

    __slots__ = ("Xs", "grid")

    def __init__(self, Xs: Tensor, grid: Grid):
        self.Xs = Xs  # int8, X - 128 with X on the [0, 255] grid
        self.grid = grid

    @property
    def f32(self) -> Tensor:
        # X = Xs + 128 is exact in float32, so this is the fake-quant path's delta * X + mn bit for bit.
        X = self.Xs.float() + 128.0
        return float(self.grid.delta) * X + float(self.grid.mn)


def requant(x: Tensor, g: Grid) -> QAct:
    """Snap a float32 tensor to the int8 form of grid ``g``."""
    X = torch.round((x - float(g.mn)) / g.step_on(x.device)).clamp(0.0, 255.0)
    return QAct((X - 128.0).to(torch.int8), g)


def int8_matmul(qa: QAct, w: Int8Weight) -> Tensor:
    """Exact int8 matmul over the last axis: ``[..., K] x [N, K] -> [..., N]`` float32, dequantized.

    The product is the plain one (float64, exact); the kernel of
    :mod:`fqss_tpu_torch.ops.int8_matmul` fuses it with a requantization."""
    *lead, k = qa.Xs.shape
    xs = qa.Xs.reshape(-1, k)
    t = w.on(xs.device)
    acc = int8_product(xs, t["w_int"])
    # The JAX function's numpy float32 constants, computed on the device: the same roundings.
    scale = float(qa.grid.delta) * t["scale"]  # [N]
    corr = float(qa.grid.mn + 128.0 * qa.grid.delta) * t["scale"] * t["sum_w"]  # [N]
    out = acc * scale + corr
    if "bias" in t:
        out = out + t["bias"]
    return out.reshape(*lead, -1)


class Int8Site:
    """One product of grid values through K4: its int8 weight and the epilogue's constants, on the device.

    ``scale = delta_in * s_w`` and ``corr = (mn_in + 128 delta_in) s_w sum_w + bias``
    are computed once in numpy float32, with the JAX engine's expressions
    (``fqss_tpu/serve/convtasnet_int8.py:204-206``). ``nl``: the epilogue's
    nonlinearity, ``"prelu"`` with slope ``alpha`` (1 = identity, 0 = ReLU),
    ``"tanh"`` or ``"sigmoid"``. Called with a channels-last :class:`QAct`
    ``[..., K]`` on ``g_in``; returns ``[..., N]`` on ``g_out``. ``g_out`` may
    be a list of up to three grids, each taking an equal share of the N
    columns (the attention in-projection's Q, K and V thirds): the call then
    returns one :class:`QAct` per grid, views of the one launch's output."""

    def __init__(self, g_in: Grid, w: Int8Weight, g_out: Grid | list[Grid], alpha: float, device: torch.device,
                 nl: str = "prelu"):
        corr = (g_in.mn + 128.0 * g_in.delta) * w.scale * w.sum_w
        if w.bias is not None:
            corr = corr + w.bias
        self.w = torch.from_numpy(w.w_int).to(device)
        self.scale = torch.from_numpy(np.asarray(g_in.delta * w.scale, np.float32)).to(device)
        self.corr = torch.from_numpy(np.asarray(corr, np.float32)).to(device)
        self.alpha, self.nl = alpha, nl
        self.g_out = g_out

    def __call__(self, qa: QAct) -> QAct | list[QAct]:
        *lead, k = qa.Xs.shape
        grids = self.g_out if isinstance(self.g_out, list) else [self.g_out]
        out = int8_matmul_requant(qa.Xs.reshape(-1, k).contiguous(), self.w, self.scale, self.corr, self.alpha,
                                  [float(g.delta) for g in grids], [float(g.mn) for g in grids], self.nl)
        out = out.reshape(*lead, -1)
        if not isinstance(self.g_out, list):
            return QAct(out, self.g_out)
        n = out.shape[-1] // len(grids)
        return [QAct(out[..., i * n : (i + 1) * n], g) for i, g in enumerate(grids)]


def prelu(x: Tensor, alpha: float) -> Tensor:
    return torch.where(x >= 0, x, alpha * x)


def gn1(x: Tensor, scale: Tensor, bias: Tensor, eps: float) -> Tensor:
    """GroupNorm(num_groups=1) of a channels-last tensor: normalise over all non-batch axes,
    per-feature affine on the last axis (the JAX engine's ``gn1``: variance as E[(x - mu)^2])."""
    axes = tuple(range(1, x.ndim))
    mu = x.mean(dim=axes, keepdim=True)
    var = (x - mu).square().mean(dim=axes, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def layer_norm(x: Tensor, scale: Tensor, bias: Tensor, eps: float) -> Tensor:
    """LayerNorm over the last axis, as the JAX engine's ``layer_norm`` computes it (variance as E[(x - mu)^2])."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def conv1d(x: Tensor, w: Tensor, stride: int = 1, padding: int = 0, dilation: int = 1, groups: int = 1,
           bf16: bool = False) -> Tensor:
    """NCT conv with host-folded weights. ``bf16``: the operands rounded to bfloat16, the sums in
    float32, as JAX's bf16 conv with ``preferred_element_type=float32`` computes (``w`` arrives
    rounded already)."""
    if bf16:
        x = bf16_round(x)
    return F.conv1d(x, w, None, stride, padding, dilation, groups)


def conv_transpose1d(x: Tensor, w: Tensor, stride: int, bf16: bool = False) -> Tensor:
    """NCT transposed conv (zero padding and output padding), operands as in :func:`conv1d`."""
    if bf16:
        x = bf16_round(x)
    return F.conv_transpose1d(x, w, stride=stride)


def mulaw_output(q) -> bool:
    """Whether the model's output planes are on a mu-law grid (``out_quant`` with ``inout_nl_quant``)."""
    return q.out_quant and q.inout_nl_quant


def check_8bit_spec(q) -> None:
    """Common engine preconditions: full fake-quant on 8-bit linear grids.

    A mu-law output grid is refused too: the JAX engines requantize the output planes onto the linear grid of the
    mu-law quantizer's ranges (``fqss_tpu/serve/convtasnet_int8.py:169-170``), which is not the model's function
    (``tests/test_torch_quant_variants.py``); ``--engine auto`` serves such a model folded."""
    if not (q.qat and q.act_quant and q.weight_quant):
        raise ValueError("int8 engine requires a fully fake-quantized model")
    if q.act_n_bits != 8 or q.weight_n_bits != 8 or q.out_act_n_bits != 8:
        raise NotImplementedError("the int8 engine maps 8-bit grids onto s8 hardware")
    if q.in_quant and (q.in_act_n_bits != 8 or q.inout_nl_quant):
        raise NotImplementedError(
            "the int8 engine's input requant assumes a linear 8-bit input grid"
        )
    if mulaw_output(q):
        raise NotImplementedError("the int8 engine's output requant assumes a linear grid, not inout_nl_quant's mu-law")
