"""Fake-quant kernels: wrappers, autograd Functions, plain versions and launch counters.

The CUDA kernels in ``csrc/fake_quant.cu`` replace the TPU kernels of the
quantizer hot path, forward and backward:

* :func:`act_fake_quant` — per-tensor uniform grid; the forward and the
  backward (``_act_fq_bwd``) of
  ``fqss_tpu/ops/pallas_qat.py:act_fake_quant_train``. :func:`fake_quant` is
  the same forward kernel under the entry point of
  ``fqss_tpu/ops/pallas_quant.py:fake_quant_pallas``.
* :func:`weight_fake_quant` — per-channel symmetric grid on any channel
  axis; the forward and the backward (``_w_bwd_impl``) of
  ``fqss_tpu/ops/pallas_qat.py:weight_fake_quant_train``.
* :func:`weight_fake_quant_group` — the same grid and backward for all of a
  model's weight quantizers (a :class:`WeightGroup`) in one launch each,
  with the one-shot observer and ``where(observing, w, y)`` of
  ``fqss_tpu/quant/quantizers.py:WeightQuantizer`` inside.

When a gradient is needed, each wrapper runs through a
``torch.autograd.Function`` whose forward is the forward kernel and whose
backward is the backward kernel. Its gradients are the JAX package's
analytic ones (``pallas_qat.py:11-27``): the straight-through estimate with
0.5 at a clip bound, and the LSQ range gradients scaled by ``scale_grad``.

A CUDA tensor launches the kernel, or the wrapper raises: there is no
fallback. A CPU tensor goes to the plain PyTorch version beside each kernel
(:func:`act_fake_quant_ref`, :func:`weight_fake_quant_ref`,
:func:`act_fake_quant_bwd_ref`, :func:`weight_fake_quant_bwd_ref`,
:func:`weight_group_forward_ref`, :func:`weight_group_backward_ref`). On the
card the kernels equal them bit for bit, except for the range gradients,
which are sums taken in another order. ``LAUNCHES`` counts the wrappers'
kernel launches, one per call (a grouped call counts once under ``weight``
or ``weight_bwd``), so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Sequence

import numpy as np
import torch
from torch._utils import _unflatten_dense_tensors

from fqss_tpu_torch.ops import _build
from fqss_tpu_torch.quant.fake_quant import act_scale, linear_fake_quant, qrange, true_div, weight_scale

Tensor = torch.Tensor

LAUNCHES = {"act": 0, "weight": 0, "act_bwd": 0, "weight_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def act_fake_quant_ref(x: Tensor, min_range: Tensor, max_range: Tensor, n_bits: int = 8) -> Tensor:
    """Plain version: ``linear_fake_quant(x, mn, mx, n_bits, sym=False)``."""
    return linear_fake_quant(x, min_range, max_range, n_bits, sym=False)


def _keepdims(r: Tensor, ndim: int, ch_axis: int) -> Tensor:
    shape = [1] * ndim
    shape[ch_axis] = r.numel()
    return r.reshape(shape)


def weight_fake_quant_ref(w: Tensor, min_range: Tensor, max_range: Tensor, n_bits: int = 8,
                          ch_axis: int = 0) -> Tensor:
    """Plain version: per-channel symmetric signed grid along ``ch_axis``.

    The ranges may be ``[C]`` or the keepdims layout (C at ``ch_axis``)."""
    ch_axis %= w.ndim
    mn = _keepdims(min_range, w.ndim, ch_axis)
    mx = _keepdims(max_range, w.ndim, ch_axis)
    return linear_fake_quant(w, mn, mx, n_bits, sym=True)


def _tie_mask(X: Tensor, lo: float, hi: float) -> Tensor:
    """The clip's gradient mask (``pallas_qat.py:_tie_mask``): 1 inside, 0.5 at a bound, 0 outside."""
    inside = ((X > lo) & (X < hi)).to(X.dtype)
    tie = ((X == lo) | (X == hi)).to(X.dtype)
    return inside + 0.5 * tie


def act_bwd_terms(x: Tensor, g: Tensor, min_range: Tensor, max_range: Tensor, n_bits: int,
                  s: float) -> tuple[Tensor, Tensor, Tensor]:
    """``dx`` and the elementwise terms whose sums are ``dmn`` and ``dmx`` (``_act_bwd_kernel``)."""
    q = 2**n_bits - 1
    delta = true_div(max_range - min_range, q)
    u = (x - min_range) / delta
    X = torch.round(u)
    m = _tie_mask(X, 0, q)
    t = true_div(X.clamp(0, q) - m * u, q)
    return g * m, g * (1.0 - m - s * t), g * s * t


def act_fake_quant_bwd_ref(x: Tensor, g: Tensor, min_range: Tensor, max_range: Tensor, n_bits: int = 8,
                           s: float = 1.0) -> tuple[Tensor, Tensor, Tensor]:
    """Plain backward of :func:`act_fake_quant`: ``(dx, dmn, dmx)`` for the cotangent ``g``.

    ``s`` is the ``scale_grad`` factor (1 without it)."""
    dx, p_mn, p_mx = act_bwd_terms(x, g, min_range, max_range, n_bits, s)
    return dx, p_mn.sum().reshape(min_range.shape), p_mx.sum().reshape(max_range.shape)


def weight_bwd_terms(w: Tensor, g: Tensor, min_range: Tensor, max_range: Tensor, n_bits: int,
                     ch_axis: int) -> tuple[Tensor, Tensor]:
    """``dw`` and the elementwise terms whose per-channel sums are ``dd`` (``_w_bwd_kernel``)."""
    ch_axis %= w.ndim
    qmin, qmax = qrange(n_bits, True)
    max_abs = torch.maximum(_keepdims(min_range, w.ndim, ch_axis).abs(),
                            _keepdims(max_range, w.ndim, ch_axis).abs())
    delta = true_div(2.0 * max_abs, 2**n_bits - 1)
    u = w / delta
    X = torch.round(u)
    m = _tie_mask(X, qmin, qmax)
    return g * m, g * (X.clamp(qmin, qmax) - m * u)


def route_range_grad(dd: Tensor, min_range: Tensor, max_range: Tensor, n_bits: int,
                     s: float) -> tuple[Tensor, Tensor]:
    """``dmax = s·2/Q·dd`` given to mn or mx by ``|mn|`` vs ``|mx|`` (0.5 each at a tie), times the sign.

    The VJP of ``max(|mn|, |mx|)``, as ``pallas_qat.py:316-326`` writes it."""
    dmax = dd.reshape(min_range.shape) * (s * 2.0 / (2**n_bits - 1))
    amn, amx = min_range.abs(), max_range.abs()
    w_mn = torch.where(amn > amx, 1.0, torch.where(amn == amx, 0.5, 0.0)) * torch.sign(min_range)
    w_mx = torch.where(amx > amn, 1.0, torch.where(amn == amx, 0.5, 0.0)) * torch.sign(max_range)
    return dmax * w_mn, dmax * w_mx


def weight_fake_quant_bwd_ref(w: Tensor, g: Tensor, min_range: Tensor, max_range: Tensor, n_bits: int = 8,
                              s: float = 1.0, ch_axis: int = 0) -> tuple[Tensor, Tensor, Tensor]:
    """Plain backward of :func:`weight_fake_quant`: ``(dw, dmn, dmx)``, ranges in their own shape."""
    ch_axis %= w.ndim
    dw, terms = weight_bwd_terms(w, g, min_range, max_range, n_bits, ch_axis)
    dd = terms.sum(tuple(i for i in range(w.ndim) if i != ch_axis))
    return (dw, *route_range_grad(dd, min_range, max_range, n_bits, s))


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------


def _check_cuda(name: str, x: Tensor, *others: Tensor) -> None:
    for t in (x, *others):
        if t.device != x.device:
            raise ValueError(f"{name}: all tensors must be on {x.device}, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")


def _check_device(name: str, x: Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x.device}")


def _launch(name: str, fn, device: torch.device, *args) -> None:
    """Call a kernel's C entry on ``device``'s current stream; raise on a launch error."""
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def _check_act_ranges(name: str, min_range: Tensor, max_range: Tensor) -> None:
    if min_range.numel() != 1 or max_range.numel() != 1:
        raise ValueError(f"{name}: ranges must hold one element each")


def _check_weight_ranges(name: str, w: Tensor, min_range: Tensor, max_range: Tensor, ch_axis: int) -> None:
    channels = w.shape[ch_axis]
    for r in (min_range, max_range):
        if r.numel() != channels or r.shape not in ((channels,), _keepdims(r, w.ndim, ch_axis).shape):
            raise ValueError(
                f"{name}: ranges of shape {tuple(r.shape)} do not hold one value for each "
                f"of the {channels} channels on axis {ch_axis} of {tuple(w.shape)}"
            )


def _act_forward(x: Tensor, min_range: Tensor, max_range: Tensor, n_bits: int) -> Tensor:
    if x.device.type == "cpu":
        return act_fake_quant_ref(x, min_range, max_range, n_bits)
    _check_cuda("act_fake_quant", x, min_range, max_range)
    _check_act_ranges("act_fake_quant", min_range, max_range)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    _launch("act_fake_quant", _build.library().fqss_act_fake_quant, x.device,
            x.data_ptr(), min_range.data_ptr(), max_range.data_ptr(), y.data_ptr(), x.numel(), n_bits)
    LAUNCHES["act"] += 1
    return y


def act_fake_quant_bwd(x: Tensor, g: Tensor, min_range: Tensor, max_range: Tensor, n_bits: int = 8,
                       s: float = 1.0) -> tuple[Tensor, Tensor, Tensor]:
    """Backward of :func:`act_fake_quant` for the cotangent ``g``: ``(dx, dmn, dmx)``.

    A two-pass CUDA kernel (elementwise pass with per-block partial sums,
    then one block that sums them), one launch on the counter; the plain
    version on the CPU. ``s`` is the ``scale_grad`` factor."""
    _check_device("act_fake_quant backward", x)
    if x.device.type == "cpu":
        return act_fake_quant_bwd_ref(x, g, min_range, max_range, n_bits, s)
    _check_cuda("act_fake_quant backward", x, g, min_range, max_range)
    _check_act_ranges("act_fake_quant backward", min_range, max_range)
    dx = torch.empty_like(x)
    sums = torch.zeros(2, device=x.device)
    if x.numel():
        lib = _build.library()
        partials = torch.empty(lib.fqss_act_bwd_blocks(x.numel()), 2, device=x.device)
        _launch("act_fake_quant backward", lib.fqss_act_fake_quant_bwd, x.device,
                x.data_ptr(), g.data_ptr(), min_range.data_ptr(), max_range.data_ptr(), dx.data_ptr(),
                partials.data_ptr(), sums.data_ptr(), x.numel(), n_bits, s)
        LAUNCHES["act_bwd"] += 1
    return dx, sums[0:1].reshape(min_range.shape), sums[1:2].reshape(max_range.shape)


def _weight_forward(w: Tensor, min_range: Tensor, max_range: Tensor, n_bits: int, ch_axis: int) -> Tensor:
    if w.device.type == "cpu":
        return weight_fake_quant_ref(w, min_range, max_range, n_bits, ch_axis)
    _check_cuda("weight_fake_quant", w, min_range, max_range)
    _check_weight_ranges("weight_fake_quant", w, min_range, max_range, ch_axis)
    y = torch.empty_like(w)
    if w.numel() == 0:
        return y
    _launch("weight_fake_quant", _build.library().fqss_weight_fake_quant, w.device,
            w.data_ptr(), min_range.data_ptr(), max_range.data_ptr(), y.data_ptr(),
            w.numel(), w.shape[ch_axis], math.prod(w.shape[ch_axis + 1:]), n_bits)
    LAUNCHES["weight"] += 1
    return y


def weight_fake_quant_bwd(w: Tensor, g: Tensor, min_range: Tensor, max_range: Tensor, n_bits: int = 8,
                          s: float = 1.0, ch_axis: int = 0) -> tuple[Tensor, Tensor, Tensor]:
    """Backward of :func:`weight_fake_quant` for the cotangent ``g``: ``(dw, dmn, dmx)``.

    The CUDA kernel (one block per channel), or the plain version on the CPU."""
    _check_device("weight_fake_quant backward", w)
    ch_axis %= w.ndim
    if w.device.type == "cpu":
        return weight_fake_quant_bwd_ref(w, g, min_range, max_range, n_bits, s, ch_axis)
    _check_cuda("weight_fake_quant backward", w, g, min_range, max_range)
    _check_weight_ranges("weight_fake_quant backward", w, min_range, max_range, ch_axis)
    dw, dmn, dmx = torch.empty_like(w), torch.zeros_like(min_range), torch.zeros_like(max_range)
    if w.numel():
        _launch("weight_fake_quant backward", _build.library().fqss_weight_fake_quant_bwd, w.device,
                w.data_ptr(), g.data_ptr(), min_range.data_ptr(), max_range.data_ptr(), dw.data_ptr(),
                dmn.data_ptr(), dmx.data_ptr(), w.shape[ch_axis], math.prod(w.shape[:ch_axis]),
                math.prod(w.shape[ch_axis + 1:]), n_bits, s * 2.0 / (2**n_bits - 1))
        LAUNCHES["weight_bwd"] += 1
    return dw, dmn, dmx


class _ActFakeQuant(torch.autograd.Function):
    """Forward and backward kernels of the per-tensor uniform grid (``act_fake_quant_train``'s VJP)."""

    @staticmethod
    def forward(ctx, x, min_range, max_range, n_bits, s):
        ctx.n_bits, ctx.s = n_bits, s
        # Copies of the ranges: ActQuantizer's observer writes them in place
        # after this call, and the backward needs the values it quantized with.
        ctx.save_for_backward(x, min_range.detach().clone(), max_range.detach().clone())
        return _act_forward(x, min_range, max_range, n_bits)

    @staticmethod
    def backward(ctx, g):
        x, mn, mx = ctx.saved_tensors
        return (*act_fake_quant_bwd(x, g.contiguous(), mn, mx, ctx.n_bits, ctx.s), None, None)


class _WeightFakeQuant(torch.autograd.Function):
    """Forward and backward kernels of the per-channel grid (``weight_fake_quant_train``'s VJP)."""

    @staticmethod
    def forward(ctx, w, min_range, max_range, n_bits, s, ch_axis):
        ctx.n_bits, ctx.s, ctx.ch_axis = n_bits, s, ch_axis
        ctx.save_for_backward(w, min_range.detach().clone(), max_range.detach().clone())
        return _weight_forward(w, min_range, max_range, n_bits, ch_axis)

    @staticmethod
    def backward(ctx, g):
        w, mn, mx = ctx.saved_tensors
        return (*weight_fake_quant_bwd(w, g.contiguous(), mn, mx, ctx.n_bits, ctx.s, ctx.ch_axis), None, None, None)


def _needs_grad(*tensors: Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


BF16_TRAINING = ("bf16 compute is for serving only, and bf16 training is not supported: the JAX package cannot "
                 "train in bf16 either (jax.grad of its bf16 convolution raises a TypeError, and so does a bf16 "
                 "teacher's forward), so a bf16 forward that needs a gradient has no reference; run it under "
                 "torch.no_grad()/inference_mode(), or train in float32")


def refuse_bf16_grad(*tensors: Tensor) -> None:
    """Raise where a bf16 product would need a gradient: the JAX package has no bf16 gradient to port (a refusal,
    not a fallback to float32)."""
    if _needs_grad(*(t for t in tensors if t is not None)):
        raise NotImplementedError(BF16_TRAINING)


def act_fake_quant(x: Tensor, min_range: Tensor, max_range: Tensor, n_bits: int = 8,
                   scale_grad: bool = False) -> Tensor:
    """Per-tensor uniform fake-quant ``d·clip(round((x−mn)/d), 0, Q) + mn``, differentiable.

    ``min_range``/``max_range``: one-element float32 tensors on x's device,
    as ActQuantizer stores them. The kernels read them on the device, so the
    call never waits for the card. ``scale_grad`` scales the ranges'
    gradients by 1/sqrt(Q·C), C = ``x.shape[1]`` (NCT channels)."""
    _check_device("act_fake_quant", x)
    if _needs_grad(x, min_range, max_range):
        return _ActFakeQuant.apply(x, min_range, max_range, n_bits, act_scale(x, n_bits, scale_grad))
    return _act_forward(x, min_range, max_range, n_bits)


def fake_quant(x: Tensor, min_range: Tensor, max_range: Tensor, n_bits: int = 8) -> Tensor:
    """Entry point of ``fake_quant_pallas``: the same kernel as :func:`act_fake_quant`."""
    return act_fake_quant(x, min_range, max_range, n_bits)


def weight_fake_quant(w: Tensor, min_range: Tensor, max_range: Tensor, n_bits: int = 8, ch_axis: int = 0,
                      scale_grad: bool = False) -> Tensor:
    """Per-channel symmetric fake-quant ``d_c·clip(round(w/d_c), −2^(b−1), 2^(b−1)−1)``, differentiable.

    ``min_range``/``max_range``: C elements, flat ``[C]`` or the keepdims
    layout with C at ``ch_axis``, as WeightQuantizer stores them."""
    _check_device("weight_fake_quant", w)
    ch_axis %= w.ndim
    if _needs_grad(w, min_range, max_range):
        s = weight_scale(w.shape[ch_axis], n_bits, scale_grad)
        return _WeightFakeQuant.apply(w, min_range, max_range, n_bits, s, ch_axis)
    return _weight_forward(w, min_range, max_range, n_bits, ch_axis)


# ---------------------------------------------------------------------------
# Grouped weight quantizers: one launch forward and one backward for a model
# ---------------------------------------------------------------------------


class WeightEntry(NamedTuple):
    """One weight quantizer of a :class:`WeightGroup`: the weight, its ranges (C values each, flat or in the
    keepdims layout), the one-shot observer's one-element bool flag (None without an observer), whether the call
    writes state (``train()`` mode), the bits, the channel axis and the ranges' ``scale_grad`` factor."""

    w: Tensor
    min_range: Tensor
    max_range: Tensor
    observed: Tensor | None
    writes: bool
    n_bits: int
    ch_axis: int
    s: float


# How the kernel spreads an entry's channels over blocks of 256 threads (csrc/fake_quant.cu): a warp a channel,
# a lane a channel with the block's 8 warps on every eighth row (the channel axis last: coalesced loads), or a
# block a channel (long channels).
_WARP_CHANNEL, _LANE_CHANNEL, _BLOCK_CHANNEL = 0, 1, 2
_GROUP_THREADS, _BLOCK_CHANNEL_MIN = 256, 2048


class WeightGroup:
    """A fixed list of weight quantizers (:class:`WeightEntry`) that :func:`weight_fake_quant_group` takes in one
    launch, with the layout of its flat buffers: every entry's output (and ``dw``) at ``offsets[i]``, one float a
    channel of all entries at ``ch0[i]`` for the ranges used and their gradients, one flag an entry.

    On the card it holds the kernel's table (``csrc/fake_quant.cu:GroupEntry``: pointers, views, first blocks)
    and its block -> entry map on the device, built once here: a caller keeps the group while its weights, ranges
    and flags keep their storage and its mode does not change."""

    def __init__(self, entries: Sequence[WeightEntry]):
        self.entries = tuple(entries)
        if not self.entries:
            raise ValueError("WeightGroup: no entries")
        self.device = self.entries[0].w.device
        _check_device("weight_fake_quant_group", self.entries[0].w)
        views, kinds, blocks = [], [], []
        for i, e in enumerate(self.entries):
            ch_axis = e.ch_axis % e.w.ndim
            outer, C = math.prod(e.w.shape[:ch_axis]), e.w.shape[ch_axis]
            inner = math.prod(e.w.shape[ch_axis + 1:])
            if e.w.numel() == 0:
                raise ValueError(f"weight_fake_quant_group: entry {i} is empty")
            _check_weight_ranges(f"weight_fake_quant_group entry {i}", e.w, e.min_range, e.max_range, ch_axis)
            if e.observed is not None and (e.observed.dtype != torch.bool or e.observed.numel() != 1):
                raise ValueError(f"weight_fake_quant_group: entry {i}'s observer flag is not one bool")
            if self.device.type == "cuda":
                flag = () if e.observed is None else (e.observed,)
                for t in (e.w, e.min_range, e.max_range, *flag):
                    if t.device != self.device:
                        raise ValueError(f"weight_fake_quant_group: entry {i} has a tensor on {t.device}, "
                                         f"not {self.device}")
                _check_cuda(f"weight_fake_quant_group entry {i}", e.w, e.min_range, e.max_range)
                if not (e.observed is None or e.observed.is_contiguous()):
                    raise ValueError(f"weight_fake_quant_group: entry {i}'s observer flag is not contiguous")
            if inner == 1 and outer > 1:
                kind, nblocks = _LANE_CHANNEL, -(-C // 32)
            elif outer * inner >= _BLOCK_CHANNEL_MIN:
                kind, nblocks = _BLOCK_CHANNEL, C
            else:
                kind, nblocks = _WARP_CHANNEL, -(-C // (_GROUP_THREADS // 32))
            views.append((outer, C, inner))
            kinds.append(kind)
            blocks.append(nblocks)
        self.views, self.kinds = tuple(views), tuple(kinds)
        self.shapes = tuple(e.w.shape for e in self.entries)
        self.strides = tuple((C * inner, inner, 1) for _, C, inner in views)  # of a contiguous [outer, C, inner]
        self.sizes = tuple(e.w.numel() for e in self.entries)
        self.offsets = tuple(np.cumsum((0, *self.sizes))[:-1].tolist())
        self.total = sum(self.sizes)
        counts = [C for _, C, _ in views]
        self.ch0 = tuple(np.cumsum((0, *counts))[:-1].tolist())
        self.channels = sum(counts)
        self.block0 = np.cumsum((0, *blocks)).astype(np.int64)
        self.blocks = int(self.block0[-1])
        self.writes = any(e.writes and e.observed is not None for e in self.entries)
        if self.device.type == "cuda":
            pointers = [(e.w.data_ptr(), e.min_range.data_ptr(), e.max_range.data_ptr(),
                         0 if e.observed is None else e.observed.data_ptr()) for e in self.entries]
            # from pinned memory without a wait: the host allocator keeps the staging copy until the copy is done
            self.table = torch.from_numpy(self.pack(pointers)).pin_memory().to(self.device, non_blocking=True)
            self._block_entry_ptr = self.table.data_ptr() + 96 * len(self)
            self._block0_host = (ctypes.c_int64 * len(self.block0))(*self.block0.tolist())

    def pack(self, pointers: Sequence[tuple[int, int, int, int]]) -> np.ndarray:
        """The kernel's table as bytes: a ``GroupEntry`` (12 int64 words) an entry with the given (weight, mn, mx,
        flag) addresses, then the block -> entry map (int32)."""
        words = np.zeros((len(self), 12), np.int64)
        for i, ptrs in enumerate(pointers):
            words[i, :4] = np.array(ptrs, np.uint64).view(np.int64)
            words[i, 4:10] = (self.offsets[i], self.ch0[i], *self.views[i], self.block0[i])
        halves = words.view(np.int32)
        halves[:, 20] = self.kinds
        halves[:, 21] = [e.n_bits for e in self.entries]
        halves[:, 22] = [int(e.writes) for e in self.entries]
        halves.view(np.float32)[:, 23] = [e.s * 2.0 / (2**e.n_bits - 1) for e in self.entries]
        block_entry = np.repeat(np.arange(len(self), dtype=np.int32), np.diff(self.block0))
        return np.concatenate([words.reshape(-1).view(np.uint8), block_entry.view(np.uint8)])

    def __len__(self) -> int:
        return len(self.entries)

    def scratch(self, buf: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        """The ranges used (mn, mx: one float a channel) and the observing flags (one an entry) in a forward's
        buffer."""
        used = buf[self.total:self.total + 2 * self.channels]
        return used[:self.channels], used[self.channels:], buf[self.total + 2 * self.channels:]

    def split(self, flat: Tensor) -> list[Tensor]:
        """Each entry's tensor, in its weight's shape, from a flat buffer laid out by ``offsets`` (views cut in one
        C++ call: a forward cuts 71-137 of them)."""
        return list(_unflatten_dense_tensors(flat[:self.total], [e.w for e in self.entries]))

    def split_ranges(self, flat: Tensor) -> list[Tensor]:
        """Each entry's slice of a per-channel flat buffer (laid out by ``ch0``), in its ranges' shape."""
        return list(_unflatten_dense_tensors(flat, [e.min_range for e in self.entries]))


def weight_group_forward_ref(group: WeightGroup, buf: Tensor) -> None:
    """Plain version of the grouped forward: each entry as ``WeightQuantizer`` computes it (the observer's
    writes where observing in ``train()``, :func:`weight_fake_quant_ref`, ``where(observing, w, y)``), written into
    ``buf`` with the ranges used and the flags, as the kernel writes them."""
    used_mn, used_mx, flags = group.scratch(buf)
    outs, used_mn, used_mx = group.split(buf), group.split_ranges(used_mn), group.split_ranges(used_mx)
    with torch.no_grad():
        for i, e in enumerate(group.entries):
            ch_axis = e.ch_axis % e.w.ndim
            observing = None if e.observed is None else ~e.observed
            if observing is not None and e.writes:
                dims = tuple(d for d in range(e.w.ndim) if d != ch_axis)
                shape = e.min_range.shape
                e.min_range.copy_(torch.where(observing, e.w.amin(dims).reshape(shape), e.min_range))
                e.max_range.copy_(torch.where(observing, e.w.amax(dims).reshape(shape), e.max_range))
                e.observed.fill_(True)
            y = weight_fake_quant_ref(e.w, e.min_range, e.max_range, e.n_bits, ch_axis)
            outs[i].copy_(y if observing is None else torch.where(observing, e.w, y))
            used_mn[i].copy_(e.min_range)
            used_mx[i].copy_(e.max_range)
            flags[i:i + 1].copy_(buf.new_zeros(1) if observing is None else observing.reshape(1))


def weight_group_backward_ref(group: WeightGroup, buf: Tensor, grads: Sequence[Tensor | None]) -> tuple:
    """Plain version of the grouped backward: per entry with a gradient :func:`weight_fake_quant_bwd_ref` at the
    ranges the forward used, or ``(g, 0, 0)`` where it was observing; ``None`` thrice where no gradient came.
    Returns the lists ``(dw, dmn, dmx)``."""
    used_mn, used_mx, flags = group.scratch(buf)
    used_mn, used_mx = group.split_ranges(used_mn), group.split_ranges(used_mx)
    dws, dmns, dmxs = [], [], []
    for i, (e, g) in enumerate(zip(group.entries, grads)):
        if g is None:
            dws.append(None), dmns.append(None), dmxs.append(None)
            continue
        mn, mx = used_mn[i], used_mx[i]
        dw, dmn, dmx = weight_fake_quant_bwd_ref(e.w, g, mn, mx, e.n_bits, e.s, e.ch_axis)
        observing = flags[i] != 0
        zero = dmn.new_zeros(())
        dws.append(torch.where(observing, g, dw))
        dmns.append(torch.where(observing, zero, dmn))
        dmxs.append(torch.where(observing, zero, dmx))
    return dws, dmns, dmxs


def _new_buffer(group: WeightGroup) -> Tensor:
    """A forward's buffer: every entry's output, then the ranges used (mn, mx) and the flags."""
    return torch.empty(group.total + 2 * group.channels + len(group), device=group.device)


def _forward_args(group: WeightGroup, buf: Tensor) -> tuple:
    """The C entry's arguments for a forward into ``buf``."""
    out = buf.data_ptr()
    used_mn = out + 4 * group.total
    used_mx = used_mn + 4 * group.channels
    return (group.table.data_ptr(), group._block_entry_ptr, len(group), group.blocks, out, used_mn, used_mx,
            used_mx + 4 * group.channels, int(group.writes))


def _group_forward(group: WeightGroup) -> Tensor:
    """The grouped forward into a new buffer (outputs, ranges used, flags): the kernel, or the plain version on
    the CPU."""
    buf = _new_buffer(group)
    if group.device.type == "cpu":
        weight_group_forward_ref(group, buf)
        return buf
    _launch("weight_fake_quant_group", _build.library().fqss_weight_group_fake_quant, group.device,
            *_forward_args(group, buf))
    LAUNCHES["weight"] += 1
    return buf


def _grad_view(g: Tensor, view: tuple[int, int, int], shape) -> Tensor:
    """``g`` as the ``[outer, C, inner]`` view the kernel indexes by strides (a copy only where no view exists)."""
    if g.shape != shape or g.dtype != torch.float32:
        raise ValueError(f"weight_fake_quant_group backward: a float32 gradient of {tuple(shape)} expected, got "
                         f"{g.dtype} {tuple(g.shape)}")
    try:
        return g.view(view)
    except RuntimeError:
        return g.contiguous().view(view)


def _backward_args(group: WeightGroup, buf: Tensor, grads: Sequence[Tensor | None], dw: Tensor,
                   dr: Tensor) -> tuple[tuple, list[Tensor]] | None:
    """The C entry's arguments for a backward of ``buf``'s forward into ``dw`` and ``dr`` (dmn, then dmx), and
    the gradient copies they point at; None where no entry has a gradient."""
    words, keep = [], []
    for g, view, shape, strides in zip(grads, group.views, group.shapes, group.strides):
        if g is None:
            words += (0, 0, 0, 0)
        elif g.is_contiguous() and g.shape == shape and g.dtype == torch.float32:
            words += (g.data_ptr(), *strides)
        else:
            gv = _grad_view(g, view, shape)
            keep.append(gv)
            words += (gv.data_ptr(), *gv.stride())
    if not any(words[0::4]):
        return None
    for g in grads:
        if g is not None and g.device != group.device:
            raise ValueError(f"weight_fake_quant_group backward: a gradient on {g.device}, not {group.device}")
    used_mn = buf.data_ptr() + 4 * group.total
    args = (group.table.data_ptr(), group._block_entry_ptr, len(group), group._block0_host,
            (ctypes.c_int64 * len(words))(*words), used_mn, used_mn + 4 * group.channels,
            used_mn + 8 * group.channels, dw.data_ptr(), dr.data_ptr(), dr.data_ptr() + 4 * group.channels)
    return args, keep


def weight_fake_quant_group_bwd(group: WeightGroup, buf: Tensor, grads: Sequence[Tensor | None]) -> tuple:
    """Backward of :func:`weight_fake_quant_group` for the entries' cotangents (``None`` where none came):
    the lists ``(dw, dmn, dmx)``, ``None`` for an entry without a cotangent. One launch on the card (the kernel
    takes the cotangents by pointer and strides, any layout), the plain version on the CPU."""
    if group.device.type == "cpu":
        return weight_group_backward_ref(group, buf, grads)
    dw = torch.empty(group.total, device=group.device)
    dr = torch.empty(2 * group.channels, device=group.device)
    launch = _backward_args(group, buf, grads, dw, dr)
    if launch is not None:
        _launch("weight_fake_quant_group backward", _build.library().fqss_weight_group_fake_quant_bwd, group.device,
                *launch[0])
        LAUNCHES["weight_bwd"] += 1
    dws = group.split(dw)
    dmn, dmx = group.split_ranges(dr[:group.channels]), group.split_ranges(dr[group.channels:])
    return tuple([d if g is not None else None for d, g in zip(part, grads)] for part in (dws, dmn, dmx))


def group_kernel_call(group: WeightGroup, grads: Sequence[Tensor | None] | None = None):
    """A call that launches the grouped forward kernel (``grads`` None: the forward's, in eval() mode, which
    writes nothing) or the backward kernel with every argument built beforehand: what the kernel takes on the
    device, apart from the wrapper's host work (the tensors' allocation, the table's lookup, the views). For
    timing the kernel alone on the card."""
    lib, buf = _build.library(), _new_buffer(group)
    stream = torch.cuda.current_stream(group.device).cuda_stream
    fwd = _forward_args(group, buf)
    _launch("weight_fake_quant_group", lib.fqss_weight_group_fake_quant, group.device, *fwd)
    if grads is None:
        def call():
            if lib.fqss_weight_group_fake_quant(*fwd[:-1], 0, stream):
                raise RuntimeError("weight_fake_quant_group: CUDA launch failed")

        call.tensors = (buf,)
        return call
    dw = torch.empty(group.total, device=group.device)
    dr = torch.empty(2 * group.channels, device=group.device)
    args, keep = _backward_args(group, buf, grads, dw, dr)

    def call():
        if lib.fqss_weight_group_fake_quant_bwd(*args, stream):
            raise RuntimeError("weight_fake_quant_group backward: CUDA launch failed")

    call.tensors = (buf, dw, dr, keep, grads)  # what the arguments point at
    return call


class _WeightGroupFakeQuant(torch.autograd.Function):
    """The grouped forward and backward kernels: all of a group's weight quantizers as one autograd node, whose
    inputs are the weights and both ranges of every entry and whose outputs are the entries' tensors."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.set_materialize_grads(False)
        ctx.group = group
        buf = _group_forward(group)
        ctx.buf = buf
        ctx.save_for_backward(*tensors[:len(group)])  # the weights: raises if one is changed before the backward
        return tuple(group.split(buf))

    @staticmethod
    def backward(ctx, *grads):
        ctx.saved_tensors  # noqa: B018 -- the version check of the saved weights
        group = ctx.group
        dws, dmns, dmxs = weight_fake_quant_group_bwd(group, ctx.buf, grads)
        need = ctx.needs_input_grad[1:]
        return (None, *(d if need[i] else None for i, d in enumerate((*dws, *dmns, *dmxs))))


def weight_fake_quant_group(group: WeightGroup) -> list[Tensor]:
    """Every entry of ``group`` fake-quantized as ``WeightQuantizer.forward`` would, in one kernel launch (and one
    more, in ``train()`` mode, that sets the observers' flags): a list of tensors in the weights' shapes.

    In ``train()`` mode (``writes``) an observing entry (flag unset) writes its per-channel min/max to its ranges
    and its flag is set; an observing entry returns its weight, any other its per-channel symmetric grid values.
    Differentiable in every weight and range: the backward is one launch too. A CUDA group launches the kernels or
    raises; a CPU group takes the plain versions."""
    tensors = [e.w for e in group.entries] + [e.min_range for e in group.entries] + [e.max_range for e in group.entries]
    if _needs_grad(*tensors):
        return list(_WeightGroupFakeQuant.apply(group, *tensors))
    return group.split(_group_forward(group))
