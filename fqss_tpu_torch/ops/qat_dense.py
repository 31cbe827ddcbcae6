"""Fused QAT dense layer: wrappers, autograd Function, plain versions and launch counter.

The CUDA kernels in ``csrc/qat_dense.cu`` replace the TPU kernels of
``fqss_tpu/ops/pallas_qat.py:qat_dense``, forward (K5, ``_qd_fwd_kernel``)
and backward (K5-bwd, ``_qd_bwd``)::

    y = act_fq(x @ weight_fq(w)^T + b)

``x [M, K]``, the weight ``w [N, K]`` in the port's ``[out, in]`` layout with
its per-out-channel symmetric ranges ``[N]`` (or ``[N, 1]``, as
``WeightQuantizer`` keeps them), ``b [N]``, and the one-element ranges of the
output's uniform grid; all float32. JAX's kernel takes the transposed weight
``[K, N]`` with ranges on axis 1: the same function. Either grid may be off
(its ranges ``None``): the folded serving model has no weight grid (its
weights are on the grid already), the float teacher neither, and inside a
model's weight pass (``quant/quantizers.py:weight_pass``) the pass's grouped
call has put the weight on its grid and takes its gradient.

Each grid may also carry a one-element bool "observing" flag on the device:
while it is set, the grid is skipped (the act quantizer inside its EMA
window, the weight quantizer before its one-shot observation), which is
``where(observing, v, fq(v))``; the backward then passes that grid's
gradient straight through and gives its ranges 0. The kernels read the flags
on the device, so no call waits for the card.

The backward follows ``_qd_bwd``: a mask pass recomputes the pre-activation
(nothing but the inputs is saved) and gives ``gm = g * mask``, the act
ranges' gradients and ``db``; then ``dx = gm @ wq`` and ``dwq = gm^T @ x``;
``dwq`` goes through the weight grid's straight-through backward, K2-bwd
(:func:`fqss_tpu_torch.ops.fake_quant.weight_fake_quant_bwd`). The forward
and the mask pass put the weights on their grid once, into an ``[N, K]``
scratch that the wrapper allocates (the TPU kernel re-quantizes each weight
tile as it loads it; ``csrc/qat_dense.cu`` says why the port does not).

``gelu=True`` is the GELU route (``QDense(nl="gelu")``, HTDemucs's FFN):
``y = act_fq(gelu(x @ weight_fq(w)^T + b))``, the exact GELU
(:func:`fqss_tpu_torch.nn.nonlin.gelu`) between the bias and the act grid,
and inside the act observer's window the post-GELU value, which the
quantizer observes. Its backward (float32) is the same three kernels with
the GELU in the mask pass: the act grid's mask and range terms at
``u = gelu(pre)``, as the forward quantizes ``u``, and
``gm = g * mask(u) * gelu'(pre)`` (:func:`fqss_tpu_torch.nn.nonlin.gelu_grad`;
``g * gelu'(pre)`` where the act grid observes or is off), ``db`` its column
sum; JAX computes this layer under XLA (``fqss_tpu/nn/layers.py:QDense``
with ``Nl("gelu")``), so ``jax.grad`` of that module is its reference.

``bf16=True`` is the forward's bf16 route (``QuantSpec.compute_dtype``
``"bfloat16"``): ``x`` and the weight (after its grid) are rounded to
bfloat16 as the kernel loads them, the sums stay float32 and the bias and
the act grid are unchanged, which is JAX's ``jnp.dot`` of bf16 operands with
``preferred_element_type=float32`` between the grids. It has no backward:
with a gradient needed it raises ``NotImplementedError``.

A CUDA tensor launches the kernels, or the wrapper raises: there is no
fallback. A CPU tensor takes the plain versions, :func:`qat_dense_ref`
(the weight grid, ``torch.matmul``, the bias, the act grid: the composition
the layers ran before the kernel) and :func:`qat_dense_bwd_ref` (the same
backward in PyTorch operations). ``LAUNCHES`` counts the kernels' launches:
``dense`` the forward (``dense_bf16`` its bf16 route, ``dense_gelu`` and
``dense_bf16_gelu`` the GELU routes), ``dense_mask``, ``dense_dx`` and ``dense_dwq`` the
backward's three kernels (``dense_mask_gelu`` the GELU route's mask pass; K2-bwd counts under
``fake_quant.LAUNCHES["weight_bwd"]``).
"""

from __future__ import annotations

import ctypes

import torch

from fqss_tpu_torch.nn.nonlin import gelu as gelu_ref
from fqss_tpu_torch.nn.nonlin import gelu_grad
from fqss_tpu_torch.ops import _build
from fqss_tpu_torch.ops.fake_quant import (
    _check_device,
    _launch,
    _needs_grad,
    act_bwd_terms,
    act_fake_quant_ref,
    refuse_bf16_grad,
    weight_fake_quant_bwd,
    weight_fake_quant_bwd_ref,
    weight_fake_quant_ref,
)
from fqss_tpu_torch.quant.fake_quant import bf16_round

Tensor = torch.Tensor

LAUNCHES = {"dense": 0, "dense_bf16": 0, "dense_gelu": 0, "dense_bf16_gelu": 0, "dense_mask": 0,
            "dense_mask_gelu": 0, "dense_dx": 0, "dense_dwq": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _weight_q(w: Tensor, w_mn: Tensor | None, w_mx: Tensor | None, w_bits: int,
              w_observing: Tensor | None) -> Tensor:
    """The weight on its grid (plain), or as it is where the grid is off or observing."""
    if w_mn is None:
        return w
    wq = weight_fake_quant_ref(w, w_mn, w_mx, w_bits, 0)
    return wq if w_observing is None else torch.where(w_observing, w, wq)


def act_q(pre: Tensor, a_mn: Tensor | None, a_mx: Tensor | None, a_bits: int,
          a_observing: Tensor | None) -> Tensor:
    """The pre-activation on the act grid (plain), or as it is where the grid is off or observing."""
    if a_mn is None:
        return pre
    y = act_fake_quant_ref(pre, a_mn, a_mx, a_bits)
    return y if a_observing is None else torch.where(a_observing, pre, y)


def operands(x: Tensor, wq: Tensor, bf16: bool) -> tuple[Tensor, Tensor]:
    """A product's operands as the kernels' route reads them: under ``bf16`` rounded to bfloat16 (the weight after
    its grid), held in float32."""
    return (bf16_round(x), bf16_round(wq)) if bf16 else (x, wq)


def qat_dense_ref(x: Tensor, w: Tensor, b: Tensor, w_mn: Tensor | None = None, w_mx: Tensor | None = None,
                  a_mn: Tensor | None = None, a_mx: Tensor | None = None, w_bits: int = 8, a_bits: int = 8,
                  w_observing: Tensor | None = None, a_observing: Tensor | None = None, bf16: bool = False,
                  gelu: bool = False) -> Tensor:
    """Plain version: ``act_fq([gelu](x @ weight_fq(w)^T + b))``, each grid skipped where its flag is set; under
    ``bf16`` the product's operands rounded to bfloat16 (the sums float32: TF32 off)."""
    xc, wc = operands(x, _weight_q(w, w_mn, w_mx, w_bits, w_observing), bf16)
    pre = torch.matmul(xc, wc.t()) + b
    return act_q(gelu_ref(pre) if gelu else pre, a_mn, a_mx, a_bits, a_observing)


def _where(flag: Tensor | None, a: Tensor, b: Tensor) -> Tensor:
    return b if flag is None else torch.where(flag, a, b)


def qat_dense_bwd_ref(x: Tensor, w: Tensor, b: Tensor, g: Tensor, w_mn: Tensor | None = None,
                      w_mx: Tensor | None = None, a_mn: Tensor | None = None, a_mx: Tensor | None = None,
                      w_bits: int = 8, a_bits: int = 8, w_observing: Tensor | None = None,
                      a_observing: Tensor | None = None, w_s: float = 1.0, a_s: float = 1.0,
                      pre: Tensor | None = None, gelu: bool = False) -> tuple:
    """Plain backward of :func:`qat_dense` for the cotangent ``g [M, N]``:
    ``(dx, dw, db, dw_mn, dw_mx, da_mn, da_mx)``, a range gradient ``None`` where its grid is off.

    ``w_s``/``a_s``: the weight and act ranges' ``scale_grad`` factors. ``pre``: the pre-activation
    ``x @ wq^T + b`` (before the GELU) where the caller has it (the kernel's own, to compare its backward at the
    same act mask), else recomputed. ``gelu``: the GELU route's backward, the act grid's terms at ``gelu(pre)``
    and ``gm`` times ``gelu'(pre)``, inside the observer window and with the act grid off too."""
    wq = _weight_q(w, w_mn, w_mx, w_bits, w_observing)
    da_mn = da_mx = None
    gm = g
    if pre is None and (a_mn is not None or gelu):
        pre = torch.matmul(x, wq.t()) + b
    if a_mn is not None:
        gm, p_mn, p_mx = act_bwd_terms(gelu_ref(pre) if gelu else pre, g, a_mn, a_mx, a_bits, a_s)
        gm = _where(a_observing, g, gm)
        zero = torch.zeros((), device=g.device)
        da_mn = _where(a_observing, zero, p_mn.sum()).reshape(a_mn.shape)
        da_mx = _where(a_observing, zero, p_mx.sum()).reshape(a_mx.shape)
    if gelu:
        gm = gm * gelu_grad(pre)
    dwq = torch.matmul(gm.t(), x)
    dw, dw_mn, dw_mx = dwq, None, None
    if w_mn is not None:
        dw, dw_mn, dw_mx = weight_fake_quant_bwd_ref(w, dwq, w_mn, w_mx, w_bits, w_s, 0)
        dw, dw_mn, dw_mx = _observed_weight_grads(w_observing, dwq, dw, dw_mn, dw_mx)
    return torch.matmul(gm, wq), dw, gm.sum(0), dw_mn, dw_mx, da_mn, da_mx


def _observed_weight_grads(w_observing: Tensor | None, dwq: Tensor, dw: Tensor, dw_mn: Tensor,
                           dw_mx: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """The weight grid's gradients, passed straight through (ranges 0) where it was observing."""
    if w_observing is None:
        return dw, dw_mn, dw_mx
    zero = torch.zeros((), device=dwq.device)
    return torch.where(w_observing, dwq, dw), torch.where(w_observing, zero, dw_mn), torch.where(w_observing, zero,
                                                                                                 dw_mx)


def _check(x: Tensor, w: Tensor, b: Tensor, w_mn, w_mx, a_mn, a_mx, w_observing, a_observing) -> None:
    """Hold the operands to what the kernels take, on every device."""
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[1] or b.shape != (w.shape[0],):
        raise ValueError(f"qat_dense: x [M, K], w [N, K] and b [N] expected, got {tuple(x.shape)}, "
                         f"{tuple(w.shape)} and {tuple(b.shape)}")
    check_grids("qat_dense", (("x", x), ("w", w), ("b", b)), w.shape[0], w_mn, w_mx, a_mn, a_mx, w_observing,
                a_observing)


def check_grids(kernel: str, operands: tuple, n: int, w_mn, w_mx, a_mn, a_mx, w_observing, a_observing) -> None:
    """Hold the named operands (the first one's device is the call's), the ranges of the weight grid (``n``
    channels) and of the act grid, and their observing flags to what the kernels take."""
    x = operands[0][1]
    if (w_mn is None) != (w_mx is None) or (a_mn is None) != (a_mx is None):
        raise ValueError(f"{kernel}: a grid needs both of its ranges")
    ranges = []
    if w_mn is not None:
        ranges += [("w_mn", w_mn, n), ("w_mx", w_mx, n)]
    if a_mn is not None:
        ranges += [("a_mn", a_mn, 1), ("a_mx", a_mx, 1)]
    for name, r, count in ranges:
        if r.numel() != count:
            raise ValueError(f"{kernel}: {name} holds {r.numel()} values, {count} expected")
    for name, t in (*operands, *((name, r) for name, r, _ in ranges)):
        if t.device != x.device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, {operands[0][0]} on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{kernel}: the kernel takes float32, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: the kernel takes contiguous tensors ({name} is not)")
    for name, flag, grid in (("w_observing", w_observing, w_mn), ("a_observing", a_observing, a_mn)):
        if flag is not None and (grid is None or flag.dtype != torch.bool or flag.numel() != 1
                                 or flag.device != x.device):
            raise ValueError(f"{kernel}: {name} must be a one-element bool tensor on {x.device}, beside its grid")


def _ptr(t: Tensor | None):
    return None if t is None else t.data_ptr()


def _forward(x, w, b, w_mn, w_mx, a_mn, a_mx, w_observing, a_observing, w_bits, a_bits, bf16=False,
             gelu=False) -> Tensor:
    if x.device.type == "cpu":
        with torch.no_grad():
            return qat_dense_ref(x, w, b, w_mn, w_mx, a_mn, a_mx, w_bits, a_bits, w_observing, a_observing, bf16,
                                 gelu)
    (M, K), N = x.shape, w.shape[0]
    y = torch.empty(M, N, device=x.device)
    if y.numel():
        wq = _weight_scratch(w, w_mn)
        route = "dense" + ("_bf16" if bf16 else "") + ("_gelu" if gelu else "")
        _launch("qat_dense", getattr(_build.library(), "fqss_qat_" + route), x.device, x.data_ptr(), w.data_ptr(),
                b.data_ptr(), _ptr(w_mn), _ptr(w_mx), _ptr(w_observing), _ptr(a_mn), _ptr(a_mx), _ptr(a_observing),
                _ptr(wq), y.data_ptr(), M, K, N, w_bits, a_bits)
        LAUNCHES[route] += 1
    return y


def _weight_scratch(w: Tensor, w_mn: Tensor | None) -> Tensor | None:
    """Where the kernels write the weights on their grid, once a call (None without a weight grid)."""
    return None if w_mn is None else torch.empty_like(w)


def mask_pass(x: Tensor, w: Tensor, b: Tensor, g: Tensor, w_mn: Tensor | None, w_mx: Tensor | None,
              a_mn: Tensor | None, a_mx: Tensor | None, w_bits: int, a_bits: int, w_observing: Tensor | None,
              a_observing: Tensor | None, a_s: float, gelu: bool = False) -> tuple:
    """K5-bwd's first kernel on CUDA tensors (checked by the caller): ``(gm, sums, db, wq)``, ``gm = g * mask`` at
    the recomputed pre-activation (``gelu``: ``g * mask(gelu(pre)) * gelu'(pre)``), ``sums`` the act ranges'
    gradients (dmn, dmx), ``wq`` the weights on their grid (None without one)."""
    (M, K), N = x.shape, w.shape[0]
    dev = x.device
    lib = _build.library()
    gm = torch.empty(M, N, device=dev)
    if not (M and N):  # no launch: the sums are 0
        return gm, torch.zeros(2, device=dev), torch.zeros(N, device=dev), _weight_scratch(w, w_mn)
    sums, db = torch.empty(2, device=dev), torch.empty(N, device=dev)  # the column sums write every element
    wq = _weight_scratch(w, w_mn)
    tiles = (ctypes.c_int64 * 2)()
    lib.fqss_qat_dense_tiles(M, N, tiles)
    act_partials = torch.empty(tiles[0] * tiles[1], 2, device=dev)
    db_partials = torch.empty(tiles[0], N, device=dev)
    entry = lib.fqss_qat_dense_bwd_mask_gelu if gelu else lib.fqss_qat_dense_bwd_mask
    _launch("qat_dense backward (mask)", entry, dev, x.data_ptr(), w.data_ptr(),
            b.data_ptr(), g.data_ptr(), _ptr(w_mn), _ptr(w_mx), _ptr(w_observing), _ptr(a_mn), _ptr(a_mx),
            _ptr(a_observing), a_s, _ptr(wq), gm.data_ptr(), act_partials.data_ptr(), db_partials.data_ptr(),
            sums.data_ptr(), db.data_ptr(), M, K, N, w_bits, a_bits)
    LAUNCHES["dense_mask_gelu" if gelu else "dense_mask"] += 1
    return gm, sums, db, wq


def qat_dense_bwd(x: Tensor, w: Tensor, b: Tensor, g: Tensor, w_mn: Tensor | None = None,
                  w_mx: Tensor | None = None, a_mn: Tensor | None = None, a_mx: Tensor | None = None,
                  w_bits: int = 8, a_bits: int = 8, w_observing: Tensor | None = None,
                  a_observing: Tensor | None = None, w_s: float = 1.0, a_s: float = 1.0,
                  gelu: bool = False) -> tuple:
    """Backward of :func:`qat_dense` (K5-bwd) for the cotangent ``g [M, N]``:
    ``(dx, dw, db, dw_mn, dw_mx, da_mn, da_mx)`` as :func:`qat_dense_bwd_ref` gives them (``gelu``: the GELU
    route's).

    Three kernels (mask, dx, dwq), then K2-bwd for the weight grid; the plain version on the CPU."""
    _check_device("qat_dense backward", x)
    if x.device.type == "cpu":
        return qat_dense_bwd_ref(x, w, b, g, w_mn, w_mx, a_mn, a_mx, w_bits, a_bits, w_observing, a_observing,
                                 w_s, a_s, gelu=gelu)
    _check(x, w, b, w_mn, w_mx, a_mn, a_mx, w_observing, a_observing)
    if g.shape != (x.shape[0], w.shape[0]) or g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError(f"qat_dense backward: a contiguous float32 g of {(x.shape[0], w.shape[0])} expected")
    (M, K), N = x.shape, w.shape[0]
    dev = x.device
    lib = _build.library()
    gm, sums, db, wq = mask_pass(x, w, b, g, w_mn, w_mx, a_mn, a_mx, w_bits, a_bits, w_observing, a_observing, a_s,
                                 gelu)
    dx, dwq = torch.empty(M, K, device=dev), torch.empty(N, K, device=dev)
    if M and N and K:
        splits = lib.fqss_qat_dense_dx_splits(M, K, N)
        partials = torch.empty(splits if splits > 1 else 0, M, K, device=dev)
        _launch("qat_dense backward (dx)", lib.fqss_qat_dense_dx, dev, gm.data_ptr(),
                (w if wq is None else wq).data_ptr(), partials.data_ptr(), dx.data_ptr(), M, K, N, splits)
        LAUNCHES["dense_dx"] += 1
        splits = lib.fqss_qat_dense_dwq_splits(M, K, N)
        partials = torch.empty(splits if splits > 1 else 0, N, K, device=dev)
        _launch("qat_dense backward (dwq)", lib.fqss_qat_dense_dwq, dev, gm.data_ptr(), x.data_ptr(),
                partials.data_ptr(), dwq.data_ptr(), M, K, N, splits)
        LAUNCHES["dense_dwq"] += 1
    else:
        dx.zero_()
        dwq.zero_()
    dw, dw_mn, dw_mx = dwq, None, None
    if w_mn is not None:
        dw, dw_mn, dw_mx = weight_fake_quant_bwd(w, dwq, w_mn, w_mx, w_bits, w_s, 0)
        dw, dw_mn, dw_mx = _observed_weight_grads(w_observing, dwq, dw, dw_mn, dw_mx)
    da_mn = sums[0:1].reshape(a_mn.shape) if a_mn is not None else None
    da_mx = sums[1:2].reshape(a_mx.shape) if a_mx is not None else None
    return dx, dw, db, dw_mn, dw_mx, da_mn, da_mx


class _QatDense(torch.autograd.Function):
    """The forward kernel (K5) and the rematerialising backward (K5-bwd), as JAX's ``qat_dense`` custom VJP."""

    @staticmethod
    def forward(ctx, x, w, b, w_mn, w_mx, a_mn, a_mx, w_observing, a_observing, w_bits, a_bits, w_s, a_s, gelu):
        ctx.bits_and_scales = (w_bits, a_bits, w_s, a_s, gelu)
        # Copies of the ranges: the act observer writes them in place after this call.
        ranges = [r.detach().clone() if r is not None else None for r in (w_mn, w_mx, a_mn, a_mx)]
        ctx.save_for_backward(x, w, b, *ranges, w_observing, a_observing)
        return _forward(x, w, b, w_mn, w_mx, a_mn, a_mx, w_observing, a_observing, w_bits, a_bits, gelu=gelu)

    @staticmethod
    def backward(ctx, g):
        x, w, b, w_mn, w_mx, a_mn, a_mx, w_observing, a_observing = ctx.saved_tensors
        w_bits, a_bits, w_s, a_s, gelu = ctx.bits_and_scales
        grads = qat_dense_bwd(x, w, b, g.contiguous(), w_mn, w_mx, a_mn, a_mx, w_bits, a_bits, w_observing,
                              a_observing, w_s, a_s, gelu)
        return (*(gi if need else None for gi, need in zip(grads, ctx.needs_input_grad)), *([None] * 7))


def qat_dense(x: Tensor, w: Tensor, b: Tensor, w_mn: Tensor | None = None, w_mx: Tensor | None = None,
              a_mn: Tensor | None = None, a_mx: Tensor | None = None, w_bits: int = 8, a_bits: int = 8,
              w_observing: Tensor | None = None, a_observing: Tensor | None = None, w_s: float = 1.0,
              a_s: float = 1.0, bf16: bool = False, gelu: bool = False) -> Tensor:
    """``act_fq(x [M, K] @ weight_fq(w [N, K])^T + b)`` -> ``[M, N]``, differentiable in x, w, b and the ranges.

    ``w_mn``/``w_mx``: the weight grid's per-out-channel ranges, or None for no weight grid; ``a_mn``/``a_mx``:
    the output grid's one-element ranges, or None. ``w_observing``/``a_observing``: one-element bool tensors
    (or None): where set, that grid is skipped. ``w_s``/``a_s``: the ranges' ``scale_grad`` factors. ``bf16``: the
    product's operands rounded to bfloat16 (forward only: raises ``NotImplementedError`` where a gradient is
    needed). ``gelu``: the exact GELU between the bias and the act grid (float32 with its backward; with ``bf16``
    forward only)."""
    _check_device("qat_dense", x)
    _check(x, w, b, w_mn, w_mx, a_mn, a_mx, w_observing, a_observing)
    tensors = (x, w, b, w_mn, w_mx, a_mn, a_mx)
    if bf16:
        refuse_bf16_grad(*tensors)
        return _forward(x, w, b, w_mn, w_mx, a_mn, a_mx, w_observing, a_observing, w_bits, a_bits, bf16, gelu)
    if _needs_grad(*(t for t in tensors if t is not None)):
        return _QatDense.apply(x, w, b, w_mn, w_mx, a_mn, a_mx, w_observing, a_observing, w_bits, a_bits, w_s, a_s,
                               gelu)
    return _forward(x, w, b, w_mn, w_mx, a_mn, a_mx, w_observing, a_observing, w_bits, a_bits, gelu=gelu)
