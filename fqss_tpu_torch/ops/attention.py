"""Fused attention core: wrappers, autograd Functions, plain versions, launch plan and launch counter.

The CUDA kernel in ``csrc/attention.cu`` (K8) replaces the TPU kernel of the
dual-path transformers' attention, ``fqss_tpu/ops/pallas_attention.py``
(``fused_attention``, ``_attn_kernel``)::

    heads = softmax(qs @ k^T) @ v                       # per head
    out   = act_fake_quant(heads, mn, mx, n_bits)       # when quantize is set

``qs`` is the query heads already scaled by 1/sqrt(d) and div-quantized, all
float32; ``mn``/``mx`` the one-element range of the head quantizer, read on
the device. The logits never reach device memory. Unlike the TPU kernel,
which pads d and Lk to 128 lanes and is gated to ``32 <= d``, ``L >= 128`` (a
TPU profitability rule), the kernel takes any ``L >= 1`` and any
``d <= 128``: on the card every attention core that the module computes this
way goes through it, DPTNet's ``d = 16`` heads and the Sepformer's short
inter-chunk sequences included. Two entries reach it:

* :func:`fused_attention` over ``[BH, L, d]`` contiguous tensors, JAX's layout
  and contract;
* :func:`fused_attention_packed` over ``[B, L, h, d]`` views with any outer
  strides (the module's ``Q.view(B, L, h, d)`` and the K and V thirds of its
  ``[B, L, 3E]`` in-projection), writing the heads as ``[B, Lq, h d]``, ready
  for the out-projection: no copy of the head layout on either side.

A CUDA tensor launches the kernel, or the wrapper raises: there is no
fallback, and the packed entry raises on a view it cannot take rather than
copy it. A CPU tensor takes the plain version (:func:`fused_attention_ref`:
``torch.matmul``, ``torch.softmax``, ``torch.matmul``, then
``act_fake_quant_ref``, the composition of ``_attention_xla``; the packed
entry's takes the head-layout copies through it). When a gradient is needed
the call runs through a ``torch.autograd.Function`` whose backward
differentiates the plain version on the saved inputs, as JAX's ``custom_vjp``
rematerialises ``_attention_xla``. :func:`plan` sizes the launch: key tiles,
warps a head, heads a block. ``LAUNCHES["attention"]`` counts the kernel's
launches.

``bf16=True`` is the bf16 route (``QuantSpec.compute_dtype="bfloat16"``):
JAX's default composition under bf16 (``fqss_tpu/nn/attention.py:117-130``),
``softmax(bf16(qs) @ bf16(k)^T)`` normalised in float32 and rounded to
bfloat16 before its product with ``bf16(v)``, the sums float32
(:func:`fused_attention_ref` with ``bf16=True``; the softmax's sum taken in
float64 and rounded once, so that its last bit does not depend on the order
of the sum). The kernel takes three passes over the keys for it
(``csrc/attention.cu``). It has no backward: with a
gradient needed it raises ``NotImplementedError``. ``LAUNCHES["attention_bf16"]``
counts its launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from fqss_tpu_torch.ops import _build
from fqss_tpu_torch.ops.fake_quant import _check_device, _needs_grad, act_fake_quant_ref, refuse_bf16_grad
from fqss_tpu_torch.quant.fake_quant import bf16_round

Tensor = torch.Tensor

LAUNCHES = {"attention": 0, "attention_bf16": 0}

# csrc/attention.cu's limits: the head widths it pads d to, its K/V ring's stages, and the shared memory a block may
# take for two blocks to fit an SM (228 KB, 1 KB of it reserved a block).
DIMS = (16, 32, 64, 128)
RING = 3
SMEM_BUDGET = 112 * 1024
ROWS = 16  # query rows of an m16 tile (the mma's m16); a warp owns mt of them
PACK_WARPS = 4  # a block takes whole heads up to this many 16-row warps


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class Plan(NamedTuple):
    """A launch of ``attention_kernel``: the padded head width, the key tile (``tile`` keys, ``tiles`` of them),
    the warps a head (``wph``, ``16 mt`` query rows each), the heads a block (``hpb``), the blocks along a head's
    queries (``qblocks``), the m16 tiles of a warp (``mt``) and the passes over the key tiles (3 on the bf16
    route)."""

    dim: int
    tile: int
    tiles: int
    wph: int
    hpb: int
    qblocks: int
    mt: int = 1
    passes: int = 1

    @property
    def smem(self) -> int:
        """A block's shared memory in bytes: the ring's stages (no more than the tiles of all passes) of K and V rows
        of dim + 8 floats for each head of the block, and each warp's 16 mt rows of Q of dim + 4."""
        return (min(RING, self.tiles * self.passes) * self.hpb * self.tile * 2 * (self.dim + 8)
                + self.wph * self.hpb * ROWS * self.mt * (self.dim + 4)) * 4

    def blocks(self, bh: int) -> int:
        return _cdiv(bh, self.hpb) * self.qblocks


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def max_warps(dim: int, mt: int) -> int:
    """The most warps of a block (``Cfg<D, MT>::kWarps``): 4 with two m16 tiles a warp or at d 16, else 8."""
    return 4 if mt == 2 or dim <= 16 else 8


def max_tile(dim: int, mt: int = 1) -> int:
    """The largest key tile: 64 keys, 32 with two m16 tiles a warp or at d 128 (the kernel's registers)."""
    return 64 if mt == 1 and dim <= 64 else 32


@functools.lru_cache(maxsize=1024)
def plan(bh: int, lq: int, lk: int, d: int, bf16: bool = False) -> Plan:
    """The launch for ``bh`` heads of ``lq`` queries and ``lk`` keys of width ``d`` (``bf16``: the bf16 route's,
    whose ring runs over the key tiles three times).

    Queries: where a head needs at most PACK_WARPS warps of 16 rows, a block takes as many whole heads as fit in
    PACK_WARPS warps (Lq 16: 4 heads; Lq 34: 3 warps, one head), fewer where their tiles would pass SMEM_BUDGET;
    else a warp takes 32 rows (two m16 tiles; 16 at d above 64) and a head's warps are spread evenly over the
    fewest blocks of at most ``max_warps`` (Lq 250: 2 blocks of 4 warps; Lq 258: 3 blocks of 3). Key tiles: the fewest that the largest
    tile allows, each a multiple of 8 keys sized to the sequence (Lk 34: one tile of 40; Lk 250 at two m16 tiles a
    warp: eight of 32; Lk 258: nine of 32).
    """
    if min(bh, lq, lk, d) < 1 or d > DIMS[-1]:
        raise ValueError(f"attention plan: no launch for BH {bh}, Lq {lq}, Lk {lk}, d {d}")
    dim = next(x for x in DIMS if d <= x)
    mt = 1 if _cdiv(lq, ROWS) <= PACK_WARPS or dim > 64 else 2
    tiles = _cdiv(lk, max_tile(dim, mt))
    tile = 8 * _cdiv(_cdiv(lk, tiles), 8)
    row_warps = _cdiv(lq, ROWS * mt)
    passes = 3 if bf16 else 1
    if mt == 1:
        hpb = max(1, min(PACK_WARPS // row_warps, bh))
        while hpb > 1 and Plan(dim, tile, tiles, row_warps, hpb, 1, 1, passes).smem > SMEM_BUDGET:
            hpb -= 1
        return Plan(dim, tile, tiles, row_warps, hpb, 1, 1, passes)
    qblocks = _cdiv(row_warps, max_warps(dim, mt))
    return Plan(dim, tile, tiles, _cdiv(row_warps, qblocks), 1, qblocks, mt, passes)


def softmax_ref(s: Tensor) -> Tensor:
    """``jax.nn.softmax`` over the last axis: ``exp(s - max) / sum``, a true division, the sum taken in float64 and
    rounded once (the bf16 route rounds the result, so its last bit matters; a float32 sum's last bits depend on
    its order, which XLA's and the kernel's do not share)."""
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return e / e.double().sum(-1, keepdim=True).float()


def bf16_tie_mask(p: Tensor, ulps: int = 2) -> Tensor:
    """Where a float32 value lies within ``ulps`` float32 ulps of a bfloat16 rounding tie (its low 16 bits within
    ``ulps`` of 0x8000). A softmax weight there can round to the other bf16 neighbour when its exp or its row's sum
    moves by an ulp, which sums taken in another order do: K8's bf16 route is held to its plain version with one
    bf16 step of slack on such weights (``chip_smoke.py``, ``tests/test_torch_bf16.py``)."""
    low = p.float().contiguous().view(torch.int32) & 0xFFFF
    return (low - 0x8000).abs() <= ulps


def fused_attention_ref(qs: Tensor, k: Tensor, v: Tensor, min_range: Tensor | None = None,
                        max_range: Tensor | None = None, n_bits: int = 8, quantize: bool = True,
                        bf16: bool = False) -> Tensor:
    """Plain version: ``softmax(qs @ k^T) @ v``, then the head grid when ``quantize``. ``bf16``: JAX's composition
    under bf16, every product's operands rounded to bfloat16 (the softmax's after it is normalised), the sums
    float32 (TF32 off)."""
    if bf16:
        logits = torch.matmul(bf16_round(qs), bf16_round(k).transpose(-1, -2))
        heads = torch.matmul(bf16_round(softmax_ref(logits)), bf16_round(v))
    else:
        heads = torch.matmul(torch.softmax(torch.matmul(qs, k.transpose(-1, -2)), dim=-1), v)
    return act_fake_quant_ref(heads, min_range, max_range, n_bits) if quantize else heads


def head_layout(x: Tensor) -> Tensor:
    """``[B, L, h, d]`` -> the contiguous ``[B h, L, d]`` of JAX's kernel (a copy)."""
    B, L, h, d = x.shape
    return x.transpose(1, 2).reshape(B * h, L, d).contiguous()


def fused_attention_packed_ref(q: Tensor, k: Tensor, v: Tensor, min_range: Tensor | None = None,
                               max_range: Tensor | None = None, n_bits: int = 8, quantize: bool = True,
                               bf16: bool = False) -> Tensor:
    """Plain version of :func:`fused_attention_packed`: :func:`fused_attention_ref` on the head-layout copies,
    the heads transposed back to ``[B, Lq, h d]``."""
    B, Lq, h, d = q.shape
    heads = fused_attention_ref(head_layout(q), head_layout(k), head_layout(v), min_range, max_range, n_bits,
                                quantize, bf16)
    return heads.reshape(B, h, Lq, d).transpose(1, 2).reshape(B, Lq, h * d)


def _check_ranges(name: str, min_range: Tensor | None, max_range: Tensor | None,
                  quantize: bool) -> tuple:
    ranges = (("min_range", min_range), ("max_range", max_range)) if quantize else ()
    for rname, r in ranges:
        if r is None or r.numel() != 1:
            raise ValueError(f"{name}: quantize needs a one-element {rname}")
    return ranges


def _check_tensor(name: str, tname: str, t: Tensor, ref: Tensor) -> None:
    if t.device != ref.device:
        raise ValueError(f"{name}: {tname} is on {t.device}, q on {ref.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32, {tname} is {t.dtype}")


def _check(qs: Tensor, k: Tensor, v: Tensor, min_range: Tensor | None, max_range: Tensor | None,
           quantize: bool) -> None:
    """Hold the ``[BH, L, d]`` operands to what the kernel takes, on every device."""
    if qs.ndim != 3 or k.ndim != 3 or k.shape != v.shape or k.shape[0] != qs.shape[0] or k.shape[2] != qs.shape[2]:
        raise ValueError(f"fused_attention: qs [BH, Lq, d] and k, v [BH, Lk, d] expected, got {tuple(qs.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if k.shape[1] == 0:
        raise ValueError("fused_attention: no keys (Lk = 0)")
    ranges = _check_ranges("fused_attention", min_range, max_range, quantize)
    for name, t in (("qs", qs), ("k", k), ("v", v), *ranges):
        _check_tensor("fused_attention", name, t, qs)
        if not t.is_contiguous():
            raise ValueError(f"fused_attention: the kernel takes contiguous tensors ({name} is not)")


def _outer_strides(x: Tensor) -> list[int]:
    """The strides of a ``[B, L, h, d]`` view's first three axes, 0 where the axis has one index."""
    return [s if n > 1 else 0 for s, n in zip(x.stride()[:3], x.shape[:3])]


def _aligned(*views: Tensor) -> bool:
    """Every row of the ``[B, L, h, d]`` views starts on 16 bytes (the kernel's 16-byte copies; else it takes
    4-byte ones)."""
    return all(x.data_ptr() % 16 == 0 and all(s % 4 == 0 for s in _outer_strides(x)) for x in views)


def _check_packed(q: Tensor, k: Tensor, v: Tensor, min_range: Tensor | None, max_range: Tensor | None,
                  quantize: bool) -> None:
    """Hold the ``[B, L, h, d]`` views to what the kernel takes: a unit inner stride."""
    name = "fused_attention_packed"
    if (q.ndim != 4 or k.ndim != 4 or k.shape != v.shape or k.shape[0] != q.shape[0]
            or k.shape[2:] != q.shape[2:]):
        raise ValueError(f"{name}: q [B, Lq, h, d] and k, v [B, Lk, h, d] expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if k.shape[1] == 0:
        raise ValueError(f"{name}: no keys (Lk = 0)")
    ranges = _check_ranges(name, min_range, max_range, quantize)
    for tname, t in (("q", q), ("k", k), ("v", v)):
        _check_tensor(name, tname, t, q)
        if t.shape[3] > 1 and t.stride(3) != 1:
            raise ValueError(f"{name}: the kernel takes a unit inner stride ({tname} has {t.stride(3)})")
    for rname, r in ranges:
        _check_tensor(name, rname, r, q)


def _launch(q: Tensor, k: Tensor, v: Tensor, min_range: Tensor | None, max_range: Tensor | None, out: Tensor,
            n_bits: int, quantize: bool, bf16: bool = False) -> None:
    """Launch the kernel (``bf16``: its bf16 route) on ``[B, L, h, d]`` views (out ``[B, Lq, h, d]``); the C entry's
    int64 argument array (``csrc/attention.cu``'s ``enum Arg``) holds the shape, the views' outer strides, the plan,
    whether q's, k's and v's rows lie on 16 bytes (the kernel's 16-byte copies, else 4-byte ones) and the plan's m16
    tiles a warp."""
    B, Lq, H, d = q.shape
    if d > DIMS[-1]:
        raise ValueError(f"fused_attention: head width {d} exceeds the kernel's {DIMS[-1]}")
    lib = _build.library()
    p = plan(B * H, Lq, k.shape[1], d, bf16)
    dims = (ctypes.c_int64 * 24)(B, H, Lq, k.shape[1], d, *_outer_strides(q), *_outer_strides(k),
                                 *_outer_strides(v), *_outer_strides(out), p.tile, p.tiles, p.wph, p.hpb,
                                 p.qblocks, int(_aligned(q, k, v)), p.mt)
    entry = lib.fqss_attention_bf16 if bf16 else lib.fqss_attention
    with torch.cuda.device(q.device):
        rc = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), min_range.data_ptr() if quantize else None,
                   max_range.data_ptr() if quantize else None, out.data_ptr(), dims, int(quantize), n_bits,
                   torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_attention: CUDA launch failed with error {rc}")
    LAUNCHES["attention_bf16" if bf16 else "attention"] += 1


def _forward(qs: Tensor, k: Tensor, v: Tensor, min_range: Tensor | None, max_range: Tensor | None, n_bits: int,
             quantize: bool, bf16: bool = False) -> Tensor:
    if qs.device.type == "cpu":
        with torch.no_grad():
            return fused_attention_ref(qs, k, v, min_range, max_range, n_bits, quantize, bf16)
    out = torch.empty_like(qs)
    if out.numel():
        _launch(qs.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2), min_range, max_range, out.unsqueeze(2), n_bits,
                quantize, bf16)
    return out


def _forward_packed(q: Tensor, k: Tensor, v: Tensor, min_range: Tensor | None, max_range: Tensor | None,
                    n_bits: int, quantize: bool, bf16: bool = False) -> Tensor:
    if q.device.type == "cpu":
        with torch.no_grad():
            return fused_attention_packed_ref(q, k, v, min_range, max_range, n_bits, quantize, bf16)
    B, Lq, h, d = q.shape
    out = q.new_empty(B, Lq, h * d)
    if out.numel():
        _launch(q, k, v, min_range, max_range, out.view(B, Lq, h, d), n_bits, quantize, bf16)
    return out


def _backward(ctx, g, ref):
    """The plain composition's gradient at the saved inputs (``pallas_attention.py:_vjp_bwd``)."""
    saved = ctx.saved_tensors
    wanted = [i for i, t in enumerate(saved) if t is not None and ctx.needs_input_grad[i]]
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(i in wanted) if t is not None else None for i, t in enumerate(saved)]
        out = ref(*inputs, ctx.n_bits, ctx.quantize)
        grads = torch.autograd.grad(out, [inputs[i] for i in wanted], g)
    result = [None] * 5
    for i, gi in zip(wanted, grads):
        result[i] = gi
    return (*result, None, None)


def _save(ctx, q, k, v, min_range, max_range, n_bits, quantize) -> None:
    ctx.n_bits, ctx.quantize = n_bits, quantize
    # Copies of the ranges: an observer may write them in place after this call.
    ranges = (min_range.detach().clone(), max_range.detach().clone()) if quantize else (None, None)
    ctx.save_for_backward(q, k, v, *ranges)


class _FusedAttention(torch.autograd.Function):
    """The kernel forward over ``[BH, L, d]``, and the plain composition's gradient."""

    @staticmethod
    def forward(ctx, qs, k, v, min_range, max_range, n_bits, quantize):
        _save(ctx, qs, k, v, min_range, max_range, n_bits, quantize)
        return _forward(qs, k, v, min_range, max_range, n_bits, quantize)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, g, fused_attention_ref)


class _FusedAttentionPacked(torch.autograd.Function):
    """The kernel forward over ``[B, L, h, d]`` views, and the plain composition's gradient at the saved views."""

    @staticmethod
    def forward(ctx, q, k, v, min_range, max_range, n_bits, quantize):
        _save(ctx, q, k, v, min_range, max_range, n_bits, quantize)
        return _forward_packed(q, k, v, min_range, max_range, n_bits, quantize)

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, g, fused_attention_packed_ref)


def fused_attention(qs: Tensor, k: Tensor, v: Tensor, min_range: Tensor | None = None,
                    max_range: Tensor | None = None, n_bits: int = 8, quantize: bool = True,
                    bf16: bool = False) -> Tensor:
    """``softmax(qs @ k^T) @ v`` over contiguous ``[BH, L, d]``, with the head grid ``(min_range, max_range)``
    applied in the kernel's epilogue when ``quantize`` (the ranges are then required); differentiable. ``bf16``:
    the bf16 route (forward only: raises ``NotImplementedError`` where a gradient is needed)."""
    _check_device("fused_attention", qs)
    _check(qs, k, v, min_range, max_range, quantize)
    tensors = (qs, k, v, *((min_range, max_range) if quantize else ()))
    if bf16:
        refuse_bf16_grad(*tensors)
        return _forward(qs, k, v, min_range, max_range, n_bits, quantize, bf16=True)
    if _needs_grad(*tensors):
        return _FusedAttention.apply(qs, k, v, min_range, max_range, n_bits, quantize)
    return _forward(qs, k, v, min_range, max_range, n_bits, quantize)


def fused_attention_packed(q: Tensor, k: Tensor, v: Tensor, min_range: Tensor | None = None,
                           max_range: Tensor | None = None, n_bits: int = 8, quantize: bool = True,
                           bf16: bool = False) -> Tensor:
    """:func:`fused_attention` on ``q [B, Lq, h, d]`` and ``k, v [B, Lk, h, d]`` views (any outer strides, a unit
    inner stride), the heads returned as a new ``[B, Lq, h d]``; differentiable. ``bf16``: the bf16 route (forward
    only)."""
    _check_device("fused_attention_packed", q)
    _check_packed(q, k, v, min_range, max_range, quantize)
    tensors = (q, k, v, *((min_range, max_range) if quantize else ()))
    if bf16:
        refuse_bf16_grad(*tensors)
        return _forward_packed(q, k, v, min_range, max_range, n_bits, quantize, bf16=True)
    if _needs_grad(*tensors):
        return _FusedAttentionPacked.apply(q, k, v, min_range, max_range, n_bits, quantize)
    return _forward_packed(q, k, v, min_range, max_range, n_bits, quantize)
