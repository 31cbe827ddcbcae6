"""Fused fake-quant matmul (K3): wrapper, plain version and launch counter.

The CUDA kernel replaces ``fqss_tpu/ops/pallas_quant.py:qmatmul_pallas``
(``_qmm_kernel``), a forward-only kernel::

    y[b] = act_fq(weight_fq(w) @ x[b])

``x [B, K, T]`` (the port's NCT activations), the weight ``w [N, K]`` (a
bias-free 1x1 convolution's ``[Cout, Cin, 1]``, squeezed) with its
per-out-channel symmetric ranges (``N`` values, in any shape), and the
one-element ranges of the output's uniform grid; ``y [B, N, T]``; all
float32. JAX's kernel takes ``x [M, K] @ w [K, N]`` with ``M = B T`` rows:
the same products on the transposed layout. It has no bias and no
``custom_vjp``, so nothing differentiates through it: a caller that needs a
gradient computes the same function with the differentiable quantizers
(``nn/layers.py:QConv1d``).

The kernel is K5's (``csrc/qat_dense.cu``) with the bias off, the weight as
the row operand, each batch row's ``[K, T]`` slice as the column operand and
the batch on the grid's third axis. So are its grids: the weight grid once a
call (K2's device function), the act grid in the epilogue (K1's), each
switched off where its ranges are ``None`` (the folded serving model has no
weight grid) or skipped on the device while its one-element bool
"observing" flag is set (``where(observing, v, fq(v))``), as in K5.

``bf16=True`` is the bf16 route, K5's: ``x`` and the weight (after its
grid) rounded to bfloat16 as the kernel loads them, the sums float32.

A CUDA tensor launches the kernel, or the wrapper raises: there is no
fallback. A CPU tensor takes the plain version, :func:`qmatmul_ref` (the
weight grid, ``torch.matmul``, the act grid). ``LAUNCHES["qmatmul"]``
counts the kernel's launches, ``LAUNCHES["qmatmul_bf16"]`` its bf16 route's.
"""

from __future__ import annotations

import torch

from fqss_tpu_torch.ops import _build
from fqss_tpu_torch.ops.fake_quant import _check_device, _launch, _needs_grad
from fqss_tpu_torch.ops.qat_dense import _ptr, _weight_q, _weight_scratch, act_q, check_grids, operands

Tensor = torch.Tensor

LAUNCHES = {"qmatmul": 0, "qmatmul_bf16": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def qmatmul_ref(x: Tensor, w: Tensor, w_mn: Tensor | None = None, w_mx: Tensor | None = None,
                a_mn: Tensor | None = None, a_mx: Tensor | None = None, w_bits: int = 8, a_bits: int = 8,
                w_observing: Tensor | None = None, a_observing: Tensor | None = None, bf16: bool = False) -> Tensor:
    """Plain version: ``act_fq(weight_fq(w) @ x[b])`` for every ``b``, each grid skipped where its flag is set; under
    ``bf16`` the product's operands rounded to bfloat16 (the sums float32: TF32 off)."""
    xc, wc = operands(x, _weight_q(w, w_mn, w_mx, w_bits, w_observing), bf16)
    pre = torch.matmul(wc, xc)
    return act_q(pre, a_mn, a_mx, a_bits, a_observing)


def qmatmul(x: Tensor, w: Tensor, w_mn: Tensor | None = None, w_mx: Tensor | None = None,
            a_mn: Tensor | None = None, a_mx: Tensor | None = None, w_bits: int = 8, a_bits: int = 8,
            w_observing: Tensor | None = None, a_observing: Tensor | None = None, bf16: bool = False) -> Tensor:
    """``act_fq(weight_fq(w [N, K]) @ x[b])`` for every ``x[b] [K, T]`` of ``x [B, K, T]`` -> ``[B, N, T]``.

    ``w_mn``/``w_mx``: the weight grid's per-out-channel ranges, or None for no weight grid; ``a_mn``/``a_mx``:
    the output grid's one-element ranges, or None. ``w_observing``/``a_observing``: one-element bool tensors
    (or None): where set, that grid is skipped. ``bf16``: the product's operands rounded to bfloat16. Forward
    only: raises where a gradient would be needed."""
    _check_device("qmatmul", x)
    if x.ndim != 3 or w.ndim != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"qmatmul: x [B, K, T] and w [N, K] expected, got {tuple(x.shape)} and {tuple(w.shape)}")
    check_grids("qmatmul", (("x", x), ("w", w)), w.shape[0], w_mn, w_mx, a_mn, a_mx, w_observing, a_observing)
    if _needs_grad(*(t for t in (x, w, w_mn, w_mx, a_mn, a_mx) if t is not None)):
        raise ValueError("qmatmul is forward only, as qmatmul_pallas: compute a gradient through the "
                         "differentiable quantizers")
    if x.device.type == "cpu":
        return qmatmul_ref(x, w, w_mn, w_mx, a_mn, a_mx, w_bits, a_bits, w_observing, a_observing, bf16)
    (B, K, T), N = x.shape, w.shape[0]
    y = torch.empty(B, N, T, device=x.device)
    if y.numel():
        wq = _weight_scratch(w, w_mn)
        lib = _build.library()
        _launch("qmatmul", lib.fqss_qmatmul_bf16 if bf16 else lib.fqss_qmatmul, x.device, x.data_ptr(),
                w.data_ptr(), _ptr(w_mn), _ptr(w_mx), _ptr(w_observing), _ptr(a_mn), _ptr(a_mx), _ptr(a_observing),
                _ptr(wq), y.data_ptr(), B, K, T, N, w_bits, a_bits)
        LAUNCHES["qmatmul_bf16" if bf16 else "qmatmul"] += 1
    return y
