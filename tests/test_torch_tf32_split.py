"""The 3xTF32 arithmetic of ``csrc/qat_dense.cu``'s products, emulated on the CPU.

The kernel (K5, K5-bwd, K3) takes each float32 product on the tensor cores as
three TF32 ones: a value v splits into ``hi`` (v rounded to TF32: 10 mantissa
bits, to nearest, ties away from zero, as ``cvt.rna.tf32.f32``) and
``lo = v - hi`` (exact in float32; the tensor cores read its top 10 mantissa
bits), and ``a b ~ lo_a hi_b + hi_a lo_b + hi_a hi_b``. The products of two
TF32 values are exact in float32; each k8 step's three products are summed in
float32, each 32-step stage from zero, and the stages added to the float32
accumulator. These tests emulate that on the CPU and hold it to the float64
product within ``DENSE_RTOL`` of the sum of the terms' magnitudes (the bound
the card tests hold the kernels to, ``tests/test_torch_cuda.py``) with a
margin of at least 10x, and record why one TF32 product alone was rejected.
"""

import numpy as np
import pytest
import torch

DENSE_RTOL = 1e-5  # tests/test_torch_cuda.py and chip_smoke.py's bound for the float products
MARGIN = 10  # the emulated error stays this many times inside DENSE_RTOL
STEP = 2.0**-7  # the planted ties' grid step (tests/test_torch_cuda.py)


def rna_tf32(v: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: float32 rounded to 10 mantissa bits, to nearest, ties away from zero, on the int32 view."""
    bits = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32).view(torch.float32)


def trunc_tf32(v: torch.Tensor) -> torch.Tensor:
    """The TF32 value the tensor cores read from a float32 register: its low 13 mantissa bits dropped."""
    return (v.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = rna_tf32(v)
    return hi, trunc_tf32(v - hi)


def product_3xtf32(a: torch.Tensor, b: torch.Tensor, stage: int = 32) -> torch.Tensor:
    """a [M, K] @ b [K, N] as the kernel takes it: per k8 step lo*hi + hi*lo + hi*hi in float32, each stage of
    ``stage`` steps summed from zero, the stages added in float32."""
    (ah, al), (bh, bl) = split(a), split(b)
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for s0 in range(0, a.shape[1], stage):
        part = torch.zeros_like(acc)
        for k in range(s0, min(s0 + stage, a.shape[1]), 8):
            ks = slice(k, k + 8)
            for x, y in ((al, bh), (ah, bl), (ah, bh)):
                part = part + x[:, ks] @ y[ks]
        acc = acc + part
    return acc


def product_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 product a term, what plain TF32 tensor-core math would give."""
    return rna_tf32(a) @ rna_tf32(b)


def relative_error(got: torch.Tensor, a: np.ndarray, b: np.ndarray) -> float:
    """max |got - a @ b| / sum |term|, in float64."""
    exact = a.astype(np.float64) @ b.astype(np.float64)
    terms = np.abs(a.astype(np.float64)) @ np.abs(b.astype(np.float64))
    return float((np.abs(got.double().numpy() - exact) / np.maximum(terms, 1e-300)).max())


def test_rna_rounds_to_nearest_ties_away_from_zero():
    one = 1.0
    ulp = 2.0**-10  # TF32's at 1
    v = torch.tensor([one, one + ulp / 2, one + ulp / 2 - 2**-23, one + ulp / 2 + 2**-23, -(one + ulp / 2),
                      3.0 * 2**-7, 2.0**-130, float("inf"), -float("inf")], dtype=torch.float32)
    want = torch.tensor([one, one + ulp, one, one + ulp, -(one + ulp), 3.0 * 2**-7, 2.0**-130, float("inf"),
                         -float("inf")], dtype=torch.float32)
    assert torch.equal(rna_tf32(v), want)
    assert torch.isnan(rna_tf32(torch.tensor([float("nan")]))).all()


def test_split_is_exact_up_to_lo_truncation():
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    hi, lo = split(v)
    assert torch.equal(hi, rna_tf32(hi)) and torch.equal(lo, trunc_tf32(lo))
    rest = (v.double() - hi.double() - lo.double()).abs()
    assert bool((rest <= 2.0**-21 * v.double().abs()).all())  # what the three products cannot see


# Shapes (M, K, N): tests/test_torch_cuda.py's DENSE_SHAPES, then chip_smoke.py's phase 31 (the QDense layers of
# DPTNet and the Sepformer) and phase 37 (K3: K -> N over B T columns) with M, the token count, cut to 256.
SHAPES = [(300, 256, 1024), (257, 1024, 256), (1000, 256, 64), (77, 64, 128), (5, 3, 2), (1, 256, 512),
          (300, 37, 65), (130, 1030, 200),
          (256, 256, 64), (256, 64, 128), (256, 256, 1024), (256, 1024, 256), (256, 256, 512)]


@pytest.mark.parametrize("sign", ["random", "positive"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_3xtf32_is_float32_accurate(m, k, n, sign):
    """Within DENSE_RTOL / MARGIN of sum |term| of the float64 product, unit-variance terms of random sign, or all
    positive (where a truncating sum would drift the most)."""
    rng = np.random.default_rng(m * k + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    if sign == "positive":
        a, b = np.abs(a), np.abs(b)
    err = relative_error(product_3xtf32(torch.from_numpy(a), torch.from_numpy(b)), a, b)
    assert err <= DENSE_RTOL / MARGIN, err


def test_planted_ties_are_tf32_exact_and_sum_exactly():
    """The card tests' planted ties: activations 1..5, a weight grid of step 1/128 (w[0, 0] = 5 steps), a bias half
    a step above the act grid's mn: every value is TF32-exact (lo = 0), so the products and the pre-activation
    (mn + (5 (r + 1) + 0.5) steps) come out exact, and round on the act grid as the plain version's."""
    x = torch.zeros(6, 16)
    x[:, 0] = torch.tensor([1.0, 2, 3, 4, 5, 0])
    grid = torch.arange(-128, 128, dtype=torch.float32) / 128  # the weight grid's points at step 1/128
    w = torch.zeros(16, 1)
    w[0, 0] = 5 * STEP
    for v in (x, w, grid):
        assert torch.equal(split(v)[1], torch.zeros_like(v))
    pre = product_3xtf32(x, w)[:, 0] + (-1.0 + 0.5 * STEP)
    want = torch.tensor([-1.0 + (5 * (r + 1) + 0.5) * STEP for r in range(5)] + [-1.0 + 0.5 * STEP])
    assert torch.equal(pre, want)


def test_one_tf32_product_is_not_enough():
    """A value that is not TF32-exact: one TF32 product a term puts the sum more than DENSE_RTOL of sum |term| off
    the float64 product, 3xTF32 keeps it within DENSE_RTOL / MARGIN. Why the kernel takes three."""
    a = np.full((1, 256), 1.0 + 2.0**-12, dtype=np.float32)  # halfway below TF32's first step above 1
    b = np.full((256, 1), 1.0 + 3 * 2.0**-13, dtype=np.float32)
    assert not torch.equal(split(torch.from_numpy(a))[1], torch.zeros(1, 256))
    one = relative_error(product_1xtf32(torch.from_numpy(a), torch.from_numpy(b)), a, b)
    three = relative_error(product_3xtf32(torch.from_numpy(a), torch.from_numpy(b)), a, b)
    assert one > DENSE_RTOL, one
    assert three <= DENSE_RTOL / MARGIN, three
    rng = np.random.default_rng(1)
    a = rng.standard_normal((64, 256)).astype(np.float32)
    b = (rng.standard_normal((256, 64)) / 16).astype(np.float32)
    assert relative_error(product_1xtf32(torch.from_numpy(a), torch.from_numpy(b)), a, b) > DENSE_RTOL
