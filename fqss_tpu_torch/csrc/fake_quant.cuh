// The per-tensor uniform grid of K1 and the per-channel symmetric grid of K2
// (and the exact GELU of the K5 and K4 epilogues) as device functions, shared by every kernel that applies them
// (fake_quant.cu's act_fake_quant_kernel and weight_fake_quant_kernel,
// attention.cu's epilogue, qat_dense.cu's weight tiles and epilogue), so that
// a value that reaches a grid lands on the same grid point bit for bit in all
// of them:
//
//   delta = (mx - mn) / Q,  y = delta * clip(rint((x - mn) / delta), 0, Q) + mn,  Q = 2^b - 1;
//   delta_c = 2 max(|mn_c|, |mx_c|) / Q,  w_q = delta_c * clip(rint(w / delta_c), -2^(b-1), 2^(b-1) - 1).
//
// Explicit round-to-nearest intrinsics keep nvcc from contracting delta * C + mn
// into an FMA (PyTorch rounds the product and the sum apart); rintf rounds half
// to even, like torch.round; the clip keeps a NaN. Do not build with --use_fast_math.

#pragma once

#include <cuda_runtime.h>

namespace fqss {

// clip(X, lo, hi) that keeps a NaN (fminf/fmaxf would drop it).
__device__ __forceinline__ float clip(float X, float lo, float hi) { return X < lo ? lo : (X > hi ? hi : X); }

__device__ __forceinline__ float act_grid_step(float mn, float mx, float q) { return __fdiv_rn(__fsub_rn(mx, mn), q); }

__device__ __forceinline__ float act_grid_value(float x, float mn, float delta, float q) {
  const float C = clip(rintf(__fdiv_rn(__fsub_rn(x, mn), delta)), 0.0f, q);
  return __fadd_rn(__fmul_rn(delta, C), mn);
}

__device__ __forceinline__ float weight_grid_step(float mn, float mx, float q) {
  return __fdiv_rn(__fmul_rn(2.0f, fmaxf(fabsf(mn), fabsf(mx))), q);
}

__device__ __forceinline__ float weight_grid_value(float w, float delta, float qmin, float qmax) {
  return __fmul_rn(delta, clip(rintf(__fdiv_rn(w, delta)), qmin, qmax));
}

// The exact GELU of K5's and K4's epilogues, jax.nn.gelu(approximate=False) operation for operation:
// 0.5 x erfc(-x sqrt(1/2)), sqrt(1/2) rounded to float32. erfcf is the function PyTorch's erfc calls on the card,
// so the plain versions (fqss_tpu_torch/nn/nonlin.py:gelu) agree bit for bit.
__device__ __forceinline__ float gelu(float x) {
  return __fmul_rn(__fmul_rn(0.5f, x), erfcf(__fmul_rn(-x, 0.70710678118654752440f)));
}

// dy = d gelu(x) / dx as JAX's autodiff of 0.5 x erfc(-x sqrt(1/2)) computes it for a unit cotangent, operation for
// operation (K5-bwd's GELU route): with d = -x sqrt(1/2), 0.5 erfc(d) - ((-(2 / sqrt(pi)) (0.5 x)) exp(-d^2))
// sqrt(1/2), 2 / sqrt(pi) rounded to float32 (erfc's derivative is -(2 / sqrt(pi)) exp(-z^2)). The plain version is
// fqss_tpu_torch/nn/nonlin.py:gelu_grad; expf and erfcf are the functions PyTorch's exp and erfc call on the card.
// gelu(x) beside it, sharing erfc(d): the same y as gelu(x).
__device__ __forceinline__ void gelu_with_grad(float x, float& y, float& dy) {
  const float d = __fmul_rn(-x, 0.70710678118654752440f);
  const float c = erfcf(d);
  const float e = expf(-__fmul_rn(d, d));
  const float q = __fmul_rn(__fmul_rn(__fmul_rn(-1.12837916709551257390f, __fmul_rn(0.5f, x)), e),
                            0.70710678118654752440f);
  y = __fmul_rn(__fmul_rn(0.5f, x), c);
  dy = __fadd_rn(-q, __fmul_rn(0.5f, c));
}

}  // namespace fqss
