// The per-tensor uniform grid of K1 as device functions, shared by every
// kernel that ends in an activation fake-quant (fake_quant.cu's
// act_fake_quant_kernel, attention.cu's epilogue), so that a value that
// reaches the grid lands on the same grid point bit for bit in all of them:
//
//   delta = (mx - mn) / Q,  y = delta * clip(rint((x - mn) / delta), 0, Q) + mn,  Q = 2^b - 1.
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

}  // namespace fqss
