// Fake-quantization kernels for NVIDIA Hopper (sm_90a), forward only.
//
// Two kernels carry every quantizer of the FQSS-8bit ConvTasNet serving path:
//
//   act_fake_quant_kernel     replaces fqss_tpu/ops/pallas_qat.py:_act_fwd_kernel
//                             (the forward of act_fake_quant_train) and
//                             fqss_tpu/ops/pallas_quant.py:_fq_kernel
//                             (fake_quant_pallas): per-tensor uniform grid
//                             y = d * clip(rint((x - mn) / d), 0, Q) + mn,
//                             d = (mx - mn) / Q, Q = 2^b - 1.
//   weight_fake_quant_kernel  replaces fqss_tpu/ops/pallas_qat.py:_w_fwd_kernel
//                             (the forward of weight_fake_quant_train):
//                             per-channel symmetric grid
//                             y = d_c * clip(rint(w / d_c), -2^(b-1), 2^(b-1)-1),
//                             d_c = 2 * max(|mn_c|, |mx_c|) / Q.
//
// What bounds them on the H100: both are elementwise and read 4 bytes and
// write 4 bytes per element against about ten floating-point operations, far
// below the card's ratio of operations to bytes, so device-memory bandwidth
// (3.35 TB/s) is the limit for the large activations; the weights (at most
// 131,072 elements in the ConvTasNet) are bound by launch latency.
//
// What the design does about it: one plain grid-stride pass, so each element
// is read once and written once (the plain PyTorch composition makes six
// passes). The ranges are read from device pointers and the step size is
// computed in the kernel, so the host never waits for the device. The TPU
// kernels' [rows, 128] panel and its padding are not carried over: the
// kernel indexes the flat tensor and masks nothing. Vectorised 16-byte loads
// and fusing the quantizer into the conv epilogues are later work.
//
// Numerics: the arithmetic is written with explicit IEEE round-to-nearest
// intrinsics so that nvcc does not contract d * C + mn into an FMA, which
// would round differently from PyTorch's separate multiply and add. rintf
// rounds half to even, like torch.round and jnp.round. Division is IEEE
// division; the plain PyTorch versions divide by a tensor for the same
// reason. Do not build with --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 4096;

__global__ void act_fake_quant_kernel(const float* __restrict__ x, const float* __restrict__ mn_ptr,
                                      const float* __restrict__ mx_ptr, float* __restrict__ y,
                                      int64_t n, int n_bits) {
  const float q = static_cast<float>((1 << n_bits) - 1);
  const float mn = __ldg(mn_ptr);
  const float delta = __fdiv_rn(__fsub_rn(__ldg(mx_ptr), mn), q);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float X = rintf(__fdiv_rn(__fsub_rn(x[i], mn), delta));
    const float C = fminf(fmaxf(X, 0.0f), q);
    y[i] = __fadd_rn(__fmul_rn(delta, C), mn);
  }
}

__global__ void weight_fake_quant_kernel(const float* __restrict__ w, const float* __restrict__ mn,
                                         const float* __restrict__ mx, float* __restrict__ y, int64_t n,
                                         int64_t channels, int64_t inner, int n_bits) {
  const float q = static_cast<float>((1 << n_bits) - 1);
  const float qmin = -static_cast<float>(1 << (n_bits - 1));
  const float qmax = static_cast<float>((1 << (n_bits - 1)) - 1);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int64_t c = (i / inner) % channels;
    const float max_abs = fmaxf(fabsf(__ldg(mn + c)), fabsf(__ldg(mx + c)));
    const float delta = __fdiv_rn(__fmul_rn(2.0f, max_abs), q);
    const float X = rintf(__fdiv_rn(w[i], delta));
    y[i] = __fmul_rn(delta, fminf(fmaxf(X, qmin), qmax));
  }
}

unsigned int blocks_for(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

// C interface, loaded with ctypes. Each function launches on the given
// stream, does not synchronise, and returns cudaGetLastError() (0 = success).

extern "C" int fqss_act_fake_quant(const float* x, const float* mn, const float* mx, float* y, int64_t n,
                                   int n_bits, void* stream) {
  act_fake_quant_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, mn, mx, y, n,
                                                                                          n_bits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fqss_weight_fake_quant(const float* w, const float* mn, const float* mx, float* y, int64_t n,
                                      int64_t channels, int64_t inner, int n_bits, void* stream) {
  weight_fake_quant_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      w, mn, mx, y, n, channels, inner, n_bits);
  return static_cast<int>(cudaGetLastError());
}
