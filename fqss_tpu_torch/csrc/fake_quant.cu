// Fake-quantization kernels for NVIDIA Hopper (sm_90a): forward and backward.
//
// Four kernels carry every quantizer of the FQSS-8bit ConvTasNet, serving and
// training:
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
//   act_bwd_partials_kernel   replaces fqss_tpu/ops/pallas_qat.py:_act_bwd_kernel
//   + act_bwd_sum_kernel      (the backward of act_fake_quant_train, _act_fq_bwd):
//                             with u = (x - mn) / d, X = rint(u), C = clip(X, 0, Q),
//                             m = 1 inside (0, Q), 0.5 at X in {0, Q}, 0 outside,
//                             t = (C - m u) / Q and s the scale_grad factor:
//                             dx = g m, dmn = sum g (1 - m - s t), dmx = sum g s t.
//   weight_bwd_kernel         replaces fqss_tpu/ops/pallas_qat.py:_w_bwd_kernel and
//                             the range routing of _w_bwd_impl (pallas_qat.py:316-326):
//                             dw = g m; per channel dd = sum g (C - m u),
//                             dmax = s 2/Q dd, given to mn or mx by |mn| vs |mx|
//                             (0.5 each at a tie), times the range's sign.
//
// What bounds them on the H100: all are elementwise passes with a handful of
// floating-point operations per element, far below the card's ratio of
// operations to bytes. The forward kernels read 4 and write 4 bytes per
// element; the activation backward reads x and g and writes dx, 12 bytes per
// element, over tensors of up to 49 M elements in the train step
// ([16, 1024, 2999]): device-memory bandwidth (3.35 TB/s) is their limit.
// The weights hold at most 131,072 elements, so the weight kernels are bound
// by launch latency.
//
// What the design does about it: one plain grid-stride pass, so each element
// is read once and written once (the plain PyTorch compositions make six to
// ten passes). The ranges are read from device pointers and the step size is
// computed in the kernel, so the host never waits for the device. The TPU
// kernels' [rows, 128] panel and its padding are not carried over: the
// kernels index the flat tensor and mask nothing. The TPU's sequential grid
// carried nothing between blocks either, but its range sums were finished by
// XLA; here each block of the activation backward reduces its two partial
// sums (warp shuffles, then shared memory) into a [blocks, 2] scratch, and a
// second one-block kernel sums them in a fixed order: the result is the same
// from run to run, with no atomics. The weight backward gives each channel
// one block, which walks the channel's elements in the strided
// [outer, C, inner] view, so the conv (ch_axis 0) and transposed-conv
// (ch_axis 1) layouts need no transpose, and finishes the channel's range
// gradients itself (C elements of work that XLA did on the TPU). Vectorised
// 16-byte loads and fusing dx into the conv backward are later work.
//
// Numerics: the arithmetic is written with explicit IEEE round-to-nearest
// intrinsics so that nvcc does not contract a product and a sum into an FMA,
// which would round differently from PyTorch's separate operations. rintf
// rounds half to even, like torch.round and jnp.round. Division is IEEE
// division; the plain PyTorch versions divide by a tensor for the same
// reason. The clip propagates NaN, as torch.clamp and jnp.clip do, so a NaN
// input stays NaN (the train step's non-finite skip relies on it). Do not
// build with --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kMaxBlocks = 4096;

// clip(X, lo, hi) that keeps a NaN (fminf/fmaxf would drop it).
__device__ __forceinline__ float clip(float X, float lo, float hi) { return X < lo ? lo : (X > hi ? hi : X); }

// The clip's gradient mask (fqss_tpu/ops/pallas_qat.py:_tie_mask): 1 inside,
// 0.5 exactly at a bound, 0 outside and for NaN.
__device__ __forceinline__ float tie_mask(float X, float lo, float hi) {
  return (X > lo && X < hi) ? 1.0f : ((X == lo || X == hi) ? 0.5f : 0.0f);
}

// Sum a and b over the block, in a fixed order; thread 0 holds the result.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sa[kWarps], sb[kWarps];
  for (int off = 16; off > 0; off >>= 1) {
    a = __fadd_rn(a, __shfl_down_sync(0xffffffffu, a, off));
    b = __fadd_rn(b, __shfl_down_sync(0xffffffffu, b, off));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sa[warp] = a;
    sb[warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kWarps ? sa[lane] : 0.0f;
    b = lane < kWarps ? sb[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) {
      a = __fadd_rn(a, __shfl_down_sync(0xffffffffu, a, off));
      b = __fadd_rn(b, __shfl_down_sync(0xffffffffu, b, off));
    }
  }
}

__global__ void act_fake_quant_kernel(const float* __restrict__ x, const float* __restrict__ mn_ptr,
                                      const float* __restrict__ mx_ptr, float* __restrict__ y,
                                      int64_t n, int n_bits) {
  const float q = static_cast<float>((1 << n_bits) - 1);
  const float mn = __ldg(mn_ptr);
  const float delta = __fdiv_rn(__fsub_rn(__ldg(mx_ptr), mn), q);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float C = clip(rintf(__fdiv_rn(__fsub_rn(x[i], mn), delta)), 0.0f, q);
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
    y[i] = __fmul_rn(delta, clip(rintf(__fdiv_rn(w[i], delta)), qmin, qmax));
  }
}

// Pass 1 of the activation backward: dx, and each block's two partial sums.
__global__ void act_bwd_partials_kernel(const float* __restrict__ x, const float* __restrict__ g,
                                        const float* __restrict__ mn_ptr, const float* __restrict__ mx_ptr,
                                        float* __restrict__ dx, float* __restrict__ partials, int64_t n,
                                        int n_bits, float s) {
  const float q = static_cast<float>((1 << n_bits) - 1);
  const float mn = __ldg(mn_ptr);
  const float delta = __fdiv_rn(__fsub_rn(__ldg(mx_ptr), mn), q);
  float p_mn = 0.0f, p_mx = 0.0f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float u = __fdiv_rn(__fsub_rn(x[i], mn), delta);
    const float X = rintf(u);
    const float m = tie_mask(X, 0.0f, q);
    const float t = __fdiv_rn(__fsub_rn(clip(X, 0.0f, q), __fmul_rn(m, u)), q);
    const float gi = g[i];
    dx[i] = __fmul_rn(gi, m);
    p_mn = __fadd_rn(p_mn, __fmul_rn(gi, __fsub_rn(__fsub_rn(1.0f, m), __fmul_rn(s, t))));
    p_mx = __fadd_rn(p_mx, __fmul_rn(__fmul_rn(gi, s), t));
  }
  block_sum2(p_mn, p_mx);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = p_mn;
    partials[2 * blockIdx.x + 1] = p_mx;
  }
}

// Pass 2: one block sums the [blocks, 2] partials in a fixed order.
__global__ void act_bwd_sum_kernel(const float* __restrict__ partials, int blocks, float* __restrict__ sums) {
  float a = 0.0f, b = 0.0f;
  for (int i = threadIdx.x; i < blocks; i += blockDim.x) {
    a = __fadd_rn(a, partials[2 * i]);
    b = __fadd_rn(b, partials[2 * i + 1]);
  }
  block_sum2(a, b);
  if (threadIdx.x == 0) {
    sums[0] = a;
    sums[1] = b;
  }
}

// One block per channel c of the [outer, channels, inner] view of w.
__global__ void weight_bwd_kernel(const float* __restrict__ w, const float* __restrict__ g,
                                  const float* __restrict__ mn, const float* __restrict__ mx,
                                  float* __restrict__ dw, float* __restrict__ dmn, float* __restrict__ dmx,
                                  int64_t channels, int64_t outer, int64_t inner, int n_bits, float dmax_scale) {
  const int64_t c = blockIdx.x;
  const float q = static_cast<float>((1 << n_bits) - 1);
  const float qmin = -static_cast<float>(1 << (n_bits - 1));
  const float qmax = static_cast<float>((1 << (n_bits - 1)) - 1);
  const float mn_c = __ldg(mn + c), mx_c = __ldg(mx + c);
  const float amn = fabsf(mn_c), amx = fabsf(mx_c);
  const float delta = __fdiv_rn(__fmul_rn(2.0f, fmaxf(amn, amx)), q);
  float dd = 0.0f, unused = 0.0f;
  for (int64_t e = threadIdx.x; e < outer * inner; e += blockDim.x) {
    const int64_t o = e / inner;
    const int64_t i = (o * channels + c) * inner + (e - o * inner);
    const float u = __fdiv_rn(w[i], delta);
    const float X = rintf(u);
    const float m = tie_mask(X, qmin, qmax);
    const float gi = g[i];
    dw[i] = __fmul_rn(gi, m);
    dd = __fadd_rn(dd, __fmul_rn(gi, __fsub_rn(clip(X, qmin, qmax), __fmul_rn(m, u))));
  }
  block_sum2(dd, unused);
  if (threadIdx.x == 0) {
    const float dmax = __fmul_rn(dmax_scale, dd);
    const float wmn = amn > amx ? 1.0f : (amn == amx ? 0.5f : 0.0f);
    const float wmx = amx > amn ? 1.0f : (amn == amx ? 0.5f : 0.0f);
    const float sign_mn = mn_c > 0.0f ? 1.0f : (mn_c < 0.0f ? -1.0f : 0.0f);
    const float sign_mx = mx_c > 0.0f ? 1.0f : (mx_c < 0.0f ? -1.0f : 0.0f);
    dmn[c] = __fmul_rn(dmax, __fmul_rn(wmn, sign_mn));
    dmx[c] = __fmul_rn(dmax, __fmul_rn(wmx, sign_mx));
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

// The number of blocks (and rows of the partials scratch) the activation
// backward uses for n elements; the wrapper allocates the scratch with it.
extern "C" int fqss_act_bwd_blocks(int64_t n) { return static_cast<int>(blocks_for(n)); }

// partials: [fqss_act_bwd_blocks(n), 2] scratch; sums: 2 floats (dmn, dmx).
extern "C" int fqss_act_fake_quant_bwd(const float* x, const float* g, const float* mn, const float* mx, float* dx,
                                       float* partials, float* sums, int64_t n, int n_bits, float s,
                                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = blocks_for(n);
  act_bwd_partials_kernel<<<blocks, kThreads, 0, st>>>(x, g, mn, mx, dx, partials, n, n_bits, s);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  act_bwd_sum_kernel<<<1, kThreads, 0, st>>>(partials, static_cast<int>(blocks), sums);
  return static_cast<int>(cudaGetLastError());
}

// w, g, dw: the weight viewed as [outer, channels, inner]; mn, mx, dmn, dmx:
// one float per channel. dmax_scale = s * 2 / Q.
extern "C" int fqss_weight_fake_quant_bwd(const float* w, const float* g, const float* mn, const float* mx,
                                          float* dw, float* dmn, float* dmx, int64_t channels, int64_t outer,
                                          int64_t inner, int n_bits, float dmax_scale, void* stream) {
  weight_bwd_kernel<<<static_cast<unsigned int>(channels), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      w, g, mn, mx, dw, dmn, dmx, channels, outer, inner, n_bits, dmax_scale);
  return static_cast<int>(cudaGetLastError());
}
