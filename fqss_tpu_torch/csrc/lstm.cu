// LSTM recurrence for NVIDIA Hopper (sm_90a): one direction (K6) or both
// directions of a bidirectional LSTM in one launch (K7).
//
//   lstm_recurrence_kernel  replaces fqss_tpu/ops/pallas_lstm.py:_lstm_kernel
//                           (lstm_sequence) and _bilstm_kernel
//                           (bilstm_sequence). For each direction d, batch row
//                           b and step t of the direction's own scan order
//                           (the caller flips the reverse direction's input
//                           and output, as the JAX functions' caller does):
//                             gates = ih_d[t, b] + h @ W_d      ([4H] = [H] x [H, 4H])
//                             i, f, g, o = the four H-wide slices of gates (torch's order)
//                             c = sigmoid(f) * c + sigmoid(i) * tanh(g)
//                             h = sigmoid(o) * tanh(c)
//                             out_d[t, b] = h
//                           with h = c = 0 before the first step.
//
// Layout: ih [T, B, 4H] and out [T, B, H] time-major and row-major, W [H, 4H]
// row-major (the JAX kernel's w_hh), all float32.
//
// What bounds it on the H100: the recurrent product is 2 x 4H x H operations
// per row and step against 4 x 5H bytes of input and output, about 50
// operations a byte at H = 128, above the card's float32 ratio of 67 TFLOP/s
// to 3.35 TB/s (20): the kernel is bound by operations, 8.6 GFLOP per step at
// DPTNet's row shape (2 directions x 2064 rows). The TPU kernel walks time on
// its sequential grid axis; here the time loop runs inside each block, and the
// blocks split the (direction, batch tile) pairs, so that every block carries
// its own h and c from step to step without leaving the SM.
//
// What the design does about it: a block owns 16 batch rows of one direction
// for the whole sequence. h lives in shared memory, double-buffered (the step
// reads one buffer and writes the other, so one barrier a step suffices), and
// c in shared memory beside it, each element read and written by the one
// thread that owns it. Each of the 256 threads owns one hidden unit j of 8
// rows and computes its four gate columns j, H + j, 2H + j, 3H + j, so the
// gate nonlinearities need no exchange between threads; H > 128 takes several
// passes. The product reads h from shared memory as float4 (one broadcast
// for the whole warp) and W_d through the read-only path: 256 KB at H = 128,
// more than a block's 227 KB of shared memory, so it stays in L2 and every
// block streams it once a step, each W value feeding 8 rows. The step's ih
// values are loaded before the product so that their latency hides behind
// it. At DPTNet's shapes 129 batch tiles x 2 directions make 258 blocks, two
// resident on each of the 132 SMs: one wave. Not yet done: W split across a
// thread-block cluster's distributed shared memory, tensor cores (the sums
// would leave float32's rounding), and overlapping the next step's ih loads.
//
// Numerics: the product sums k = 0 .. H-1 in order with fused multiply-adds
// and adds ih afterwards, as ih_t + h @ w_hh groups it; the gates use
// expf/tanhf (no fast math) and round-to-nearest intrinsics, so that nvcc
// contracts nothing into an FMA there. cuBLAS sums the plain version's product
// in another order, and PyTorch's transcendentals may differ by an ulp, so the
// two agree to a tolerance, not bit for bit. Do not build with --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;             // hidden units one pass of a block covers
constexpr int kGroups = 2;              // row groups of a block
constexpr int kThreads = kLanes * kGroups;
constexpr int kRows = 8;                // batch rows of a thread
constexpr int kTile = kGroups * kRows;  // batch rows of a block

struct Direction {
  const float* ih;  // [T, B, 4H]
  const float* w;   // [H, 4H]
  float* out;       // [T, B, H]
};

__device__ __forceinline__ float sigmoid_rn(float x) { return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x))); }

// kVec: H is a multiple of 4, so every shared-memory row of h is 16-byte aligned.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    lstm_recurrence_kernel(Direction d0, Direction d1, int64_t T, int64_t B, int H) {
  extern __shared__ __align__(16) float smem[];
  float* h_buf = smem;                // [2][kTile][H]
  float* c_s = smem + 2 * kTile * H;  // [kTile][H]
  const Direction d = blockIdx.y == 0 ? d0 : d1;
  const int64_t G = 4 * static_cast<int64_t>(H);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int lane = threadIdx.x % kLanes;
  const int grp = threadIdx.x / kLanes;

  for (int i = threadIdx.x; i < 3 * kTile * H; i += kThreads) smem[i] = 0.0f;
  __syncthreads();

  for (int64_t t = 0; t < T; ++t) {
    const float* h_old = h_buf + (t & 1) * kTile * H + grp * kRows * H;
    float* h_new = h_buf + ((t + 1) & 1) * kTile * H;
    const float* ih_t = d.ih + t * B * G;
    float* out_t = d.out + t * B * H;
    for (int j = lane; j - lane < H; j += kLanes) {
      if (j >= H) continue;
      float pre[kRows][4];
      float acc[kRows][4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int64_t row = row0 + grp * kRows + r;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          pre[r][g] = row < B ? __ldg(ih_t + row * G + g * H + j) : 0.0f;
          acc[r][g] = 0.0f;
        }
      }
      if (kVec) {
#pragma unroll 2
        for (int k = 0; k < H; k += 4) {
          float wk[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int g = 0; g < 4; ++g) wk[kk][g] = __ldg(d.w + (k + kk) * G + g * H + j);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float4 hv = *reinterpret_cast<const float4*>(h_old + r * H + k);
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              acc[r][g] = fmaf(hv.x, wk[0][g], acc[r][g]);
              acc[r][g] = fmaf(hv.y, wk[1][g], acc[r][g]);
              acc[r][g] = fmaf(hv.z, wk[2][g], acc[r][g]);
              acc[r][g] = fmaf(hv.w, wk[3][g], acc[r][g]);
            }
          }
        }
      } else {
        for (int k = 0; k < H; ++k) {
          float wk[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) wk[g] = __ldg(d.w + k * G + g * H + j);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float hv = h_old[r * H + k];
#pragma unroll
            for (int g = 0; g < 4; ++g) acc[r][g] = fmaf(hv, wk[g], acc[r][g]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int64_t row = row0 + grp * kRows + r;
        const int idx = (grp * kRows + r) * H + j;
        const float i_g = sigmoid_rn(__fadd_rn(pre[r][0], acc[r][0]));
        const float f_g = sigmoid_rn(__fadd_rn(pre[r][1], acc[r][1]));
        const float g_g = tanhf(__fadd_rn(pre[r][2], acc[r][2]));
        const float o_g = sigmoid_rn(__fadd_rn(pre[r][3], acc[r][3]));
        const float c = __fadd_rn(__fmul_rn(f_g, c_s[idx]), __fmul_rn(i_g, g_g));
        const float h = __fmul_rn(o_g, tanhf(c));
        c_s[idx] = c;
        h_new[idx] = h;
        if (row < B) out_t[row * H + j] = h;
      }
    }
    __syncthreads();
  }
}

template <bool kVec>
int launch(Direction d0, Direction d1, int dirs, int64_t T, int64_t B, int64_t H, cudaStream_t stream) {
  const size_t smem = 3 * kTile * static_cast<size_t>(H) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(lstm_recurrence_kernel<kVec>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned int>((B + kTile - 1) / kTile), static_cast<unsigned int>(dirs));
  lstm_recurrence_kernel<kVec><<<grid, kThreads, smem, stream>>>(d0, d1, T, B, static_cast<int>(H));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Largest H the kernel takes: h (two buffers) and c of a block's 16 rows in 227 KB of shared memory.
extern "C" int fqss_lstm_max_hidden() { return static_cast<int>(232448 / (3 * kTile * sizeof(float))); }

// dirs = 1: ih0, w0 -> out0 (K6); dirs = 2: also ih1, w1 -> out1 in the same launch (K7).
// ih: [T, B, 4H], w: [H, 4H], out: [T, B, H], float32, contiguous, on the current device;
// T, B >= 1 and 1 <= H <= fqss_lstm_max_hidden(). Returns the launch's CUDA error code.
extern "C" int fqss_lstm_recurrence(const float* ih0, const float* w0, float* out0, const float* ih1, const float* w1,
                                    float* out1, int dirs, int64_t T, int64_t B, int64_t H, void* stream) {
  const Direction d0{ih0, w0, out0};
  const Direction d1{ih1, w1, out1};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return H % 4 == 0 ? launch<true>(d0, d1, dirs, T, B, H, st) : launch<false>(d0, d1, dirs, T, B, H, st);
}
