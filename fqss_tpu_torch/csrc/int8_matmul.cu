// Int8 matrix product with a fused requantizing epilogue for NVIDIA Hopper (sm_90a).
//
//   int8_mm_requant_kernel  replaces fqss_tpu/ops/pallas_quant.py:_qmm8_kernel
//                           (int8_matmul_requant_pallas, the int8 serving
//                           engine's 1x1 convolutions). For each row m and
//                           output channel n:
//                             acc = sum_k xs[m, k] * w[n, k]        (exact int32)
//                             v   = float(acc) * scale[n] + corr[n]
//                             v   = v >= 0 ? v : alpha * v          (PReLU; 1 = identity, 0 = ReLU)
//                             X   = clip(rint((v - mn_g) / delta_g), 0, 255)
//                             out[m, n] = int8(X - 128)
//                           where (delta_g, mn_g) is the output grid of
//                           column n's group g = n / cols: one grid for all
//                           N columns, or up to three (the Sepformer
//                           engine's attention in-projection requantizes its
//                           Q, K and V thirds to their own grids in one launch).
//                           The epilogue's nonlinearity may instead be tanh or
//                           the sigmoid 1 / (1 + exp(-v)) (nl = 1, 2): the
//                           TPU kernel has only the PReLU, and the JAX
//                           engines apply those two outside it, to the
//                           dequantized product (DPTNet's gated output).
//
// Layout: xs is [M, K] row-major (the engine's channels-last activations,
// M = batch x time) and w is [N, K] row-major (the port's conv weight
// [Cout, Cin, 1] squeezed), so both operands are K-major, the layout that
// mma.sync's row.col s8 form and Hopper's s8 wgmma both read.
//
// What bounds it on the H100: at the ConvTasNet's serving shapes (M = 383,968,
// K and N of 128 to 1024) the product does 2 K operations for every
// K + N bytes that must cross device memory (each activation read once,
// each output written once): about 200 operations a byte at K = 512, N = 128,
// against the card's ratio of 1,979 int8 TOP/s to 3.35 TB/s, about 590. The
// kernel is bound by memory, provided the tensor cores do the products:
// with __dp4a on the CUDA cores (about 1/15 of the tensor-core rate) it
// would be bound by operations instead.
//
// What the design does about it: the int32 accumulator, the dequantization,
// the PReLU and the requantization never leave registers, so every
// activation crosses device memory once as one byte in and one byte out,
// where the plain composition writes and reads a 4-byte float for every
// product. A block stages a 128 x 64 tile of each operand in shared memory
// (16-byte loads where K is a multiple of 16, byte loads otherwise, zero
// past every edge, so any M, K and N is taken) and eight warps multiply it
// with mma.sync m16n8k32 s8 x s8 -> s32, each warp a 32 x 64 output tile.
// The blocks run the N tiles of one row block next to each other, so the
// activation rows that the N tiles share are read from device memory once
// and from L2 after. The shared-memory rows are padded to 80 bytes, which
// keeps the fragment reads free of bank conflicts. No pipelining of the
// tile loads (cp.async or TMA), no wgmma and no staged, coalesced output
// stores yet: those are later work.
//
// Numerics: float(acc) is exact while |acc| < 2^24 (|acc| <= 128 * 128 * K,
// so K <= 1024 is exact; the ConvTasNet's K is at most 512), and rounds to
// nearest above, as the plain version's float64 product does when cast to
// float32. The epilogue is written with explicit round-to-nearest
// intrinsics so that nvcc contracts no product and sum into an FMA, which
// would round differently from PyTorch's separate operations; division is
// IEEE division and rintf rounds half to even, like torch.round and
// jnp.round. Do not build with --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;  // rows of a block tile
constexpr int kBN = 128;  // output channels of a block tile
constexpr int kBK = 64;   // depth of a shared-memory stage
constexpr int kThreads = 256;  // 8 warps: 4 along M x 2 along N
constexpr int kWarpM = 32;
constexpr int kWarpN = 64;
constexpr int kMi = kWarpM / 16;  // m16 tiles per warp
constexpr int kNi = kWarpN / 8;   // n8 tiles per warp
constexpr int kStride = kBK + 16;  // bytes per shared-memory row: 16-byte aligned, conflict-free
constexpr int kMaxGrids = 3;

// The output grids: column n is requantized to (delta[g], mn[g]) of its group g = n / cols, found by two
// comparisons (no division in the epilogue).
struct OutGrids {
  float delta[kMaxGrids];
  float mn[kMaxGrids];
  int64_t cols;
  __device__ __forceinline__ int group(int64_t n) const { return (n >= cols) + (n >= 2 * cols); }
  __device__ __forceinline__ float delta_of(int g) const { return g == 0 ? delta[0] : (g == 1 ? delta[1] : delta[2]); }
  __device__ __forceinline__ float mn_of(int g) const { return g == 0 ? mn[0] : (g == 1 ? mn[1] : mn[2]); }
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copy rows [r0, r0 + 128) and depth [k0, k0 + 64) of the K-major matrix
// src [R, K] into the shared tile dst [128][kStride], zero past the edges.
// kVec: K is a multiple of 16 and src is 16-byte aligned, so every 16-byte
// chunk lies wholly inside or wholly outside the matrix.
template <bool kVec>
__device__ __forceinline__ void load_tile(const int8_t* __restrict__ src, int64_t R, int64_t K, int64_t r0,
                                          int64_t k0, int8_t* dst) {
  if (kVec) {
    constexpr int kChunks = kBM * kBK / 16;
    for (int c = threadIdx.x; c < kChunks; c += kThreads) {
      const int row = c / (kBK / 16);
      const int col = (c % (kBK / 16)) * 16;
      int4 v = make_int4(0, 0, 0, 0);
      if (r0 + row < R && k0 + col < K) v = *reinterpret_cast<const int4*>(src + (r0 + row) * K + k0 + col);
      *reinterpret_cast<int4*>(dst + row * kStride + col) = v;
    }
  } else {
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int row = i / kBK;
      const int col = i % kBK;
      dst[row * kStride + col] = (r0 + row < R && k0 + col < K) ? src[(r0 + row) * K + k0 + col] : int8_t(0);
    }
  }
}

// The epilogue's nonlinearity (fqss_int8_matmul_requant's nl), a template parameter of the kernel so that
// each instantiation carries only its own epilogue.
enum Nl : int { kPrelu = 0, kTanh = 1, kSigmoid = 2 };

template <int kNl>
__device__ __forceinline__ int8_t requant(int acc, float scale, float corr, float alpha, float delta, float mn) {
  float v = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), corr);
  if (kNl == kTanh) {
    v = tanhf(v);
  } else if (kNl == kSigmoid) {
    v = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v)));  // PyTorch's sigmoid, operation for operation
  } else {
    v = v >= 0.0f ? v : __fmul_rn(alpha, v);
  }
  float X = rintf(__fdiv_rn(__fsub_rn(v, mn), delta));
  X = X < 0.0f ? 0.0f : (X > 255.0f ? 255.0f : X);
  return static_cast<int8_t>(static_cast<int>(X) - 128);
}

template <bool kVec, int kNl>
__global__ void __launch_bounds__(kThreads) int8_mm_requant_kernel(
    const int8_t* __restrict__ xs, const int8_t* __restrict__ w, const float* __restrict__ scale,
    const float* __restrict__ corr, float alpha, OutGrids grids, int8_t* __restrict__ out, int64_t M,
    int64_t N, int64_t K, unsigned int n_tiles) {
  __shared__ __align__(16) int8_t As[kBM * kStride];
  __shared__ __align__(16) int8_t Bs[kBN * kStride];

  // The N tiles of one row block are neighbours in launch order (see the note above).
  const int64_t n0 = static_cast<int64_t>(blockIdx.x % n_tiles) * kBN;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x / n_tiles) * kBM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // the fragment's groupID
  const int t = lane % 4;  // its thread in the group
  const int wm = (warp % 4) * kWarpM;
  const int wn = (warp / 4) * kWarpN;

  int acc[kMi][kNi][4];
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  for (int64_t k0 = 0; k0 < K; k0 += kBK) {
    load_tile<kVec>(xs, M, K, m0, k0, As);
    load_tile<kVec>(w, N, K, n0, k0, Bs);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[kMi][4];
      uint32_t b[kNi][2];
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi) {
        const int8_t* p = As + (wm + mi * 16 + g) * kStride + kk + t * 4;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(p);                     // row g,     k t*4..+3
        a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kStride);       // row g + 8, k t*4..+3
        a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);                // row g,     k 16+t*4..+3
        a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kStride + 16);  // row g + 8, k 16+t*4..+3
      }
#pragma unroll
      for (int ni = 0; ni < kNi; ++ni) {
        const int8_t* p = Bs + (wn + ni * 8 + g) * kStride + kk + t * 4;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(p);       // column g, k t*4..+3
        b[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);  // column g, k 16+t*4..+3
      }
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNi; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

  // Epilogue: accumulator r of an m16n8 tile sits at row g + 8 (r / 2), column t * 2 + r % 2.
#pragma unroll
  for (int ni = 0; ni < kNi; ++ni) {
    const int64_t col = n0 + wn + ni * 8 + t * 2;
    if (col >= N) continue;
    const bool pair = col + 1 < N;
    const float s0 = scale[col], c0 = corr[col];
    const float s1 = pair ? scale[col + 1] : 0.0f, c1 = pair ? corr[col + 1] : 0.0f;
    const int g0 = grids.group(col), g1 = grids.group(col + 1);
    const float d0 = grids.delta_of(g0), z0 = grids.mn_of(g0), d1 = grids.delta_of(g1), z1 = grids.mn_of(g1);
#pragma unroll
    for (int mi = 0; mi < kMi; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = m0 + wm + mi * 16 + g + 8 * h;
        if (row >= M) continue;
        int8_t* o = out + row * N + col;
        const int8_t q0 = requant<kNl>(acc[mi][ni][2 * h], s0, c0, alpha, d0, z0);
        if (!pair) {
          o[0] = q0;
        } else {
          const int8_t q1 = requant<kNl>(acc[mi][ni][2 * h + 1], s1, c1, alpha, d1, z1);
          if (N % 2 == 0) {
            *reinterpret_cast<char2*>(o) = make_char2(q0, q1);  // col is even: 2-byte aligned
          } else {
            o[0] = q0;
            o[1] = q1;
          }
        }
      }
    }
  }
}

template <bool kVec>
void launch(const int8_t* xs, const int8_t* w, const float* scale, const float* corr, int nl, float alpha,
            const OutGrids& grids, int8_t* out, int64_t M, int64_t N, int64_t K, unsigned int blocks,
            unsigned int n_tiles, cudaStream_t st) {
  if (nl == kTanh) {
    int8_mm_requant_kernel<kVec, kTanh><<<blocks, kThreads, 0, st>>>(xs, w, scale, corr, alpha, grids, out, M, N, K,
                                                                     n_tiles);
  } else if (nl == kSigmoid) {
    int8_mm_requant_kernel<kVec, kSigmoid><<<blocks, kThreads, 0, st>>>(xs, w, scale, corr, alpha, grids, out, M, N,
                                                                        K, n_tiles);
  } else {
    int8_mm_requant_kernel<kVec, kPrelu><<<blocks, kThreads, 0, st>>>(xs, w, scale, corr, alpha, grids, out, M, N, K,
                                                                      n_tiles);
  }
}

}  // namespace

// xs: [M, K] int8, w: [N, K] int8, scale and corr: [N] float32, out: [M, N] int8;
// all contiguous on the current device. nl: 0 PReLU with slope alpha, 1 tanh,
// 2 sigmoid. Output grid g = 0, 1, 2 is (delta_g, mn_g) and takes columns
// [g cols, (g + 1) cols); cols = N for one grid. Returns the launch's CUDA error code.
extern "C" int fqss_int8_matmul_requant(const int8_t* xs, const int8_t* w, const float* scale, const float* corr,
                                        int nl, float alpha, float delta0, float mn0, float delta1, float mn1,
                                        float delta2, float mn2, int64_t cols, int8_t* out, int64_t M, int64_t N,
                                        int64_t K, void* stream) {
  if (cols < 1 || (N + cols - 1) / cols > kMaxGrids) return static_cast<int>(cudaErrorInvalidValue);
  const OutGrids grids{{delta0, delta1, delta2}, {mn0, mn1, mn2}, cols};
  const unsigned int n_tiles = static_cast<unsigned int>((N + kBN - 1) / kBN);
  const unsigned int blocks = n_tiles * static_cast<unsigned int>((M + kBM - 1) / kBM);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = K % 16 == 0 && reinterpret_cast<uintptr_t>(xs) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (vec) {
    launch<true>(xs, w, scale, corr, nl, alpha, grids, out, M, N, K, blocks, n_tiles, st);
  } else {
    launch<false>(xs, w, scale, corr, nl, alpha, grids, out, M, N, K, blocks, n_tiles, st);
  }
  return static_cast<int>(cudaGetLastError());
}
