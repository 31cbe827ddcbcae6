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
//                           The epilogue's nonlinearity may instead be tanh,
//                           the sigmoid 1 / (1 + exp(-v)) or the exact GELU
//                           0.5 v erfc(-v sqrt(1/2)) (nl = 1, 2, 3): the
//                           TPU kernel has only the PReLU, and the JAX
//                           engines apply the others outside it, to the
//                           dequantized product (DPTNet's gated output,
//                           HTDemucs's FFN linear1).
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
// kernel is bound by memory, provided the tensor cores do the products, and
// where N > K, by the epilogue's issue rate unless that overlaps the loads.
//
// What the design does about it: the int32 accumulator, the dequantization,
// the nonlinearity and the requantization never leave registers, so every
// activation crosses device memory once as one byte in and one byte out.
// Blocks are persistent (the wrapper sizes the grid to the blocks that fit
// co-resident, fqss_tpu_torch/ops/int8_matmul.py:grid): block b keeps the
// N tile b % n_tiles of the weight (BN = 128 columns, 64 where N <= 64 or K
// is too deep for 128) in shared memory for the whole launch, and walks the
// M tiles b / n_tiles, + blocks / n_tiles, ... of 128 rows. The activations
// stream through a 3-stage ring of 128 x 128-byte stages filled by 16-byte
// cp.async.cg copies (zero-filled past M), so that while the eight warps
// multiply one stage (mma.sync m16n8k32 s8 x s8 -> s32, each warp a 32 x BN/2
// output tile) and run a tile's epilogue, the next two stages, the next
// tiles' among them, are in flight (row segments of 128 bytes: 64-byte ones
// read at about 20% less of the memory's rate on an H100). Where K is not a
// multiple of 16 or a pointer is not 16-byte aligned the same ring is filled
// by byte copies. The
// epilogue writes each int8 tile into shared memory, then the block stores it
// as 16-byte rows (byte stores where N is not a multiple of 16), in place of
// 2-byte stores straight from the fragments, which wrote each 32-byte sector
// with four instructions. Shared-memory rows are padded to 16 mod 128 bytes,
// which keeps the fragment reads and the tile writes free of bank conflicts.
// Not yet done: s8 wgmma and TMA.
//
// Numerics: float(acc) is exact while |acc| < 2^24 (|acc| <= 128 * 128 * K,
// so K <= 1024 is exact), and rounds to nearest above, as the plain version's
// float64 product does when cast to float32. The epilogue is written with
// explicit round-to-nearest intrinsics so that nvcc contracts no product and
// sum into an FMA, which would round differently from PyTorch's separate
// operations; rintf rounds half to even, like torch.round and jnp.round. The
// division by delta is IEEE division computed as Markstein's correction of a
// reciprocal: with r = RN(1 / delta) (__frcp_rn, once a column),
// q = RN(a r) and q' = RN(q + RN(a - q delta) r) (two FMAs) equals RN(a /
// delta) (tests/test_torch_kernel_plans.py emulates it bit for bit and holds
// it to IEEE division around every rounding boundary). The numerator a is
// first clamped to [-delta, 256 delta], which changes no output (beyond it X
// clips to 0 or 255 either way) and keeps q finite; cvt.rni.sat.u8 rounds
// the quotient half to even and clips it to [0, 255] in one instruction. Do
// not build with --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fake_quant.cuh"

namespace {

constexpr int kBM = 128;        // rows of a block tile
constexpr int kBK = 128;        // depth of a ring stage
constexpr int kStages = 3;      // ring stages
constexpr int kThreads = 256;   // 8 warps: 4 along M x 2 along N
constexpr int kWarpM = 32;
constexpr int kMi = kWarpM / 16;      // m16 tiles per warp
constexpr int kAStride = kBK + 16;    // bytes per ring row: 16-byte aligned, conflict-free
constexpr int kStageBytes = kBM * kAStride;
constexpr int kMaxGrids = 3;
constexpr int kSmemBytes = 232448;    // the most dynamic shared memory a block may have on sm_90
constexpr int kSmemPerSm = 233472;    // an SM's shared memory, of which each resident block takes 1 KB more

// The output grids: column n is requantized to (delta[g], mn[g]) of its group g = n / cols.
struct OutGrids {
  float delta[kMaxGrids];
  float mn[kMaxGrids];
  int64_t cols;
};

// Shared memory of a block with N tile BN at depth K: the weight tile, the ring, the output tile and six floats a
// column (scale, corr, mn, delta, 1 / delta, 256 delta).
__host__ __device__ constexpr int64_t w_stride(int64_t K) { return (K + kBK - 1) / kBK * kBK + 16; }
__host__ __device__ constexpr int out_stride(int BN) { return BN + 16; }
constexpr int64_t smem_bytes(int BN, int64_t K) {
  return BN * w_stride(K) + kStages * kStageBytes + kBM * out_stride(BN) + 6 * 4 * BN;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(int8_t* dst, const int8_t* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy rows [r0, r0 + rows) and depth [k0, k0 + kBK) of the K-major matrix src [R, K] into dst (rows of `stride`
// bytes), zero past the edges. kVec: K is a multiple of 16 and src is 16-byte aligned, so every 16-byte chunk lies
// wholly inside or wholly outside the matrix, and goes by cp.async; otherwise bytes go by plain loads and stores.
template <bool kVec>
__device__ __forceinline__ void load_rows(const int8_t* __restrict__ src, int64_t R, int64_t K, int64_t r0, int rows,
                                          int64_t k0, int8_t* dst, int64_t stride) {
  if (kVec) {
    for (int c = threadIdx.x; c < rows * (kBK / 16); c += kThreads) {
      const int row = c / (kBK / 16);
      const int col = (c % (kBK / 16)) * 16;
      const bool ok = r0 + row < R && k0 + col < K;
      cp_async16(dst + row * stride + col, ok ? src + (r0 + row) * K + k0 + col : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * kBK; i += kThreads) {
      const int row = i / kBK;
      const int col = i % kBK;
      dst[row * stride + col] = (r0 + row < R && k0 + col < K) ? src[(r0 + row) * K + k0 + col] : int8_t(0);
    }
  }
}

// The epilogue's nonlinearity (fqss_int8_matmul_requant's nl), a template parameter of the kernel so that
// each instantiation carries only its own epilogue.
enum Nl : int { kPrelu = 0, kTanh = 1, kSigmoid = 2, kGelu = 3 };

// The requantized output X in [0, 255] (the int8 output is X - 128, X ^ 0x80 in its low byte).
template <int kNl>
__device__ __forceinline__ uint32_t requant(int acc, float scale, float corr, float alpha, float mn, float delta,
                                            float rcp, float hi) {
  float v = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), corr);
  if (kNl == kTanh) {
    v = tanhf(v);
  } else if (kNl == kSigmoid) {
    v = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v)));  // PyTorch's sigmoid, operation for operation
  } else if (kNl == kGelu) {
    v = fqss::gelu(v);  // the exact GELU (HTDemucs's FFN linear1), fake_quant.cuh
  } else {
    v = v >= 0.0f ? v : __fmul_rn(alpha, v);
  }
  const float a = fminf(fmaxf(__fsub_rn(v, mn), -delta), hi);
  const float q = __fmul_rn(a, rcp);
  const float quotient = __fmaf_rn(__fmaf_rn(-q, delta, a), rcp, q);  // RN(a / delta), see the note above
  unsigned short X;  // rint half to even, then clip to [0, 255], in one conversion
  asm("cvt.rni.sat.u8.f32 %0, %1;\n" : "=h"(X) : "f"(quotient));
  return X;
}

// kNi: n8 tiles of a warp (BN = 16 kNi columns a block). kMinBlocks: 2 where two blocks' shared memory fits an SM,
// which caps the registers at 128 a thread so that their registers fit too (two blocks an SM run the N > K shapes,
// whose epilogue sets their time, 14-18% faster; where only one fits, the cap costs 2-3%).
template <bool kVec, int kNl, int kNi, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks) int8_mm_requant_kernel(
    const int8_t* __restrict__ xs, const int8_t* __restrict__ w, const float* __restrict__ scale,
    const float* __restrict__ corr, float alpha, OutGrids grids, int8_t* __restrict__ out, int64_t M,
    int64_t N, int64_t K, int n_tiles) {
  constexpr int kBN = 16 * kNi;
  constexpr int kWarpN = kBN / 2;
  constexpr int kOStride = out_stride(kBN);
  extern __shared__ __align__(16) int8_t smem[];
  const int64_t ws = w_stride(K);
  int8_t* Ws = smem;                               // [kBN][ws]: the block's weight tile, all of K
  int8_t* ring = Ws + kBN * ws;                    // [kStages][kBM][kAStride]
  int8_t* Os = ring + kStages * kStageBytes;       // [kBM][kOStride]: the output tile
  float* prm = reinterpret_cast<float*>(Os + kBM * kOStride);  // [6][kBN]: scale, corr, mn, delta, 1 / delta, 256 delta

  const int64_t n0 = static_cast<int64_t>(blockIdx.x % n_tiles) * kBN;
  const int64_t m_first = blockIdx.x / n_tiles;
  const int64_t m_step = gridDim.x / n_tiles;
  const int64_t m_tiles = (M + kBM - 1) / kBM;
  const int64_t my_tiles = m_first < m_tiles ? (m_tiles - m_first + m_step - 1) / m_step : 0;
  const int ks = static_cast<int>((K + kBK - 1) / kBK);
  const int64_t total = my_tiles * ks;  // ring stages this block runs

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // the fragment's groupID
  const int t = lane % 4;  // its thread in the group
  const int wm = (warp % 4) * kWarpM;
  const int wn = (warp / 4) * kWarpN;

  // The next stage to issue: depth chunk i_kc of the block's M tile i_row0 / kBM, into ring slot i_slot (stage s
  // of the walk is chunk s % ks of its (s / ks)-th tile, in slot s % kStages; counted, not divided).
  int64_t issued = 0, i_row0 = m_first * kBM;
  int i_kc = 0, i_slot = 0;
  auto issue = [&]() {
    if (issued < total)
      load_rows<kVec>(xs, M, K, i_row0, kBM, static_cast<int64_t>(i_kc) * kBK, ring + i_slot * kStageBytes, kAStride);
    cp_async_commit();
    ++issued;
    if (++i_kc == ks) {
      i_kc = 0;
      i_row0 += m_step * kBM;
    }
    if (++i_slot == kStages) i_slot = 0;
  };

  // The weight tile (with the first stage's group), the column parameters, then the ring's first stages.
  for (int c = 0; c < ks; ++c) load_rows<kVec>(w, N, K, n0, kBN, c * kBK, Ws + c * kBK, ws);
  for (int i = threadIdx.x; i < kBN; i += kThreads) {
    const int64_t col = n0 + i;
    const bool in = col < N;
    const int grid = in ? static_cast<int>((col >= grids.cols) + (col >= 2 * grids.cols)) : 0;
    const float d = grid == 0 ? grids.delta[0] : (grid == 1 ? grids.delta[1] : grids.delta[2]);
    prm[i] = in ? scale[col] : 0.0f;
    prm[kBN + i] = in ? corr[col] : 0.0f;
    prm[2 * kBN + i] = grid == 0 ? grids.mn[0] : (grid == 1 ? grids.mn[1] : grids.mn[2]);
    prm[3 * kBN + i] = d;
    prm[4 * kBN + i] = __frcp_rn(d);
    prm[5 * kBN + i] = __fmul_rn(256.0f, d);
  }
  for (int s = 0; s < kStages - 1; ++s) issue();

  int acc[kMi][kNi][4];
#pragma unroll
  for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNi; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  int64_t row0 = m_first * kBM;  // the M tile of stage s, its depth chunk kc, its ring slot
  int kc = 0, slot = 0;
  for (int64_t s = 0; s < total; ++s) {
    cp_async_wait<kStages - 2>();  // stage s (and the weight tile with stage 0) has landed for this thread
    __syncthreads();               // ... and for all; every thread is done with the slot of stage s - 1
    issue();                       // stage s + kStages - 1
    const int8_t* As = ring + slot * kStageBytes;
    const int8_t* Bs = Ws + kc * kBK;
    if (++slot == kStages) slot = 0;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[kMi][4];
      uint32_t b[kNi][2];
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi) {
        const int8_t* p = As + (wm + mi * 16 + g) * kAStride + kk + t * 4;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(p);                      // row g,     k t*4..+3
        a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kAStride);       // row g + 8, k t*4..+3
        a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);                 // row g,     k 16+t*4..+3
        a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kAStride + 16);  // row g + 8, k 16+t*4..+3
      }
#pragma unroll
      for (int ni = 0; ni < kNi; ++ni) {
        const int8_t* p = Bs + (wn + ni * 8 + g) * ws + kk + t * 4;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(p);       // column g, k t*4..+3
        b[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);  // column g, k 16+t*4..+3
      }
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNi; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
    if (++kc < ks) continue;
    kc = 0;

    // Epilogue of the M tile: accumulator r of an m16n8 tile sits at row g + 8 (r / 2), column t * 2 + r % 2.
#pragma unroll
    for (int ni = 0; ni < kNi; ++ni) {
      const int col = wn + ni * 8 + t * 2;
      const float2 sc = *reinterpret_cast<const float2*>(prm + col);
      const float2 co = *reinterpret_cast<const float2*>(prm + kBN + col);
      const float2 mn = *reinterpret_cast<const float2*>(prm + 2 * kBN + col);
      const float2 de = *reinterpret_cast<const float2*>(prm + 3 * kBN + col);
      const float2 rc = *reinterpret_cast<const float2*>(prm + 4 * kBN + col);
      const float2 hi = *reinterpret_cast<const float2*>(prm + 5 * kBN + col);
#pragma unroll
      for (int mi = 0; mi < kMi; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t x0 = requant<kNl>(acc[mi][ni][2 * h], sc.x, co.x, alpha, mn.x, de.x, rc.x, hi.x);
          const uint32_t x1 = requant<kNl>(acc[mi][ni][2 * h + 1], sc.y, co.y, alpha, mn.y, de.y, rc.y, hi.y);
          *reinterpret_cast<uint16_t*>(Os + (wm + mi * 16 + g + 8 * h) * kOStride + col) =
              static_cast<uint16_t>((x0 | (x1 << 8)) ^ 0x8080u);
          acc[mi][ni][2 * h] = 0;
          acc[mi][ni][2 * h + 1] = 0;
        }
      }
    }
    __syncthreads();
    const int64_t m0 = row0;
    row0 += m_step * kBM;
    constexpr int kChunks = kBM * kBN / 16;
    for (int c = threadIdx.x; c < kChunks; c += kThreads) {
      const int row = c / (kBN / 16);
      const int col = (c % (kBN / 16)) * 16;
      const int64_t grow = m0 + row;
      const int64_t gcol = n0 + col;
      if (grow >= M || gcol >= N) continue;
      const int8_t* src = Os + row * kOStride + col;
      int8_t* dst = out + grow * N + gcol;
      if (N % 16 == 0) {
        *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
      } else {
        const int n = static_cast<int>(N - gcol < 16 ? N - gcol : 16);
        for (int i = 0; i < n; ++i) dst[i] = src[i];
      }
    }
    // The next tile's epilogue writes Os only after the next iteration's __syncthreads.
  }
  cp_async_wait<0>();
}

// One launch's operands; max_blocks set: only ask how many blocks fit an SM.
struct Launch {
  const int8_t* xs;
  const int8_t* w;
  const float* scale;
  const float* corr;
  int nl;
  float alpha;
  OutGrids grids;
  int8_t* out;
  int64_t M, N, K;
  int blocks, n_tiles;
  cudaStream_t stream;
  int* max_blocks;
};

template <bool kVec, int kNi, int kMinBlocks>
int launch_nl(const Launch& l) {
  void (*kernel)(const int8_t*, const int8_t*, const float*, const float*, float, OutGrids, int8_t*, int64_t, int64_t,
                 int64_t, int) =
      l.nl == kTanh      ? int8_mm_requant_kernel<kVec, kTanh, kNi, kMinBlocks>
      : l.nl == kSigmoid ? int8_mm_requant_kernel<kVec, kSigmoid, kNi, kMinBlocks>
      : l.nl == kGelu    ? int8_mm_requant_kernel<kVec, kGelu, kNi, kMinBlocks>
                         : int8_mm_requant_kernel<kVec, kPrelu, kNi, kMinBlocks>;
  const int64_t smem = smem_bytes(16 * kNi, l.K);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (l.max_blocks != nullptr)
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(l.max_blocks, kernel, kThreads, smem));
  kernel<<<l.blocks, kThreads, smem, l.stream>>>(l.xs, l.w, l.scale, l.corr, l.alpha, l.grids, l.out, l.M, l.N, l.K,
                                                  l.n_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int kNi, int kMinBlocks>
int launch_tile(const Launch& l) {
  const bool vec = l.K % 16 == 0 && reinterpret_cast<uintptr_t>(l.xs) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(l.w) % 16 == 0;
  // the byte path (odd K or pointers) is off the engines' shapes, and spills under the 128-register cap
  return vec ? launch_nl<true, kNi, kMinBlocks>(l) : launch_nl<false, kNi, 1>(l);
}

// The N tile: 128 columns, or 64 where N <= 64 or the 128-column weight tile does not fit; 0 where neither fits.
int tile_n(int64_t N, int64_t K) {
  if (N > 64 && smem_bytes(128, K) <= kSmemBytes) return 128;
  return smem_bytes(64, K) <= kSmemBytes ? 64 : 0;
}

int dispatch(Launch l) {
  const int bn = tile_n(l.N, l.K);
  if (bn == 0) return static_cast<int>(cudaErrorInvalidValue);
  l.n_tiles = static_cast<int>((l.N + bn - 1) / bn);
  if (l.max_blocks == nullptr && (l.blocks < l.n_tiles || l.blocks % l.n_tiles != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool two = 2 * (smem_bytes(bn, l.K) + 1024) <= kSmemPerSm;
  if (bn == 128) return two ? launch_tile<8, 2>(l) : launch_tile<8, 1>(l);
  return two ? launch_tile<4, 2>(l) : launch_tile<4, 1>(l);
}

}  // namespace

// Blocks of the kernel for (N, K) that fit on one SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor, the PReLU
// epilogue), into *out. Returns the CUDA error code.
extern "C" int fqss_int8_matmul_blocks_per_sm(int64_t N, int64_t K, int* out) {
  *out = 0;
  const OutGrids none{{1.0f, 1.0f, 1.0f}, {0.0f, 0.0f, 0.0f}, N};
  return dispatch({nullptr, nullptr, nullptr, nullptr, kPrelu, 1.0f, none, nullptr, 1, N, K, 0, 0, nullptr, out});
}

// xs: [M, K] int8, w: [N, K] int8, scale and corr: [N] float32, out: [M, N] int8;
// all contiguous on the current device, out 16-byte aligned. nl: 0 PReLU with slope alpha, 1 tanh,
// 2 sigmoid, 3 the exact GELU. Output grid g = 0, 1, 2 is (delta_g, mn_g) and takes columns
// [g cols, (g + 1) cols); cols = N for one grid. blocks: the persistent grid, a multiple of the N tiles
// (ceil(N / 128), or ceil(N / 64) where N <= 64 or K > 1152). Returns the launch's CUDA error code.
extern "C" int fqss_int8_matmul_requant(const int8_t* xs, const int8_t* w, const float* scale, const float* corr,
                                        int nl, float alpha, float delta0, float mn0, float delta1, float mn1,
                                        float delta2, float mn2, int64_t cols, int8_t* out, int64_t M, int64_t N,
                                        int64_t K, int blocks, void* stream) {
  if (cols < 1 || (N + cols - 1) / cols > kMaxGrids || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const OutGrids grids{{delta0, delta1, delta2}, {mn0, mn1, mn2}, cols};
  return dispatch({xs, w, scale, corr, nl, alpha, grids, out, M, N, K, blocks, 0, static_cast<cudaStream_t>(stream),
                   nullptr});
}
