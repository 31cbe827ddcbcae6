// Fused QAT dense layer for NVIDIA Hopper (sm_90a): K5 forward and K5-bwd, and K3.
//
//   weight_grid_kernel             the weight grid of K5 and K5-bwd, once a call:
//                                  wq = weight_fq(w), the same grid point as K2's
//   qat_dense_kernel<kEpiForward>  replaces fqss_tpu/ops/pallas_qat.py:_qd_fwd_kernel
//                                  (the forward of qat_dense):
//                                  y = act_fq(x @ wq^T + b),
//                                  x [M, K], w [N, K] (the port's [out, in] layout,
//                                  one symmetric grid per out-channel n), b [N],
//                                  one uniform grid for the output.
//   qat_dense_kernel<kEpiMask>     replaces _qd_bwd_mask_kernel: recomputes the
//   + colsum_kernel (x2)           pre-activation, gives gm = g * m (the act grid's
//                                  straight-through mask, 0.5 at a clip bound),
//                                  each tile's partial sums of the act ranges'
//                                  gradient terms and of db; two fixed-order
//                                  column sums finish dmn, dmx and db.
//   qat_dense_kernel<kEpiSplit>    replaces _qd_dx_kernel and _qd_dwq_kernel: dx = gm @ wq
//   + colsum_kernel                and dwq = gm^T @ x, each sum (over N, over M) split
//                                  into fixed ranges whose partial products a
//                                  fixed-order column sum adds (split_count: where
//                                  the output's tiles alone leave most of a wave of
//                                  blocks idle).
// dwq then goes through the weight grid's straight-through backward, K2-bwd
// (fake_quant.cu:weight_bwd_kernel), as _qd_bwd does with _w_bwd_impl.
//   qat_dense_kernel<kEpiForward>  also replaces fqss_tpu/ops/pallas_quant.py:_qmm_kernel
//   without a bias (K3)            (qmatmul_pallas, forward only): y[b] = act_fq(weight_fq(w) @ x[b]),
//                                  w [N, K], x [B, K, T], y [B, N, T]: the port's NCT layout of a
//                                  bias-free 1x1 convolution, so the weight is the row operand (A, [I][R]),
//                                  x[b] the column operand stored [R][J], and blockIdx.z the batch row.
//                                  JAX's kernel takes x [M, K] @ w [K, N]: the same products, transposed.
//   qat_dense_kernel<kEpiForward>  K5's GELU route (QDense(nl="gelu"), HTDemucs's transformer FFN):
//   with DenseArgs::gelu           y = act_fq(gelu(x @ wq^T + b)), the exact GELU (fake_quant.cuh:gelu)
//                                  between the bias and the act grid; inside the observer window the
//                                  post-GELU value; float32 or bf16 operands.
//   qat_dense_kernel<kEpiMask>     K5-bwd's GELU route (float32): the mask pass takes the act grid's mask
//   with DenseArgs::gelu           and range terms at u = gelu(pre), as the forward quantizes u, and gives
//                                  gm = g * mask(u) * gelu'(pre) (fake_quant.cuh:gelu_with_grad; g * gelu'(pre)
//                                  where the act grid observes or is off), db its column sum. JAX computes
//                                  this under XLA (fqss_tpu/nn/layers.py:QDense, Nl("gelu") between the
//                                  bias and the act quantizer): no TPU kernel to replace; dx and dwq are
//                                  the float32 route's.
//   qat_dense_kernel<kEpiForward,  the bf16 routes of K5 and K3 (QuantSpec.compute_dtype "bfloat16"): both
//   BF16 = true>                   operands rounded to bfloat16 as they leave shared memory (x as loaded,
//                                  the weight after its grid, computed in float32 first, as JAX rounds
//                                  wq(w)), the sums float32, the epilogue unchanged: JAX's jnp.dot of bf16
//                                  operands with preferred_element_type=float32 between the grids.
//
// Either grid can be switched off per call (no weight quantizer: the folded
// serving model, whose weights are already on the grid; no act quantizer: the
// float teacher), and each has a device-resident "observing" flag: while it
// is set (an act quantizer inside its EMA window, a weight quantizer before
// its one-shot observation) the grid is skipped, and in the backward its mask
// is the identity and its range gradients are 0 -- the gradient of
// where(observing, x, fq(x)). The flags are read on the device, so the host
// never waits for the card.
//
// What bounds it on the H100: the products. The Sepformer's feed-forward
// layers do 2 M N K operations on 4 (M K + N K + M N) bytes with K, N of 256
// and 1024, i.e. 100+ operations per byte, and K3's 1x1 convolutions 25.6
// (DPTNet's 256 -> 64) to 64 (the Sepformer's 256 -> 256): above the card's
// float32 ratio (67 TFLOP/s over 3.35 TB/s = 20), so on the CUDA cores the
// float32 rate is the limit. K5-bwd also recomputes the pre-activation (three
// products where cuBLAS's composition does two), so no CUDA-core kernel can
// match the library there.
//
// What the design does about it: the products run on the tensor cores as
// 3xTF32 (mma.sync m16n8k8, TF32 in, float32 accumulators). Each operand value
// v is split as it leaves shared memory into hi = v rounded to TF32 (10
// mantissa bits, to nearest, ties away from zero: cvt.rna.tf32.f32's rounding,
// done with an integer add and mask, which run at four times the rate of a
// conversion) and lo = v - hi (exact; the tensor cores read its top 10
// mantissa bits), and each product is taken as lo*hi + hi*lo + hi*hi: what is
// dropped is about 2^-21 of |term|, so the sums keep float32's accuracy. One
// TF32 product alone (2^-11 of |term|) would put the pre-activations about
// 1e-3 off and move outputs off the 8-bit grids. The tensor cores' own
// accumulation is not an IEEE sum (it truncates below the largest addend's
// bits): summed into one accumulator, 128 k8 steps of positive terms (K = 1024)
// came out 1.4e-5 of sum |term| low on an H100, beyond the 1e-5 the port holds
// the products to. So each 32-step stage is summed from zero and added to the
// float32 accumulator with one __fadd_rn (5.8e-7 there).
// A block owns a 128 x 128 output tile (16 warps), or 64 rows or columns where
// that side has at most 64 (DPTNet's 64 channels, a short dx reduction's
// output); each warp a 32 x 32 sub-tile of 2 x 4 mma tiles. The operand tiles
// stream through a ring of 3 shared-memory stages of 32 reduction steps each,
// filled by 16-byte cp.async.cg (4-byte cp.async.ca, zero-filling, where a
// row is not 16-byte aligned: K = 3, 37, T = 301, ...) two stages ahead of the
// products. Each tile is kept as the operand lies in memory (reduction-major
// or reduction-minor), padded so that the fragment reads are free of bank
// conflicts in both layouts; within a k8 step the reduction slots t and t + 4
// of a thread read k = 2t and 2t + 1 (both operands alike), so a
// reduction-minor row gives both in one 8-byte read. mma.sync and not wgmma:
// TF32 wgmma reads both operands reduction-minor only, and dx's weights, dwq's
// operands and K3's activations lie the other way.
// The weight grid is applied once a call, by a small kernel into an [N, K]
// scratch that the products then read. The epilogue adds b and applies the act
// grid with K1's own device function (fake_quant.cuh), so a quantized output
// equals its own float pre-activation put through K1's grid bit for bit. Every
// sum is taken in a fixed order (the mma sequence of a tile, stage by stage;
// partial sums within a thread, then fixed shuffle trees and warps in order,
// then a fixed-order column sum across blocks): a run repeats bit for bit, and
// the backward's mask pass, which runs the same tiles in the same order as the
// forward, recomputes its pre-activation bit for bit. No float atomics.
//
// The bf16 route takes one TF32 mma.sync a product on the rounded values, not
// a bf16 m16n8k16 one: a value rounded to bf16 is exact in TF32, and the product
// of two (8 x 8 significant bits) is exact in float32, so one TF32 product is
// the exact product that JAX's bf16 dot sums, and the route keeps the float32
// route's ring, tile layouts and fragment reads (both operand layouts, which
// bf16 mma fragments, packed in pairs along k, would each need anew). It takes
// a third of the float32 route's products. Its sums are the float32 route's:
// each 32-step stage from zero (the tensor cores truncate), the stages added
// with __fadd_rn. The rounding is cvt.rn.bf16.f32 (ties to even).
//
// Numerics: explicit _rn intrinsics keep nvcc from contracting or reordering;
// rintf rounds half to even. Do not build with --use_fast_math. A NaN input
// gives NaN outputs; an infinite one also gives NaN (its lo part is inf - inf),
// where a float32 product could give an infinity.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "fake_quant.cuh"
#include "tf32_mma.cuh"

namespace {

using fqss::bf16_tf32;
using fqss::cp_async16;
using fqss::cp_async4;
using fqss::cp_async_commit;
using fqss::cp_async_wait;
using fqss::mma_tf32;
using fqss::split_tf32;

constexpr int kBK = 32;  // reduction steps a stage of the ring holds
constexpr int kStages = 3;  // stages of the ring: two are loading while one is multiplied
constexpr int kWarpI = 32, kWarpJ = 32;  // a warp's output tile
constexpr int kMT = kWarpI / 16, kNT = kWarpJ / 8;  // its m16n8 mma tiles
constexpr int kGridThreads = 256;

enum Epilogue { kEpiForward, kEpiMask, kEpiSplit };

// C[i][j] = sum_r A(i, r) B(r, j) over r in [r_begin, r_end).
struct DenseArgs {
  const float* a;  // A stored [I][R] (A_RC) or [R][I]
  const float* b;  // B stored [J][R] (B_RC) or [R][J]
  int64_t I, J, R;
  int64_t r_chunk;  // kEpiSplit: the rows of R each blockIdx.z sums
  int64_t b_batch, out_batch;  // kEpiForward: B's and out's stride between the batch rows of blockIdx.z (K3)
  bool a_vec, b_vec;  // the operand's rows are 16-byte aligned (base, row length and batch stride)
  // kEpiForward / kEpiMask: the bias (kEpiForward: none when null) and the act grid, when a_mn is set and
  // *a_obs is 0
  const float* bias;
  const float* a_mn;
  const float* a_mx;
  const unsigned char* a_obs;
  int a_bits;
  float s;  // kEpiMask: the act ranges' scale_grad factor
  bool gelu;  // kEpiForward: the exact GELU between the bias and the act grid; kEpiMask: its derivative in gm
  const float* g;  // kEpiMask: the cotangent [I][J]
  float* out;  // y, gm, dx or the [splits][I][J] partial products
  float* act_partials;  // kEpiMask: [tiles, 2]
  float* db_partials;  // kEpiMask: [row tiles][J]
};

__device__ __forceinline__ bool grid_on(const float* mn, const unsigned char* obs) {
  return mn != nullptr && (obs == nullptr || *obs == 0);
}

__device__ __forceinline__ float tie_mask(float X, float lo, float hi) {
  return (X > lo && X < hi) ? 1.0f : ((X == lo || X == hi) ? 0.5f : 0.0f);
}

// An operand tile of BO rows (of I or J) by kBK reduction steps, kept in shared memory as the operand lies in
// device memory: [BO][kBK + 8] where R is contiguous, else [kBK][BO + 4]. The pads make the fragment reads
// conflict-free: 8-byte reads at (o = g, k = 2t) in the first layout, 4-byte reads at (o = g, k = 2t) in the
// second (g = lane / 4, t = lane % 4).
template <int BO, bool R_CONTIG>
struct Tile {
  static constexpr int kStride = R_CONTIG ? kBK + 8 : BO + 4;
  static constexpr int kFloats = R_CONTIG ? BO * kStride : kBK * kStride;
  __device__ static __forceinline__ int at(int o, int r) { return R_CONTIG ? o * kStride + r : r * kStride + o; }
  // Reduction steps k and k + 1 of row o.
  __device__ static __forceinline__ float2 pair(const float* s, int o, int k) {
    if (R_CONTIG) return *reinterpret_cast<const float2*>(s + o * kStride + k);
    return make_float2(s[k * kStride + o], s[(k + 1) * kStride + o]);
  }
};

template <int BI, int BJ>
struct Shape {
  static constexpr int kWarpsI = BI / kWarpI, kWarpsJ = BJ / kWarpJ;
  static constexpr int kThreads = 32 * kWarpsI * kWarpsJ;
  static constexpr int kMinBlocks = kThreads < 256 ? 256 / kThreads : 1;
};

// The ring's bytes: kStages stages of both operand tiles.
template <int BI, int BJ, bool A_RC, bool B_RC>
constexpr int ring_bytes() {
  return kStages * (Tile<BI, A_RC>::kFloats + Tile<BJ, B_RC>::kFloats) * 4;
}

// A thread's share of copying one operand's tiles (o in [o0, o0 + BO), stage s: r in [r_begin + s kBK, ...)
// of an operand stored [O][R] (R_CONTIG) or [R][O]) into the ring: its chunks of 4 neighbours along the
// contiguous axis, all at the same contiguous offset v and kStep apart along the strided one. Everything that
// depends on the block is computed once; a stage adds offsets. What lies outside o < O, r < r_end is filled
// with zeros. vec: one 16-byte copy a chunk (the contiguous extent is then a multiple of 4, so a chunk is all
// inside or all out); else four 4-byte copies.
template <int BO, bool R_CONTIG, int THREADS>
struct TileLoader {
  static constexpr int kRow = R_CONTIG ? kBK / 4 : BO / 4;  // chunks along the contiguous axis
  static constexpr int kStep = THREADS / kRow;  // strided-axis distance between a thread's chunks
  static constexpr int kChunks = BO * kBK / 4 / THREADS;
  static_assert(THREADS % kRow == 0 && (BO * kBK / 4) % THREADS == 0, "the chunks divide among the threads");

  const float* p;  // the operand (a valid address for the copies that read nothing)
  const float* base;  // this thread's first chunk at stage 0
  int64_t chunk_stride, stage_stride;  // elements between a thread's chunks, between stages
  int u0, v;  // the first chunk's strided and contiguous offsets in the tile
  int64_t o_left;  // R_CONTIG: rows of O from the first chunk's on; else columns from v on
  int64_t r_len;  // r_end - r_begin
  bool vec;

  __device__ __forceinline__ TileLoader(const float* p_, int64_t O, int64_t R, int64_t o0, int64_t r_begin,
                                        int64_t r_end, bool vec_)
      : p(p_), u0(threadIdx.x / kRow), v(threadIdx.x % kRow * 4), r_len(r_end - r_begin), vec(vec_) {
    if (R_CONTIG) {
      base = p + (o0 + u0) * R + r_begin + v;
      chunk_stride = kStep * R;
      stage_stride = kBK;
      o_left = O - o0 - u0;
    } else {
      base = p + (r_begin + u0) * O + o0 + v;
      chunk_stride = kStep * O;
      stage_stride = kBK * O;
      o_left = O - o0 - v;
    }
  }

  __device__ __forceinline__ void load(float* s, int stage) const {
    const int64_t rs = static_cast<int64_t>(stage) * kBK;
    const float* src = base + stage * stage_stride;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int u = u0 + k * kStep;
      const float* ck = src + k * chunk_stride;
      float* dst = s + (R_CONTIG ? Tile<BO, R_CONTIG>::at(u, v) : Tile<BO, R_CONTIG>::at(v, u));
      // R_CONTIG: row u inside O, the chunk's steps inside R; else the chunk's row inside R, columns inside O
      const bool strided_ok = R_CONTIG ? k * kStep < o_left : rs + u < r_len;
      if (vec) {
        const bool ok = strided_ok && (R_CONTIG ? rs + v < r_len : o_left > 0);
        cp_async16(dst, ok ? ck : p, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = strided_ok && (R_CONTIG ? rs + v + e < r_len : e < o_left);
          cp_async4(dst + e, ok ? ck + e : p, ok);
        }
      }
    }
  }
};

template <int THREADS>
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  constexpr int kWarps = THREADS / 32;
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
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      a = __fadd_rn(a, sa[w]);
      b = __fadd_rn(b, sb[w]);
    }
  }
}

// Accumulator element c of mma tile (mt, nt): row g + 8 (c / 2) of the tile's 16, column 2 t + c % 2 of its 8.
__device__ __forceinline__ int acc_row(int wi, int mt, int g, int c) { return wi * kWarpI + mt * 16 + g + (c >> 1) * 8; }
__device__ __forceinline__ int acc_col(int wj, int nt, int t, int c) { return wj * kWarpJ + nt * 8 + 2 * t + (c & 1); }

// The accumulators and a stage's partial sums take 64 registers a thread: a block of 16 warps (128 x 128) fits
// in 128 registers a thread without spilling, the smaller blocks are given up to 255.
// BF16 (kEpiForward only): the products of the operands rounded to bfloat16, one TF32 mma each.
template <int BI, int BJ, bool A_RC, bool B_RC, int EPI, bool BF16>
__global__ void __launch_bounds__(Shape<BI, BJ>::kThreads, Shape<BI, BJ>::kMinBlocks)
    qat_dense_kernel(DenseArgs p) {
  static_assert(!BF16 || EPI == kEpiForward, "the bf16 route is the forward's");
  using S = Shape<BI, BJ>;
  using TA = Tile<BI, A_RC>;
  using TB = Tile<BJ, B_RC>;
  extern __shared__ __align__(16) float ring[];
  float* const As = ring;
  float* const Bs = ring + kStages * TA::kFloats;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wi = warp / S::kWarpsJ, wj = warp % S::kWarpsJ;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * BI;
  const int64_t j0 = static_cast<int64_t>(blockIdx.y) * BJ;
  // kEpiForward: blockIdx.z is a batch row of B and out (K3; K5 has one)
  const int64_t z = EPI == kEpiForward ? static_cast<int64_t>(blockIdx.z) : 0;
  int64_t r_begin = 0, r_end = p.R;
  if (EPI == kEpiSplit) {
    r_begin = static_cast<int64_t>(blockIdx.z) * p.r_chunk;
    r_end = r_begin + p.r_chunk < p.R ? r_begin + p.r_chunk : p.R;
  }
  const bool a_on = (EPI == kEpiForward || EPI == kEpiMask) && grid_on(p.a_mn, p.a_obs);

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.0f;

  // The mask kernel needs the product only where the act grid applies or the GELU stands.
  if (EPI != kEpiMask || a_on || p.gelu) {
    const TileLoader<BI, A_RC, S::kThreads> la(p.a, p.I, p.R, i0, r_begin, r_end, p.a_vec);
    const TileLoader<BJ, B_RC, S::kThreads> lb(p.b + z * p.b_batch, p.J, p.R, j0, r_begin, r_end, p.b_vec);
    const int stages = r_end > r_begin ? static_cast<int>((r_end - r_begin + kBK - 1) / kBK) : 0;
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < stages) {
        la.load(As + st * TA::kFloats, st);
        lb.load(Bs + st * TB::kFloats, st);
      }
      cp_async_commit();
    }
    for (int kt = 0; kt < stages; ++kt) {
      cp_async_wait<kStages - 2>();  // stage kt has landed (for this thread's copies) ...
      __syncthreads();  // ... for every thread's, and stage kt - 1 is no longer read
      const int next = kt + kStages - 1;
      if (next < stages) {
        la.load(As + next % kStages * TA::kFloats, next);
        lb.load(Bs + next % kStages * TB::kFloats, next);
      }
      cp_async_commit();
      const float* a = As + kt % kStages * TA::kFloats;
      const float* b = Bs + kt % kStages * TB::kFloats;
      float part[kMT][kNT][4];  // this stage's products, summed from zero
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) part[mt][nt][c] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 8) {
        const int k = kk + 2 * t;  // reduction slots t and t + 4 of this k8 step
        uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const float2 v = TB::pair(b, wj * kWarpJ + nt * 8 + g, k);
          if constexpr (BF16) {
            bh[nt][0] = bf16_tf32(v.x);
            bh[nt][1] = bf16_tf32(v.y);
          } else {
            split_tf32(v.x, bh[nt][0], bl[nt][0]);
            split_tf32(v.y, bh[nt][1], bl[nt][1]);
          }
        }
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          const int row = wi * kWarpI + mt * 16 + g;
          const float2 v0 = TA::pair(a, row, k), v1 = TA::pair(a, row + 8, k);
          uint32_t ah[4], al[4];
          if constexpr (BF16) {
            ah[0] = bf16_tf32(v0.x);
            ah[1] = bf16_tf32(v1.x);
            ah[2] = bf16_tf32(v0.y);
            ah[3] = bf16_tf32(v1.y);
          } else {
            split_tf32(v0.x, ah[0], al[0]);
            split_tf32(v1.x, ah[1], al[1]);
            split_tf32(v0.y, ah[2], al[2]);
            split_tf32(v1.y, ah[3], al[3]);
          }
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            if constexpr (BF16) {
              mma_tf32(part[mt][nt], ah, bh[nt]);
            } else {
              mma_tf32(part[mt][nt], al, bh[nt]);
              mma_tf32(part[mt][nt], ah, bl[nt]);
              mma_tf32(part[mt][nt], ah, bh[nt]);
            }
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mt][nt][c] = __fadd_rn(acc[mt][nt][c], part[mt][nt][c]);
    }
  }

  // The epilogues walk a thread's rows (mt, c / 2) and, in each, its columns (nt, c % 2).
  float* const out = p.out + (EPI == kEpiSplit ? static_cast<int64_t>(blockIdx.z) * p.I * p.J : z * p.out_batch);
  if (EPI == kEpiSplit) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t i = i0 + acc_row(wi, mt, g, 2 * h);
        if (i >= p.I) continue;
        float* const row = out + i * p.J + j0;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = acc_col(wj, nt, t, e);
            if (j0 + j < p.J) row[j] = acc[mt][nt][2 * h + e];
          }
      }
    return;
  }

  const float aq = static_cast<float>((1 << p.a_bits) - 1);
  float a_mn = 0.0f, a_delta = 1.0f;
  if (a_on) {
    a_mn = __ldg(p.a_mn);
    a_delta = fqss::act_grid_step(a_mn, __ldg(p.a_mx), aq);
  }
  float bias[kNT][2];  // the bias of each of the thread's columns (0 where there is none)
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int64_t j = j0 + acc_col(wj, nt, t, e);
      bias[nt][e] = p.bias != nullptr && j < p.J ? __ldg(p.bias + j) : 0.0f;
    }

  if (EPI == kEpiForward) {
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t i = i0 + acc_row(wi, mt, g, 2 * h);
        if (i >= p.I) continue;
        float* const row = out + i * p.J + j0;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = acc_col(wj, nt, t, e);
            if (j0 + j >= p.J) continue;
            const float pre = acc[mt][nt][2 * h + e];
            float v = p.bias != nullptr ? __fadd_rn(pre, bias[nt][e]) : pre;
            if (p.gelu) v = fqss::gelu(v);
            if (a_on) v = fqss::act_grid_value(v, a_mn, a_delta, aq);
            row[j] = v;
          }
      }
    return;
  }

  // kEpiMask: gm, the act ranges' partial sums (fixed order: mt, h, nt, e), and db's column partials (each
  // thread's columns over its rows in that order, then the 8 row groups of a warp by a fixed shuffle tree, then
  // the warps along I in order).
  float p_mn = 0.0f, p_mx = 0.0f;
  float col[kNT][2];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) col[nt][0] = col[nt][1] = 0.0f;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t i = i0 + acc_row(wi, mt, g, 2 * h);
      if (i >= p.I) continue;
      float* const row = out + i * p.J + j0;
      const float* const grow = p.g + i * p.J + j0;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = acc_col(wj, nt, t, e);
          if (j0 + j >= p.J) continue;
          const float gi = grow[j];
          float gm = gi;
          if (a_on || p.gelu) {
            const float pre = __fadd_rn(acc[mt][nt][2 * h + e], bias[nt][e]);
            // the GELU route: the act grid sees gelu(pre), and gm carries gelu'(pre) whether the grid applies,
            // observes or is off
            float v = pre, slope = 1.0f;
            if (p.gelu) fqss::gelu_with_grad(pre, v, slope);
            if (a_on) {
              const float u = __fdiv_rn(__fsub_rn(v, a_mn), a_delta);
              const float X = rintf(u);
              const float m = tie_mask(X, 0.0f, aq);
              const float tt = __fdiv_rn(__fsub_rn(fqss::clip(X, 0.0f, aq), __fmul_rn(m, u)), aq);
              gm = __fmul_rn(gi, m);
              p_mn = __fadd_rn(p_mn, __fmul_rn(gi, __fsub_rn(__fsub_rn(1.0f, m), __fmul_rn(p.s, tt))));
              p_mx = __fadd_rn(p_mx, __fmul_rn(__fmul_rn(gi, p.s), tt));
            }
            if (p.gelu) gm = __fmul_rn(gm, slope);
          }
          row[j] = gm;
          col[nt][e] = __fadd_rn(col[nt][e], gm);
        }
    }
  block_sum2<S::kThreads>(p_mn, p_mx);
  if (threadIdx.x == 0) {
    const int64_t tile = static_cast<int64_t>(blockIdx.x) * gridDim.y + blockIdx.y;
    p.act_partials[2 * tile] = p_mn;
    p.act_partials[2 * tile + 1] = p_mx;
  }
  __shared__ float cs[S::kWarpsI][BJ];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = col[nt][e];
      for (int off = 16; off >= 4; off >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
      if (g == 0) cs[wi][acc_col(wj, nt, t, e)] = v;
    }
  __syncthreads();
  for (int c = threadIdx.x; c < BJ && j0 + c < p.J; c += S::kThreads) {
    float s = cs[0][c];
    for (int w = 1; w < S::kWarpsI; ++w) s = __fadd_rn(s, cs[w][c]);
    p.db_partials[static_cast<int64_t>(blockIdx.x) * p.J + j0 + c] = s;
  }
}

// out[c] = sum over r of p[r][c] for a [rows, cols] matrix of few rows (a split product's partials), in row
// order, one thread a column.
__global__ void colsum_rows_kernel(const float* __restrict__ p, int64_t rows, int64_t cols, float* __restrict__ out) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  float a = p[c];
#pragma unroll 4
  for (int64_t r = 1; r < rows; ++r) a = __fadd_rn(a, p[r * cols + c]);
  out[c] = a;
}

// out[c] = sum over r of p[r][c] for a [rows, cols] matrix, in a fixed order: each of 8 thread rows sums every
// 8th row, then the 8 partial sums are added in order.
__global__ void colsum_kernel(const float* __restrict__ p, int64_t rows, int64_t cols, float* __restrict__ out) {
  __shared__ float s[8][33];
  const int64_t c = static_cast<int64_t>(blockIdx.x) * 32 + threadIdx.x;
  float a = 0.0f;
  if (c < cols) {
    for (int64_t r = threadIdx.y; r < rows; r += 8) a = __fadd_rn(a, p[r * cols + c]);
  }
  s[threadIdx.y][threadIdx.x] = a;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    float t = s[0][threadIdx.x];
    for (int k = 1; k < 8; ++k) t = __fadd_rn(t, s[k][threadIdx.x]);
    out[c] = t;
  }
}

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// The block tile's side along an output axis of n: 64 where n is at most 64, else 128.
int64_t tile_side(int64_t n) { return n <= 64 ? 64 : 128; }

constexpr int64_t kSms = 132;  // the H100's SMs; a block of the products takes one (16 warps, 128 registers each)

// The ranges a product's sum over R (with `tiles` output tiles) is split into, their partial products then added
// by a fixed-order column sum: one where the tiles alone fill four waves of blocks; else the fewest, of at least
// 256 reduction steps each, whose waves come within 5% of the best split's (a wave's blocks each sum R / splits).
// It depends on the shapes only, so the sums' order does too. At the Sepformer's training shapes dx's 134 tiles
// take 4 ranges (5 waves of a quarter of the work, not 2 of all of it) and dwq's 16 take 8 (one wave).
int64_t split_count(int64_t tiles, int64_t R) {
  if (tiles >= 4 * kSms) return 1;
  int64_t most = cdiv(R, 256);
  most = most < 1 ? 1 : (most > 2 * kSms ? 2 * kSms : most);
  const auto cost = [tiles](int64_t s) { return static_cast<double>(cdiv(tiles * s, kSms)) / s; };
  double best = cost(1);
  for (int64_t s = 2; s <= most; ++s) best = cost(s) < best ? cost(s) : best;
  for (int64_t s = 1; s <= most; ++s) {
    if (cost(s) <= 1.05 * best) return s;
  }
  return 1;
}

bool rows_aligned(const void* ptr, int64_t row, int64_t batch) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && row % 4 == 0 && batch % 4 == 0;
}

template <int BI, int BJ, bool A_RC, bool B_RC, int EPI, bool BF16>
cudaError_t launch_tiles(const DenseArgs& p, int64_t z, cudaStream_t stream) {
  const int64_t tiles_j = cdiv(p.J, BJ);
  if (tiles_j > 65535 || z > 65535) return cudaErrorInvalidConfiguration;  // the grid's y and z limits
  constexpr int smem = ring_bytes<BI, BJ, A_RC, B_RC>();
  // The ring passes 48 KB: the kernel's limit is raised once on each device, not at every launch (it is a driver
  // call on the host, and the training step's small launches are bound by the host).
  static std::atomic<uint64_t> raised{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const uint64_t bit = uint64_t{1} << (device & 63);
  if ((raised.load() & bit) == 0) {
    err = cudaFuncSetAttribute(qat_dense_kernel<BI, BJ, A_RC, B_RC, EPI, BF16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    raised.fetch_or(bit);
  }
  const dim3 grid(static_cast<unsigned int>(cdiv(p.I, BI)), static_cast<unsigned int>(tiles_j),
                  static_cast<unsigned int>(z));
  qat_dense_kernel<BI, BJ, A_RC, B_RC, EPI, BF16><<<grid, Shape<BI, BJ>::kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// One launch over the I x J output tiles (tile_side of each) and z along blockIdx.z (K5's dwq: the row ranges
// of R; K3: the batch rows). The tiles depend on the shapes only, so the forward and the mask pass (I = M,
// J = N both) take the same ones. BF16: the forward's bf16 route.
template <bool A_RC, bool B_RC, int EPI, bool BF16 = false>
cudaError_t launch(DenseArgs p, int64_t z, cudaStream_t stream) {
  p.a_vec = rows_aligned(p.a, A_RC ? p.R : p.I, 0);
  p.b_vec = rows_aligned(p.b, B_RC ? p.R : p.J, p.b_batch);
  const bool narrow_i = tile_side(p.I) == 64, narrow_j = tile_side(p.J) == 64;
  if (narrow_i && narrow_j) return launch_tiles<64, 64, A_RC, B_RC, EPI, BF16>(p, z, stream);
  if (narrow_i) return launch_tiles<64, 128, A_RC, B_RC, EPI, BF16>(p, z, stream);
  if (narrow_j) return launch_tiles<128, 64, A_RC, B_RC, EPI, BF16>(p, z, stream);
  return launch_tiles<128, 128, A_RC, B_RC, EPI, BF16>(p, z, stream);
}

// wq [N, K] = the weight grid of w [N, K] (one symmetric grid per row n, K2's arithmetic), or w itself where the
// observing flag is set.
__global__ void weight_grid_kernel(const float* __restrict__ w, const float* __restrict__ mn,
                                   const float* __restrict__ mx, const unsigned char* __restrict__ obs,
                                   float* __restrict__ wq, int64_t n, int64_t K, int bits) {
  const bool on = obs == nullptr || *obs == 0;
  const float q = static_cast<float>((1 << bits) - 1);
  const float qmin = -static_cast<float>(1 << (bits - 1));
  const float qmax = static_cast<float>((1 << (bits - 1)) - 1);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int64_t c = i / K;
    wq[i] = on ? fqss::weight_grid_value(w[i], fqss::weight_grid_step(__ldg(mn + c), __ldg(mx + c), q), qmin, qmax)
               : w[i];
  }
}

// The weights the products read: wq (written here) when there is a weight grid, else w.
const float* grid_weights(const float* w, const float* w_mn, const float* w_mx, const unsigned char* w_obs,
                          float* wq, int64_t N, int64_t K, int bits, cudaStream_t stream, cudaError_t* err) {
  *err = cudaSuccess;
  if (w_mn == nullptr) return w;
  const int64_t n = N * K;
  const int64_t blocks = cdiv(n, kGridThreads) < 1024 ? cdiv(n, kGridThreads) : 1024;
  weight_grid_kernel<<<static_cast<unsigned int>(blocks), kGridThreads, 0, stream>>>(w, w_mn, w_mx, w_obs, wq, n, K,
                                                                                      bits);
  *err = cudaGetLastError();
  return wq;
}

// Fixed-order column sums: of the mask kernel's per-tile partial sums (many rows, few columns: 8 threads a
// column), and of a split product's partials (at most 2 x 132 rows, many columns: one thread a column).
cudaError_t colsum(const float* p, int64_t rows, int64_t cols, float* out, cudaStream_t stream) {
  colsum_kernel<<<static_cast<unsigned int>(cdiv(cols, 32)), dim3(32, 8), 0, stream>>>(p, rows, cols, out);
  return cudaGetLastError();
}

cudaError_t colsum_splits(const float* p, int64_t splits, int64_t cols, float* out, cudaStream_t stream) {
  colsum_rows_kernel<<<static_cast<unsigned int>(cdiv(cols, 256)), 256, 0, stream>>>(p, splits, cols, out);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. Each function launches on the given stream, does not synchronise, and
// returns cudaGetLastError() (0 = success). A null w_mn (a_mn) switches the weight (act) grid off; a null
// w_obs (a_obs) means the grid's quantizer has no observer. The flags are one byte (torch.bool) on the device.

// tiles[0], tiles[1]: the row and column tiles of a [rows, cols] output (the mask kernel's partial sums).
extern "C" void fqss_qat_dense_tiles(int64_t rows, int64_t cols, int64_t* tiles) {
  tiles[0] = cdiv(rows, tile_side(rows));
  tiles[1] = cdiv(cols, tile_side(cols));
}

// The number of ranges the dx product splits its sum over N into, and the dwq product its sum over M
// (split_count).
extern "C" int fqss_qat_dense_dx_splits(int64_t M, int64_t K, int64_t N) {
  return static_cast<int>(split_count(cdiv(M, tile_side(M)) * cdiv(K, tile_side(K)), N));
}

extern "C" int fqss_qat_dense_dwq_splits(int64_t M, int64_t K, int64_t N) {
  return static_cast<int>(split_count(cdiv(N, tile_side(N)) * cdiv(K, tile_side(K)), M));
}

namespace {

template <bool BF16>
int dense_forward(const float* x, const float* w, const float* b, const float* w_mn, const float* w_mx,
                  const unsigned char* w_obs, const float* a_mn, const float* a_mx, const unsigned char* a_obs,
                  float* wq, float* y, int64_t M, int64_t K, int64_t N, int w_bits, int a_bits, bool gelu,
                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  DenseArgs p{};
  p.a = x, p.b = grid_weights(w, w_mn, w_mx, w_obs, wq, N, K, w_bits, st, &err), p.I = M, p.J = N, p.R = K;
  if (err != cudaSuccess) return static_cast<int>(err);
  p.bias = b, p.a_mn = a_mn, p.a_mx = a_mx, p.a_obs = a_obs, p.a_bits = a_bits, p.gelu = gelu;
  p.out = y;
  return static_cast<int>(launch<true, true, kEpiForward, BF16>(p, 1, st));
}

template <bool BF16>
int qmatmul_forward(const float* x, const float* w, const float* w_mn, const float* w_mx, const unsigned char* w_obs,
                    const float* a_mn, const float* a_mx, const unsigned char* a_obs, float* wq, float* y, int64_t B,
                    int64_t K, int64_t T, int64_t N, int w_bits, int a_bits, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  DenseArgs p{};
  p.a = grid_weights(w, w_mn, w_mx, w_obs, wq, N, K, w_bits, st, &err), p.b = x, p.I = N, p.J = T, p.R = K;
  if (err != cudaSuccess) return static_cast<int>(err);
  p.b_batch = K * T, p.out_batch = N * T;
  p.a_mn = a_mn, p.a_mx = a_mx, p.a_obs = a_obs, p.a_bits = a_bits;
  p.out = y;
  return static_cast<int>(launch<true, false, kEpiForward, BF16>(p, B, st));
}

}  // namespace

// y [M, N] = act_fq(x [M, K] @ weight_fq(w [N, K])^T + b [N]); wq: [N, K] scratch for the weight grid (unused
// without one).
extern "C" int fqss_qat_dense(const float* x, const float* w, const float* b, const float* w_mn, const float* w_mx,
                              const unsigned char* w_obs, const float* a_mn, const float* a_mx,
                              const unsigned char* a_obs, float* wq, float* y, int64_t M, int64_t K, int64_t N,
                              int w_bits, int a_bits, void* stream) {
  return dense_forward<false>(x, w, b, w_mn, w_mx, w_obs, a_mn, a_mx, a_obs, wq, y, M, K, N, w_bits, a_bits, false,
                              stream);
}

// fqss_qat_dense's bf16 route: x and the weight (after its grid) rounded to bfloat16, the sums float32.
extern "C" int fqss_qat_dense_bf16(const float* x, const float* w, const float* b, const float* w_mn,
                                   const float* w_mx, const unsigned char* w_obs, const float* a_mn, const float* a_mx,
                                   const unsigned char* a_obs, float* wq, float* y, int64_t M, int64_t K, int64_t N,
                                   int w_bits, int a_bits, void* stream) {
  return dense_forward<true>(x, w, b, w_mn, w_mx, w_obs, a_mn, a_mx, a_obs, wq, y, M, K, N, w_bits, a_bits, false,
                             stream);
}

// The GELU routes of fqss_qat_dense and fqss_qat_dense_bf16: y = act_fq(gelu(x @ weight_fq(w)^T + b)).
extern "C" int fqss_qat_dense_gelu(const float* x, const float* w, const float* b, const float* w_mn,
                                   const float* w_mx, const unsigned char* w_obs, const float* a_mn, const float* a_mx,
                                   const unsigned char* a_obs, float* wq, float* y, int64_t M, int64_t K, int64_t N,
                                   int w_bits, int a_bits, void* stream) {
  return dense_forward<false>(x, w, b, w_mn, w_mx, w_obs, a_mn, a_mx, a_obs, wq, y, M, K, N, w_bits, a_bits, true,
                              stream);
}

extern "C" int fqss_qat_dense_bf16_gelu(const float* x, const float* w, const float* b, const float* w_mn,
                                        const float* w_mx, const unsigned char* w_obs, const float* a_mn,
                                        const float* a_mx, const unsigned char* a_obs, float* wq, float* y, int64_t M,
                                        int64_t K, int64_t N, int w_bits, int a_bits, void* stream) {
  return dense_forward<true>(x, w, b, w_mn, w_mx, w_obs, a_mn, a_mx, a_obs, wq, y, M, K, N, w_bits, a_bits, true,
                             stream);
}

// The mask pass of the backward: gm [M, N]; sums[0..1] = (dmn, dmx) of the act ranges; db [N]; wq [N, K], the
// weights on their grid, for the dx pass (unused without a weight grid). act_partials [tiles[0] * tiles[1], 2]
// and db_partials [tiles[0], N] are scratch (fqss_qat_dense_tiles(M, N)).
namespace {

int mask_pass(const float* x, const float* w, const float* b, const float* g, const float* w_mn, const float* w_mx,
              const unsigned char* w_obs, const float* a_mn, const float* a_mx, const unsigned char* a_obs, float s,
              float* wq, float* gm, float* act_partials, float* db_partials, float* sums, float* db, int64_t M,
              int64_t K, int64_t N, int w_bits, int a_bits, bool gelu, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  DenseArgs p{};
  p.a = x, p.b = grid_weights(w, w_mn, w_mx, w_obs, wq, N, K, w_bits, st, &err), p.I = M, p.J = N, p.R = K;
  if (err != cudaSuccess) return static_cast<int>(err);
  p.bias = b, p.a_mn = a_mn, p.a_mx = a_mx, p.a_obs = a_obs, p.a_bits = a_bits, p.s = s, p.gelu = gelu;
  p.g = g, p.out = gm, p.act_partials = act_partials, p.db_partials = db_partials;
  err = launch<true, true, kEpiMask>(p, 1, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t tiles[2];
  fqss_qat_dense_tiles(M, N, tiles);
  err = colsum(act_partials, tiles[0] * tiles[1], 2, sums, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(colsum(db_partials, tiles[0], N, db, st));
}

}  // namespace

extern "C" int fqss_qat_dense_bwd_mask(const float* x, const float* w, const float* b, const float* g,
                                       const float* w_mn, const float* w_mx, const unsigned char* w_obs,
                                       const float* a_mn, const float* a_mx, const unsigned char* a_obs, float s,
                                       float* wq, float* gm, float* act_partials, float* db_partials, float* sums,
                                       float* db, int64_t M, int64_t K, int64_t N, int w_bits, int a_bits,
                                       void* stream) {
  return mask_pass(x, w, b, g, w_mn, w_mx, w_obs, a_mn, a_mx, a_obs, s, wq, gm, act_partials, db_partials, sums, db,
                   M, K, N, w_bits, a_bits, false, stream);
}

// The mask pass of the GELU route's backward (y = act_fq(gelu(x @ wq^T + b))): gm = g * mask(gelu(pre)) *
// gelu'(pre), the act ranges' sums taken at gelu(pre), db the column sums of gm; the arguments as
// fqss_qat_dense_bwd_mask's.
extern "C" int fqss_qat_dense_bwd_mask_gelu(const float* x, const float* w, const float* b, const float* g,
                                            const float* w_mn, const float* w_mx, const unsigned char* w_obs,
                                            const float* a_mn, const float* a_mx, const unsigned char* a_obs, float s,
                                            float* wq, float* gm, float* act_partials, float* db_partials,
                                            float* sums, float* db, int64_t M, int64_t K, int64_t N, int w_bits,
                                            int a_bits, void* stream) {
  return mask_pass(x, w, b, g, w_mn, w_mx, w_obs, a_mn, a_mx, a_obs, s, wq, gm, act_partials, db_partials, sums, db,
                   M, K, N, w_bits, a_bits, true, stream);
}

// dx [M, K] = gm [M, N] @ wq [N, K] (the weights as the mask pass left them: on their grid, or w); partials:
// [splits, M, K] scratch (unused when splits is 1).
extern "C" int fqss_qat_dense_dx(const float* gm, const float* wq, float* partials, float* dx, int64_t M, int64_t K,
                                 int64_t N, int splits, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  DenseArgs p{};
  p.a = gm, p.b = wq, p.I = M, p.J = K, p.R = N;
  p.r_chunk = cdiv(cdiv(N, splits), kBK) * kBK;
  p.out = splits > 1 ? partials : dx;
  const cudaError_t err = launch<true, false, kEpiSplit>(p, splits, st);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(colsum_splits(partials, splits, M * K, dx, st));
}

// dwq [N, K] = gm [M, N]^T @ x [M, K]; partials: [splits, N, K] scratch (unused when splits is 1).
extern "C" int fqss_qat_dense_dwq(const float* gm, const float* x, float* partials, float* dwq, int64_t M,
                                  int64_t K, int64_t N, int splits, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  DenseArgs p{};
  p.a = gm, p.b = x, p.I = N, p.J = K, p.R = M;
  p.r_chunk = cdiv(cdiv(M, splits), kBK) * kBK;
  p.out = splits > 1 ? partials : dwq;
  const cudaError_t err = launch<false, false, kEpiSplit>(p, splits, st);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(colsum_splits(partials, splits, N * K, dwq, st));
}

// K3 (qmatmul): y [B, N, T] = act_fq(weight_fq(w [N, K]) @ x[b]) for every x[b] [K, T] of x [B, K, T], the port's
// NCT layout of a bias-free 1x1 convolution; wq: [N, K] scratch for the weight grid (unused without one). A layer
// of at most 64 output channels takes 64-row tiles, so that no warp computes rows that do not exist.
extern "C" int fqss_qmatmul(const float* x, const float* w, const float* w_mn, const float* w_mx,
                            const unsigned char* w_obs, const float* a_mn, const float* a_mx,
                            const unsigned char* a_obs, float* wq, float* y, int64_t B, int64_t K, int64_t T,
                            int64_t N, int w_bits, int a_bits, void* stream) {
  return qmatmul_forward<false>(x, w, w_mn, w_mx, w_obs, a_mn, a_mx, a_obs, wq, y, B, K, T, N, w_bits, a_bits, stream);
}

// fqss_qmatmul's bf16 route: x and the weight (after its grid) rounded to bfloat16, the sums float32.
extern "C" int fqss_qmatmul_bf16(const float* x, const float* w, const float* w_mn, const float* w_mx,
                                 const unsigned char* w_obs, const float* a_mn, const float* a_mx,
                                 const unsigned char* a_obs, float* wq, float* y, int64_t B, int64_t K, int64_t T,
                                 int64_t N, int w_bits, int a_bits, void* stream) {
  return qmatmul_forward<true>(x, w, w_mn, w_mx, w_obs, a_mn, a_mx, a_obs, wq, y, B, K, T, N, w_bits, a_bits, stream);
}
