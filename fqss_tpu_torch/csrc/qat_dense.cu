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
//   qat_dense_kernel<kEpiStore>    replaces _qd_dx_kernel: dx = gm @ wq.
//   qat_dense_kernel<kEpiSplit>    replaces _qd_dwq_kernel: dwq = gm^T @ x, the sum
//   + colsum_kernel                over M split into fixed row ranges whose partial
//                                  products a fixed-order column sum adds.
// dwq then goes through the weight grid's straight-through backward, K2-bwd
// (fake_quant.cu:weight_bwd_kernel), as _qd_bwd does with _w_bwd_impl.
//   qat_dense_kernel<kEpiForward>  also replaces fqss_tpu/ops/pallas_quant.py:_qmm_kernel
//   without a bias (K3)            (qmatmul_pallas, forward only): y[b] = act_fq(weight_fq(w) @ x[b]),
//                                  w [N, K], x [B, K, T], y [B, N, T]: the port's NCT layout of a
//                                  bias-free 1x1 convolution, so the weight is the row operand (A, [I][R]),
//                                  x[b] the column operand stored [R][J], and blockIdx.z the batch row.
//                                  JAX's kernel takes x [M, K] @ w [K, N]: the same products, transposed.
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
// and 1024, i.e. 100+ operations per byte: far above the card's float32
// ratio (67 TFLOP/s over 3.35 TB/s = 20), so the float32 CUDA-core rate is
// the limit. So are K3's 1x1 convolutions: 2 N K T operations on 4 (K + N) T
// bytes a batch row, 25.6 per byte for DPTNet's 256 -> 64 and 64 for the
// Sepformer's 256 -> 256. Tensor cores are not used: TF32 would move values off the 8-bit
// grids, and these are float32 sums in the JAX package too.
//
// What the design does about it: a register-tiled GEMM on the CUDA cores.
// A block of 256 (or 128) threads owns a 128 x 128 (or 128 x 64, for N <= 64)
// output tile; each thread holds an 8 x 8 sub-tile in registers (two 4-wide
// halves in each direction, so that its shared-memory reads are conflict-free
// float4 broadcasts). Eight reduction steps of both operand tiles are staged
// in shared memory, reduction-major, while the next eight are loaded into
// registers. The weight grid is applied once a call, by a small kernel into
// an [N, K] scratch that the products then read (the weights are at most
// 262,144 values): applied to every weight tile as it is loaded, as the TPU
// kernel does, it re-quantizes the weights once per 128-row tile, an IEEE
// division per weight each time, which cost a Sepformer forward 48 ms of 299
// on an H100 (its folded forward, whose weights are on the grid already,
// took 251). The epilogue adds b and applies the act grid with K1's own
// device function (fake_quant.cuh), so a quantized output equals its own
// float pre-activation put through K1's grid bit for bit. Every sum is taken in a fixed order
// (each output in increasing k with fmaf; partial sums within a thread, then
// a fixed tree across the block, then a fixed-order column sum across
// blocks): a run repeats bit for bit, and the backward's recomputed
// pre-activation equals the forward's. No float atomics. wgmma, TMA and
// cp.async pipelines are later speed work.
//
// Numerics: explicit _rn intrinsics and fmaf keep nvcc from contracting or
// reordering; rintf rounds half to even. Do not build with --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fake_quant.cuh"

namespace {

constexpr int kBR = 8;  // reduction steps staged per shared-memory tile
constexpr int kGridThreads = 256;
constexpr int kTM = 8, kTN = 8;  // outputs per thread in each direction
constexpr int kBI = 128;  // output rows per block
constexpr int kBINarrow = 64;  // K3's row tile where the layer has at most 64 output channels

enum Epilogue { kEpiForward, kEpiMask, kEpiStore, kEpiSplit };

// C[i][j] = sum_r A(i, r) B(r, j) over r in [r_begin, r_end).
struct DenseArgs {
  const float* a;  // A stored [I][R] (A_RC) or [R][I]
  const float* b;  // B stored [J][R] (B_RC) or [R][J]
  int64_t I, J, R;
  int64_t r_chunk;  // kEpiSplit: the rows of R each blockIdx.z sums
  int64_t b_batch, out_batch;  // kEpiForward: B's and out's stride between the batch rows of blockIdx.z (K3)
  // kEpiForward / kEpiMask: the bias (kEpiForward: none when null) and the act grid, when a_mn is set and
  // *a_obs is 0
  const float* bias;
  const float* a_mn;
  const float* a_mx;
  const unsigned char* a_obs;
  int a_bits;
  float s;  // kEpiMask: the act ranges' scale_grad factor
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

// Element (o, r) of an operand stored [O][R] (R_CONTIG) or [R][O].
template <bool R_CONTIG>
__device__ __forceinline__ float element(const float* p, int64_t O, int64_t R, int64_t o, int64_t r) {
  return R_CONTIG ? p[o * R + r] : p[r * O + o];
}

template <int BI, int BJ>
struct Shape {
  static constexpr int kThreadsJ = BJ / kTN;
  static constexpr int kThreadsI = BI / kTM;
  static constexpr int kThreads = kThreadsI * kThreadsJ;
  static constexpr int kLoadA = BI * kBR / kThreads;
  static constexpr int kLoadB = BJ * kBR / kThreads;
};

// The block's share of an operand tile, o in [o0, o0 + BO), r in [r0, r0 + kBR): element e = tid + p * threads
// of the tile, ordered along the operand's contiguous axis so that neighbouring threads read neighbouring words.
template <bool R_CONTIG, int BO>
__device__ __forceinline__ void tile_index(int e, int& o, int& r) {
  if (R_CONTIG) {
    o = e / kBR;
    r = e % kBR;
  } else {
    o = e % BO;
    r = e / BO;
  }
}

template <int BI, int BJ, bool A_RC, bool B_RC>
__device__ __forceinline__ void load_tiles(const DenseArgs& p, const float* b, int64_t i0, int64_t j0, int64_t r0,
                                           int64_t r_end, float* ra, float* rb) {
  using S = Shape<BI, BJ>;
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 0; k < S::kLoadA; ++k) {
    int o, r;
    tile_index<A_RC, BI>(tid + k * S::kThreads, o, r);
    const int64_t gi = i0 + o, gr = r0 + r;
    ra[k] = (gi < p.I && gr < r_end) ? element<A_RC>(p.a, p.I, p.R, gi, gr) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < S::kLoadB; ++k) {
    int o, r;
    tile_index<B_RC, BJ>(tid + k * S::kThreads, o, r);
    const int64_t gj = j0 + o, gr = r0 + r;
    rb[k] = (gj < p.J && gr < r_end) ? element<B_RC>(b, p.J, p.R, gj, gr) : 0.0f;
  }
}

template <int BI, int BJ, bool A_RC, bool B_RC>
__device__ __forceinline__ void store_tiles(float (*As)[BI + 4], float (*Bs)[BJ + 4], const float* ra,
                                            const float* rb) {
  using S = Shape<BI, BJ>;
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 0; k < S::kLoadA; ++k) {
    int o, r;
    tile_index<A_RC, BI>(tid + k * S::kThreads, o, r);
    As[r][o] = ra[k];
  }
#pragma unroll
  for (int k = 0; k < S::kLoadB; ++k) {
    int o, r;
    tile_index<B_RC, BJ>(tid + k * S::kThreads, o, r);
    Bs[r][o] = rb[k];
  }
}

// Row (or column) of a thread's k-th output in its tile: two 4-wide halves, tile/2 apart.
template <int B>
__device__ __forceinline__ int sub(int t, int k) {
  return (k < 4 ? 0 : B / 2) + t * 4 + (k & 3);
}

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

// At most 128 registers a thread, so that two blocks of 256 threads (four of 128) share an SM: 16-23% faster
// at the Sepformer's and DPTNet's shapes than leaving the compiler 155-195, though ptxas then spills 32-456
// bytes a thread (the most in the 64-column and 64-row tiles).
template <int BI, int BJ, bool A_RC, bool B_RC, int EPI>
__global__ void __launch_bounds__(Shape<BI, BJ>::kThreads, 512 / Shape<BI, BJ>::kThreads)
    qat_dense_kernel(DenseArgs p) {
  using S = Shape<BI, BJ>;
  __shared__ __align__(16) float As[kBR][BI + 4];
  __shared__ __align__(16) float Bs[kBR][BJ + 4];

  const int tid = threadIdx.x;
  const int tj = tid % S::kThreadsJ, ti = tid / S::kThreadsJ;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * BI;
  const int64_t j0 = static_cast<int64_t>(blockIdx.y) * BJ;
  // kEpiForward: blockIdx.z is a batch row of B and out (K3; K5 has one)
  const int64_t z = EPI == kEpiForward ? static_cast<int64_t>(blockIdx.z) : 0;
  const float* bz = p.b + z * p.b_batch;
  int64_t r_begin = 0, r_end = p.R;
  if (EPI == kEpiSplit) {
    r_begin = static_cast<int64_t>(blockIdx.z) * p.r_chunk;
    r_end = r_begin + p.r_chunk < p.R ? r_begin + p.r_chunk : p.R;
  }
  const bool a_on = (EPI == kEpiForward || EPI == kEpiMask) && grid_on(p.a_mn, p.a_obs);

  float acc[kTM][kTN];
#pragma unroll
  for (int ii = 0; ii < kTM; ++ii)
#pragma unroll
    for (int jj = 0; jj < kTN; ++jj) acc[ii][jj] = 0.0f;

  // The mask kernel needs the product only where the act grid applies.
  if (EPI != kEpiMask || a_on) {
    float ra[S::kLoadA], rb[S::kLoadB];
    load_tiles<BI, BJ, A_RC, B_RC>(p, bz, i0, j0, r_begin, r_end, ra, rb);
    for (int64_t r0 = r_begin; r0 < r_end; r0 += kBR) {
      store_tiles<BI, BJ, A_RC, B_RC>(As, Bs, ra, rb);
      __syncthreads();
      if (r0 + kBR < r_end) load_tiles<BI, BJ, A_RC, B_RC>(p, bz, i0, j0, r0 + kBR, r_end, ra, rb);
#pragma unroll
      for (int rr = 0; rr < kBR; ++rr) {
        float a[kTM], b[kTN];
        *reinterpret_cast<float4*>(&a[0]) = *reinterpret_cast<const float4*>(&As[rr][ti * 4]);
        *reinterpret_cast<float4*>(&a[4]) = *reinterpret_cast<const float4*>(&As[rr][BI / 2 + ti * 4]);
        *reinterpret_cast<float4*>(&b[0]) = *reinterpret_cast<const float4*>(&Bs[rr][tj * 4]);
        *reinterpret_cast<float4*>(&b[4]) = *reinterpret_cast<const float4*>(&Bs[rr][BJ / 2 + tj * 4]);
#pragma unroll
        for (int ii = 0; ii < kTM; ++ii)
#pragma unroll
          for (int jj = 0; jj < kTN; ++jj) acc[ii][jj] = fmaf(a[ii], b[jj], acc[ii][jj]);
      }
      __syncthreads();
    }
  }

  if (EPI == kEpiStore || EPI == kEpiSplit) {
    float* out = p.out + (EPI == kEpiSplit ? static_cast<int64_t>(blockIdx.z) * p.I * p.J : 0);
#pragma unroll
    for (int ii = 0; ii < kTM; ++ii) {
      const int64_t i = i0 + sub<BI>(ti, ii);
#pragma unroll
      for (int jj = 0; jj < kTN; ++jj) {
        const int64_t j = j0 + sub<BJ>(tj, jj);
        if (i < p.I && j < p.J) out[i * p.J + j] = acc[ii][jj];
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

  if (EPI == kEpiForward) {
    float* out = p.out + z * p.out_batch;
#pragma unroll
    for (int ii = 0; ii < kTM; ++ii) {
      const int64_t i = i0 + sub<BI>(ti, ii);
#pragma unroll
      for (int jj = 0; jj < kTN; ++jj) {
        const int64_t j = j0 + sub<BJ>(tj, jj);
        if (i < p.I && j < p.J) {
          float v = p.bias != nullptr ? __fadd_rn(acc[ii][jj], __ldg(p.bias + j)) : acc[ii][jj];
          if (a_on) v = fqss::act_grid_value(v, a_mn, a_delta, aq);
          out[i * p.J + j] = v;
        }
      }
    }
    return;
  }

  // kEpiMask: gm, the act ranges' partial sums (fixed order: ii, then jj), and db's column partials.
  float p_mn = 0.0f, p_mx = 0.0f;
  float col[kTN];
#pragma unroll
  for (int jj = 0; jj < kTN; ++jj) col[jj] = 0.0f;
#pragma unroll
  for (int ii = 0; ii < kTM; ++ii) {
    const int64_t i = i0 + sub<BI>(ti, ii);
#pragma unroll
    for (int jj = 0; jj < kTN; ++jj) {
      const int64_t j = j0 + sub<BJ>(tj, jj);
      if (i < p.I && j < p.J) {
        const float gi = p.g[i * p.J + j];
        float gm = gi;
        if (a_on) {
          const float pre = __fadd_rn(acc[ii][jj], __ldg(p.bias + j));
          const float u = __fdiv_rn(__fsub_rn(pre, a_mn), a_delta);
          const float X = rintf(u);
          const float m = tie_mask(X, 0.0f, aq);
          const float t = __fdiv_rn(__fsub_rn(fqss::clip(X, 0.0f, aq), __fmul_rn(m, u)), aq);
          gm = __fmul_rn(gi, m);
          p_mn = __fadd_rn(p_mn, __fmul_rn(gi, __fsub_rn(__fsub_rn(1.0f, m), __fmul_rn(p.s, t))));
          p_mx = __fadd_rn(p_mx, __fmul_rn(__fmul_rn(gi, p.s), t));
        }
        p.out[i * p.J + j] = gm;
        col[jj] = __fadd_rn(col[jj], gm);
      }
    }
  }
  block_sum2<S::kThreads>(p_mn, p_mx);
  if (tid == 0) {
    const int64_t tile = static_cast<int64_t>(blockIdx.x) * gridDim.y + blockIdx.y;
    p.act_partials[2 * tile] = p_mn;
    p.act_partials[2 * tile + 1] = p_mx;
  }
  __shared__ float cs[S::kThreadsI][BJ];
#pragma unroll
  for (int jj = 0; jj < kTN; ++jj) cs[ti][sub<BJ>(tj, jj)] = col[jj];
  __syncthreads();
  if (tid < BJ && j0 + tid < p.J) {
    float s = cs[0][tid];
    for (int t = 1; t < S::kThreadsI; ++t) s = __fadd_rn(s, cs[t][tid]);
    p.db_partials[static_cast<int64_t>(blockIdx.x) * p.J + j0 + tid] = s;
  }
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

int col_tile(int64_t J) { return J <= 64 ? 64 : 128; }

// One launch over I x J output tiles of BI rows and col_tile(J) columns, and z along blockIdx.z (K5's dwq: the
// row ranges of R; K3: the batch rows).
template <int BI, bool A_RC, bool B_RC, int EPI>
cudaError_t launch_rows(const DenseArgs& p, int64_t z, cudaStream_t stream) {
  const int64_t bj = col_tile(p.J), tiles_j = cdiv(p.J, bj);
  if (tiles_j > 65535 || z > 65535) return cudaErrorInvalidConfiguration;  // the grid's y and z limits
  const dim3 grid(static_cast<unsigned int>(cdiv(p.I, BI)), static_cast<unsigned int>(tiles_j),
                  static_cast<unsigned int>(z));
  if (bj == 64) {
    qat_dense_kernel<BI, 64, A_RC, B_RC, EPI><<<grid, Shape<BI, 64>::kThreads, 0, stream>>>(p);
  } else {
    qat_dense_kernel<BI, 128, A_RC, B_RC, EPI><<<grid, Shape<BI, 128>::kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

template <bool A_RC, bool B_RC, int EPI>
cudaError_t launch(const DenseArgs& p, int splits, cudaStream_t stream) {
  return launch_rows<kBI, A_RC, B_RC, EPI>(p, splits, stream);
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

cudaError_t colsum(const float* p, int64_t rows, int64_t cols, float* out, cudaStream_t stream) {
  colsum_kernel<<<static_cast<unsigned int>(cdiv(cols, 32)), dim3(32, 8), 0, stream>>>(p, rows, cols, out);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes. Each function launches on the given stream, does not synchronise, and
// returns cudaGetLastError() (0 = success). A null w_mn (a_mn) switches the weight (act) grid off; a null
// w_obs (a_obs) means the grid's quantizer has no observer. The flags are one byte (torch.bool) on the device.

// tiles[0], tiles[1]: the row and column tiles of a [rows, cols] output (the mask kernel's partial sums).
extern "C" void fqss_qat_dense_tiles(int64_t rows, int64_t cols, int64_t* tiles) {
  tiles[0] = cdiv(rows, kBI);
  tiles[1] = cdiv(cols, col_tile(cols));
}

// The number of row ranges the dwq product splits M into: enough blocks for the card's 132 SMs twice over, and
// at least 512 rows each. It depends on the shapes only, so the sums' order does too.
extern "C" int fqss_qat_dense_dwq_splits(int64_t M, int64_t K, int64_t N) {
  const int64_t tiles = cdiv(N, kBI) * cdiv(K, col_tile(K));
  int64_t splits = cdiv(264, tiles);
  const int64_t most = cdiv(M, 512);
  if (splits > most) splits = most;
  return static_cast<int>(splits < 1 ? 1 : splits);
}

// y [M, N] = act_fq(x [M, K] @ weight_fq(w [N, K])^T + b [N]); wq: [N, K] scratch for the weight grid (unused
// without one).
extern "C" int fqss_qat_dense(const float* x, const float* w, const float* b, const float* w_mn, const float* w_mx,
                              const unsigned char* w_obs, const float* a_mn, const float* a_mx,
                              const unsigned char* a_obs, float* wq, float* y, int64_t M, int64_t K, int64_t N,
                              int w_bits, int a_bits, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  DenseArgs p{};
  p.a = x, p.b = grid_weights(w, w_mn, w_mx, w_obs, wq, N, K, w_bits, st, &err), p.I = M, p.J = N, p.R = K;
  if (err != cudaSuccess) return static_cast<int>(err);
  p.bias = b, p.a_mn = a_mn, p.a_mx = a_mx, p.a_obs = a_obs, p.a_bits = a_bits;
  p.out = y;
  return static_cast<int>(launch<true, true, kEpiForward>(p, 1, st));
}

// The mask pass of the backward: gm [M, N]; sums[0..1] = (dmn, dmx) of the act ranges; db [N]; wq [N, K], the
// weights on their grid, for the dx pass (unused without a weight grid). act_partials [tiles[0] * tiles[1], 2]
// and db_partials [tiles[0], N] are scratch (fqss_qat_dense_tiles(M, N)).
extern "C" int fqss_qat_dense_bwd_mask(const float* x, const float* w, const float* b, const float* g,
                                       const float* w_mn, const float* w_mx, const unsigned char* w_obs,
                                       const float* a_mn, const float* a_mx, const unsigned char* a_obs, float s,
                                       float* wq, float* gm, float* act_partials, float* db_partials, float* sums,
                                       float* db, int64_t M, int64_t K, int64_t N, int w_bits, int a_bits,
                                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  DenseArgs p{};
  p.a = x, p.b = grid_weights(w, w_mn, w_mx, w_obs, wq, N, K, w_bits, st, &err), p.I = M, p.J = N, p.R = K;
  if (err != cudaSuccess) return static_cast<int>(err);
  p.bias = b, p.a_mn = a_mn, p.a_mx = a_mx, p.a_obs = a_obs, p.a_bits = a_bits, p.s = s;
  p.g = g, p.out = gm, p.act_partials = act_partials, p.db_partials = db_partials;
  err = launch<true, true, kEpiMask>(p, 1, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t row_tiles = cdiv(M, kBI), col_tiles = cdiv(N, col_tile(N));
  err = colsum(act_partials, row_tiles * col_tiles, 2, sums, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(colsum(db_partials, row_tiles, N, db, st));
}

// dx [M, K] = gm [M, N] @ wq [N, K] (the weights as the mask pass left them: on their grid, or w).
extern "C" int fqss_qat_dense_dx(const float* gm, const float* wq, float* dx, int64_t M, int64_t K, int64_t N,
                                 void* stream) {
  DenseArgs p{};
  p.a = gm, p.b = wq, p.I = M, p.J = K, p.R = N;
  p.out = dx;
  return static_cast<int>(launch<true, false, kEpiStore>(p, 1, static_cast<cudaStream_t>(stream)));
}

// dwq [N, K] = gm [M, N]^T @ x [M, K]; partials: [splits, N, K] scratch (unused when splits is 1).
extern "C" int fqss_qat_dense_dwq(const float* gm, const float* x, float* partials, float* dwq, int64_t M,
                                  int64_t K, int64_t N, int splits, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  DenseArgs p{};
  p.a = gm, p.b = x, p.I = N, p.J = K, p.R = M;
  p.r_chunk = cdiv(cdiv(M, splits), kBR) * kBR;
  p.out = splits > 1 ? partials : dwq;
  const cudaError_t err = launch<false, false, kEpiSplit>(p, splits, st);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(colsum(partials, splits, N * K, dwq, st));
}

// K3 (qmatmul): y [B, N, T] = act_fq(weight_fq(w [N, K]) @ x[b]) for every x[b] [K, T] of x [B, K, T], the port's
// NCT layout of a bias-free 1x1 convolution; wq: [N, K] scratch for the weight grid (unused without one). A layer
// of at most 64 output channels takes 64-row tiles, so that no thread computes rows that do not exist.
extern "C" int fqss_qmatmul(const float* x, const float* w, const float* w_mn, const float* w_mx,
                            const unsigned char* w_obs, const float* a_mn, const float* a_mx,
                            const unsigned char* a_obs, float* wq, float* y, int64_t B, int64_t K, int64_t T,
                            int64_t N, int w_bits, int a_bits, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  DenseArgs p{};
  p.a = grid_weights(w, w_mn, w_mx, w_obs, wq, N, K, w_bits, st, &err), p.b = x, p.I = N, p.J = T, p.R = K;
  if (err != cudaSuccess) return static_cast<int>(err);
  p.b_batch = K * T, p.out_batch = N * T;
  p.a_mn = a_mn, p.a_mx = a_mx, p.a_obs = a_obs, p.a_bits = a_bits;
  p.out = y;
  return static_cast<int>(N <= kBINarrow ? launch_rows<kBINarrow, true, false, kEpiForward>(p, B, st)
                                         : launch_rows<kBI, true, false, kEpiForward>(p, B, st));
}
