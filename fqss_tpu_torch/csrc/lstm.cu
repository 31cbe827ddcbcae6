// LSTM recurrence for NVIDIA Hopper (sm_90a): one direction (K6) or both
// directions of a bidirectional LSTM in one launch (K7).
//
//   lstm_cluster_kernel   replace fqss_tpu/ops/pallas_lstm.py:_lstm_kernel
//   lstm_blocks_kernel    (lstm_sequence) and _bilstm_kernel
//                         (bilstm_sequence). For each direction d, batch row
//                         b and step t of the direction's own scan order
//                         (the caller flips the reverse direction's input
//                         and output, as the JAX functions' caller does):
//                           gates = ih_d[t, b] + h @ W_d      ([4H] = [H] x [H, 4H])
//                           i, f, g, o = the four H-wide slices of gates (torch's order)
//                           c = sigmoid(f) * c + sigmoid(i) * tanh(g)
//                           h = sigmoid(o) * tanh(c)
//                           out_d[t, b] = h
//                         with h = c = 0 before the first step.
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
// blocks split the (direction, batch tile) pairs, so that h and c stay on the
// SMs from step to step.
//
// What the design does about it (lstm_cluster_kernel, H up to 322): a
// thread-block cluster of c CTAs owns a tile of batch rows of one direction
// for the whole sequence. CTA r owns the hidden units [r U, (r + 1) U), U =
// ceil(H / c), and the four gate columns of each, so its slice of W_hh (H x
// 4U floats: 128 KB at H = 128, c = 2) is loaded into shared memory once a
// launch and read from there at every step; the earlier design streamed all of
// W_hh (256 KB) from L2 in every block at every step. h of the tile is
// double-buffered in every CTA: at step t each CTA reads the full h of step t
// from its own buffer t & 1 and writes its slice of the new h into buffer
// (t + 1) & 1 of every CTA of the cluster through distributed shared memory.
// The rows of the tile are split among the CTA's 8 warps, and warp w of every
// CTA exchanges only its own rows, so the warps synchronise only with their
// namesakes in the other CTAs: each thread arrives (release, cluster scope) on
// the mbarrier of its buffer and row group in every CTA, and warp w waits
// (acquire) on its own for c x 32 arrivals before it reads the buffer. No
// barrier holds a whole CTA, so one warp's gates and exchange overlap another's
// product. With two buffers one mbarrier a buffer suffices: a warp that has
// seen its peers' step t - 1 arrivals knows they are done reading the buffer it
// writes at step t. Each of a CTA's 256 threads owns one
// pair of units (p and p + 32) and kRpt rows of the tile (8 row groups, one a
// warp, of 32 unit lanes), so the gate nonlinearities need no exchange and c
// stays in the thread's registers. A warp reads one row of h at a time (a
// broadcast) and 32 units' four gates of W as float4s (conflict-free). The ih
// loads of step t + 1 are issued as soon as step t's gates are done, and fly
// during the wait and the product of step t + 1 (a whole step earlier would
// take 64 more registers a thread).
// The row tile (8 to 64 rows) and c come from the wrapper
// (fqss_tpu_torch/ops/lstm.py:plan): c is the least that holds the W slice,
// and the tile the least whose clusters all fit co-resident
// (cudaOccupancyMaxActiveClusters, fqss_lstm_cluster_max_active), so no
// cluster waits for a second wave. At DPTNet's shapes (H 128, B' 2064 and
// 2000) that is c = 2 and 64 rows: 66 and 64 clusters, one CTA on each SM.
// CTAs end on a cluster barrier, so no CTA exits while a peer may still write
// into its shared memory.
//
// lstm_blocks_kernel, the second route by shape, takes H above what a cluster
// of 8 holds (up to fqss_lstm_max_hidden() = 1210): a block owns 16 batch rows
// of one direction, h double-buffered and c in shared memory, each of 256
// threads one hidden unit of 8 rows (several passes for H > 128), W_hh read
// from L2 through the read-only path at every step.
//
// Numerics (both kernels): the product sums k = 0 .. H-1 in order with fused
// multiply-adds from 0 and adds ih afterwards, as ih_t + h @ w_hh groups it;
// the gates use expf/tanhf (no fast math) and round-to-nearest intrinsics, so
// that nvcc contracts nothing into an FMA there. The two kernels therefore
// compute the same values bit for bit. cuBLAS sums the plain version's
// product in another order, and PyTorch's transcendentals may differ by an
// ulp, so kernel and plain version agree to a tolerance, not bit for bit. Do
// not build with --use_fast_math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSmemBytes = 232448;  // the most dynamic shared memory a block may have on sm_90

struct Direction {
  const float* ih;  // [T, B, 4H]
  const float* w;   // [H, 4H]
  float* out;       // [T, B, H]
};

__device__ __forceinline__ float sigmoid_rn(float x) { return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x))); }

// ---------------------------------------------------------------------------------------------------------------
// The cluster route.

constexpr int kCThreads = 256;
constexpr int kCLanes = 32;                   // unit lanes of a row group (a warp): each owns units p and p + 32
constexpr int kCUnits = 2 * kCLanes;          // the most hidden units a CTA owns
constexpr int kCGroups = kCThreads / kCLanes; // row groups of a CTA, one a warp
constexpr int kMaxCluster = 8;                // the portable cluster size

// Shared memory of one CTA: its W slice [H][U] float4, h of the tile in two buffers [2][rows][H], and an mbarrier
// for each buffer and row group [2][kCGroups].
size_t cluster_smem(int64_t H, int c, int rows) {
  const int64_t U = (H + c - 1) / c;
  return sizeof(float) * static_cast<size_t>(4 * H * U + 2 * rows * H) + sizeof(uint64_t) * 2 * kCGroups;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Arrive (release, cluster scope) on the mbarrier at shared address `bar` of cluster rank `rank`.
__device__ __forceinline__ void arrive_remote(uint32_t bar, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(bar), "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
}

// Wait (acquire, cluster scope) until the phase of parity `parity` of the local mbarrier `bar` has completed.
__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// kRpt: rows of a thread (the tile has kCGroups * kRpt rows); kVec: H is a multiple of 4, so every row of h in
// shared memory is 16-byte aligned. A thread sums 2 units x 4 gates x kRpt rows: each k it reads 8 values of W and
// kRpt of h from shared memory for 8 kRpt FMAs (at kRpt = 8, one float read a 4 FMAs, the SM's ratio of shared
// memory bandwidth, 32 floats a clock, to its 128 FMA lanes).
template <int kRpt, bool kVec>
__global__ void __launch_bounds__(kCThreads, 1)
    lstm_cluster_kernel(Direction d0, Direction d1, int64_t T, int64_t B, int H, int U) {
  constexpr int kRows = kCGroups * kRpt;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  float4* w_s = reinterpret_cast<float4*>(smem);  // [H][U]: (W[k][j], W[k][H + j], W[k][2H + j], W[k][3H + j])
  float* h_buf = smem + 4 * H * U;                 // [2][kRows][H]
  uint64_t* full = reinterpret_cast<uint64_t*>(h_buf + 2 * kRows * H);  // [2][kCGroups]
  const Direction d = blockIdx.y == 0 ? d0 : d1;
  const int64_t G = 4 * static_cast<int64_t>(H);
  const int p = threadIdx.x % kCLanes;
  const int grp = threadIdx.x / kCLanes;
  int j[2], uc[2];
  bool live[2];  // the thread owns hidden unit j[q]
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int u = p + q * kCLanes;
    j[q] = rank * U + u;
    live[q] = u < U && j[q] < H;
    uc[q] = u < U ? u : U - 1;  // the W column a dead unit reads (its sums are discarded)
  }
  const int64_t row0 = static_cast<int64_t>(blockIdx.x / c) * kRows + grp * kRpt;

  for (int i = threadIdx.x; i < H * U; i += kCThreads) {
    const int k = i / U;
    const int jj = rank * U + i % U;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (jj < H) {
      const float* wk = d.w + k * G + jj;
      v = make_float4(__ldg(wk), __ldg(wk + H), __ldg(wk + 2 * H), __ldg(wk + 3 * H));
    }
    w_s[i] = v;
  }
  for (int i = threadIdx.x; i < kRows * H; i += kCThreads) h_buf[i] = 0.0f;
  // full[b][w] completes a phase when warp w of every CTA has written its rows of buffer b and arrived: c x 32
  // arrivals.
  if (threadIdx.x < 2 * kCGroups) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(full + threadIdx.x)), "r"(c * kCLanes));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  float pre[kRpt][2][4];
  float c_reg[kRpt][2];
#pragma unroll
  for (int r = 0; r < kRpt; ++r)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      c_reg[r][q] = 0.0f;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        pre[r][q][g] = live[q] && row0 + r < B ? __ldg(d.ih + (row0 + r) * G + g * H + j[q]) : 0.0f;
    }
  // Every CTA's W slice, zeroed buffer 0 and mbarriers are in place, and its shared memory is live, before a peer
  // reads, writes or arrives there.
  cluster.sync();

  for (int64_t t = 0; t < T; ++t) {
    // h of step t for this warp's rows: buffer t & 1, filled at step t - 1 (its ((t - 1) >> 1)-th fill)
    if (t > 0) wait_parity(smem_addr(full + (t & 1) * kCGroups + grp), static_cast<uint32_t>(((t - 1) >> 1) & 1));
    const float* h_old = h_buf + (t & 1) * kRows * H + grp * kRpt * H;
    float* h_new = h_buf + ((t + 1) & 1) * kRows * H + grp * kRpt * H;
    float acc[kRpt][2][4];
#pragma unroll
    for (int r = 0; r < kRpt; ++r)
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][q][g] = 0.0f;
    if (kVec) {
#pragma unroll 2
      for (int k = 0; k < H; k += 4) {
        float4 wk[4][2];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int q = 0; q < 2; ++q) wk[kk][q] = w_s[(k + kk) * U + uc[q]];
#pragma unroll
        for (int r = 0; r < kRpt; ++r) {
          const float4 hv = *reinterpret_cast<const float4*>(h_old + r * H + k);
          const float hk[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              acc[r][q][0] = fmaf(hk[kk], wk[kk][q].x, acc[r][q][0]);
              acc[r][q][1] = fmaf(hk[kk], wk[kk][q].y, acc[r][q][1]);
              acc[r][q][2] = fmaf(hk[kk], wk[kk][q].z, acc[r][q][2]);
              acc[r][q][3] = fmaf(hk[kk], wk[kk][q].w, acc[r][q][3]);
            }
        }
      }
    } else {
      for (int k = 0; k < H; ++k) {
        float4 wk[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) wk[q] = w_s[k * U + uc[q]];
#pragma unroll
        for (int r = 0; r < kRpt; ++r) {
          const float hv = h_old[r * H + k];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            acc[r][q][0] = fmaf(hv, wk[q].x, acc[r][q][0]);
            acc[r][q][1] = fmaf(hv, wk[q].y, acc[r][q][1]);
            acc[r][q][2] = fmaf(hv, wk[q].z, acc[r][q][2]);
            acc[r][q][3] = fmaf(hv, wk[q].w, acc[r][q][3]);
          }
        }
      }
    }
    float* out_t = d.out + t * B * H;
    // The new h goes to every CTA: at 32 and 64 rows as float4 copies of the warp's rows once they are all in place
    // here (7% faster at DPTNet's shapes), at fewer rows cell by cell (3% faster at 8 rows).
    const bool copy4 = kVec && kRpt >= 4 && U % 4 == 0 && (rank + 1) * U <= H;
#pragma unroll
    for (int r = 0; r < kRpt; ++r)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float i_g = sigmoid_rn(__fadd_rn(pre[r][q][0], acc[r][q][0]));
        const float f_g = sigmoid_rn(__fadd_rn(pre[r][q][1], acc[r][q][1]));
        const float g_g = tanhf(__fadd_rn(pre[r][q][2], acc[r][q][2]));
        const float o_g = sigmoid_rn(__fadd_rn(pre[r][q][3], acc[r][q][3]));
        c_reg[r][q] = __fadd_rn(__fmul_rn(f_g, c_reg[r][q]), __fmul_rn(i_g, g_g));
        const float h = __fmul_rn(o_g, tanhf(c_reg[r][q]));
        if (live[q]) {
          if (copy4) {
            h_new[r * H + j[q]] = h;
          } else {
            for (int rk = 0; rk < c; ++rk) cluster.map_shared_rank(h_new, rk)[r * H + j[q]] = h;
          }
          if (row0 + r < B) out_t[(row0 + r) * H + j[q]] = h;
        }
      }
    if (copy4) {
      __syncwarp();
      for (int rk = 0; rk < c; ++rk) {
        if (rk == rank) continue;
        float* peer = cluster.map_shared_rank(h_new, rk);
        for (int i = p; i < kRpt * U / 4; i += kCLanes) {
          const int r = i / (U / 4);
          const int jj = rank * U + (i % (U / 4)) * 4;
          *reinterpret_cast<float4*>(peer + r * H + jj) = *reinterpret_cast<const float4*>(h_new + r * H + jj);
        }
      }
    }
    {
      const uint32_t bar = smem_addr(full + ((t + 1) & 1) * kCGroups + grp);
      for (int rk = 0; rk < c; ++rk) arrive_remote(bar, rk);
    }
    if (t + 1 < T) {
      const float* ih_n = d.ih + (t + 1) * B * G;
#pragma unroll
      for (int r = 0; r < kRpt; ++r)
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int g = 0; g < 4; ++g)
            pre[r][q][g] = live[q] && row0 + r < B ? __ldg(ih_n + (row0 + r) * G + g * H + j[q]) : 0.0f;
    }
  }
  // No CTA exits while a peer may still write into its shared memory or arrive on its barriers.
  cluster.sync();
}

// Launches the cluster kernel, or with max_active set only asks how many of its clusters fit co-resident.
template <int kRpt, bool kVec>
int cluster_launch(Direction d0, Direction d1, int dirs, int64_t T, int64_t B, int64_t H, int c, cudaStream_t stream,
                   int* max_active) {
  constexpr int kRows = kCGroups * kRpt;
  auto kernel = lstm_cluster_kernel<kRpt, kVec>;
  const size_t smem = cluster_smem(H, c, kRows);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = max_active != nullptr ? 1 : (B + kRows - 1) / kRows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(c * tiles), static_cast<unsigned int>(max_active != nullptr ? 1 : dirs));
  cfg.blockDim = dim3(kCThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(c);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_active != nullptr) return static_cast<int>(cudaOccupancyMaxActiveClusters(max_active, kernel, &cfg));
  const int U = static_cast<int>((H + c - 1) / c);
  err = cudaLaunchKernelEx(&cfg, kernel, d0, d1, T, B, static_cast<int>(H), U);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec>
int cluster_dispatch(Direction d0, Direction d1, int dirs, int64_t T, int64_t B, int64_t H, int c, int rows,
                     cudaStream_t stream, int* max_active) {
  switch (rows) {
    case kCGroups * 1: return cluster_launch<1, kVec>(d0, d1, dirs, T, B, H, c, stream, max_active);
    case kCGroups * 2: return cluster_launch<2, kVec>(d0, d1, dirs, T, B, H, c, stream, max_active);
    case kCGroups * 4: return cluster_launch<4, kVec>(d0, d1, dirs, T, B, H, c, stream, max_active);
    case kCGroups * 8: return cluster_launch<8, kVec>(d0, d1, dirs, T, B, H, c, stream, max_active);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int cluster_checked(Direction d0, Direction d1, int dirs, int64_t T, int64_t B, int64_t H, int c, int rows,
                    cudaStream_t stream, int* max_active) {
  if (c < 1 || c > kMaxCluster || H < 1 || (H + c - 1) / c > kCUnits || cluster_smem(H, c, rows) > kSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  return H % 4 == 0 ? cluster_dispatch<true>(d0, d1, dirs, T, B, H, c, rows, stream, max_active)
                    : cluster_dispatch<false>(d0, d1, dirs, T, B, H, c, rows, stream, max_active);
}

// ---------------------------------------------------------------------------------------------------------------
// The blocks route, for H above what a cluster holds.

constexpr int kLanes = 128;             // hidden units one pass of a block covers
constexpr int kGroups = 2;              // row groups of a block
constexpr int kThreads = kLanes * kGroups;
constexpr int kRows = 8;                // batch rows of a thread
constexpr int kTile = kGroups * kRows;  // batch rows of a block

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    lstm_blocks_kernel(Direction d0, Direction d1, int64_t T, int64_t B, int H) {
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
        // not unrolled: two iterations' W values spilled past the 128 registers that two blocks an SM leave
#pragma unroll 1
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
int blocks_launch(Direction d0, Direction d1, int dirs, int64_t T, int64_t B, int64_t H, cudaStream_t stream) {
  const size_t smem = 3 * kTile * static_cast<size_t>(H) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(lstm_blocks_kernel<kVec>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned int>((B + kTile - 1) / kTile), static_cast<unsigned int>(dirs));
  lstm_blocks_kernel<kVec><<<grid, kThreads, smem, stream>>>(d0, d1, T, B, static_cast<int>(H));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Largest H the blocks route takes: h (two buffers) and c of a block's 16 rows in 227 KB of shared memory.
extern "C" int fqss_lstm_max_hidden() { return static_cast<int>(kSmemBytes / (3 * kTile * sizeof(float))); }

// The blocks route. dirs = 1: ih0, w0 -> out0 (K6); dirs = 2: also ih1, w1 -> out1 in the same launch (K7).
// ih: [T, B, 4H], w: [H, 4H], out: [T, B, H], float32, contiguous, on the current device;
// T, B >= 1 and 1 <= H <= fqss_lstm_max_hidden(). Returns the launch's CUDA error code.
extern "C" int fqss_lstm_recurrence(const float* ih0, const float* w0, float* out0, const float* ih1, const float* w1,
                                    float* out1, int dirs, int64_t T, int64_t B, int64_t H, void* stream) {
  const Direction d0{ih0, w0, out0};
  const Direction d1{ih1, w1, out1};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return H % 4 == 0 ? blocks_launch<true>(d0, d1, dirs, T, B, H, st) : blocks_launch<false>(d0, d1, dirs, T, B, H, st);
}

// The cluster route, with the operands of fqss_lstm_recurrence: clusters of `cluster` CTAs (1 to 8, with
// ceil(H / cluster) <= 64), each owning `rows` batch rows (8, 16, 32 or 64) of one direction, and
// ceil(B / rows) x dirs clusters. Returns the launch's CUDA error code (cudaErrorInvalidValue for a cluster size or
// tile the kernel does not take, or whose shared memory exceeds 227 KB).
extern "C" int fqss_lstm_cluster(const float* ih0, const float* w0, float* out0, const float* ih1, const float* w1,
                                 float* out1, int dirs, int64_t T, int64_t B, int64_t H, int cluster, int rows,
                                 void* stream) {
  const Direction d0{ih0, w0, out0};
  const Direction d1{ih1, w1, out1};
  return cluster_checked(d0, d1, dirs, T, B, H, cluster, rows, static_cast<cudaStream_t>(stream), nullptr);
}

// How many clusters of the cluster route at (H, cluster, rows) fit co-resident on the current device
// (cudaOccupancyMaxActiveClusters), into *out. Returns the CUDA error code.
extern "C" int fqss_lstm_cluster_max_active(int64_t H, int cluster, int rows, int* out) {
  *out = 0;
  const Direction none{nullptr, nullptr, nullptr};
  return cluster_checked(none, none, 1, 1, 1, H, cluster, rows, nullptr, out);
}
