// The LSTM recurrence kernels of csrc/lstm.cu (K7/K6) and csrc/lstm_static.cu (their static route) as templates:
// lstm_cluster_kernel and lstm_blocks_kernel with the mode (kFused, kObserve, kStatic) a template parameter, their
// launchers and the Direction operands. Each source instantiates the modes it exports, so that nvcc compiles the
// two sources in parallel. The design and the numerics are set out in csrc/lstm.cu.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fake_quant.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kSmemBytes = 232448;  // the most dynamic shared memory a block may have on sm_90

struct Direction {
  const float* ih;                  // [T, B, 4H]
  const float* w;                   // [H, 4H]
  float* out;                       // [T, B, H]
  const float* h0 = nullptr;        // [B, H] state before the first step, zero if null
  const float* c0 = nullptr;        // [B, H]
  float* c_last = nullptr;          // [B, H] c after the last step, if not null
  const float* site_min = nullptr;  // [12] the static cell's ranges (kStatic)
  const float* site_max = nullptr;  // [12]
  float* stats = nullptr;           // kObserve: [T][partials][12][2] each warp's min and max of each site
};

enum Mode { kFused = 0, kObserve = 1, kStatic = 2 };

// Whether a mode's launch takes h0/c0 and writes c_last: the static route's two launches carry the state across the
// window; the fused route starts from zero and keeps none (its code, and its registers, as before the route).
template <int kMode>
constexpr bool kCarriesState = kMode != kFused;
constexpr int kSites = 12;  // _SITES: ih hh add0 sig0 sig1 tanh0 sig2 mul0 mul1 add1 tanh1 mul2
enum Site { kIh, kHh, kAdd0, kSig0, kSig1, kTanh0, kSig2, kMul0, kMul1, kAdd1, kTanh1, kMul2 };

__device__ __forceinline__ float sigmoid_rn(float x) { return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x))); }

// A thread's running min and max of each site over the values it owns in one step (kObserve).
struct SiteStats {
  float mn[kSites], mx[kSites];
  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int s = 0; s < kSites; ++s) {
      mn[s] = INFINITY;
      mx[s] = -INFINITY;
    }
  }
  __device__ __forceinline__ void add(int s, float v) {
    mn[s] = fminf(mn[s], v);
    mx[s] = fmaxf(mx[s], v);
  }
  // The warp's min and max of each site into dst [12][2] (every lane of the warp calls it).
  __device__ __forceinline__ void write_warp(float* dst) {
#pragma unroll
    for (int s = 0; s < kSites; ++s) {
      float lo = mn[s], hi = mx[s];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
      }
      if ((threadIdx.x & 31) == 0) {
        dst[2 * s] = lo;
        dst[2 * s + 1] = hi;
      }
    }
  }
};

// The static cell's grids, [mn x 12][delta x 12] in shared memory, from the direction's ranges.
__device__ __forceinline__ void load_grids(float* grid, const Direction& d, float q) {
  if (threadIdx.x < kSites) {
    const float mn = d.site_min[threadIdx.x];
    grid[threadIdx.x] = mn;
    grid[kSites + threadIdx.x] = fqss::act_grid_step(mn, d.site_max[threadIdx.x], q);
  }
}

__device__ __forceinline__ float site_q(const float* grid, int s, float x, float q) {
  return fqss::act_grid_value(x, grid[s], grid[kSites + s], q);
}

// One cell step of one row and unit from its input projection pre[4] and recurrent product acc[4] (gates i, f, g,
// o): c is updated, h returned. kFused and kObserve compute the float cell, kStatic the quantized one; kObserve adds
// every site's value to st where `count`.
template <int kMode>
__device__ __forceinline__ float cell(const float (&pre)[4], const float (&acc)[4], float& c, const float* grid,
                                      float q, SiteStats& st, bool count) {
  float a[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    if (kMode == kStatic) {
      a[g] = site_q(grid, kAdd0, __fadd_rn(site_q(grid, kIh, pre[g], q), site_q(grid, kHh, acc[g], q)), q);
    } else {
      a[g] = __fadd_rn(pre[g], acc[g]);
    }
  }
  float i_g = sigmoid_rn(a[0]), f_g = sigmoid_rn(a[1]), g_g = tanhf(a[2]), o_g = sigmoid_rn(a[3]);
  if (kMode == kStatic) {
    i_g = site_q(grid, kSig0, i_g, q);
    f_g = site_q(grid, kSig1, f_g, q);
    g_g = site_q(grid, kTanh0, g_g, q);
    o_g = site_q(grid, kSig2, o_g, q);
  }
  float m0 = __fmul_rn(f_g, c), m1 = __fmul_rn(i_g, g_g);
  if (kMode == kStatic) {
    m0 = site_q(grid, kMul0, m0, q);
    m1 = site_q(grid, kMul1, m1, q);
  }
  float c_new = __fadd_rn(m0, m1);
  if (kMode == kStatic) c_new = site_q(grid, kAdd1, c_new, q);
  float tc = tanhf(c_new);
  if (kMode == kStatic) tc = site_q(grid, kTanh1, tc, q);
  float h = __fmul_rn(o_g, tc);
  if (kMode == kStatic) h = site_q(grid, kMul2, h, q);
  if (kMode == kObserve && count) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      st.add(kIh, pre[g]);
      st.add(kHh, acc[g]);
      st.add(kAdd0, a[g]);
    }
    st.add(kSig0, i_g);
    st.add(kSig1, f_g);
    st.add(kTanh0, g_g);
    st.add(kSig2, o_g);
    st.add(kMul0, m0);
    st.add(kMul1, m1);
    st.add(kAdd1, c_new);
    st.add(kTanh1, tc);
    st.add(kMul2, h);
  }
  c = c_new;
  return h;
}

// ---------------------------------------------------------------------------------------------------------------
// The cluster route.

constexpr int kCThreads = 256;
constexpr int kCLanes = 32;                   // unit lanes of a row group (a warp): each owns units p and p + 32
constexpr int kCUnits = 2 * kCLanes;          // the most hidden units a CTA owns
constexpr int kCGroups = kCThreads / kCLanes; // row groups of a CTA, one a warp
constexpr int kMaxCluster = 8;                // the portable cluster size
constexpr int kObserveRpt = 4;                // kObserve's largest row tile, 32 rows: its launches are short

// Shared memory of one CTA: its W slice [H][U] float4, h of the tile in two buffers [2][rows][H], an mbarrier
// for each buffer and row group [2][kCGroups], and on the static route the 12 sites' grids [2][kSites].
size_t cluster_smem(int64_t H, int c, int rows, bool grids) {
  const int64_t U = (H + c - 1) / c;
  return sizeof(float) * static_cast<size_t>(4 * H * U + 2 * rows * H) + sizeof(uint64_t) * 2 * kCGroups +
         (grids ? sizeof(float) * 2 * kSites : 0);
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
template <int kRpt, bool kVec, int kMode>
__global__ void __launch_bounds__(kCThreads, 1)
    lstm_cluster_kernel(Direction d0, Direction d1, int64_t T, int64_t B, int H, int U, float levels) {
  constexpr int kRows = kCGroups * kRpt;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  float4* w_s = reinterpret_cast<float4*>(smem);  // [H][U]: (W[k][j], W[k][H + j], W[k][2H + j], W[k][3H + j])
  float* h_buf = smem + 4 * H * U;                 // [2][kRows][H]
  uint64_t* full = reinterpret_cast<uint64_t*>(h_buf + 2 * kRows * H);  // [2][kCGroups]
  float* grid = reinterpret_cast<float*>(full + 2 * kCGroups);           // [2][kSites] (kStatic)
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
  {
    const int64_t tile0 = static_cast<int64_t>(blockIdx.x / c) * kRows;
    for (int i = threadIdx.x; i < kRows * H; i += kCThreads) {
      const int64_t row = tile0 + i / H;
      h_buf[i] = kCarriesState<kMode> && d.h0 != nullptr && row < B ? d.h0[row * H + i % H] : 0.0f;
    }
  }
  if (kMode == kStatic) load_grids(grid, d, levels);
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
    for (int u = 0; u < 2; ++u) {
      c_reg[r][u] = kCarriesState<kMode> && d.c0 != nullptr && live[u] && row0 + r < B
                        ? d.c0[(row0 + r) * H + j[u]] : 0.0f;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        pre[r][u][g] = live[u] && row0 + r < B ? __ldg(d.ih + (row0 + r) * G + g * H + j[u]) : 0.0f;
    }
  // Every CTA's W slice, buffer 0 (h0 or zeros), grids and mbarriers are in place, and its shared memory is live,
  // before a peer reads, writes or arrives there.
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
    SiteStats st;
    if (kMode == kObserve) st.reset();
#pragma unroll
    for (int r = 0; r < kRpt; ++r)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float h = cell<kMode>(pre[r][u], acc[r][u], c_reg[r][u], grid, levels, st, live[u] && row0 + r < B);
        if (live[u]) {
          if (copy4) {
            h_new[r * H + j[u]] = h;
          } else {
            for (int rk = 0; rk < c; ++rk) cluster.map_shared_rank(h_new, rk)[r * H + j[u]] = h;
          }
          if (row0 + r < B) out_t[(row0 + r) * H + j[u]] = h;
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
    if (kMode == kObserve) {
      const int64_t partials = static_cast<int64_t>(gridDim.x) * kCGroups;
      st.write_warp(d.stats + ((t * partials) + blockIdx.x * kCGroups + grp) * 2 * kSites);
    }
    if (t + 1 < T) {
      const float* ih_n = d.ih + (t + 1) * B * G;
#pragma unroll
      for (int r = 0; r < kRpt; ++r)
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int g = 0; g < 4; ++g)
            pre[r][u][g] = live[u] && row0 + r < B ? __ldg(ih_n + (row0 + r) * G + g * H + j[u]) : 0.0f;
    }
  }
  if (kCarriesState<kMode> && d.c_last != nullptr) {
#pragma unroll
    for (int r = 0; r < kRpt; ++r)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        if (live[u] && row0 + r < B) d.c_last[(row0 + r) * H + j[u]] = c_reg[r][u];
  }
  // No CTA exits while a peer may still write into its shared memory or arrive on its barriers.
  cluster.sync();
}

// Launches the cluster kernel, or with max_active set only asks how many of its clusters fit co-resident.
template <int kRpt, bool kVec, int kMode>
int cluster_launch(Direction d0, Direction d1, int dirs, int64_t T, int64_t B, int64_t H, int c, float levels,
                   cudaStream_t stream, int* max_active) {
  constexpr int kRows = kCGroups * kRpt;
  auto kernel = lstm_cluster_kernel<kRpt, kVec, kMode>;
  const size_t smem = cluster_smem(H, c, kRows, kMode == kStatic);
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
  err = cudaLaunchKernelEx(&cfg, kernel, d0, d1, T, B, static_cast<int>(H), U, levels);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec, int kMode>
int cluster_dispatch(Direction d0, Direction d1, int dirs, int64_t T, int64_t B, int64_t H, int c, int rows,
                     float levels, cudaStream_t stream, int* max_active) {
  if (kMode == kObserve && rows > kCGroups * kObserveRpt) return static_cast<int>(cudaErrorInvalidValue);
  switch (rows) {
    case kCGroups * 1: return cluster_launch<1, kVec, kMode>(d0, d1, dirs, T, B, H, c, levels, stream, max_active);
    case kCGroups * 2: return cluster_launch<2, kVec, kMode>(d0, d1, dirs, T, B, H, c, levels, stream, max_active);
    case kCGroups * 4: return cluster_launch<4, kVec, kMode>(d0, d1, dirs, T, B, H, c, levels, stream, max_active);
    case kCGroups * 8:
      return cluster_launch<kMode == kObserve ? kObserveRpt : 8, kVec, kMode>(d0, d1, dirs, T, B, H, c, levels, stream,
                                                                            max_active);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int kMode>
int cluster_checked(Direction d0, Direction d1, int dirs, int64_t T, int64_t B, int64_t H, int c, int rows,
                    float levels, cudaStream_t stream, int* max_active) {
  if (c < 1 || c > kMaxCluster || H < 1 || (H + c - 1) / c > kCUnits ||
      cluster_smem(H, c, rows, kMode == kStatic) > kSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  return H % 4 == 0 ? cluster_dispatch<true, kMode>(d0, d1, dirs, T, B, H, c, rows, levels, stream, max_active)
                    : cluster_dispatch<false, kMode>(d0, d1, dirs, T, B, H, c, rows, levels, stream, max_active);
}

// ---------------------------------------------------------------------------------------------------------------
// The blocks route, for H above what a cluster holds.

constexpr int kLanes = 128;             // hidden units one pass of a block covers
constexpr int kGroups = 2;              // row groups of a block
constexpr int kThreads = kLanes * kGroups;
constexpr int kRows = 8;                // batch rows of a thread
constexpr int kTile = kGroups * kRows;  // batch rows of a block
constexpr int kBWarps = kThreads / 32;  // warps of a block (kObserve's partials)

template <bool kVec, int kMode>
__global__ void __launch_bounds__(kThreads, 2)
    lstm_blocks_kernel(Direction d0, Direction d1, int64_t T, int64_t B, int H, float levels) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float grid[kMode == kStatic ? 2 * kSites : 1];
  float* h_buf = smem;                // [2][kTile][H]
  float* c_s = smem + 2 * kTile * H;  // [kTile][H]
  const Direction d = blockIdx.y == 0 ? d0 : d1;
  const int64_t G = 4 * static_cast<int64_t>(H);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int lane = threadIdx.x % kLanes;
  const int grp = threadIdx.x / kLanes;

  for (int i = threadIdx.x; i < kTile * H; i += kThreads) {
    const int64_t row = row0 + i / H;
    h_buf[i] = kCarriesState<kMode> && d.h0 != nullptr && row < B ? d.h0[row * H + i % H] : 0.0f;
    h_buf[kTile * H + i] = 0.0f;
    c_s[i] = kCarriesState<kMode> && d.c0 != nullptr && row < B ? d.c0[row * H + i % H] : 0.0f;
  }
  if (kMode == kStatic) load_grids(grid, d, levels);
  __syncthreads();

  for (int64_t t = 0; t < T; ++t) {
    const float* h_old = h_buf + (t & 1) * kTile * H + grp * kRows * H;
    float* h_new = h_buf + ((t + 1) & 1) * kTile * H;
    const float* ih_t = d.ih + t * B * G;
    float* out_t = d.out + t * B * H;
    SiteStats st;
    if (kMode == kObserve) st.reset();
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
        float c = c_s[idx];
        const float h = cell<kMode>(pre[r], acc[r], c, grid, levels, st, row < B);
        c_s[idx] = c;
        h_new[idx] = h;
        if (row < B) out_t[row * H + j] = h;
      }
    }
    if (kMode == kObserve) {
      const int64_t partials = static_cast<int64_t>(gridDim.x) * kBWarps;
      st.write_warp(d.stats + ((t * partials) + blockIdx.x * kBWarps + threadIdx.x / 32) * 2 * kSites);
    }
    __syncthreads();
  }
  if (kCarriesState<kMode> && d.c_last != nullptr) {
    for (int i = threadIdx.x; i < kTile * H; i += kThreads) {
      const int64_t row = row0 + i / H;
      if (row < B) d.c_last[row * H + i % H] = c_s[i];
    }
  }
}

template <bool kVec, int kMode>
int blocks_launch(Direction d0, Direction d1, int dirs, int64_t T, int64_t B, int64_t H, float levels,
                  cudaStream_t stream) {
  const size_t smem = 3 * kTile * static_cast<size_t>(H) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(lstm_blocks_kernel<kVec, kMode>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned int>((B + kTile - 1) / kTile), static_cast<unsigned int>(dirs));
  lstm_blocks_kernel<kVec, kMode><<<grid, kThreads, smem, stream>>>(d0, d1, T, B, static_cast<int>(H), levels);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode>
int blocks_checked(Direction d0, Direction d1, int dirs, int64_t T, int64_t B, int64_t H, float levels,
                   cudaStream_t stream) {
  return H % 4 == 0 ? blocks_launch<true, kMode>(d0, d1, dirs, T, B, H, levels, stream)
                    : blocks_launch<false, kMode>(d0, d1, dirs, T, B, H, levels, stream);
}

// The static route's directions from the wrapper's pointer table: 9 a direction (ih, w, out, h0, c0, c_last,
// site_min, site_max, stats), as int64.
Direction direction_of(const int64_t* p) {
  Direction d{reinterpret_cast<const float*>(p[0]), reinterpret_cast<const float*>(p[1]),
              reinterpret_cast<float*>(p[2])};
  d.h0 = reinterpret_cast<const float*>(p[3]);
  d.c0 = reinterpret_cast<const float*>(p[4]);
  d.c_last = reinterpret_cast<float*>(p[5]);
  d.site_min = reinterpret_cast<const float*>(p[6]);
  d.site_max = reinterpret_cast<const float*>(p[7]);
  d.stats = reinterpret_cast<float*>(p[8]);
  return d;
}

}  // namespace
