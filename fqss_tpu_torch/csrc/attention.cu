// Fused attention core for NVIDIA Hopper (sm_90a): softmax(q k^T) v with the
// head fake-quant in its epilogue (K8).
//
//   attention_kernel  replaces fqss_tpu/ops/pallas_attention.py:_attn_kernel
//                     (fused_attention). For each head (b, h), query i and key
//                     j of q [B, Lq, H, d], k, v [B, Lk, H, d] (any outer
//                     strides, unit inner stride):
//                       s[i, j]        = sum_c q[b, i, h, c] * k[b, j, h, c]
//                       out[b, i, h, :] = sum_j softmax_j(s[i, :]) * v[b, j, h, :]
//                     then, when quantize is set, the per-tensor uniform grid
//                     of K1 (fake_quant.cuh) with the range (mn, mx). q
//                     arrives already scaled by 1/sqrt(d) and quantized
//                     (QMultiheadAttention's div site). The [BH, L, d] layout
//                     of JAX's kernel is the case H = 1; the module passes
//                     views of its in-projection [B, L, 3E] and gets the heads
//                     back as [B, Lq, E], so no copy of the head layout is made
//                     on either side.
//
// What bounds it on the H100: 4 BH Lq Lk d operations (two products) against
// 4 (2 BH Lq d + 2 BH Lk d) bytes that must cross device memory. At the
// Sepformer's intra-chunk shape (BH 2176, L 250, d 32) that is 17.4 GFLOP over
// 278 MB, about 63 operations a byte, above the card's float32 ratio of 67
// TFLOP/s to 3.35 TB/s (20): bound by operations. At its inter-chunk shape
// (BH 16000, L 34) it is 8.5 a byte: bound by memory. DPTNet's d = 16 heads
// (L 250 and 258) do half the products per score, so there the softmax's
// exponentials and bookkeeping weigh as much as the products.
//
// What the design does about it:
// - A warp owns MT m16 tiles of query rows of a head, as flash attention's
//   warps own one: MT = 2 (32 rows) where a head has more than 64 queries,
//   else 1. S = Q K^T is computed by each thread for the P V product's A
//   fragments directly: of each m16 tile rows g and g + 8, keys t and t + 4 of
//   every 8-key group (g = lane / 4, t = lane % 4). The row max and sum are
//   taken over the quad of threads that shares a row (two shuffles), and the
//   exponentiated scores P are those A fragments: no shuffle and no trip
//   through shared memory.
// - S runs on the CUDA cores as a chain of float32 FMAs in the order of the
//   head dimension, from zero: the logits cuBLAS's float32 product rounds,
//   bit for bit. At logits of +-400 (phase 24 of chip_smoke.py plants them)
//   float32's spacing of 3e-5 moves a softmax weight by that share of
//   itself, and the plain version itself sits up to 2.5e-5 of max |heads|
//   from the float64 attention there; a kernel that rounds the logits in
//   another order (3xTF32 on the tensor cores read 1.7e-5 to 3.3e-5 from the
//   plain version) leaves the 1e-5 bound the port holds K8 to. Each K value
//   is read as float4 from shared memory and feeds an FMA of each of the
//   thread's 2 MT rows: at MT = 2 the reads are half as many a row.
// - P V runs on the tensor cores as 3xTF32 (tf32_mma.cuh: mma.sync m16n8k8,
//   each operand split into hi + lo, three TF32 products a float32 one; one
//   TF32 product alone leaves the bound); V's B fragments serve every m16
//   tile of the warp. Each 8-key group is summed from
//   zero and added to the rescaled float32 output with _rn arithmetic:
//   O = O alpha + group + group ... (alpha the online softmax's rescale). The
//   tensor cores truncate their sums (measured on an H100), so no
//   accumulator runs long.
// - Q's tile is copied into shared memory once per block; K and V tiles come
//   in by 16-byte cp.async into a ring of three stages (one __syncthreads a
//   tile). Rows are padded to D + 4 (Q) and D + 8 (K, V) floats, so that the
//   float4 reads of Q's eight rows and of K's four, and V's fragment reads,
//   each hit every bank once. Rows past Lq or Lk and dims past d are
//   zero-filled by the copies; where a row is not 16-byte aligned (d = 5, or
//   a packed view whose E is not a multiple of 4) the copies take 4 bytes. No
//   integer division runs inside the loop: a block's heads are resolved once.
// - Key tiles are a multiple of 8 keys sized to the sequence by the plan
//   (ops/attention.py:plan), at most 64 (32 at MT = 2, to stay in 128
//   registers): Lk 34 takes one tile of 40, Lk 250 eight of 32. Where Lq is
//   short a block takes several heads, one or more warps a head (the
//   Sepformer's inter-chunk L 34: 3 warps, one head a block).
//
// The bf16 route (attention_kernel<D, MT, true>; QuantSpec.compute_dtype
// "bfloat16") computes JAX's default composition under bf16
// (fqss_tpu/nn/attention.py:117-130): the logits from q and k rounded to
// bfloat16, softmax(s) = exp(s - max) / sum normalised in float32 and then
// rounded to bfloat16, times v rounded to bfloat16, the sums float32. The
// online softmax rescales an unnormalised P, whose rounding would differ, so
// the route takes three passes over the key tiles through the same ring,
// computing the logits in each, bit for bit: the rows' max; the rows' sums of
// exp(s - max); P = exp(s - max) / sum, rounded, into P V. A weight that lies
// within an ulp of a bf16 tie rounds to either neighbour with an ulp of its
// sum, and a float32 sum over 250 keys taken in another order than the plain
// version's is several ulps off (a two-pass design, with the sum taken online,
// moved such weights on 55-102 rows of a serving shape): so each sum is taken
// in float64 and rounded once, as the plain version's is, and the two agree
// bit for bit but where the float64 sums round differently. Each tile is
// rounded in shared memory once it has landed (one more __syncthreads a tile),
// Q's rows once. With exact products the logits' FMA chain is the float32 sum
// of exact terms; P V takes one TF32 mma a product (bf16 values are exact in
// TF32, their products in float32), each 8-key group summed from zero. The
// head grid is unchanged. The route reads K three times.
//
// Numerics: the logits are cuBLAS's; the softmax is taken online and P V's
// three products per term drop about 2^-21 of |term|, so the float heads
// agree with the plain version to a tolerance, not bit for bit. Both
// settings of quantize compute the same float heads bit for bit, and the
// epilogue puts them on K1's grid exactly as act_fake_quant_ref does. expf is
// the accurate exponential. Do not build with --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "fake_quant.cuh"
#include "tf32_mma.cuh"

namespace {

using fqss::mma_3xtf32;
using fqss::mma_tf32;
using fqss::round_bf16;
using fqss::split_tf32;

constexpr int kMaxDim = 128;
constexpr int kMaxWarps = 8;  // warps of a block at most (the plan's wph * hpb; Cfg<D>::kWarps at D)
constexpr int kRing = 3;      // stages of the K/V ring (fewer are allocated where a head has fewer tiles)

// Layout of the host's int64 argument array (ops/attention.py:_launch).
enum Arg {
  kB, kH, kLq, kLk, kD,
  kQsB, kQsL, kQsH, kKsB, kKsL, kKsH, kVsB, kVsL, kVsH, kOsB, kOsL, kOsH,
  kTile, kTiles, kWph, kHpb, kQBlocks, kVec, kMt
};

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* mn;
  const float* mx;
  float* out;
  int64_t H, BH, Lq, Lk;
  int64_t q_sb, q_sl, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, o_sb, o_sl, o_sh;  // strides in floats
  int64_t qblocks;  // blocks along a head's queries
  int d, bk, ntiles, wph, hpb, vec, mt, quantize, n_bits;
};

// D: the head width d is padded to; MT: the m16 tiles of query rows a warp owns (2 where a head has more than 64
// queries and D <= 64: each K value read from shared memory then feeds twice the FMAs, each V fragment twice the
// mmas).
template <int D, int MT>
struct Cfg {
  static constexpr int kRows = 16 * MT;          // query rows of a warp
  static constexpr int kSteps = D / 8;           // n8 tiles of P V's output
  static constexpr int kChunks = D / 4;          // 16-byte chunks of a row
  static constexpr int kMaxN = MT == 1 && D <= 64 ? 8 : 4;  // 8-key groups of a tile: 64 keys, else 32
  static constexpr int kQStride = D + 4;         // D / 4 + 1 chunks, odd: eight rows' float4 reads conflict-free
  static constexpr int kKVStride = D + 8;        // = 8 or 24 (mod 32): K's float4 and V's fragment reads too
  // Warps of a block at most (ops/attention.py:max_warps), and blocks of them an SM.
  static constexpr int kWarps = MT == 2 || D <= 16 ? 4 : kMaxWarps;
  static constexpr int kMinBlocks = MT == 2 ? (D <= 32 ? 4 : 2) : (D <= 16 ? 5 : D <= 32 ? 2 : 1);
};

// The first `n` floats of 4 (0 to 4) from src to dst, the rest zero-filled: one 16-byte copy where the rows lie
// on 16 bytes (vec), else four 4-byte ones. `fallback` is any valid address (read for nothing).
__device__ __forceinline__ void copy_chunk(float* dst, const float* src, int n, bool vec, const float* fallback) {
  if (vec) {
    fqss::cp_async16_bytes(dst, n > 0 ? src : fallback, 4 * n);
  } else {
#pragma unroll
    for (int x = 0; x < 4; ++x) fqss::cp_async4(dst + x, x < n ? src + x : fallback, x < n);
  }
}

// acc + a . b over four dims in order, an FMA each: the steps of cuBLAS's float32 sum of a product's terms.
__device__ __forceinline__ float fma4(const float4 a, const float4 b, const float acc) {
  return __fmaf_rn(a.w, b.w, __fmaf_rn(a.z, b.z, __fmaf_rn(a.y, b.y, __fmaf_rn(a.x, b.x, acc))));
}

// The passes over the key tiles: the bf16 route's first computes the rows' max, its second their sums, its third
// P V.
template <bool BF16>
constexpr int kPasses = BF16 ? 3 : 1;

// BF16: the bf16 route (the header's note).
template <int D, int MT, bool BF16>
__global__ void __launch_bounds__(Cfg<D, MT>::kWarps * 32, Cfg<D, MT>::kMinBlocks) attention_kernel(const Args a) {
  using C = Cfg<D, MT>;
  extern __shared__ __align__(16) float smem[];
  __shared__ const float* head_k[kMaxWarps];
  __shared__ const float* head_v[kMaxWarps];

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int64_t group = blockIdx.x / a.qblocks;
  const int64_t qb = blockIdx.x - group * a.qblocks;
  const int64_t head0 = group * a.hpb;
  const int nheads = static_cast<int>(a.BH - head0 < a.hpb ? a.BH - head0 : a.hpb);
  if (tid < nheads) {
    const int64_t bh = head0 + tid, b = bh / a.H, h = bh - b * a.H;
    head_k[tid] = a.k + b * a.k_sb + h * a.k_sh;
    head_v[tid] = a.v + b * a.v_sb + h * a.v_sh;
  }

  // Shared memory: the ring's stages of [hpb][bk][kKVStride] K tiles, then [hpb][bk][kKVStride] V tiles; after
  // them each warp's rows of Q, [kRows][kQStride]. The ring runs over `steps` tiles: the key tiles once for each
  // pass.
  const int steps = kPasses<BF16> * a.ntiles;
  const int stages = steps < kRing ? steps : kRing;
  const int stage_floats = 2 * a.hpb * a.bk * C::kKVStride;
  const int v_offset = a.hpb * a.bk * C::kKVStride;
  float* qs = smem + stages * stage_floats + warp * C::kRows * C::kQStride;

  // This warp's query rows [r0, r0 + kRows) of head hl of the block, copied into qs.
  const int hl = warp / a.wph;
  const int64_t r0 = (qb * a.wph + (warp - hl * a.wph)) * C::kRows;
  const bool active = hl < nheads && r0 < a.Lq;  // warp-uniform
  float* oh = a.out;
  if (active) {
    const int64_t bh = head0 + hl, b = bh / a.H, h = bh - b * a.H;
    const float* qh = a.q + b * a.q_sb + h * a.q_sh;
    oh += b * a.o_sb + h * a.o_sh;
    for (int e = lane; e < C::kRows * C::kChunks; e += 32) {
      const int r = e / C::kChunks, c = e % C::kChunks * 4;  // compile-time divisors
      const bool row_ok = r0 + r < a.Lq;
      const int left = a.d - c;
      copy_chunk(qs + r * C::kQStride + c, qh + (row_ok ? r0 + r : 0) * a.q_sl + c,
                 row_ok && left > 0 ? (left < 4 ? left : 4) : 0, a.vec, a.q);
    }
  }
  __syncthreads();  // head_k, head_v

  const int per_head = a.bk * C::kChunks;
  // Step `step` of the ring: key tile step % ntiles; V only in the last pass.
  auto load_tile = [&](int step, int stage) {
    const bool with_v = step >= (kPasses<BF16> - 1) * a.ntiles;
    float* ks = smem + stage * stage_floats;
    const int64_t j0 = static_cast<int64_t>(BF16 ? step % a.ntiles : step) * a.bk;
    for (int hh = 0; hh < nheads; ++hh) {
      const float* kh = head_k[hh];
      const float* vh = head_v[hh];
      float* kd = ks + hh * a.bk * C::kKVStride;
      float* vd = ks + v_offset + hh * a.bk * C::kKVStride;
      for (int e = tid; e < per_head; e += nthreads) {
        const int r = static_cast<unsigned>(e) / C::kChunks, c = static_cast<unsigned>(e) % C::kChunks * 4;
        const int64_t j = j0 + r;
        const bool row_ok = j < a.Lk;
        const int left = a.d - c;
        const int n = row_ok && left > 0 ? (left < 4 ? left : 4) : 0;
        copy_chunk(kd + r * C::kKVStride + c, kh + (row_ok ? j : 0) * a.k_sl + c, n, a.vec, a.k);
        if (with_v) copy_chunk(vd + r * C::kKVStride + c, vh + (row_ok ? j : 0) * a.v_sl + c, n, a.vec, a.v);
      }
    }
  };

  // Of m16 tile i (rows 16 i + [0, 16)): the output fragment, and of its rows 16 i + g and 16 i + g + 8 the running
  // max and this thread's share of the running sums (the bf16 route's in float64, ld, to round them once).
  float o[MT][C::kSteps][4], m[MT][2], l[MT][2];
  [[maybe_unused]] double ld[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int dn = 0; dn < C::kSteps; ++dn) o[i][dn][0] = o[i][dn][1] = o[i][dn][2] = o[i][dn][3] = 0.0f;
    m[i][0] = m[i][1] = -INFINITY;
    l[i][0] = l[i][1] = 0.0f;
    ld[i][0] = ld[i][1] = 0.0;
  }
  const int chunks = (a.d + 3) >> 2;     // the chunks of Q K^T that hold a dim (the rest are zeros)

  int load_stage = 0, stage = 0;
#pragma unroll
  for (int i = 0; i < kRing - 1; ++i) {  // Q's rows went into the first group
    if (i < steps) load_tile(i, load_stage);
    fqss::cp_async_commit();
    load_stage = load_stage + 1 == kRing ? 0 : load_stage + 1;
  }
  for (int step = 0; step < steps; ++step) {
    fqss::cp_async_wait<kRing - 2>();
    __syncthreads();  // this tile has landed, and every warp is done with the stage the next load overwrites
    if (step + kRing - 1 < steps) load_tile(step + kRing - 1, load_stage);
    fqss::cp_async_commit();
    load_stage = load_stage + 1 == kRing ? 0 : load_stage + 1;
    const int pass = BF16 ? step / a.ntiles : 0;
    const int tile = step - pass * a.ntiles;

    if constexpr (BF16) {  // round what this step reads to bfloat16 in place: K (and V in the last pass), Q once
      if (step == 0 && active) {  // this warp's own rows, which the wait above has brought in
        for (int e = lane; e < C::kRows * D; e += 32) {
          float* at = qs + e / D * C::kQStride + e % D;
          *at = round_bf16(*at);
        }
        __syncwarp();
      }
      float* ks = smem + stage * stage_floats;
      const int n = nheads * a.bk * D;
      for (int e = tid; e < n; e += nthreads) {
        const int at = e / D * C::kKVStride + e % D;  // row e / D of the stage's nheads * bk rows
        ks[at] = round_bf16(ks[at]);
        if (pass == kPasses<BF16> - 1) ks[v_offset + at] = round_bf16(ks[v_offset + at]);
      }
      __syncthreads();
    }

    if (active) {
      const float* ks = smem + stage * stage_floats + hl * a.bk * C::kKVStride;
      const float* vs = smem + stage * stage_floats + v_offset + hl * a.bk * C::kKVStride;
      const int64_t j0 = static_cast<int64_t>(tile) * a.bk;
      // the tile's 8-key groups that hold a key (the last tile's zero-filled groups past Lk are skipped)
      const int n8 = static_cast<int>(a.Lk - j0 < a.bk ? (a.Lk - j0 + 7) >> 3 : a.bk >> 3);

      // S = Q K^T as P V's A fragments: s[i][n] = (row 16 i + g, key 8n + t), (row 16 i + g + 8, key 8n + t), (row
      // 16 i + g, key 8n + t + 4), (row 16 i + g + 8, key 8n + t + 4), each a chain of FMAs over the dims in order,
      // from zero (cuBLAS's sum).
      float s[MT][C::kMaxN][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int n = 0; n < C::kMaxN; ++n) s[i][n][0] = s[i][n][1] = s[i][n][2] = s[i][n][3] = 0.0f;
      const float* kr = ks + t * C::kKVStride;
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) {
        if (c < chunks) {
          float4 q[MT][2];
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            q[i][0] = *reinterpret_cast<const float4*>(qs + (16 * i + g) * C::kQStride + 4 * c);
            q[i][1] = *reinterpret_cast<const float4*>(qs + (16 * i + g + 8) * C::kQStride + 4 * c);
          }
#pragma unroll
          for (int n = 0; n < C::kMaxN; ++n) {
            if (n < n8) {
              const float4 b0 = *reinterpret_cast<const float4*>(kr + 8 * n * C::kKVStride + 4 * c);
              const float4 b1 = *reinterpret_cast<const float4*>(kr + (8 * n + 4) * C::kKVStride + 4 * c);
#pragma unroll
              for (int i = 0; i < MT; ++i) {
                s[i][n][0] = fma4(q[i][0], b0, s[i][n][0]);
                s[i][n][1] = fma4(q[i][1], b0, s[i][n][1]);
                s[i][n][2] = fma4(q[i][0], b1, s[i][n][2]);
                s[i][n][3] = fma4(q[i][1], b1, s[i][n][3]);
              }
            }
          }
        }
      }
      if (j0 + a.bk > a.Lk) {  // the last tile runs past the keys: those scores take no weight
#pragma unroll
        for (int n = 0; n < C::kMaxN; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (n < n8 && j0 + n * 8 + t + 4 * (c >> 1) >= a.Lk) {
#pragma unroll
              for (int i = 0; i < MT; ++i) s[i][n][c] = -INFINITY;
            }
      }

      if constexpr (BF16) {
        if (pass == 0) {  // the rows' max over the quad
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
            for (int n = 0; n < C::kMaxN; ++n) {
              if (n < n8) {
                t0 = fmaxf(t0, fmaxf(s[i][n][0], s[i][n][2]));
                t1 = fmaxf(t1, fmaxf(s[i][n][1], s[i][n][3]));
              }
            }
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
              t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, off));
              t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, off));
            }
            m[i][0] = fmaxf(m[i][0], t0);
            m[i][1] = fmaxf(m[i][1], t1);
          }
        } else if (pass == 1) {  // this thread's share of the rows' sums of exp(s - max), in float64
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int n = 0; n < C::kMaxN; ++n)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                if (n < n8) ld[i][c & 1] = __dadd_rn(ld[i][c & 1], expf(__fsub_rn(s[i][n][c], m[i][c & 1])));
        } else {
          if (tile == 0) {  // the rows' sums over the quad, rounded once to float32
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
              for (int r = 0; r < 2; ++r) {
#pragma unroll
                for (int off = 1; off < 4; off <<= 1)
                  ld[i][r] = __dadd_rn(ld[i][r], __shfl_xor_sync(0xffffffffu, ld[i][r], off));
                l[i][r] = __double2float_rn(ld[i][r]);
              }
          }
          // O += round(exp(S - max) / sum) V, summed from zero over each 8-key group; V was rounded in place.
#pragma unroll
          for (int n = 0; n < C::kMaxN; ++n) {
            if (n < n8) {
              uint32_t p[MT][4];
#pragma unroll
              for (int i = 0; i < MT; ++i)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                  p[i][c] = __float_as_uint(
                      round_bf16(__fdiv_rn(expf(__fsub_rn(s[i][n][c], m[i][c & 1])), l[i][c & 1])));
              const float* vr = vs + (n * 8 + t) * C::kKVStride + g;
#pragma unroll
              for (int dn = 0; dn < C::kSteps; ++dn) {
                const uint32_t b[2] = {__float_as_uint(vr[8 * dn]), __float_as_uint(vr[4 * C::kKVStride + 8 * dn])};
#pragma unroll
                for (int i = 0; i < MT; ++i) {
                  float pv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                  mma_tf32(pv, p[i], b);
#pragma unroll
                  for (int c = 0; c < 4; ++c) o[i][dn][c] = __fadd_rn(o[i][dn][c], pv[c]);
                }
              }
            }
          }
        }
      } else {
        // The online softmax: the tile's row max over the quad, the rescale alpha of what came before; P = exp(S -
        // max) in place.
        float alpha[MT][2];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
          for (int n = 0; n < C::kMaxN; ++n) {
            if (n < n8) {
              t0 = fmaxf(t0, fmaxf(s[i][n][0], s[i][n][2]));
              t1 = fmaxf(t1, fmaxf(s[i][n][1], s[i][n][3]));
            }
          }
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, off));
            t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, off));
          }
          const float new0 = fmaxf(m[i][0], t0), new1 = fmaxf(m[i][1], t1);  // finite: a tile holds a key
          alpha[i][0] = expf(__fsub_rn(m[i][0], new0));  // 0 on the first tile
          alpha[i][1] = expf(__fsub_rn(m[i][1], new1));
          m[i][0] = new0;
          m[i][1] = new1;
          float p0 = 0.0f, p1 = 0.0f;
#pragma unroll
          for (int n = 0; n < C::kMaxN; ++n) {
            if (n < n8) {
              s[i][n][0] = expf(__fsub_rn(s[i][n][0], new0));  // 0 for a key past Lk
              p0 = __fadd_rn(p0, s[i][n][0]);
              s[i][n][2] = expf(__fsub_rn(s[i][n][2], new0));
              p0 = __fadd_rn(p0, s[i][n][2]);
              s[i][n][1] = expf(__fsub_rn(s[i][n][1], new1));
              p1 = __fadd_rn(p1, s[i][n][1]);
              s[i][n][3] = expf(__fsub_rn(s[i][n][3], new1));
              p1 = __fadd_rn(p1, s[i][n][3]);
            }
          }
          l[i][0] = __fadd_rn(__fmul_rn(l[i][0], alpha[i][0]), p0);
          l[i][1] = __fadd_rn(__fmul_rn(l[i][1], alpha[i][1]), p1);
#pragma unroll
          for (int dn = 0; dn < C::kSteps; ++dn) {
            o[i][dn][0] = __fmul_rn(o[i][dn][0], alpha[i][0]);
            o[i][dn][1] = __fmul_rn(o[i][dn][1], alpha[i][0]);
            o[i][dn][2] = __fmul_rn(o[i][dn][2], alpha[i][1]);
            o[i][dn][3] = __fmul_rn(o[i][dn][3], alpha[i][1]);
          }
        }

        // O = O alpha + P V, P V summed from zero over each 8-key group and added to O with __fadd_rn; V's B
        // fragment of group n (rows 8n + t and 8n + t + 4, column g of each n8 tile of the output) serves every m16
        // tile.
#pragma unroll
        for (int n = 0; n < C::kMaxN; ++n) {
          if (n < n8) {
            uint32_t p_hi[MT][4], p_lo[MT][4];
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
              for (int c = 0; c < 4; ++c) split_tf32(s[i][n][c], p_hi[i][c], p_lo[i][c]);
            const float* vr = vs + (n * 8 + t) * C::kKVStride + g;
#pragma unroll
            for (int dn = 0; dn < C::kSteps; ++dn) {
              uint32_t b_hi[2], b_lo[2];
              split_tf32(vr[8 * dn], b_hi[0], b_lo[0]);
              split_tf32(vr[4 * C::kKVStride + 8 * dn], b_hi[1], b_lo[1]);
#pragma unroll
              for (int i = 0; i < MT; ++i) {
                float pv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                mma_3xtf32(pv, p_hi[i], p_lo[i], b_hi, b_lo);
#pragma unroll
                for (int c = 0; c < 4; ++c) o[i][dn][c] = __fadd_rn(o[i][dn][c], pv[c]);
              }
            }
          }
        }
      }
    }
    stage = stage + 1 == kRing ? 0 : stage + 1;
  }
  fqss::cp_async_wait<0>();
  if (!active) return;

  // The rows' sums over the quad, then O / l (the bf16 route's O is normalised already) and the head grid.
  float mn = 0.0f, delta = 1.0f;
  const float qmax = static_cast<float>((1 << a.n_bits) - 1);
  if (a.quantize) {
    mn = __ldg(a.mn);
    delta = fqss::act_grid_step(mn, __ldg(a.mx), qmax);
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if constexpr (!BF16) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l[i][0] = __fadd_rn(l[i][0], __shfl_xor_sync(0xffffffffu, l[i][0], off));
        l[i][1] = __fadd_rn(l[i][1], __shfl_xor_sync(0xffffffffu, l[i][1], off));
      }
    }
#pragma unroll
    for (int dn = 0; dn < C::kSteps; ++dn)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t row = r0 + 16 * i + g + 8 * (c >> 1);
        const int col = 8 * dn + 2 * t + (c & 1);
        if (row < a.Lq && col < a.d) {
          const float y = BF16 ? o[i][dn][c] : __fdiv_rn(o[i][dn][c], l[i][c >> 1]);
          oh[row * a.o_sl + col] = a.quantize ? fqss::act_grid_value(y, mn, delta, qmax) : y;
        }
      }
  }
}

template <int D, int MT, bool BF16>
int launch(const Args& a, cudaStream_t st) {
  using C = Cfg<D, MT>;
  const int threads = 32 * a.wph * a.hpb;
  if (a.bk < 8 || a.bk % 8 || a.bk > 8 * C::kMaxN || a.ntiles < 1 || static_cast<int64_t>(a.ntiles - 1) * a.bk >= a.Lk ||
      static_cast<int64_t>(a.ntiles) * a.bk < a.Lk || a.wph < 1 || a.hpb < 1 || threads > 32 * C::kWarps ||
      a.qblocks < 1 || a.qblocks * a.wph * C::kRows < a.Lq)
    return static_cast<int>(cudaErrorInvalidValue);
  const int steps = kPasses<BF16> * a.ntiles;
  const int stages = steps < kRing ? steps : kRing;
  const int smem = (stages * 2 * a.hpb * a.bk * C::kKVStride + a.wph * a.hpb * C::kRows * C::kQStride) *
                   static_cast<int>(sizeof(float));
  // Dynamic and static shared memory above 48 KB need the kernel's limit raised: it is raised on the first launch
  // on each device, to the card's opt-in maximum less the static part (a call on the host, made once: the serving
  // forwards launch K8 32 times).
  static std::atomic<uint64_t> raised{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint64_t bit = uint64_t{1} << (device & 63);
  if ((raised.load() & bit) == 0) {
    int optin = 0;
    cudaFuncAttributes fa;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, attention_kernel<D, MT, BF16>);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attention_kernel<D, MT, BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin - static_cast<int>(fa.sharedSizeBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised.fetch_or(bit);
  }
  const int64_t blocks = (a.BH + a.hpb - 1) / a.hpb * a.qblocks;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  attention_kernel<D, MT, BF16><<<static_cast<unsigned int>(blocks), threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int MT, bool BF16>
int launch_width(const Args& a, cudaStream_t st) {
  if (a.d <= 16) return launch<16, MT, BF16>(a, st);
  if (a.d <= 32) return launch<32, MT, BF16>(a, st);
  if (a.d <= 64) return launch<64, MT, BF16>(a, st);
  if constexpr (MT == 1) {  // two m16 tiles a warp at D 128 would need more than 255 registers
    if (a.d <= kMaxDim) return launch<128, MT, BF16>(a, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The largest head width the kernel takes.
extern "C" int fqss_attention_max_dim() { return kMaxDim; }

// q [B, Lq, H, d], k, v [B, Lk, H, d], out [B, Lq, H, d]: float32 on the current device, unit inner stride, strides
// in `dims` (layout: enum Arg) with the plan of ops/attention.py:plan (key tile, tiles, warps a head, heads a block,
// query blocks a head, m16 tiles a warp) and vec: q's, k's and v's rows are 16-byte aligned (16-byte copies; else
// 4-byte ones). Lk >= 1, d <= fqss_attention_max_dim(). mn, mx: one float each on the device, read only when
// quantize is set. Returns the launch's CUDA error code.
namespace {

template <bool BF16>
int attention(const float* q, const float* k, const float* v, const float* mn, const float* mx, float* out,
              const int64_t* dims, int quantize, int n_bits, void* stream) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.mn = mn;
  a.mx = mx;
  a.out = out;
  a.H = dims[kH];
  a.BH = dims[kB] * dims[kH];
  a.Lq = dims[kLq];
  a.Lk = dims[kLk];
  a.q_sb = dims[kQsB], a.q_sl = dims[kQsL], a.q_sh = dims[kQsH];
  a.k_sb = dims[kKsB], a.k_sl = dims[kKsL], a.k_sh = dims[kKsH];
  a.v_sb = dims[kVsB], a.v_sl = dims[kVsL], a.v_sh = dims[kVsH];
  a.o_sb = dims[kOsB], a.o_sl = dims[kOsL], a.o_sh = dims[kOsH];
  a.qblocks = dims[kQBlocks];
  a.d = static_cast<int>(dims[kD]);
  a.bk = static_cast<int>(dims[kTile]);
  a.ntiles = static_cast<int>(dims[kTiles]);
  a.wph = static_cast<int>(dims[kWph]);
  a.hpb = static_cast<int>(dims[kHpb]);
  a.vec = static_cast<int>(dims[kVec]);
  a.mt = static_cast<int>(dims[kMt]);
  a.quantize = quantize;
  a.n_bits = n_bits;
  if (a.H < 1 || a.BH < 1 || a.Lq < 1 || a.Lk < 1 || a.d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.mt == 1) return launch_width<1, BF16>(a, st);
  if (a.mt == 2) return launch_width<2, BF16>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int fqss_attention(const float* q, const float* k, const float* v, const float* mn, const float* mx,
                              float* out, const int64_t* dims, int quantize, int n_bits, void* stream) {
  return attention<false>(q, k, v, mn, mx, out, dims, quantize, n_bits, stream);
}

// fqss_attention's bf16 route (the header's note); the same arguments and plan (ops/attention.py:plan with
// bf16=True sizes its ring for two passes).
extern "C" int fqss_attention_bf16(const float* q, const float* k, const float* v, const float* mn,
                                   const float* mx, float* out, const int64_t* dims, int quantize, int n_bits,
                                   void* stream) {
  return attention<true>(q, k, v, mn, mx, out, dims, quantize, n_bits, stream);
}
