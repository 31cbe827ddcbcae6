// Fused attention core for NVIDIA Hopper (sm_90a): softmax(q k^T) v with the
// head fake-quant in its epilogue (K8).
//
//   fused_attention_kernel  replaces fqss_tpu/ops/pallas_attention.py:_attn_kernel
//                           (fused_attention). For each head b, query i and
//                           key j of q [BH, Lq, d], k, v [BH, Lk, d]:
//                             s[i, j]     = sum_c q[b, i, c] * k[b, j, c]
//                             out[b, i, :] = sum_j softmax_j(s[i, :]) * v[b, j, :]
//                           then, when quantize is set, the per-tensor uniform
//                           grid of K1 (fake_quant.cuh) with the range (mn, mx).
//                           q arrives already scaled by 1/sqrt(d) and
//                           quantized (QMultiheadAttention's div site).
//
// What bounds it on the H100: 4 BH Lq Lk d operations (two products) against
// 4 (2 BH Lq d + 2 BH Lk d) bytes that must cross device memory. At the
// Sepformer's intra-chunk shape (BH 2176, L 250, d 32) that is 17.4 GFLOP over
// 278 MB, about 63 operations a byte, above the card's float32 ratio of
// 67 TFLOP/s to 3.35 TB/s (20): bound by operations. At its inter-chunk shape
// (BH 16000, L 34) it is 8.5 a byte: bound by memory. The plain composition
// writes the [BH, Lq, Lk] logits to device memory, reads them for the
// softmax, writes the probabilities and reads them again (2 GB a layer at
// DPTNet's width); here they never leave registers.
//
// What the design does about it: the TPU kernel holds a whole padded head in
// VMEM; here a block of 128 threads owns up to 128 query rows and streams the
// head's K and V through shared memory in tiles of 32 keys, with an online
// softmax (running max and sum, the accumulator rescaled when the max grows),
// so any Lk works and shared memory stays small. A thread holds its query's
// d values and its output row in registers (d up to 32; for d of 64 and 128,
// two or four neighbouring threads split the row and add their partial
// scores with warp shuffles); every key row is read from shared memory as
// float4 broadcasts. Where Lq is shorter than a block's query slots (the
// Sepformer's inter-chunk L = 34), a block takes several heads at once, so
// the slots stay busy; a warp with no live query skips the arithmetic. d is
// a template parameter padded to 16, 32, 64 or 128 with zeros in shared
// memory. The products run on the CUDA cores in float32 (TF32 would leave
// the plain version's rounding). Not done yet: tensor cores (mma/wgmma, in
// float32 only through 3xTF32 splitting), reading q, k and v straight from
// the in-projection's [B, L, 3E] output, and double-buffered tiles.
//
// Numerics: the arithmetic is written with fmaf and round-to-nearest
// intrinsics, so that both settings of quantize compute the same float heads
// bit for bit and the epilogue puts them on K1's grid exactly as
// act_fake_quant_ref does. The sums run in another order than cuBLAS's and the
// softmax is taken online, so the float heads agree with the plain version to
// a tolerance (about 1e-6 of their magnitude), not bit for bit. expf is the
// accurate exponential. Do not build with --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fake_quant.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBK = 32;                 // keys per shared-memory tile
constexpr int kMaxDim = 128;
constexpr int kSmemBudget = 48 * 1024;  // shared memory a block may take without an opt-in

template <int kDim>
struct Cfg {
  static constexpr int kTpq = kDim >= 32 ? kDim / 32 : 1;  // threads per query
  static constexpr int kDt = kDim / kTpq;                   // dims of a thread: 16 or 32
  static constexpr int kVecs = kDt / 4;                     // its float4 chunks
  static constexpr int kSlots = kThreads / kTpq;            // query slots of a block
  // floats per head tile; the pad starts the next head's rows on other banks
  static constexpr int kHeadStride = kBK * kDim + 4 * kTpq;
};

// A block owns heads [head0, head0 + hpb) (fewer at the end) and, of each, the
// queries [q0, q0 + qpb): blockIdx.x = (head group) * nqb + (query block).
template <int kDim>
__global__ void __launch_bounds__(kThreads) fused_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ mn_ptr, const float* __restrict__ mx_ptr, float* __restrict__ out, int64_t BH,
    int64_t Lq, int64_t Lk, int d, int hpb, int qpb, int64_t nqb, int quantize, int n_bits) {
  using C = Cfg<kDim>;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = smem + hpb * C::kHeadStride;

  const int64_t head0 = (blockIdx.x / nqb) * hpb;
  const int64_t q0 = (blockIdx.x % nqb) * qpb;
  const int nheads = static_cast<int>(BH - head0 < hpb ? BH - head0 : hpb);
  const int slot = threadIdx.x / C::kTpq;
  const int part = threadIdx.x % C::kTpq;
  const int hl = slot / qpb;
  const int64_t qi = q0 + slot % qpb;
  const bool active = hl < nheads && qi < Lq;
  const bool warp_active = __any_sync(0xffffffffu, active);
  const int hc = active ? hl : 0;  // the head whose tiles an idle thread reads

  // This thread's dims of its query: float4 chunks part, part + kTpq, ... of the padded row.
  float qv[C::kDt];
  {
    const float* qrow = q + ((head0 + hc) * Lq + (active ? qi : 0)) * d;
#pragma unroll
    for (int i = 0; i < C::kVecs; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * (part + C::kTpq * i) + e;
        qv[4 * i + e] = (active && c < d) ? qrow[c] : 0.0f;
      }
  }
  float o[C::kDt];
#pragma unroll
  for (int i = 0; i < C::kDt; ++i) o[i] = 0.0f;
  float m = -INFINITY, l = 0.0f;

  const int per_head = kBK * kDim;
  for (int64_t j0 = 0; j0 < Lk; j0 += kBK) {
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < nheads * per_head; e += kThreads) {
      const int h = e / per_head;
      const int r = e - h * per_head;
      const int jj = r / kDim;
      const int c = r % kDim;
      const int64_t j = j0 + jj;
      float kv = 0.0f, vv = 0.0f;
      if (j < Lk && c < d) {
        const int64_t g = ((head0 + h) * Lk + j) * d + c;
        kv = k[g];
        vv = v[g];
      }
      Ks[h * C::kHeadStride + jj * kDim + c] = kv;
      Vs[h * C::kHeadStride + jj * kDim + c] = vv;
    }
    __syncthreads();
    if (!warp_active) continue;  // warp-uniform: the shuffles below see all 32 lanes

    const float* kh = Ks + hc * C::kHeadStride;
    const float* vh = Vs + hc * C::kHeadStride;
    float s[kBK];
#pragma unroll
    for (int jj = 0; jj < kBK; ++jj) {
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < C::kVecs; ++i) {
        const float4 kk = *reinterpret_cast<const float4*>(kh + jj * kDim + 4 * (part + C::kTpq * i));
        acc = fmaf(qv[4 * i], kk.x, acc);
        acc = fmaf(qv[4 * i + 1], kk.y, acc);
        acc = fmaf(qv[4 * i + 2], kk.z, acc);
        acc = fmaf(qv[4 * i + 3], kk.w, acc);
      }
#pragma unroll
      for (int off = 1; off < C::kTpq; off <<= 1) acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
      s[jj] = j0 + jj < Lk ? acc : -INFINITY;
    }
    float tmax = s[0];
#pragma unroll
    for (int jj = 1; jj < kBK; ++jj) tmax = fmaxf(tmax, s[jj]);
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(__fsub_rn(m, m_new));  // 0 on the first tile (m = -inf)
    float psum = 0.0f;
#pragma unroll
    for (int jj = 0; jj < kBK; ++jj) {
      s[jj] = expf(__fsub_rn(s[jj], m_new));  // 0 for a key past Lk
      psum = __fadd_rn(psum, s[jj]);
    }
    l = __fadd_rn(__fmul_rn(l, alpha), psum);
#pragma unroll
    for (int i = 0; i < C::kDt; ++i) o[i] = __fmul_rn(o[i], alpha);
#pragma unroll
    for (int jj = 0; jj < kBK; ++jj) {
      const float p = s[jj];
#pragma unroll
      for (int i = 0; i < C::kVecs; ++i) {
        const float4 vv = *reinterpret_cast<const float4*>(vh + jj * kDim + 4 * (part + C::kTpq * i));
        o[4 * i] = fmaf(p, vv.x, o[4 * i]);
        o[4 * i + 1] = fmaf(p, vv.y, o[4 * i + 1]);
        o[4 * i + 2] = fmaf(p, vv.z, o[4 * i + 2]);
        o[4 * i + 3] = fmaf(p, vv.w, o[4 * i + 3]);
      }
    }
    m = m_new;
  }

  if (!active) return;
  float mn = 0.0f, delta = 1.0f;
  const float qmax = static_cast<float>((1 << n_bits) - 1);
  if (quantize) {
    mn = __ldg(mn_ptr);
    delta = fqss::act_grid_step(mn, __ldg(mx_ptr), qmax);
  }
  float* orow = out + ((head0 + hl) * Lq + qi) * d;
#pragma unroll
  for (int i = 0; i < C::kVecs; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * (part + C::kTpq * i) + e;
      if (c < d) {
        const float y = __fdiv_rn(o[4 * i + e], l);
        orow[c] = quantize ? fqss::act_grid_value(y, mn, delta, qmax) : y;
      }
    }
}

template <int kDim>
int launch(const float* q, const float* k, const float* v, const float* mn, const float* mx, float* out, int64_t BH,
           int64_t Lq, int64_t Lk, int d, int quantize, int n_bits, cudaStream_t st) {
  using C = Cfg<kDim>;
  constexpr int head_bytes = 2 * C::kHeadStride * static_cast<int>(sizeof(float));
  int hpb = 1, qpb = C::kSlots;
  int64_t nqb = (Lq + C::kSlots - 1) / C::kSlots;
  if (Lq < C::kSlots) {  // several whole heads a block
    int64_t fit = C::kSlots / Lq;
    if (fit > kSmemBudget / head_bytes) fit = kSmemBudget / head_bytes;
    if (fit > BH) fit = BH;
    hpb = fit < 1 ? 1 : static_cast<int>(fit);
    qpb = static_cast<int>(Lq);
    nqb = 1;
  }
  const int64_t blocks = (BH + hpb - 1) / hpb * nqb;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  fused_attention_kernel<kDim><<<static_cast<unsigned int>(blocks), kThreads, hpb * head_bytes, st>>>(
      q, k, v, mn, mx, out, BH, Lq, Lk, d, hpb, qpb, nqb, quantize, n_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The largest head width the kernel takes.
extern "C" int fqss_attention_max_dim() { return kMaxDim; }

// q, out: [BH, Lq, d]; k, v: [BH, Lk, d]; float32, contiguous, on the current
// device; Lk >= 1, d <= fqss_attention_max_dim(). mn, mx: one float each on the
// device, read only when quantize is set. Returns the launch's CUDA error code.
extern "C" int fqss_fused_attention(const float* q, const float* k, const float* v, const float* mn, const float* mx,
                                    float* out, int64_t BH, int64_t Lq, int64_t Lk, int d, int quantize, int n_bits,
                                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 16) return launch<16>(q, k, v, mn, mx, out, BH, Lq, Lk, d, quantize, n_bits, st);
  if (d <= 32) return launch<32>(q, k, v, mn, mx, out, BH, Lq, Lk, d, quantize, n_bits, st);
  if (d <= 64) return launch<64>(q, k, v, mn, mx, out, BH, Lq, Lk, d, quantize, n_bits, st);
  if (d <= kMaxDim) return launch<128>(q, k, v, mn, mx, out, BH, Lq, Lk, d, quantize, n_bits, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
