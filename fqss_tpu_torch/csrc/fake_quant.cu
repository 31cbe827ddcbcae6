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
//   weight_group_kernel       the same two TPU kernels for all of a model's weight
//   + weight_group_bwd_kernel quantizers in one launch each, with the module's
//                             one-shot observer and its where(observing, w, y)
//                             (fqss_tpu/quant/quantizers.py:219-256) inside: see
//                             "Grouped weight quantizers" below.
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

#include "fake_quant.cuh"

namespace {

using fqss::clip;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kMaxBlocks = 4096;

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
  const float delta = fqss::act_grid_step(mn, __ldg(mx_ptr), q);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    y[i] = fqss::act_grid_value(x[i], mn, delta, q);
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
    const float delta = fqss::weight_grid_step(__ldg(mn + c), __ldg(mx + c), q);
    y[i] = fqss::weight_grid_value(w[i], delta, qmin, qmax);
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

// ---------------------------------------------------------------------------
// Grouped weight quantizers
// ---------------------------------------------------------------------------
//
// weight_fake_quant_kernel and weight_bwd_kernel take one weight a launch, and a
// model holds 71-137 of them, most of 64-1024 elements a channel: each launch
// is over in a microsecond or two, and the host's work around it (the wrapper,
// the observer's min/max and where, the range copies) is what the card waits
// for. The grouped kernels take every weight quantizer of a model in one
// launch forward and one backward. A device-resident table (GroupEntry, built
// by ops/fake_quant.py:WeightGroup and rebuilt when a weight's storage, the
// device or the train()/eval() mode changes) holds each quantizer's weight and
// range pointers, its observer flag, its [outer, C, inner] view from ch_axis
// (so the conv, transposed-conv and LSTM layouts need no transpose) and its
// first block. A block finds its entry in a block -> entry map and takes 8
// channels (one a warp), 32 channels (one a lane, its 8 warps taking every
// eighth row, where the channel axis is the last: the LSTM's [C, 4H], whose
// rows are 512 floats apart, so a warp's loads stay coalesced) or one channel
// (one a block, for channels of 2048 elements or more: the decoders' single
// channel of 4096-16384), so the 29,506-75,778 channels of a model spread over
// the card.
//
// Each channel does the module's work (fqss_tpu/quant/quantizers.py:219-256):
// observing (its flag unset) in train() mode it takes the channel's min/max,
// writes them to the ranges and outputs w; observing in eval() mode it outputs
// w; otherwise it outputs K2's grid value (fqss::weight_grid_value, the device
// function K5 and the fold apply), bit for bit the per-tensor kernel's. It
// also writes the ranges it used and, for channel 0, the entry's flag into a
// scratch that the backward reads: the host copies nothing. Every channel
// reads the flag, so in train() mode a second one-block kernel sets it after
// the first has read it: no result depends on the order of the blocks.
//
// The backward takes the entries' incoming gradients as kernel parameters (a
// pointer and the [outer, C, inner] strides each: the attention's
// in-projection hands back a transposed one; a null pointer skips the entry),
// so a call copies nothing to the device either. Per channel it gives
// dw = g m and dd = sum g (C - m u) in a fixed order (a thread's elements in
// order, then a shuffle tree over the warp, then the block's warps in order:
// no atomics), routed to mn and mx as weight_bwd_kernel does; where the entry
// was observing, dw = g and the range gradients are 0. Bound: bytes, 8 a
// weight element forward and 12 backward, over 3.35 TB/s.

constexpr int kGroupThreads = 256;
constexpr int kGroupWarps = kGroupThreads / 32;
constexpr int kMaxGradEntries = 256;  // entries a backward launch takes; more take further launches

enum : int32_t { kWarpChannel = 0, kLaneChannel = 1, kBlockChannel = 2 };

// One weight quantizer (96 bytes; ops/fake_quant.py:WeightGroup packs it as 12 int64 words).
struct GroupEntry {
  const float* w;
  float* mn;  // per-channel ranges: C contiguous floats each
  float* mx;
  bool* observed;  // the one-shot observer's flag; nullptr without an observer
  int64_t out;     // offset of the entry's output (and dw) in the flat buffer
  int64_t ch0;     // offset of its channels in the flat per-channel scratch
  int64_t outer, channels, inner;
  int64_t block0;  // its first block
  int32_t kind, n_bits;
  int32_t writes;    // train(): the observer writes the ranges and the flag
  float dmax_scale;  // s * 2 / Q
};
static_assert(sizeof(GroupEntry) == 96, "GroupEntry must match ops/fake_quant.py:WeightGroup");

// The incoming gradients of the entries of one backward launch: a pointer (nullptr: no gradient) and the
// [outer, C, inner] strides in elements.
struct GradTable {
  const float* g[kMaxGradEntries];
  int64_t stride[kMaxGradEntries][3];
};

struct MinOp {
  __device__ float operator()(float a, float b) const { return (a != a || a < b) ? a : b; }  // keeps a NaN
};
struct MaxOp {
  __device__ float operator()(float a, float b) const { return (a != a || a > b) ? a : b; }
};
struct SumOp {
  __device__ float operator()(float a, float b) const { return __fadd_rn(a, b); }
};

// Element e (of outer * inner) of channel c in the [outer, C, inner] view of a contiguous weight.
__device__ __forceinline__ int64_t elem_index(const GroupEntry& E, int64_t c, int64_t e) {
  if (E.outer == 1) return c * E.inner + e;
  if (E.inner == 1) return e * E.channels + c;
  const int64_t o = e / E.inner;
  return (o * E.channels + c) * E.inner + (e - o * E.inner);
}

// The same element in a gradient with strides st.
__device__ __forceinline__ int64_t grad_index(const GroupEntry& E, const int64_t* st, int64_t c, int64_t e) {
  const int64_t o = E.inner == 1 ? e : e / E.inner;
  return o * st[0] + c * st[1] + (e - o * E.inner) * st[2];
}

// The channel this thread works on and how it walks the channel's elements.
struct ChannelWork {
  int64_t c;  // >= channels: nothing to do
  int start, step;
  bool leader;  // holds the reduced values and writes the channel's results
};

template <int Kind>
__device__ __forceinline__ ChannelWork channel_work(int64_t local_block) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (Kind == kWarpChannel) return {local_block * kGroupWarps + warp, lane, 32, lane == 0};
  if (Kind == kLaneChannel) return {local_block * 32 + lane, warp, kGroupWarps, warp == 0};
  return {local_block, static_cast<int>(threadIdx.x), kGroupThreads, threadIdx.x == 0};
}

// Reduce v over the threads that share a channel (a warp; the block; a lane of each warp) in a fixed order; the
// leader holds the result. Every thread of the warp (warp kind) or of the block (the others) must call it.
template <int Kind, typename Op>
__device__ __forceinline__ float channel_reduce(float v, Op op) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (Kind == kLaneChannel) {  // the 8 warps' partials of each lane's channel, summed in warp order
    __shared__ float column[kGroupWarps][32];
    __syncthreads();  // column may still be read by a previous call's leaders
    column[warp][lane] = v;
    __syncthreads();
    if (warp == 0) {
      for (int i = 1; i < kGroupWarps; ++i) v = op(v, column[i][lane]);
    }
    return v;
  }
  for (int off = 16; off > 0; off >>= 1) v = op(v, __shfl_down_sync(0xffffffffu, v, off));
  if (Kind == kBlockChannel) {
    __shared__ float partial[kGroupWarps];
    __syncthreads();  // partial may still be read by a previous call's leader
    if (lane == 0) partial[warp] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = 1; i < kGroupWarps; ++i) v = op(v, partial[i]);
    }
  }
  return v;
}

template <int Kind>
__device__ void group_forward(const GroupEntry& E, int64_t entry, int64_t local_block, float* __restrict__ out,
                              float* __restrict__ used_mn, float* __restrict__ used_mx, float* __restrict__ flags) {
  const ChannelWork cw = channel_work<Kind>(local_block);
  const bool active = cw.c < E.channels;
  if (Kind == kWarpChannel && !active) return;  // the whole warp, and the warp kind has no block-wide step
  // an idle lane (lane kind) walks no element but takes part in the reductions
  const int64_t c = active ? cw.c : 0, n = active ? E.outer * E.inner : 0;
  const bool leader = cw.leader && active;
  const float* __restrict__ w = E.w;
  float* __restrict__ y = out + E.out;
  const bool observing = E.observed != nullptr && !*E.observed;
  float mn_c, mx_c;
  if (observing) {
    float lo = __int_as_float(0x7f800000), hi = __int_as_float(0xff800000);  // +inf, -inf
#pragma unroll 4
    for (int64_t e = cw.start; e < n; e += cw.step) {
      const int64_t i = elem_index(E, c, e);
      const float v = w[i];
      y[i] = v;
      lo = MinOp()(lo, v);
      hi = MaxOp()(hi, v);
    }
    if (E.writes) {  // the same for every thread of the entry
      mn_c = channel_reduce<Kind>(lo, MinOp());
      mx_c = channel_reduce<Kind>(hi, MaxOp());
      if (leader) {
        E.mn[c] = mn_c;
        E.mx[c] = mx_c;
      }
    } else {
      mn_c = E.mn[c];
      mx_c = E.mx[c];
    }
  } else {
    mn_c = E.mn[c];
    mx_c = E.mx[c];
    const float q = static_cast<float>((1 << E.n_bits) - 1);
    const float qmin = -static_cast<float>(1 << (E.n_bits - 1));
    const float qmax = static_cast<float>((1 << (E.n_bits - 1)) - 1);
    const float delta = fqss::weight_grid_step(mn_c, mx_c, q);
#pragma unroll 4
    for (int64_t e = cw.start; e < n; e += cw.step) {
      const int64_t i = elem_index(E, c, e);
      y[i] = fqss::weight_grid_value(w[i], delta, qmin, qmax);
    }
  }
  if (leader) {
    used_mn[E.ch0 + c] = mn_c;
    used_mx[E.ch0 + c] = mx_c;
    if (c == 0) flags[entry] = observing ? 1.0f : 0.0f;
  }
}

__global__ void __launch_bounds__(kGroupThreads)
    weight_group_kernel(const GroupEntry* __restrict__ table, const int32_t* __restrict__ block_entry,
                        float* __restrict__ out, float* __restrict__ used_mn, float* __restrict__ used_mx,
                        float* __restrict__ flags) {
  const int64_t entry = block_entry[blockIdx.x];
  const GroupEntry E = table[entry];
  const int64_t local = blockIdx.x - E.block0;
  if (E.kind == kWarpChannel) {
    group_forward<kWarpChannel>(E, entry, local, out, used_mn, used_mx, flags);
  } else if (E.kind == kLaneChannel) {
    group_forward<kLaneChannel>(E, entry, local, out, used_mn, used_mx, flags);
  } else {
    group_forward<kBlockChannel>(E, entry, local, out, used_mn, used_mx, flags);
  }
}

// train(): every observer's flag is set, after weight_group_kernel has read them all.
__global__ void weight_group_flags_kernel(const GroupEntry* __restrict__ table, int64_t entries) {
  for (int64_t e = threadIdx.x; e < entries; e += blockDim.x) {
    if (table[e].writes && table[e].observed != nullptr) *table[e].observed = true;
  }
}

template <int Kind>
__device__ void group_backward(const GroupEntry& E, const float* __restrict__ g, const int64_t* st, int64_t entry,
                               int64_t local_block, const float* __restrict__ used_mn,
                               const float* __restrict__ used_mx, const float* __restrict__ flags,
                               float* __restrict__ dw_out, float* __restrict__ dmn, float* __restrict__ dmx) {
  const ChannelWork cw = channel_work<Kind>(local_block);
  const bool active = cw.c < E.channels;
  if (Kind == kWarpChannel && !active) return;
  const int64_t c = active ? cw.c : 0, n = active ? E.outer * E.inner : 0;
  const bool leader = cw.leader && active;
  float* __restrict__ dw = dw_out + E.out;
  if (flags[entry] != 0.0f) {  // observing (the whole entry): where(observing, w, y) gives g to w, 0 to the ranges
#pragma unroll 4
    for (int64_t e = cw.start; e < n; e += cw.step) dw[elem_index(E, c, e)] = g[grad_index(E, st, c, e)];
    if (leader) {
      dmn[E.ch0 + c] = 0.0f;
      dmx[E.ch0 + c] = 0.0f;
    }
    return;
  }
  const float* __restrict__ w = E.w;
  const float q = static_cast<float>((1 << E.n_bits) - 1);
  const float qmin = -static_cast<float>(1 << (E.n_bits - 1));
  const float qmax = static_cast<float>((1 << (E.n_bits - 1)) - 1);
  const float mn_c = used_mn[E.ch0 + c], mx_c = used_mx[E.ch0 + c];
  const float amn = fabsf(mn_c), amx = fabsf(mx_c);
  const float delta = __fdiv_rn(__fmul_rn(2.0f, fmaxf(amn, amx)), q);
  float dd = 0.0f;
#pragma unroll 4
  for (int64_t e = cw.start; e < n; e += cw.step) {
    const int64_t i = elem_index(E, c, e);
    const float u = __fdiv_rn(w[i], delta);
    const float X = rintf(u);
    const float m = tie_mask(X, qmin, qmax);
    const float gi = g[grad_index(E, st, c, e)];
    dw[i] = __fmul_rn(gi, m);
    dd = __fadd_rn(dd, __fmul_rn(gi, __fsub_rn(clip(X, qmin, qmax), __fmul_rn(m, u))));
  }
  dd = channel_reduce<Kind>(dd, SumOp());
  if (leader) {
    const float dmax = __fmul_rn(E.dmax_scale, dd);
    const float wmn = amn > amx ? 1.0f : (amn == amx ? 0.5f : 0.0f);
    const float wmx = amx > amn ? 1.0f : (amn == amx ? 0.5f : 0.0f);
    const float sign_mn = mn_c > 0.0f ? 1.0f : (mn_c < 0.0f ? -1.0f : 0.0f);
    const float sign_mx = mx_c > 0.0f ? 1.0f : (mx_c < 0.0f ? -1.0f : 0.0f);
    dmn[E.ch0 + c] = __fmul_rn(dmax, __fmul_rn(wmn, sign_mn));
    dmx[E.ch0 + c] = __fmul_rn(dmax, __fmul_rn(wmx, sign_mx));
  }
}

// Blocks [block_base, block_base + gridDim.x) of the entries [entry_base, entry_base + kMaxGradEntries).
__global__ void __launch_bounds__(kGroupThreads)
    weight_group_bwd_kernel(const GroupEntry* __restrict__ table, const int32_t* __restrict__ block_entry,
                            int64_t block_base, int64_t entry_base, const __grid_constant__ GradTable grads,
                            const float* __restrict__ used_mn, const float* __restrict__ used_mx,
                            const float* __restrict__ flags, float* __restrict__ dw, float* __restrict__ dmn,
                            float* __restrict__ dmx) {
  const int64_t block = block_base + blockIdx.x;
  const int64_t entry = block_entry[block];
  const float* g = grads.g[entry - entry_base];
  if (g == nullptr) return;  // no gradient reached this entry: the wrapper returns None for it
  const int64_t* st = grads.stride[entry - entry_base];
  const GroupEntry E = table[entry];
  const int64_t local = block - E.block0;
  if (E.kind == kWarpChannel) {
    group_backward<kWarpChannel>(E, g, st, entry, local, used_mn, used_mx, flags, dw, dmn, dmx);
  } else if (E.kind == kLaneChannel) {
    group_backward<kLaneChannel>(E, g, st, entry, local, used_mn, used_mx, flags, dw, dmn, dmx);
  } else {
    group_backward<kBlockChannel>(E, g, st, entry, local, used_mn, used_mx, flags, dw, dmn, dmx);
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

// The grouped weight fake-quant (weight_group_kernel) of the entries of a device-resident table: out holds every
// entry's output at its offset; used_mn, used_mx (one float per channel of all entries) and flags (one per entry)
// are the scratch the backward reads. flag_pass (train()): then set every observer's flag.
extern "C" int fqss_weight_group_fake_quant(const void* table, const int32_t* block_entry, int64_t entries,
                                            int64_t blocks, float* out, float* used_mn, float* used_mx, float* flags,
                                            int flag_pass, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const GroupEntry* t = static_cast<const GroupEntry*>(table);
  weight_group_kernel<<<static_cast<unsigned int>(blocks), kGroupThreads, 0, st>>>(t, block_entry, out, used_mn,
                                                                                   used_mx, flags);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !flag_pass) return static_cast<int>(err);
  weight_group_flags_kernel<<<1, kGroupThreads, 0, st>>>(t, entries);
  return static_cast<int>(cudaGetLastError());
}

// Its backward. block0: host array of entries + 1 block offsets (the last = all blocks); grads: host array of
// entries x 4 int64 (the gradient's address or 0, and its [outer, C, inner] strides in elements). dw, dmn, dmx:
// the flat buffers laid out as out, used_mn and used_mx; an entry without a gradient is left unwritten.
extern "C" int fqss_weight_group_fake_quant_bwd(const void* table, const int32_t* block_entry, int64_t entries,
                                                const int64_t* block0, const int64_t* grads, const float* used_mn,
                                                const float* used_mx, const float* flags, float* dw, float* dmn,
                                                float* dmx, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const GroupEntry* t = static_cast<const GroupEntry*>(table);
  for (int64_t e0 = 0; e0 < entries; e0 += kMaxGradEntries) {
    const int64_t e1 = e0 + kMaxGradEntries < entries ? e0 + kMaxGradEntries : entries;
    GradTable table_g;
    bool any = false;
    for (int64_t e = e0; e < e1; ++e) {
      table_g.g[e - e0] = reinterpret_cast<const float*>(grads[4 * e]);
      any = any || grads[4 * e] != 0;
      for (int k = 0; k < 3; ++k) table_g.stride[e - e0][k] = grads[4 * e + 1 + k];
    }
    if (!any) continue;
    weight_group_bwd_kernel<<<static_cast<unsigned int>(block0[e1] - block0[e0]), kGroupThreads, 0, st>>>(
        t, block_entry, block0[e0], e0, table_g, used_mn, used_mx, flags, dw, dmn, dmx);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
