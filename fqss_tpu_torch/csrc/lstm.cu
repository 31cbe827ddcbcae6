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
// The static route (both kernels, as templates on kMode in csrc/lstm.cuh; its quantized launch is exported from
// csrc/lstm_static.cu): the port's own, as JAX runs its static cell as a lax.scan (fqss_tpu/nn/lstm.py:108-176).
// The cell of QLSTM(mode="static") with its 12 quantizer sites per direction, in _cell_step's order
// (fqss_tpu/nn/lstm.py:40-60), each a per-tensor uniform grid from the direction's (site_min, site_max) through
// K1's device functions (fake_quant.cuh):
//                           a = q2(q0(ih_d[t, b]) + q1(h @ W_d))   (h @ W_d summed from zero, then quantized)
//                           i, f, g, o = q3(sigmoid(a_i)), q4(sigmoid(a_f)), q5(tanh(a_g)), q6(sigmoid(a_o))
//                           c = q9(q7(f * c) + q8(i * g)),  h = q11(o * q10(tanh(c)))
// The observer window is a launch of its own (kObserve): the float cell, as the fused route computes it, whose
// warps write each step's min and max of every site over their rows and units to stats [T, partials, 12, 2]; the
// wrapper reduces them and runs the 0.9/0.1 EMA on the device, then launches the quantized cell (kStatic) for the
// steps after the window from the observed launch's last h (h0) and c (c0, written to c_last). The grids live in
// shared memory; the state in and out (h0, c0, c_last) is [B, H], zero where no h0/c0 is given.
//
// Numerics (both kernels): the product sums k = 0 .. H-1 in order with fused
// multiply-adds from 0 and adds ih afterwards, as ih_t + h @ w_hh groups it;
// the gates use expf/tanhf (no fast math) and round-to-nearest intrinsics, so
// that nvcc contracts nothing into an FMA there. The two kernels therefore
// compute the same values bit for bit. cuBLAS sums the plain version's
// product in another order, and PyTorch's transcendentals may differ by an
// ulp, so kernel and plain version agree to a tolerance, not bit for bit. Do
// not build with --use_fast_math.

#include "lstm.cuh"

// Largest H the blocks route takes: h (two buffers) and c of a block's 16 rows in 227 KB of shared memory (with the
// static route's 96 bytes of grids).
extern "C" int fqss_lstm_max_hidden() {
  return static_cast<int>((kSmemBytes - 2 * kSites * sizeof(float)) / (3 * kTile * sizeof(float)));
}

// The blocks route. dirs = 1: ih0, w0 -> out0 (K6); dirs = 2: also ih1, w1 -> out1 in the same launch (K7).
// ih: [T, B, 4H], w: [H, 4H], out: [T, B, H], float32, contiguous, on the current device;
// T, B >= 1 and 1 <= H <= fqss_lstm_max_hidden(). Returns the launch's CUDA error code.
extern "C" int fqss_lstm_recurrence(const float* ih0, const float* w0, float* out0, const float* ih1, const float* w1,
                                    float* out1, int dirs, int64_t T, int64_t B, int64_t H, void* stream) {
  const Direction d0{ih0, w0, out0};
  const Direction d1{ih1, w1, out1};
  return blocks_checked<kFused>(d0, d1, dirs, T, B, H, 0.0f, static_cast<cudaStream_t>(stream));
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
  return cluster_checked<kFused>(d0, d1, dirs, T, B, H, cluster, rows, 0.0f, static_cast<cudaStream_t>(stream),
                                 nullptr);
}

// How many clusters of the cluster route at (H, cluster, rows) fit co-resident on the current device
// (cudaOccupancyMaxActiveClusters), into *out; mode 0 the fused kernel, 1 the static route's observing launch (2, its
// quantized one: fqss_lstm_static_max_active). Returns the CUDA error code.
extern "C" int fqss_lstm_cluster_max_active(int64_t H, int cluster, int rows, int mode, int* out) {
  *out = 0;
  const Direction none{nullptr, nullptr, nullptr};
  switch (mode) {
    case kFused: return cluster_checked<kFused>(none, none, 1, 1, 1, H, cluster, rows, 0.0f, nullptr, out);
    case kObserve: return cluster_checked<kObserve>(none, none, 1, 1, 1, H, cluster, rows, 0.0f, nullptr, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The static route's observing launch (kObserve): the float cell over the observer window's steps. ptrs: 9 device
// pointers a direction (ih, w, out, h0, c0, c_last, site_min, site_max, stats; h0, c0, c_last may be 0; the ranges
// are not read), for `dirs` directions; each warp writes the min and max of every site at every step to stats
// [T, partials, 12, 2], partials = 8 x the CTAs of a direction. cluster > 0 takes the cluster route with `rows` rows
// a cluster (8 to 32), cluster 0 the blocks route. Returns the launch's CUDA error code.
extern "C" int fqss_lstm_observe(const int64_t* ptrs, int dirs, int64_t T, int64_t B, int64_t H, int cluster, int rows,
                                 void* stream) {
  const Direction d0 = direction_of(ptrs);
  const Direction d1 = direction_of(ptrs + (dirs > 1 ? 9 : 0));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return cluster > 0 ? cluster_checked<kObserve>(d0, d1, dirs, T, B, H, cluster, rows, 0.0f, st, nullptr)
                     : blocks_checked<kObserve>(d0, d1, dirs, T, B, H, 0.0f, st);
}

