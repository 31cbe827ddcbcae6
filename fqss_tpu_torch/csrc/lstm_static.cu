// The static route's quantized launch of the LSTM recurrence (K7/K6, csrc/lstm.cu): the cell of QLSTM(mode="static")
// on the 12 sites' grids, lstm_cluster_kernel and lstm_blocks_kernel of csrc/lstm.cuh instantiated with kStatic (a
// source of its own so that nvcc compiles it beside csrc/lstm.cu). The design, the sites and the numerics are set out
// in csrc/lstm.cu.

#include "lstm.cuh"

// ptrs: 9 device pointers a direction (ih, w, out, h0, c0, c_last, site_min, site_max, stats; h0, c0, c_last may be
// 0; stats is not written), for `dirs` directions: the quantized cell on n_bits-bit grids from site_min/site_max
// [12], from h0/c0 (zero if 0), c after the last step into c_last (if not 0). cluster > 0 takes the cluster route
// with `rows` rows a cluster (as fqss_lstm_cluster), cluster 0 the blocks route. Returns the launch's CUDA error
// code.
extern "C" int fqss_lstm_static(const int64_t* ptrs, int dirs, int64_t T, int64_t B, int64_t H, int cluster, int rows,
                                int n_bits, void* stream) {
  if (n_bits < 1 || n_bits > 16) return static_cast<int>(cudaErrorInvalidValue);
  const Direction d0 = direction_of(ptrs);
  const Direction d1 = direction_of(ptrs + (dirs > 1 ? 9 : 0));
  const float levels = static_cast<float>((1 << n_bits) - 1);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return cluster > 0 ? cluster_checked<kStatic>(d0, d1, dirs, T, B, H, cluster, rows, levels, st, nullptr)
                     : blocks_checked<kStatic>(d0, d1, dirs, T, B, H, levels, st);
}

// How many clusters of the static route's quantized launch at (H, cluster, rows) fit co-resident on the current
// device (cudaOccupancyMaxActiveClusters), into *out. Returns the CUDA error code.
extern "C" int fqss_lstm_static_max_active(int64_t H, int cluster, int rows, int* out) {
  *out = 0;
  const Direction none{nullptr, nullptr, nullptr};
  return cluster_checked<kStatic>(none, none, 1, 1, 1, H, cluster, rows, 0.0f, nullptr, out);
}
