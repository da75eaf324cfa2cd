// The dual-ISO exposure fit's scoring of its candidate gains, hand-written
// for Hopper (sm_90a).
//
// Replaces no Pallas kernel: mlvfs_tpu/ops/dualiso_analysis_dev.py's
// match_exposures scores its 3000 candidate gains in plain XLA. Its twin is
// mlvfs_tpu_torch/ops/dualiso_analysis_dev.py: fit_scores_plain. For each
// frame b and candidate i (gain a[i], offset bc[b, i]):
//   scores[b, i] = #{j : valid[b, j] and |trunc(hd[b, j] - fma(hb[b, j], a[i], bc[b, i]))| < 50}
// over the frame's highlight pairs (hb, hd), hi_nmax of them (~4,600 at
// 1080p). The twin runs a (3000, hi_nmax) fma, subtract, trunc, abs,
// compare, mask and sum a frame, some 7 launches over 55-MB temporaries
// each frame: 5.4 ms a 1080p batch of 16 on the card, half of the analysis'
// device time (PERF.md section 6). Each float32 operation here is rounded
// as the twin's on the card: __fmaf_rn where it calls evmath.fma, the
// subtract on its own (-fmad=false, _build.EXTRA_FLAGS).
//
// Entry (plain C, loaded with ctypes by mlvfs_tpu_torch/_build.py; launches
// on the caller's stream, allocates nothing, does not synchronise, returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments it does not take):
//   mlvfs_fit_scores  scores (B, C) int64 from hb, hd (B, N) float32, valid
//                     (B, N) bool, a (C,) and bc (B, C) float32, contiguous
//
// What bounds it on an H100: operations. B * C * N evaluations (222 M at
// 1080p, B = 16) of about 7 operations each: 0.023 ms at 67 TFLOP/s; the
// bytes (the pairs, 9 B each, and the candidates) are a few hundred KB. A
// thread takes a candidate of a frame (a block 256 candidates of one
// frame) and walks the frame's pairs, staged in shared memory a tile at a
// time, every thread reading the same pair (a broadcast); an invalid pair is
// staged with hd = NaN, which no comparison counts.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 2048;  // pairs staged a round: 16 KB of shared memory

__global__ void __launch_bounds__(THREADS)
    scores_kernel(long long* __restrict__ scores, const float* __restrict__ hb,
                  const float* __restrict__ hd, const bool* __restrict__ valid,
                  const float* __restrict__ a, const float* __restrict__ bc, int n_cand, int n) {
  __shared__ float s_hb[TILE], s_hd[TILE];
  const int b = blockIdx.y;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const float ai = i < n_cand ? a[i] : 0.0f;
  const float bi = i < n_cand ? bc[static_cast<long long>(b) * n_cand + i] : 0.0f;
  const long long row = static_cast<long long>(b) * n;
  int count = 0;
  for (int j0 = 0; j0 < n; j0 += TILE) {
    const int m = min(TILE, n - j0);
    __syncthreads();
    for (int k = threadIdx.x; k < m; k += THREADS) {
      s_hb[k] = hb[row + j0 + k];
      s_hd[k] = valid[row + j0 + k] ? hd[row + j0 + k] : __int_as_float(0x7fc00000);
    }
    __syncthreads();
    for (int k = 0; k < m; ++k) {
      const float e = __fsub_rn(s_hd[k], __fmaf_rn(s_hb[k], ai, bi));
      count += fabsf(truncf(e)) < 50.0f;
    }
  }
  if (i < n_cand) {
    scores[static_cast<long long>(b) * n_cand + i] = count;
  }
}

}  // namespace

extern "C" int mlvfs_fit_scores(void* scores, const void* hb, const void* hd, const void* valid,
                                const void* a, const void* bc, long long batch, long long n_cand,
                                long long n, void* stream) {
  if (batch < 0 || batch > 65535 || n_cand < 0 || n_cand > (1 << 24) || n < 0 || n > (1 << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || n_cand == 0) {
    return 0;
  }
  // without pairs (n == 0) the pair pointers are not read: every score is 0
  if (scores == nullptr || a == nullptr || bc == nullptr ||
      (n > 0 && (hb == nullptr || hd == nullptr || valid == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((n_cand + THREADS - 1) / THREADS), static_cast<unsigned>(batch));
  scores_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(scores), static_cast<const float*>(hb), static_cast<const float*>(hd),
      static_cast<const bool*>(valid), static_cast<const float*>(a), static_cast<const float*>(bc),
      static_cast<int>(n_cand), static_cast<int>(n));
  return static_cast<int>(cudaGetLastError());
}
