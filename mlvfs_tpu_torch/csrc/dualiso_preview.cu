// Dual-ISO preview row transform, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mlvfs_tpu/ops/dualiso_preview_pallas.py:
// apply_preview_pallas and computes what mlvfs_tpu/ops/dualiso.py:
// apply_preview_xla computes (hdr_convert_data's per-row transform,
// hdr.c:185-224). Rows are walked top to bottom, because a row reads the
// already transformed row two above:
//   scale(p)   = min(white, fma(p - black, a, black) + b)
//   bright row ((y - drs + 4) % 4 >= 2): p >= white takes the mean of the
//              transformed row y-2 and source row y+2 (row y-2 alone at the
//              bottom, row y+2 alone at the top), else trunc(scale(p));
//   dark row:  p < shadow takes the mean of the transformed row y-2 and
//              scale(source row y+2) (same edge rules), else p;
//   out        = clip(., 0, 65535), then (u16 << 2) & 0xFFFF.
// Means are trunc((u + v) / 2); "top" is y <= 2, "bottom" y >= h-2, and row
// y+2 is clamped to h-1. Both carried rows start as source row 0.
// The float32 operations run in the order above with the roundings XLA gives
// the scan on the CPU: it contracts (p - black) * a + black into one fused
// multiply-add (one rounding, not two), and rounds every other operation on
// its own. The intrinsics (__fmaf_rn, __fadd_rn, ...) pin exactly that, so
// nvcc can neither contract nor split anything else.
//
// What bounds it on an H100: bytes. At 1920x1080, B=16 the frames are
// 66.4 MB in and 66.4 MB out (about 40 us at 3.35 TB/s) for some 20 float
// operations a pixel. The design follows the sequential-down-rows,
// parallel-over-columns shape of the recurrence: one thread per (frame,
// column) walks the rows, carrying the transformed rows y-2 and y-1 and the
// source rows y+1 and y+2 in registers, so each source pixel is read once
// and each output pixel written once; adjacent threads take adjacent
// columns, so each warp's loads and stores are contiguous 64-byte runs. At
// 1080p/B=16 that is 30,720 threads, a quarter of the card's resident
// threads, each with a 1080-step dependent chain; making it faster (more
// loads in flight per thread) is later work. The TPU kernel's (H, B, W)
// transpose, 128-row chunks and look-ahead view were TPU tiling and have no
// counterpart here.
//
// Plain C interface, loaded with ctypes (mlvfs_tpu_torch/_build.py). The
// kernel launches on the caller's stream, allocates nothing and does not
// synchronise; the return value is cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;  // columns per block

__device__ __forceinline__ float scale(float p, float a, float b, float black, float white) {
  return fminf(white, __fadd_rn(__fmaf_rn(__fsub_rn(p, black), a, black), b));
}

__device__ __forceinline__ float half_sum(float u, float v) {
  return truncf(__fdiv_rn(__fadd_rn(u, v), 2.0f));
}

__global__ void __launch_bounds__(THREADS)
    preview_kernel(const uint16_t* src, uint16_t* dst, const float* a, const float* b,
                   const float* shadow, const int* drs, int h, int w, float black, float white) {
  const int x = blockIdx.x * THREADS + threadIdx.x;
  if (x >= w) {
    return;
  }
  const long long f = blockIdx.y;
  const uint16_t* s = src + f * h * (long long)w + x;
  uint16_t* o = dst + f * h * (long long)w + x;
  const float af = a[f];
  const float bf = b[f];
  const float sf = shadow[f];
  const int phase = drs[f];

  float cur = s[0];                                // source row y
  float nxt = s[(long long)min(1, h - 1) * w];     // source row y+1
  float prev2 = cur;                               // transformed row y-2
  float prev1 = cur;                               // transformed row y-1
  for (int y = 0; y < h; ++y) {
    const float row = cur;
    const float below = s[(long long)min(y + 2, h - 1) * w];
    const bool up_ok = y > 2;
    const bool down_ok = y < h - 2;
    const bool bright = ((((y - phase + 4) % 4) + 4) % 4) >= 2;
    float out;
    if (bright) {
      if (row >= white) {
        out = up_ok ? (down_ok ? half_sum(prev2, below) : prev2) : below;
      } else {
        out = truncf(scale(row, af, bf, black, white));
      }
    } else if (row < sf) {
      const float scaled_below = scale(below, af, bf, black, white);
      out = up_ok ? (down_ok ? half_sum(prev2, scaled_below) : prev2) : truncf(scaled_below);
    } else {
      out = row;
    }
    out = fminf(fmaxf(out, 0.0f), 65535.0f);
    o[(long long)y * w] = (uint16_t)(((unsigned)out << 2) & 0xFFFFu);
    prev2 = prev1;
    prev1 = out;
    cur = nxt;
    nxt = below;
  }
}

}  // namespace

// imgs, out: (batch, height, width) u16, contiguous on the device; a, b,
// shadow: float32[batch]; dark_row_start: int32[batch]. Returns a cudaError_t
// as int (0 = launched).
extern "C" int mlvfs_dualiso_preview(const void* imgs, void* out, const void* a, const void* b,
                                     const void* shadow, const void* dark_row_start,
                                     long long batch, long long height, long long width,
                                     int black, int white, void* stream) {
  if (batch < 0 || batch > 65535 || height < 0 || width < 0 || height > (1 << 20) ||
      width > (1 << 24)) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0 || height == 0 || width == 0) {
    return 0;
  }
  const int w = (int)width;
  dim3 grid((w + THREADS - 1) / THREADS, (unsigned)batch);
  preview_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)imgs, (uint16_t*)out, (const float*)a, (const float*)b,
      (const float*)shadow, (const int*)dark_row_start, (int)height, w, (float)black,
      (float)white);
  return (int)cudaGetLastError();
}
