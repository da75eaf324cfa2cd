// Dual-ISO edge scorer and directional pick, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mlvfs_tpu/ops/amaze_edge_pallas.py: edge_pick
// and computes what mlvfs_tpu/ops/amaze.py: edge_pick_xla computes (and
// mlvfs_tpu_torch/ops/amaze_edge.py: edge_pick_plain repeats) on a batch of
// int32 EV planes, every tap outside the frame reading 0:
//   * row class k of a pixel in row y is the grayscale EV row y + s_y * k
//     (s_y = +1 or -1, the row sign), k in {2, 1, -2, -3};
//   * direction d (EDGE_DIRECTIONS: taps (dx, k) ack, a, b, bck) scores
//     sum_{j=-5..5} |P1 - P2| + |P2 - P3| + |P3 - P4| at column x + j, plus
//     |d - 6| * 32768 / 8; the first least score wins;
//   * where the pixel is restricted or outside 5 <= y < h-5, 5 <= x < w-5,
//     the direction is 6 (vertical) and nothing is scored (the reference's
//     box filter by doubled partial sums equals this direct sum inside that
//     window, and its scores are discarded outside);
//   * val(d) = (EW_a[y, x + a.dx] * 2 + EW_b[y, x + b.dx]) / 3 and the output
//     (2 val(d) + val(min(d+1, 11)) + val(max(d-1, 0))) / 4, C division
//     (truncating), as the reference's int32 arithmetic.
//
// What bounds it on an H100: bytes are 4 B each of evgray, EW_a, EW_b and
// the output and 1 B of the restricted map a pixel (0.17 ms for a 1080p batch
// of 16 at 3.35 TB/s); the operations, counted in the reference's form (the
// box sum by doubled partial sums), are some 230 int32 operations a scored
// pixel, about 0.45 ms at the card's int32 rate when most pixels are scored:
// the operations bound it.
//
// Design: one block per 128-pixel segment of one row of one frame. The four
// grayscale rows the segment's row classes read are loaded once into shared
// memory with a 14-pixel apron (|dx| <= 9 plus the window's 5), zero outside
// the frame; each thread then scores its pixel's 12 directions from shared
// memory (12 x 11 x 4 taps), keeping the running least in registers, and
// reads its three EW_a/EW_b tap pairs from device memory. The TPU kernel's
// 256-row chunks with 8-row zero aprons and its pltpu.roll taps were TPU
// tiling and have no counterpart here. Sharing the taps' differences between
// neighbouring pixels (the doubled partial sums) is later work.
//
// Plain C interface, loaded with ctypes (mlvfs_tpu_torch/_build.py). The
// kernel launches on the caller's stream, allocates nothing and does not
// synchronise; the return value is cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SEG = 128;   // pixels of a row per block
constexpr int HALO = 14;   // max |dx| of a tap (9) + the window (5)
constexpr int ROW = SEG + 2 * HALO;
constexpr int ND = 12;
constexpr int DIR0 = ND / 2;
constexpr int EV_RESOLUTION = 32768;

// EDGE_DIRECTIONS (hdr.c:916-938): dx of the taps ack, a, b, bck; their row
// classes are always 2, 1, -2, -3 (rows held in shared memory in that order)
__constant__ int TAP_DX[ND][4] = {
    {-4, -2, 4, 6}, {-3, -1, 3, 4}, {-2, -1, 2, 3}, {-1, -1, 1, 2},
    {-1, 0, 1, 1},  {0, 0, 0, 0},   {1, 0, -1, -1}, {1, 1, -1, -2},
    {2, 1, -2, -3}, {3, 1, -3, -4}, {4, 2, -4, -6}, {6, 3, -6, -9},
};

__global__ void __launch_bounds__(SEG)
    edge_pick_kernel(const int* __restrict__ evgray, const int* __restrict__ ewa,
                     const int* __restrict__ ewb, const int* __restrict__ sgn,
                     const uint8_t* __restrict__ restricted, int* __restrict__ out, int h, int w) {
  __shared__ int rows[4][ROW];
  const int x0 = blockIdx.x * SEG, y = blockIdx.y;
  const long long fo = (long long)blockIdx.z * h * w;
  // row class k > 0 reads y + k where the sign is 1, else y - k; class
  // k < 0 (the sign negated) reads y + |k| where the sign is -1, else y - |k|
  const int sv = sgn[(long long)blockIdx.z * h + y];
  const int ys[4] = {sv == 1 ? y + 2 : y - 2, sv == 1 ? y + 1 : y - 1,
                     sv == -1 ? y + 2 : y - 2, sv == -1 ? y + 3 : y - 3};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int ry = ys[k];
    for (int i = threadIdx.x; i < ROW; i += SEG) {
      const int gx = x0 - HALO + i;
      rows[k][i] = (ry >= 0 && ry < h && gx >= 0 && gx < w) ? evgray[fo + (long long)ry * w + gx] : 0;
    }
  }
  __syncthreads();
  const int x = x0 + threadIdx.x;
  if (x >= w) {
    return;
  }
  const long long p = fo + (long long)y * w + x;
  int dbest = DIR0;
  const bool window = y >= 5 && y < h - 5 && x >= 5 && x < w - 5;
  if (window && !restricted[p]) {
    const int lx = threadIdx.x + HALO;
    int best = 0;
    for (int d = 0; d < ND; ++d) {
      const int a0 = TAP_DX[d][0], a1 = TAP_DX[d][1], a2 = TAP_DX[d][2], a3 = TAP_DX[d][3];
      int score = 0;
#pragma unroll
      for (int j = -5; j <= 5; ++j) {
        const int p1 = rows[0][lx + j + a0], p2 = rows[1][lx + j + a1];
        const int p3 = rows[2][lx + j + a2], p4 = rows[3][lx + j + a3];
        score += abs(p1 - p2) + abs(p2 - p3) + abs(p3 - p4);
      }
      score += abs(d - DIR0) * EV_RESOLUTION / 8;
      if (d == 0 || score < best) {
        best = score;
        dbest = d;
      }
    }
  }
  auto val = [&](int d) {
    const int xa = x + TAP_DX[d][1], xb = x + TAP_DX[d][2];
    const int ea = (xa >= 0 && xa < w) ? ewa[p + TAP_DX[d][1]] : 0;
    const int eb = (xb >= 0 && xb < w) ? ewb[p + TAP_DX[d][2]] : 0;
    return (ea * 2 + eb) / 3;
  };
  out[p] = (2 * val(dbest) + val(min(dbest + 1, ND - 1)) + val(max(dbest - 1, 0))) / 4;
}

}  // namespace

// evgray, ewa, ewb, out: int32 (batch, height, width) contiguous; sgn: int32
// (batch, height); restricted: bool as uint8 (batch, height, width).
// Returns a cudaError_t as int (0 = launched).
extern "C" int mlvfs_amaze_edge_pick(const void* evgray, const void* ewa, const void* ewb,
                                     const void* sgn, const void* restricted, void* out,
                                     long long batch, long long height, long long width,
                                     void* stream) {
  if (batch < 0 || batch > 65535 || height < 0 || height > 65535 || width < 0 ||
      width > (1 << 24)) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0 || height == 0 || width == 0) {
    return 0;
  }
  dim3 grid((unsigned)((width + SEG - 1) / SEG), (unsigned)height, (unsigned)batch);
  edge_pick_kernel<<<grid, SEG, 0, (cudaStream_t)stream>>>(
      (const int*)evgray, (const int*)ewa, (const int*)ewb, (const int*)sgn,
      (const uint8_t*)restricted, (int*)out, (int)height, (int)width);
  return (int)cudaGetLastError();
}
