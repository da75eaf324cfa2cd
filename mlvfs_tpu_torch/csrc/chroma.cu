// Chroma smoothing (2x2 / 3x3 / 5x5) of u16 Bayer frames, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mlvfs_tpu/ops/chroma_pallas.py:
// chroma_smooth_pallas and computes what mlvfs_tpu/ops/chroma_smooth.py:
// chroma_smooth_image computes (chroma_smooth.c template, cs.c:37-47). For
// every 2x2 cell (R G1 / G2 B) with top-left (4 + 2cy, 4 + 2cx), cy < ny,
// cx < nx (the window [4, w-4) x [4, h-5)):
//   ge     = (E(G1) + E(G2)) / 2 of the cell itself, in EV (E = raw->EV table);
//   dr, db = medians over the K = 5/9/25 neighbour cells of E(R) - gen and
//            E(B) - gen, gen being that neighbour's own green mean;
//   unless ge < 2 EVR or ge + dr <= EVR or ge + db <= EVR, the R and B sites
//   become ev2raw(clip(ge + d, 0, 14 EVR - 1)) + black.
// Every other pixel is copied. Arithmetic is C int32: adds wrap (done in
// uint32, since signed overflow is undefined in C++), "/ 2" truncates, and
// E(black) is INT_MIN, so the sums at black pixels wrap as on the reference.
//
// What bounds it on an H100: at 1920x1080, B=16 the frames are 66.4 MB in and
// 66.4 MB out (about 40 us at 3.35 TB/s, the H100 SXM data-sheet rate at
// 700 W), and the 5x5 medians take some 400 integer operations a cell, so
// 3x3 and 5x5 are bound by integer issue rather than bytes. The design keeps the work per cell to the minimum:
//   - a block owns a tile of 32 x 8 cells. It first computes, once per cell of
//     the tile and its apron (1 cell for 2x2/3x3, 2 for 5x5), the chroma
//     differences q_r = E(R) - gen and q_b = E(B) - gen and the green mean
//     into shared memory (four table lookups a cell);
//   - each thread then reads its K neighbours' q from shared memory and runs
//     two Devillard median-selection networks in registers (7/19/99
//     compare-exchanges, the tables of mlvfs_tpu_torch/ops/medians.py; the
//     comparators that cannot reach the median are dead code after
//     unrolling);
//   - the raw->EV table (256 KiB) and the EV->raw table (1.75 MiB) are read
//     through __ldg and stay in L2.
// The window keeps every neighbour read inside the frame (the wrapper refuses
// 5x5 at an odd width, where the reference's own slices would overrun), so no
// apron padding exists in memory. The TPU kernel's 216-row chunks, 8-row
// apron and lane rolls were TPU tiling and have no counterpart here.
//
// Plain C interface, loaded with ctypes (mlvfs_tpu_torch/_build.py). The
// kernel launches on the caller's stream, allocates nothing and does not
// synchronise; the return value is cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int EVR = 32768;  // EV_RESOLUTION, mlvfs.h:87
constexpr int TX = 32;      // cells per tile row (one warp)
constexpr int TY = 8;       // cell rows per tile

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((uint32_t)a - (uint32_t)b);
}

#define PIX_SORT(a, b)                  \
  {                                     \
    const int lo_ = min(v[a], v[b]);    \
    const int hi_ = max(v[a], v[b]);    \
    v[a] = lo_;                         \
    v[b] = hi_;                         \
  }

// Devillard 1998 median-selection networks; the median lands in v[K / 2].
template <int K>
__device__ __forceinline__ int median(int* v);

template <>
__device__ __forceinline__ int median<5>(int* v) {
  PIX_SORT(0, 1) PIX_SORT(3, 4) PIX_SORT(0, 3) PIX_SORT(1, 4) PIX_SORT(1, 2)
  PIX_SORT(2, 3) PIX_SORT(1, 2)
  return v[2];
}

template <>
__device__ __forceinline__ int median<9>(int* v) {
  PIX_SORT(1, 2) PIX_SORT(4, 5) PIX_SORT(7, 8) PIX_SORT(0, 1) PIX_SORT(3, 4)
  PIX_SORT(6, 7) PIX_SORT(1, 2) PIX_SORT(4, 5) PIX_SORT(7, 8) PIX_SORT(0, 3)
  PIX_SORT(5, 8) PIX_SORT(4, 7) PIX_SORT(3, 6) PIX_SORT(1, 4) PIX_SORT(2, 5)
  PIX_SORT(4, 7) PIX_SORT(4, 2) PIX_SORT(6, 4) PIX_SORT(4, 2)
  return v[4];
}

template <>
__device__ __forceinline__ int median<25>(int* v) {
  PIX_SORT(0, 1) PIX_SORT(3, 4) PIX_SORT(2, 4) PIX_SORT(2, 3) PIX_SORT(6, 7)
  PIX_SORT(5, 7) PIX_SORT(5, 6) PIX_SORT(9, 10) PIX_SORT(8, 10) PIX_SORT(8, 9)
  PIX_SORT(12, 13) PIX_SORT(11, 13) PIX_SORT(11, 12) PIX_SORT(15, 16)
  PIX_SORT(14, 16) PIX_SORT(14, 15) PIX_SORT(18, 19) PIX_SORT(17, 19)
  PIX_SORT(17, 18) PIX_SORT(21, 22) PIX_SORT(20, 22) PIX_SORT(20, 21)
  PIX_SORT(23, 24) PIX_SORT(2, 5) PIX_SORT(3, 6) PIX_SORT(0, 6) PIX_SORT(0, 3)
  PIX_SORT(4, 7) PIX_SORT(1, 7) PIX_SORT(1, 4) PIX_SORT(11, 14) PIX_SORT(8, 14)
  PIX_SORT(8, 11) PIX_SORT(12, 15) PIX_SORT(9, 15) PIX_SORT(9, 12)
  PIX_SORT(13, 16) PIX_SORT(10, 16) PIX_SORT(10, 13) PIX_SORT(20, 23)
  PIX_SORT(17, 23) PIX_SORT(17, 20) PIX_SORT(21, 24) PIX_SORT(18, 24)
  PIX_SORT(18, 21) PIX_SORT(19, 22) PIX_SORT(8, 17) PIX_SORT(9, 18)
  PIX_SORT(0, 18) PIX_SORT(0, 9) PIX_SORT(10, 19) PIX_SORT(1, 19)
  PIX_SORT(1, 10) PIX_SORT(11, 20) PIX_SORT(2, 20) PIX_SORT(2, 11)
  PIX_SORT(12, 21) PIX_SORT(3, 21) PIX_SORT(3, 12) PIX_SORT(13, 22)
  PIX_SORT(4, 22) PIX_SORT(4, 13) PIX_SORT(14, 23) PIX_SORT(5, 23)
  PIX_SORT(5, 14) PIX_SORT(15, 24) PIX_SORT(6, 24) PIX_SORT(6, 15)
  PIX_SORT(7, 16) PIX_SORT(7, 19) PIX_SORT(13, 21) PIX_SORT(15, 23)
  PIX_SORT(7, 13) PIX_SORT(7, 15) PIX_SORT(1, 9) PIX_SORT(3, 11)
  PIX_SORT(5, 17) PIX_SORT(11, 17) PIX_SORT(9, 17) PIX_SORT(4, 10)
  PIX_SORT(6, 12) PIX_SORT(7, 14) PIX_SORT(4, 6) PIX_SORT(4, 7)
  PIX_SORT(12, 14) PIX_SORT(10, 14) PIX_SORT(6, 7) PIX_SORT(10, 12)
  PIX_SORT(6, 10) PIX_SORT(6, 17) PIX_SORT(12, 17) PIX_SORT(7, 17)
  PIX_SORT(7, 10) PIX_SORT(12, 18) PIX_SORT(7, 12) PIX_SORT(10, 18)
  PIX_SORT(12, 20) PIX_SORT(10, 20) PIX_SORT(10, 12)
  return v[12];
}

#undef PIX_SORT

// Cells of the frame are indexed on the 2x2 grid from pixel (0, 0): grid cell
// (gy, gx) holds pixels (2gy .. 2gy+1, 2gx .. 2gx+1). Window cell (cy, cx) is
// grid cell (cy + 2, cx + 2).
template <int METHOD>
__global__ void __launch_bounds__(TX * TY)
chroma_kernel(const uint16_t* __restrict__ imgs, uint16_t* __restrict__ out,
              const int* __restrict__ raw2ev, const int* __restrict__ ev2raw,
              int h, int w, int ny, int nx, int black) {
  constexpr int R = METHOD == 5 ? 2 : 1;  // reach in cells
  constexpr int K = METHOD == 5 ? 25 : METHOD == 3 ? 9 : 5;
  constexpr int SW = TX + 2 * R;
  constexpr int SH = TY + 2 * R;
  __shared__ int q_r[SH][SW];
  __shared__ int q_b[SH][SW];
  __shared__ int g_mean[SH][SW];

  const long long frame_px = (long long)h * w;
  const uint16_t* src = imgs + blockIdx.z * frame_px;
  uint16_t* dst = out + blockIdx.z * frame_px;
  const int gx0 = blockIdx.x * TX;
  const int gy0 = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;

  // stage 1: per-cell chroma differences of the tile and its apron
  for (int i = tid; i < SH * SW; i += TX * TY) {
    const int ly = i / SW;
    const int lx = i - ly * SW;
    const int y = 2 * (gy0 + ly - R);
    const int x = 2 * (gx0 + lx - R);
    int qr = 0, qb = 0, gm = 0;
    if (y >= 0 && x >= 0 && y + 1 < h && x + 1 < w) {
      const uint16_t* p = src + (long long)y * w + x;
      const int e_r = __ldg(raw2ev + p[0]);
      const int e_g1 = __ldg(raw2ev + p[1]);
      const int e_g2 = __ldg(raw2ev + p[w]);
      const int e_b = __ldg(raw2ev + p[w + 1]);
      gm = wrap_add(e_g1, e_g2) / 2;  // C truncating division
      qr = wrap_sub(e_r, gm);
      qb = wrap_sub(e_b, gm);
    }
    q_r[ly][lx] = qr;
    q_b[ly][lx] = qb;
    g_mean[ly][lx] = gm;
  }
  __syncthreads();

  // stage 2: one thread per cell of the tile
  const int gx = gx0 + threadIdx.x;
  const int gy = gy0 + threadIdx.y;
  const int x = 2 * gx;
  const int y = 2 * gy;
  if (x >= w || y >= h) {
    return;
  }
  const long long o = (long long)y * w + x;
  const bool has_right = x + 1 < w;
  const bool has_below = y + 1 < h;
  uint16_t px_r = src[o];
  const uint16_t px_g1 = has_right ? src[o + 1] : 0;
  const uint16_t px_g2 = has_below ? src[o + w] : 0;
  uint16_t px_b = has_right && has_below ? src[o + w + 1] : 0;

  const int cy = gy - 2;
  const int cx = gx - 2;
  if (cy >= 0 && cy < ny && cx >= 0 && cx < nx) {
    const int ly = threadIdx.y + R;
    const int lx = threadIdx.x + R;
    int vr[K];
    int vb[K];
    int k = 0;
#pragma unroll
    for (int di = -R; di <= R; ++di) {
#pragma unroll
      for (int dj = -R; dj <= R; ++dj) {
        if (METHOD == 2 && (di < 0 ? -di : di) + (dj < 0 ? -dj : dj) == 2) {
          continue;  // the 2x2 method drops the four corner cells
        }
        vr[k] = q_r[ly + dj][lx + di];
        vb[k] = q_b[ly + dj][lx + di];
        ++k;
      }
    }
    const int ge = g_mean[ly][lx];
    const int er = wrap_add(ge, median<K>(vr));
    const int eb = wrap_add(ge, median<K>(vb));
    if (ge >= 2 * EVR && er > EVR && eb > EVR) {
      const int top = 14 * EVR - 1;
      px_r = (uint16_t)(__ldg(ev2raw + min(max(er, 0), top)) + black);
      px_b = (uint16_t)(__ldg(ev2raw + min(max(eb, 0), top)) + black);
    }
  }
  dst[o] = px_r;
  if (has_right) dst[o + 1] = px_g1;
  if (has_below) dst[o + w] = px_g2;
  if (has_right && has_below) dst[o + w + 1] = px_b;
}

template <int METHOD>
int launch(const void* imgs, void* out, const void* raw2ev, const void* ev2raw,
           long long batch, int h, int w, int black, cudaStream_t stream) {
  const int ny = h >= 8 ? (h - 8) / 2 : 0;
  const int nx = w >= 7 ? (w - 7) / 2 : 0;
  const int grid_w = (w + 1) / 2;
  const int grid_h = (h + 1) / 2;
  dim3 grid((grid_w + TX - 1) / TX, (grid_h + TY - 1) / TY, (unsigned)batch);
  dim3 block(TX, TY);
  chroma_kernel<METHOD><<<grid, block, 0, stream>>>(
      (const uint16_t*)imgs, (uint16_t*)out, (const int*)raw2ev, (const int*)ev2raw, h, w,
      ny, nx, black);
  return (int)cudaGetLastError();
}

}  // namespace

// imgs, out: (batch, height, width) u16, contiguous on the device; raw2ev:
// int32[65536] for this black level; ev2raw: int32[14 * 32768], the EV->raw
// table from EV 0. Returns a cudaError_t as int (0 = launched).
extern "C" int mlvfs_chroma_smooth(const void* imgs, void* out, const void* raw2ev,
                                   const void* ev2raw, long long batch, long long height,
                                   long long width, int method, int black, void* stream) {
  if (batch < 0 || batch > 65535 || height < 0 || width < 0 || height > (1 << 19) ||
      width > (1 << 20)) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0 || height == 0 || width == 0) {
    return 0;
  }
  const int h = (int)height;
  const int w = (int)width;
  cudaStream_t s = (cudaStream_t)stream;
  switch (method) {
    case 2:
      return launch<2>(imgs, out, raw2ev, ev2raw, batch, h, w, black, s);
    case 3:
      return launch<3>(imgs, out, raw2ev, ev2raw, batch, h, w, black, s);
    case 5:
      return launch<5>(imgs, out, raw2ev, ev2raw, batch, h, w, black, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
