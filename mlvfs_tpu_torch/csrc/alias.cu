// Dual-ISO alias-map filter chain, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mlvfs_tpu/ops/alias_pallas.py: alias_filter
// and computes what mlvfs_tpu/ops/dualiso_full.py: _alias_filter_xla computes
// (build_alias_map's filter stages, hdr.c:1421-1486) on a batch of int32
// alias maps and their bool skip maps, "inner" being 6 <= y < h-6 and
// 6 <= x < w-6, and out-of-frame taps reading 0:
//   1. aux = the 6th largest of the 37-tap diamond FILTER_OFFS where
//      inner & !skip, else alias;
//   2. blurred = aux + sum over the 8 BLUR_GROUPS of (group sum * weight) //
//      1024 (floor division, int32, as the reference writes it; offsets
//      listed twice in the reference are summed twice) where inner & !skip,
//      else alias;
//   3. per 2x2 cell of the grid from (2, 2) -- ny = len(range(2, h-2, 2))
//      cells down, nx likewise across -- the cell's max, capped at 15000, on
//      all four pixels; pixels outside the grid keep blurred.
//
// What bounds it on an H100: the bytes are 4 B of alias and 1 B of skip read
// and 4 B written a pixel, 0.089 ms for a 1080p batch of 16 at 3.35 TB/s. The
// operations are the selection: the 6th largest of 37 values needs at least
// 50 comparisons a selected pixel (n - k + ceil(log2 C(n, k-1)), with n = 37,
// k = 6), plus some 60 integer operations of the blur, about 0.2 ms at the
// card's int32 rate when few pixels are skipped; so the operations bound it,
// and chip_smoke.py computes both bounds from the data it runs.
//
// Design: one launch for the batch, one block per 32x64 output tile of one
// frame, tile origins on even rows and columns, so every 2x2 cell of the
// grid (which starts on an even row and column) lies inside one tile and
// step 3 needs no other block's results. A block loads its tile plus a
// 12-pixel apron of alias (6 for the diamond, 6 for the blur) and a 6-pixel
// apron of skip into shared memory, computes aux over the tile plus 6 into
// shared memory (each thread keeping the running top 6 of its 37 taps in
// registers: 6 max/min pairs a tap), then the blur over the tile into shared
// memory, then the cell max, and writes the tile once. This is the simple
// form: aux is recomputed on the 6-pixel apron by both neighbouring blocks
// (1.6x the aux work at this tile size), and the insertion does 444 int32
// operations a pixel where a selection network needs fewer; both are later
// work. The TPU kernel's 256-row chunks, zero-padded row aprons and
// pltpu.roll taps were TPU tiling and have no counterpart here.
//
// Plain C interface, loaded with ctypes (mlvfs_tpu_torch/_build.py). The
// kernel launches on the caller's stream, allocates nothing and does not
// synchronise; the return value is cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TH = 32;              // output tile rows (even)
constexpr int TW = 64;              // output tile columns (even)
constexpr int R = 6;                // radius of the diamond, and of the blur
constexpr int AH = TH + 4 * R;      // alias rows held: tile + 12 each side
constexpr int AW = TW + 4 * R;
constexpr int XH = TH + 2 * R;      // aux rows computed: tile + 6 each side
constexpr int XW = TW + 2 * R;
constexpr int THREADS = 256;
constexpr int ALIAS_MAP_MAX = 15000;
constexpr int NEG = -(1 << 30);

// the 37-tap diamond (dx, dy), _ALIAS_FILTER_OFFS (dualiso_full.py:162)
__constant__ int FILTER_DX[37] = {-2, 0, 2, -4, -2, 0, 2, 4, -6, -4, -2, 0, 2, 4, 6, -6, -4, -2, 0,
                                  2, 4, 6, -6, -4, -2, 0, 2, 4, 6, -4, -2, 0, 2, 4, -2, 0, 2};
__constant__ int FILTER_DY[37] = {-6, -6, -6, -4, -4, -4, -4, -4, -2, -2, -2, -2, -2, -2, -2, 0, 0, 0, 0,
                                  0, 0, 0, 2, 2, 2, 2, 2, 2, 2, 4, 4, 4, 4, 4, 6, 6, 6};

// _ALIAS_BLUR_GROUPS (dualiso_full.py:174-183): (weight, taps (dx, dy)),
// flattened; a group's taps are BLUR_DX/DY[BLUR_START[g] .. BLUR_START[g+1])
__constant__ int BLUR_WEIGHT[8] = {820, 657, 421, 337, 173, 139, 111, 57};
__constant__ int BLUR_START[9] = {0, 4, 8, 12, 20, 24, 28, 36, 44};
__constant__ int BLUR_DX[44] = {0, -2, 2, 0,  -2, 2, -2, 2,  0, -2, 2, 0,
                                -2, 2, -2, 2, -2, 2, -2, 2,  -2, 2, -2, 2,  0, -6, 6, 0,
                                -2, 2, -6, 6, -6, 6, -2, 2,  -2, 2, -6, 6, -6, 6, -2, 2};
__constant__ int BLUR_DY[44] = {-2, 0, 0, 2,  -2, -2, 2, 2,  -2, 0, 0, 2,
                                -2, -2, -2, -2, 2, 2, 2, 2,  -2, -2, 2, 2,  -6, 0, 0, 6,
                                -6, -6, -2, -2, 2, 2, 6, 6,  -6, -6, -2, -2, 2, 2, 6, 6};

__device__ __forceinline__ bool is_inner(int y, int x, int h, int w) {
  return y >= 6 && y < h - 6 && x >= 6 && x < w - 6;
}

__global__ void __launch_bounds__(THREADS)
    alias_filter_kernel(const int* __restrict__ alias, const uint8_t* __restrict__ skip,
                        int* __restrict__ out, int h, int w, long long alias_stride,
                        long long skip_stride, long long out_stride, int ny_cells, int nx_cells) {
  __shared__ int s_alias[AH][AW];
  __shared__ int s_aux[XH][XW];
  __shared__ uint8_t s_skip[XH][XW];
  __shared__ int s_blur[TH][TW];

  const long long f = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int* a = alias + f * alias_stride;
  const uint8_t* k = skip + f * skip_stride;
  int* o = out + f * out_stride;

  for (int i = threadIdx.x; i < AH * AW; i += THREADS) {
    const int yy = i / AW, xx = i % AW;
    const int gy = y0 - 2 * R + yy, gx = x0 - 2 * R + xx;
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    s_alias[yy][xx] = in ? a[(long long)gy * w + gx] : 0;
  }
  for (int i = threadIdx.x; i < XH * XW; i += THREADS) {
    const int yy = i / XW, xx = i % XW;
    const int gy = y0 - R + yy, gx = x0 - R + xx;
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    s_skip[yy][xx] = in ? k[(long long)gy * w + gx] : 1;
  }
  __syncthreads();

  // 1. aux over the tile plus 6
  for (int i = threadIdx.x; i < XH * XW; i += THREADS) {
    const int yy = i / XW, xx = i % XW;
    const int gy = y0 - R + yy, gx = x0 - R + xx;
    int v = s_alias[yy + R][xx + R];
    if (is_inner(gy, gx, h, w) && !s_skip[yy][xx]) {
      int t0 = NEG, t1 = NEG, t2 = NEG, t3 = NEG, t4 = NEG, t5 = NEG;
#pragma unroll
      for (int j = 0; j < 37; ++j) {
        int c = s_alias[yy + R + FILTER_DY[j]][xx + R + FILTER_DX[j]];
        int hi;
        hi = max(t0, c); c = min(t0, c); t0 = hi;
        hi = max(t1, c); c = min(t1, c); t1 = hi;
        hi = max(t2, c); c = min(t2, c); t2 = hi;
        hi = max(t3, c); c = min(t3, c); t3 = hi;
        hi = max(t4, c); c = min(t4, c); t4 = hi;
        t5 = max(t5, c);
      }
      v = t5;
    }
    s_aux[yy][xx] = v;
  }
  __syncthreads();

  // 2. the integer gaussian over the tile (int32 wrapping arithmetic, as the
  // reference's int32 arrays wrap; the documented range never overflows)
  for (int i = threadIdx.x; i < TH * TW; i += THREADS) {
    const int yy = i / TW, xx = i % TW;
    const int gy = y0 + yy, gx = x0 + xx;
    int v = s_alias[yy + 2 * R][xx + 2 * R];
    if (gy < h && gx < w && is_inner(gy, gx, h, w) && !s_skip[yy + R][xx + R]) {
      unsigned acc = (unsigned)s_aux[yy + R][xx + R];
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        unsigned sum = 0;
#pragma unroll
        for (int j = BLUR_START[g]; j < BLUR_START[g + 1]; ++j) {
          sum += (unsigned)s_aux[yy + R + BLUR_DY[j]][xx + R + BLUR_DX[j]];
        }
        // floor division by 1024 of the int32 product: an arithmetic shift
        acc += (unsigned)((int)(sum * (unsigned)BLUR_WEIGHT[g]) >> 10);
      }
      v = (int)acc;
    }
    s_blur[yy][xx] = v;
  }
  __syncthreads();

  // 3. the 2x2 cell max over the grid from (2, 2), capped; write the tile
  for (int i = threadIdx.x; i < TH * TW; i += THREADS) {
    const int yy = i / TW, xx = i % TW;
    const int gy = y0 + yy, gx = x0 + xx;
    if (gy >= h || gx >= w) {
      continue;
    }
    int v = s_blur[yy][xx];
    if (gy >= 2 && gy < 2 + 2 * ny_cells && gx >= 2 && gx < 2 + 2 * nx_cells) {
      // the cell's top-left: the even local row/column at or above (tile
      // origins are even, so the cell never leaves the tile)
      const int cy = yy - ((gy - 2) & 1), cx = xx - ((gx - 2) & 1);
      const int m = max(max(s_blur[cy][cx], s_blur[cy][cx + 1]),
                        max(s_blur[cy + 1][cx], s_blur[cy + 1][cx + 1]));
      v = min(m, ALIAS_MAP_MAX);
    }
    o[(long long)gy * w + gx] = v;
  }
}

}  // namespace

// alias: int32 (batch, height, width), rows contiguous (row stride = width),
// frames alias_stride elements apart; skip: bool as uint8, the same layout
// with skip_stride; out: int32, out_stride. Returns a cudaError_t as int
// (0 = launched).
extern "C" int mlvfs_alias_filter(const void* alias, const void* skip, void* out,
                                  long long batch, long long height, long long width,
                                  long long alias_stride, long long skip_stride,
                                  long long out_stride, void* stream) {
  if (batch < 0 || batch > 65535 || height < 0 || width < 0 || height > (1 << 20) ||
      width > (1 << 20)) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0 || height == 0 || width == 0) {
    return 0;
  }
  const int h = (int)height, w = (int)width;
  const int ny_cells = h > 4 ? (h - 3) / 2 : 0;  // len(range(2, h - 2, 2))
  const int nx_cells = w > 4 ? (w - 3) / 2 : 0;
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, (unsigned)batch);
  alias_filter_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)alias, (const uint8_t*)skip, (int*)out, h, w, alias_stride, skip_stride,
      out_stride, ny_cells, nx_cells);
  return (int)cudaGetLastError();
}
