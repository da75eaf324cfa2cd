// Pattern noise's edge-aware median blur, hand-written for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels that compute the same blur:
//   #3 mlvfs_tpu/ops/patternnoise_fused.py: blur_interleaved, on the
//      interleaved Bayer frame (entry point mlvfs_pn_blur_interleaved);
//   #4 mlvfs_tpu/ops/patternnoise_pallas.py: edge_aware_blur_pallas, on the
//      four de-interleaved channel planes (entry point mlvfs_pn_blur_split).
// Both run one device function; only where a pixel is loaded from and stored
// to differs. The blur (patternnoise.c:88-180, horizontal_edge_aware_blur_rggb):
//   avg    = (g1 + g2) >> 1 of each 2x2 cell (R G1 / G2 B), floored like the
//            reference's "// 2";
//   window = channel offsets d in [-L, R]: walking right over d = 1..24 and
//            left over d = 1..25, stop at the first cell whose avg differs
//            from the centre cell's by more than 500, or at the row edge;
//   V      = p at green sites, p - avg at R and B sites;
//   med    = the k-th smallest V of the window, k = n odd ? n/2 : n/2 - 1
//            (wirth.h), n = L + R + 1;
//   out    = med at green sites, med + ((mg1 + mg2) >> 1) at R and B, mg1
//            and mg2 being the cell's green medians.
// Channel offset d is lane offset 2d on the interleaved frame. Pixels are
// int32 (the caller sign-extends the int16 bit patterns, so values of 32768
// and above are negative, as the reference's astype(int16)).
//
// What bounds it on an H100: operations. At 1920x1080, B=16 the frames are
// 133 MB in and 133 MB out as int32 (about 80 us at 3.35 TB/s), while each
// pixel scans a window of up to 50 entries per selection pass: some 10^3
// integer operations a pixel, about 2 ms at the card's int32 rate. The design
// keeps those operations on shared memory:
//   - a block owns a tile of 4 rows x 128 pixels (2 x 64 cells) and holds it
//     with an apron of 25 cells (50 lanes) each side in shared memory;
//   - one pass per cell computes avg (once per cell, not per pixel) and V;
//   - each thread (one pixel, or one channel element for #4) walks the
//     window on the cell averages, then selects rank k exactly by bisection
//     over [min, max] of its window: smallest v with count(V <= v) > k. The
//     ranges are narrow on real frames (a few hundred), so a selection takes
//     about ten counting passes. Neighbouring threads read neighbouring
//     lanes, so the shared-memory reads are free of bank conflicts;
//   - the green medians' cell mean is added back from shared memory after
//     one barrier.
// The TPU kernels' 32-row chunks, row aprons for the parity rolls and the
// Batcher network over 50 vector registers were TPU tiling and have no
// counterpart here.
//
// Plain C interface, loaded with ctypes (mlvfs_tpu_torch/_build.py). The
// kernel launches on the caller's stream, allocates nothing and does not
// synchronise; the return value is cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int STRENGTH = 25;         // patternnoise.c:104, call site :332
constexpr int THR = 500;
constexpr int BIG = 1000000000;      // avg of a cell outside the frame
constexpr int TW = 128;              // pixels per tile row (64 cells)
constexpr int TH = 4;                // rows per tile (2 cell rows)
constexpr int APRON = 2 * STRENGTH;  // lanes of apron each side
constexpr int SW = TW + 2 * APRON;   // lanes held per row
constexpr int SC = SW / 2;           // cells held per cell row

struct Planes {
  const int* in[4];
  int* out[4];
};

// Where pixel (y, x) of frame f of the (virtual) h x w Bayer frame lives: the
// interleaved frame itself (plane 0), or element (y/2, x/2) of channel plane
// 2*(y&1) + (x&1) of the split layout.
template <bool SPLIT>
__device__ __forceinline__ long long locate(long long f, int y, int x, int h, int w, int& plane) {
  if (SPLIT) {
    const int w2 = w >> 1;
    plane = ((y & 1) << 1) | (x & 1);
    return (f * (h >> 1) + (y >> 1)) * w2 + (x >> 1);
  }
  plane = 0;
  return (f * h + y) * (long long)w + x;
}

template <bool SPLIT>
__device__ __forceinline__ int load(const Planes& p, long long f, int y, int x, int h, int w) {
  int plane;
  const long long o = locate<SPLIT>(f, y, x, h, w, plane);
  return p.in[plane][o];
}

template <bool SPLIT>
__global__ void __launch_bounds__(TW * TH) blur_kernel(Planes p, int h, int w) {
  __shared__ int s_v[TH][SW];
  __shared__ int s_avg[TH / 2][SC];
  __shared__ int s_med[TH][TW];

  const long long f = blockIdx.z;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int tid = threadIdx.y * TW + threadIdx.x;

  // stage 1, one thread per cell of the tile and its apron: avg and V. h and
  // w are even, so a cell is either wholly inside the frame or wholly out.
  for (int i = tid; i < (TH / 2) * SC; i += TW * TH) {
    const int cr = i / SC;
    const int cl = i - cr * SC;
    const int y = y0 + 2 * cr;
    const int x = x0 - APRON + 2 * cl;
    int avg = BIG;
    int v_r = 0, v_g1 = 0, v_g2 = 0, v_b = 0;
    if (y < h && x >= 0 && x < w) {
      v_g1 = load<SPLIT>(p, f, y, x + 1, h, w);
      v_g2 = load<SPLIT>(p, f, y + 1, x, h, w);
      avg = (v_g1 + v_g2) >> 1;
      v_r = load<SPLIT>(p, f, y, x, h, w) - avg;
      v_b = load<SPLIT>(p, f, y + 1, x + 1, h, w) - avg;
    }
    s_avg[cr][cl] = avg;
    s_v[2 * cr][2 * cl] = v_r;
    s_v[2 * cr][2 * cl + 1] = v_g1;
    s_v[2 * cr + 1][2 * cl] = v_g2;
    s_v[2 * cr + 1][2 * cl + 1] = v_b;
  }
  __syncthreads();

  // stage 2, one thread per pixel: window, rank, exact selection
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int x = x0 + tx;
  const int y = y0 + ty;
  const bool inside = x < w && y < h;
  int med = 0;
  if (inside) {
    const int lane = tx + APRON;
    const int* avg_row = s_avg[ty >> 1];
    const int c = lane >> 1;
    const int a0 = avg_row[c];
    int right = 0;
    while (right < STRENGTH - 1 && abs(avg_row[c + right + 1] - a0) <= THR) {
      ++right;
    }
    int left = 0;
    while (left < STRENGTH && abs(avg_row[c - left - 1] - a0) <= THR) {
      ++left;
    }
    const int n = left + right + 1;
    const int k = (n & 1) ? n / 2 : n / 2 - 1;
    const int* v = &s_v[ty][lane];
    int lo = v[0];
    int hi = lo;
    for (int d = -left; d <= right; ++d) {
      lo = min(lo, v[2 * d]);
      hi = max(hi, v[2 * d]);
    }
    while (lo < hi) {  // smallest m with count(V <= m) > k
      const int mid = lo + (int)(((unsigned)hi - (unsigned)lo) >> 1);
      int cnt = 0;
      for (int d = -left; d <= right; ++d) {
        cnt += v[2 * d] <= mid;
      }
      if (cnt > k) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    med = lo;
  }
  s_med[ty][tx] = med;
  __syncthreads();
  if (!inside) {
    return;
  }
  int out = med;
  if (((x ^ y) & 1) == 0) {  // R or B: add the cell's green median mean
    const int cx = tx & ~1;
    const int cy = ty & ~1;
    out = med + ((s_med[cy][cx + 1] + s_med[cy + 1][cx]) >> 1);
  }
  int plane;
  const long long o = locate<SPLIT>(f, y, x, h, w, plane);
  p.out[plane][o] = out;
}

template <bool SPLIT>
int launch(const Planes& p, long long batch, long long height, long long width, void* stream) {
  if (batch < 0 || batch > 65535 || height < 0 || width < 0 || (height & 1) || (width & 1) ||
      height > (1 << 20) || width > (1 << 20)) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0 || height == 0 || width == 0) {
    return 0;
  }
  const int h = (int)height;
  const int w = (int)width;
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, (unsigned)batch);
  dim3 block(TW, TH);
  blur_kernel<SPLIT><<<grid, block, 0, (cudaStream_t)stream>>>(p, h, w);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel #3. img, out: (batch, height, width) int32, contiguous on the device;
// height and width even. Returns a cudaError_t as int (0 = launched).
extern "C" int mlvfs_pn_blur_interleaved(const void* img, void* out, long long batch,
                                         long long height, long long width, void* stream) {
  Planes p = {};
  p.in[0] = (const int*)img;
  p.out[0] = (int*)out;
  return launch<false>(p, batch, height, width, stream);
}

// Kernel #4. r, g1, g2, b and their outputs: (batch, height/2, width/2)
// int32 channel planes, contiguous on the device, of the (height, width)
// Bayer frames. Returns a cudaError_t as int (0 = launched).
extern "C" int mlvfs_pn_blur_split(const void* r, const void* g1, const void* g2, const void* b,
                                   void* rs, void* g1s, void* g2s, void* bs, long long batch,
                                   long long height, long long width, void* stream) {
  Planes p = {{(const int*)r, (const int*)g1, (const int*)g2, (const int*)b},
              {(int*)rs, (int*)g1s, (int*)g2s, (int*)bs}};
  return launch<true>(p, batch, height, width, stream);
}
