// AMaZE's in-place raster passes, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of mlvfs_tpu/ops/amaze_scans_pallas.py
// (_run_pass via refine_tiles / dilate_tiles / chroma_one_tiles, the split
// AMaZE path's passes) and computes what the XLA scans of
// mlvfs_tpu/ops/amaze_core.py compute on the CPU (_neighbor_refine_scan,
// _nyquist_dilate, _chroma_smooth_scan), which mlvfs_tpu_torch/ops/amaze_core.py
// repeats as the plain twins. Each pass takes a padded (batch, hp, wp) plane
// and writes a new one:
//   * the passes restart on the reference's tile grid: tile t covers padded
//     rows [128 t, 128 t + 160); padded frame row y comes from the tile that
//     keeps it (rows [16, 144) of a tile, the first tile's rows [0, 16), the
//     last tile's rows from 144 on), so every block writes only its own rows;
//   * rows below a tile, and lanes beyond the width, wrap around the frame
//     (a roll); rows at or past hp never reach a kept row, so they are not
//     computed;
//   * a cell is two lanes; its site lane is x % 2 == r % 2 on tile row r,
//     and the site's value goes to both lanes.
//
// refine (amaze:1054-1058, :1280-1281): new = the mean of the four diagonal
//   neighbours when it is further from 1/2 than the value; row r reads the
//   updated row r-1 (row 0 reads itself) and the original row r+1.
// dilate (amaze:998-1010): K = the updated rows r-2 (x) and r-1 (x-1, x+1),
//   the original row (x, x+2) and rows r+1 (x-1, x+1) and r+2 (x), the
//   updated rows above the tile being 0; each cell's new value is f(new of
//   the cell to its left), f(a) = 1 when a + K > 4, 0 when a + K < 4, else the
//   original value, the chain seeded with 0 at the tile's left edge.
// chroma (amaze:1386-1398): rows of parity `parity` get the directional
//   interpolation from rows r-1 and r-3 above (0 above the tile's top) and
//   r+1, r+3 below; the other rows keep their values.
//
// What bounds them on an H100: each pass reads and writes its plane once,
// 4 B a pixel each way (0.083 ms a pass for a 1080p batch of 16 at
// 3.35 TB/s); the operations (some 10 a pixel for refine, 40 for chroma) are
// fewer than the bytes allow. The row chains of refine and dilate are what
// holds a simple kernel back: 160 dependent rows a tile.
//
// Design, the simple form:
//   * refine: one block per (frame, tile); its threads stride over the
//     row's cells, the updated row above in shared memory (two row buffers),
//     one __syncthreads() a row.
//   * dilate: one block per (frame, tile); per row the threads compute
//     every cell's transfer function (2 bits: f(0), f(1)) into shared
//     memory, then one warp composes them: each lane composes a run of
//     about wp/64 cells in order, a shuffle scan over the 32 lanes composes
//     the runs, and each lane walks its run again from the value entering
//     it. The updated rows r-2, r-1 stay in shared memory.
//   * chroma: no chain at all. The rows a pass updates read only rows of
//     the other parity above them, which the pass never changes, so every
//     row is computed at once: one thread per (frame, row, cell).
// The Pallas kernels' lane padding with wrap copies and their 8-tile
// sublane stacks were TPU layout and have no counterpart here.
//
// Built with -fmad=false: the float operations are those of the twins, one
// rounding each, in their order, with a product fused into a sum
// (__fmaf_rn) exactly where the twin fuses one, so the results are the
// twins' bit for bit.
//
// Plain C interface, loaded with ctypes (mlvfs_tpu_torch/_build.py). The
// kernels launch on the caller's stream, allocate nothing and do not
// synchronise; the return value is cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 160;
constexpr int STEP = 128;
constexpr int APRON = 16;
constexpr int THREADS = 256;
constexpr float EPS = 1.e-05f;

__device__ __forceinline__ int wrapx(int x, int wp) {
  return x < 0 ? x + wp : (x >= wp ? x - wp : x);
}

// last tile row a block computes, and whether tile row r is one it keeps
__device__ __forceinline__ int last_row(int t, int T, int hp) {
  const int r = (t == T - 1) ? TILE - 1 : APRON + STEP - 1;
  return min(r, hp - 1 - STEP * t);
}
__device__ __forceinline__ bool kept(int r, int t, int T) {
  return (r >= APRON || t == 0) && (r < APRON + STEP || t == T - 1);
}

__global__ void __launch_bounds__(THREADS)
    refine_kernel(const float* __restrict__ in, float* __restrict__ out, int hp, int wp, int T) {
  extern __shared__ float rows[];  // two row buffers of wp
  const int t = blockIdx.x;
  const long long fo = (long long)blockIdx.y * hp * wp;
  const float* f = in + fo;
  float* o = out + fo;
  const int y0 = STEP * t, rlast = last_row(t, T, hp), ncell = wp / 2;
  for (int x = threadIdx.x; x < wp; x += THREADS) {
    rows[x] = f[(long long)y0 * wp + x];  // the carry starts as the tile's first row
  }
  __syncthreads();
  for (int r = 0; r <= rlast; ++r) {
    const float* prev = rows + (r & 1) * wp;
    float* cur = rows + ((r + 1) & 1) * wp;
    const int y = y0 + r, yn = (y + 1 == hp) ? 0 : y + 1;
    const float* orow = f + (long long)y * wp;
    const float* nrow = f + (long long)yn * wp;
    const bool keep = kept(r, t, T);
    for (int c = threadIdx.x; c < ncell; c += THREADS) {
      const int xs = 2 * c + (r & 1);
      const int xm = wrapx(xs - 1, wp), xp = wrapx(xs + 1, wp);
      const float old = orow[xs];
      const float alt = 0.25f * (((prev[xm] + prev[xp]) + nrow[xm]) + nrow[xp]);
      const float nv = fabsf(0.5f - old) < fabsf(0.5f - alt) ? alt : old;
      const float v = nv + 0.0f;  // the cell sum with the other lane's 0
      cur[2 * c] = v;
      cur[2 * c + 1] = v;
      if (keep) {
        o[(long long)y * wp + 2 * c] = v;
        o[(long long)y * wp + 2 * c + 1] = v;
      }
    }
    __syncthreads();
  }
}

// transfer functions {0,1} -> {0,1} as 2 bits (f(0) | f(1) << 1)
constexpr int IDENTITY = 2;
__device__ __forceinline__ int apply(int f, int a) { return (f >> a) & 1; }
__device__ __forceinline__ int after(int f, int g) {  // f after g
  return apply(f, g & 1) | (apply(f, (g >> 1) & 1) << 1);
}

__global__ void __launch_bounds__(THREADS)
    dilate_kernel(const int* __restrict__ in, int* __restrict__ out, int hp, int wp, int T) {
  extern __shared__ int smem[];  // three updated rows of wp, then wp/2 transfer functions
  int* ring = smem;
  uint8_t* fn = reinterpret_cast<uint8_t*>(smem + 3 * wp);
  const int t = blockIdx.x;
  const long long fo = (long long)blockIdx.y * hp * wp;
  const int* f = in + fo;
  int* o = out + fo;
  const int y0 = STEP * t, rlast = last_row(t, T, hp), ncell = wp / 2;
  for (int x = threadIdx.x; x < 3 * wp; x += THREADS) {
    ring[x] = 0;  // the updated rows above the tile are 0
  }
  __syncthreads();
  for (int r = 0; r <= rlast; ++r) {
    const int* r2 = ring + ((r + 1) % 3) * wp;
    const int* r1 = ring + ((r + 2) % 3) * wp;
    int* cur = ring + (r % 3) * wp;
    const int y = y0 + r;
    const int* orow = f + (long long)y * wp;
    const int* d1 = f + (long long)((y + 1) % hp) * wp;
    const int* d2 = f + (long long)((y + 2) % hp) * wp;
    for (int c = threadIdx.x; c < ncell; c += THREADS) {
      const int xs = 2 * c + (r & 1);
      const int xm = wrapx(xs - 1, wp), xp = wrapx(xs + 1, wp), xpp = wrapx(xs + 2, wp);
      const int K = r2[xs] + r1[xm] + r1[xp] + orow[xs] + orow[xpp] + d1[xm] + d1[xp] + d2[xs];
      const int ov = orow[xs];
      const int f0 = K > 4 ? 1 : (K < 4 ? 0 : ov);
      const int f1 = K + 1 > 4 ? 1 : (K + 1 < 4 ? 0 : ov);
      fn[c] = (uint8_t)(f0 | (f1 << 1));
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const int run = (ncell + 31) / 32;
      const int c0 = min(lane * run, ncell), c1 = min(c0 + run, ncell);
      int F = IDENTITY;
      for (int c = c0; c < c1; ++c) {
        F = after(fn[c], F);
      }
      for (int off = 1; off < 32; off *= 2) {  // inclusive scan of the runs
        const int G = __shfl_up_sync(0xffffffffu, F, off);
        if (lane >= off) {
          F = after(F, G);
        }
      }
      int in_fn = __shfl_up_sync(0xffffffffu, F, 1);
      if (lane == 0) {
        in_fn = IDENTITY;
      }
      int v = apply(in_fn, 0);  // the chain starts from 0 at the tile's left
      for (int c = c0; c < c1; ++c) {
        v = apply(fn[c], v);
        cur[2 * c] = v;
        cur[2 * c + 1] = v;
      }
    }
    __syncthreads();
    if (kept(r, t, T)) {
      for (int x = threadIdx.x; x < wp; x += THREADS) {
        o[(long long)y * wp + x] = cur[x];
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    chroma_kernel(const float* __restrict__ in, float* __restrict__ out, int hp, int wp, int T,
                  int parity, long long n_cells) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_cells) {
    return;
  }
  const int ncell = wp / 2;
  const long long row = i / ncell;
  const int c = (int)(i % ncell);
  const int y = (int)(row % hp);
  const long long fo = (row / hp) * hp * wp;
  const float* f = in + fo;
  float* o = out + fo + (long long)y * wp;
  if ((y & 1) != parity) {
    o[2 * c] = f[(long long)y * wp + 2 * c];
    o[2 * c + 1] = f[(long long)y * wp + 2 * c + 1];
    return;
  }
  const int t = y < APRON ? 0 : min((y - APRON) / STEP, T - 1);
  const int r = y - STEP * t;
  const float* um1 = r >= 1 ? f + (long long)(y - 1) * wp : nullptr;
  const float* um3 = r >= 3 ? f + (long long)(y - 3) * wp : nullptr;
  const float* d1 = f + (long long)((y + 1) % hp) * wp;
  const float* d3 = f + (long long)((y + 3) % hp) * wp;
  const int x = 2 * c + (y & 1);
  auto up1 = [&](int dx) { return um1 ? um1[wrapx(x + dx, wp)] : 0.0f; };
  auto up3 = [&](int dx) { return um3 ? um3[wrapx(x + dx, wp)] : 0.0f; };
  auto dn1 = [&](int dx) { return d1[wrapx(x + dx, wp)]; };
  auto dn3 = [&](int dx) { return d3[wrapx(x + dx, wp)]; };
  const float nm1 = up1(-1), pp1 = up1(1), nm3 = up3(-3), pp3 = up3(3);
  const float om1 = dn1(1), op1 = dn1(-1), om3 = dn3(3), op3 = dn3(-3);
  const float wtnw = 1.0f / (((EPS + fabsf(nm1 - om1)) + fabsf(nm1 - nm3)) + fabsf(om1 - nm3));
  const float wtne = 1.0f / (((EPS + fabsf(pp1 - op1)) + fabsf(pp1 - pp3)) + fabsf(op1 - pp3));
  const float wtsw = 1.0f / (((EPS + fabsf(op1 - pp1)) + fabsf(op1 - om3)) + fabsf(pp1 - op3));
  const float wtse = 1.0f / (((EPS + fabsf(om1 - nm1)) + fabsf(om1 - op3)) + fabsf(nm1 - om3));
  // 1.325 c1 - 0.175 c3 - 0.075 a - 0.075 b, the products after the
  // second fused into the sum, as XLA on the CPU computes it for the twin
  auto taps = [](float c1, float c3, float a, float b) {
    return __fmaf_rn(-0.075f, b, __fmaf_rn(-0.075f, a, __fmaf_rn(1.325f, c1, -(0.175f * c3))));
  };
  const float tnw = taps(nm1, nm3, up1(-3), up3(-1));
  const float tne = taps(pp1, pp3, up1(3), up3(1));
  const float tsw = taps(op1, op3, dn1(-3), dn3(-1));
  const float tse = taps(om1, om3, dn1(3), dn3(1));
  const float acc = __fmaf_rn(wtse, tse, __fmaf_rn(wtsw, tsw, __fmaf_rn(wtnw, tnw, wtne * tne)));
  const float val = acc / (((wtnw + wtne) + wtsw) + wtse);
  const float v = val + 0.0f;  // the cell sum with the other lane's 0
  o[2 * c] = v;
  o[2 * c + 1] = v;
}

bool bad_shape(long long batch, long long hp, long long wp, long long T) {
  return batch < 0 || batch > 65535 || hp < 4 || wp < 2 || wp % 2 || hp > (1 << 20) ||
         wp > (1 << 20) || T < 1 || STEP * (T - 1) >= hp;
}

int launch_rows(const void* kernel, size_t smem, dim3 grid, void** args, void* stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) {
      return (int)e;
    }
  }
  cudaError_t e = cudaLaunchKernel(kernel, grid, dim3(THREADS), args, smem, (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

// in/out: (batch, hp, wp) contiguous, float32 (refine, chroma) or int32
// (dilate); T: the number of tiles of the grid, max(1, ceil((hp - 32) / 128)).
// Returns a cudaError_t as int (0 = launched).
extern "C" int mlvfs_amaze_refine(const void* in, void* out, long long batch, long long hp,
                                  long long wp, long long T, void* stream) {
  if (bad_shape(batch, hp, wp, T)) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0) {
    return 0;
  }
  int h = (int)hp, w = (int)wp, nt = (int)T;
  const float* i = (const float*)in;
  float* o = (float*)out;
  void* args[] = {&i, &o, &h, &w, &nt};
  return launch_rows((const void*)refine_kernel, 2 * wp * sizeof(float),
                     dim3(nt, (unsigned)batch), args, stream);
}

extern "C" int mlvfs_amaze_dilate(const void* in, void* out, long long batch, long long hp,
                                  long long wp, long long T, void* stream) {
  if (bad_shape(batch, hp, wp, T)) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0) {
    return 0;
  }
  int h = (int)hp, w = (int)wp, nt = (int)T;
  const int* i = (const int*)in;
  int* o = (int*)out;
  void* args[] = {&i, &o, &h, &w, &nt};
  return launch_rows((const void*)dilate_kernel, 3 * wp * sizeof(int) + wp / 2,
                     dim3(nt, (unsigned)batch), args, stream);
}

extern "C" int mlvfs_amaze_chroma(const void* in, void* out, long long batch, long long hp,
                                  long long wp, long long T, int parity, void* stream) {
  if (bad_shape(batch, hp, wp, T) || (parity != 0 && parity != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0) {
    return 0;
  }
  const long long n_cells = batch * hp * (wp / 2);
  const unsigned blocks = (unsigned)((n_cells + THREADS - 1) / THREADS);
  chroma_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, (int)hp, (int)wp, (int)T, parity, n_cells);
  return (int)cudaGetLastError();
}
