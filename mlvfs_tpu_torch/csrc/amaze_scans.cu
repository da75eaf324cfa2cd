// AMaZE's in-place raster passes, hand-written for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of mlvfs_tpu/ops/amaze_scans_pallas.py:
//   #10 _run_pass via refine_tiles / dilate_tiles / chroma_one_tiles, the
//       split AMaZE path's passes: mlvfs_amaze_refine, mlvfs_amaze_dilate,
//       mlvfs_amaze_chroma (one plane);
//   #11 refine_pallas / dilate_pallas / chroma_pallas, the frame-level entry
//       points: the same refine and dilate entries, and mlvfs_amaze_chroma2
//       (both chroma planes in one launch, the plane in blockIdx.z).
// Each computes what the XLA scans of mlvfs_tpu/ops/amaze_core.py compute on
// the CPU, which mlvfs_tpu_torch/ops/amaze_core.py repeats as the plain
// twins, on padded (batch, hp, wp) planes. The pass bodies, their semantics
// and their design are csrc/amaze_passes.cuh (shared with kernel #9,
// csrc/amaze_mega.cu):
//   * refine: one block per (frame, tile), the tile's source rows streamed
//     through a ring in shared memory by cp.async four rows ahead of the
//     row being computed, one __syncthreads() a row (refine_ring);
//   * dilate: the same ring, the rows held as bits, 32 cells a thread of
//     one warp, each row's chain composed over the bits and across the
//     lanes by a shuffle scan (dilate_ring);
//   * planes too wide for the rings take the row walks that read device
//     memory: refine (refine_tile) where refine_ring_smem is above the
//     227 KB a block may have, past about 7,260 padded columns; dilate
//     (dilate_tile) where a row of cells is more than one warp's 32 words,
//     past 2,049 columns;
//   * chroma: a block per 32 rows x 256 lanes of one frame's plane, staged
//     with its three rows and lanes around in shared memory (chroma_tile).
// Kernel #9 runs the same walks, chosen by the same widths, inside its
// cooperative launch.
// The Pallas kernels' lane padding with wrap copies and their 8-tile
// sublane stacks were TPU layout and have no counterpart here.
//
// What bounds them on an H100: each pass reads and writes its plane once,
// 4 B a pixel each way (0.083 ms a pass for a 1080p batch of 16 at
// 3.35 TB/s); the operations (some 10 a pixel for refine, 40 for chroma) are
// fewer than the bytes allow. Refine and dilate are chains of up to 160
// dependent rows a tile, 144 tiles at 1080p/B=16, one block each: a row
// step that waited for its own loads from device memory (the walk before
// the ring) spent most of its 2-4 us in that wait; with the ring a step
// waits for its block's __syncthreads(), and the loads for the rows ahead
// are in flight meanwhile (4 rows of 7.8 KB a block at 1080p). What is left
// is the one block an SM that 144 chains give: its copies in flight, not
// the card's, bound the rate.
//
// Built with -fmad=false, so the results are the twins' bit for bit (see
// csrc/amaze_passes.cuh).
//
// Plain C interface, loaded with ctypes (mlvfs_tpu_torch/_build.py). The
// kernels launch on the caller's stream, allocate nothing and do not
// synchronise; the return value is cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "amaze_passes.cuh"

using namespace amaze_passes;

namespace {

template <bool RING>
__global__ void __launch_bounds__(THREADS)
    refine_kernel(const float* __restrict__ in, float* __restrict__ out, int hp, int wp, int T) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  const long long fo = (long long)blockIdx.y * hp * wp;
  float* smem = reinterpret_cast<float*>(dyn_smem);
  if constexpr (RING) {
    refine_ring(block_team<THREADS>(), in + fo, out + fo, hp, wp, T, blockIdx.x, smem);
  } else {
    refine_tile(block_team<THREADS>(), in + fo, out + fo, hp, wp, T, blockIdx.x, smem);
  }
}

template <bool RING>
__global__ void __launch_bounds__(THREADS)
    dilate_kernel(const int* __restrict__ in, int* __restrict__ out, int hp, int wp, int T) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  const long long fo = (long long)blockIdx.y * hp * wp;
  int* smem = reinterpret_cast<int*>(dyn_smem);
  if constexpr (RING) {
    dilate_ring(block_team<THREADS>(), in + fo, out + fo, hp, wp, T, blockIdx.x, smem);
  } else {
    dilate_tile(block_team<THREADS>(), in + fo, out + fo, hp, wp, T, blockIdx.x, smem);
  }
}

__global__ void __launch_bounds__(THREADS)
    chroma_kernel(const float* __restrict__ in, float* __restrict__ out, int hp, int wp, int T,
                  int parity, int lanes_blocks) {
  __shared__ __align__(16) float tile[CHROMA_H * CHROMA_W];
  const long long fo = (long long)blockIdx.y * hp * wp;
  chroma_tile(block_team<THREADS>(), in + fo, out + fo, hp, wp, T, parity, blockIdx.x / lanes_blocks,
              blockIdx.x % lanes_blocks, tile);
}

// plane 0 (in0 -> out0) updates the rows of parity 1, plane 1 those of parity 0
__global__ void __launch_bounds__(THREADS)
    chroma2_kernel(const float* __restrict__ in0, const float* __restrict__ in1,
                   float* __restrict__ out0, float* __restrict__ out1, int hp, int wp, int T,
                   int lanes_blocks) {
  __shared__ __align__(16) float tile[CHROMA_H * CHROMA_W];
  const long long fo = (long long)blockIdx.y * hp * wp;
  const bool second = blockIdx.z == 1;
  chroma_tile(block_team<THREADS>(), (second ? in1 : in0) + fo, (second ? out1 : out0) + fo, hp, wp, T,
              second ? 0 : 1, blockIdx.x / lanes_blocks, blockIdx.x % lanes_blocks, tile);
}

// blocks of the staged chroma pass: (lane blocks, row blocks)
inline dim3 chroma_grid(long long batch, long long hp, long long wp, unsigned planes) {
  const long long lb = (wp + CHROMA_LANES - 1) / CHROMA_LANES, rb = (hp + CHROMA_ROWS - 1) / CHROMA_ROWS;
  return dim3((unsigned)(lb * rb), (unsigned)batch, planes);
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
  const bool ring = refine_ring_smem(wp) <= MAX_SMEM;
  return launch_rows(ring ? (const void*)refine_kernel<true> : (const void*)refine_kernel<false>,
                     ring ? refine_ring_smem(wp) : refine_smem(wp), dim3(nt, (unsigned)batch), args,
                     stream);
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
  const bool ring = dilate_ring_fits(wp);
  return launch_rows(ring ? (const void*)dilate_kernel<true> : (const void*)dilate_kernel<false>,
                     ring ? dilate_ring_smem(wp) : dilate_smem(wp), dim3(nt, (unsigned)batch), args,
                     stream);
}

extern "C" int mlvfs_amaze_chroma(const void* in, void* out, long long batch, long long hp,
                                  long long wp, long long T, int parity, void* stream) {
  if (bad_shape(batch, hp, wp, T) || (parity != 0 && parity != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0) {
    return 0;
  }
  const int lb = (int)((wp + CHROMA_LANES - 1) / CHROMA_LANES);
  chroma_kernel<<<chroma_grid(batch, hp, wp, 1), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, (int)hp, (int)wp, (int)T, parity, lb);
  return (int)cudaGetLastError();
}

// in0/in1 -> out0/out1: float32 (batch, hp, wp) contiguous; plane 0 updates
// the rows of parity 1 (G-R), plane 1 those of parity 0 (G-B).
extern "C" int mlvfs_amaze_chroma2(const void* in0, const void* in1, void* out0, void* out1,
                                   long long batch, long long hp, long long wp, long long T,
                                   void* stream) {
  if (bad_shape(batch, hp, wp, T)) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0) {
    return 0;
  }
  const int lb = (int)((wp + CHROMA_LANES - 1) / CHROMA_LANES);
  chroma2_kernel<<<chroma_grid(batch, hp, wp, 2), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)in0, (const float*)in1, (float*)out0, (float*)out1, (int)hp, (int)wp, (int)T,
      lb);
  return (int)cudaGetLastError();
}
