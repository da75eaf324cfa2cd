// AMaZE demosaic stencil stages, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mlvfs_tpu/ops/amaze_pallas.py: _split_path
// (its stages _stage_cardinal, _stage_area, _stage_populate, _stage_diag,
// _stage_gcorr and _stage_output), computing the frame-wide values of
// mlvfs_tpu/ops/amaze_core.py: amaze_demosaic (the reference's CPU form, which
// mlvfs_tpu_torch/ops/amaze_core.py repeats as the plain twin): every stencil
// reads the reflect-padded (hp, wp) frame with wrap-around, and per-cell
// values (the reference's indx>>1 arrays) are the site lane's value on both
// lanes of a 2-pixel cell, summed with the other lane's 0 as the twin sums.
//
// The group bodies are csrc/amaze_tiles.cuh, over the stage bodies of
// csrc/amaze_stages.cuh (both shared with kernel #9, csrc/amaze_mega.cu).
// One call of mlvfs_amaze_stage(k) is one launch of stage group k, a block
// per (tile column, tile row, frame) of 32 x 32 tiles:
//   1. gradients, cardinal interpolation, selection, hvwt, the Nyquist test
//      [then kernel #10 dilates nyq0 -> nyq]
//   2. area interpolation in the Nyquist regions  [#10 refines hvwt1 -> hvwt]
//   3. populate G, the diagonal gradients, the G curvature, the Nyquist
//      refinement, diagonal interpolation  [#10 refines pmwt0 -> pmwt]
//   4. rbint, G correction, the chroma planes
//      [#10 smooths d0 -> d0s and d1 -> d1s]
//   5. the output, a thread a pixel.
//
// What bounds it on an H100: one plane in and three out, 16 B a padded
// pixel (0.17 ms for a 1080p batch of 16 at 3.35 TB/s), against some 450
// float32 operations a padded pixel (0.23 ms at 67 TFLOP/s): the operations.
// What kept the first form (12 one-pixel-a-thread launches) at 3 % of that
// was plane traffic: 36 workspace planes, some 35 written and 60 read back
// through device memory. This form keeps every plane that only one group
// reads in shared memory, and the planes that cross a launch in a
// workspace of 18 (enum SplitSlot); see csrc/amaze_tiles.cuh.
//
// Built with -fmad=false, so the results are the twin's bit for bit (see
// csrc/amaze_stages.cuh).
//
// Plain C interface, loaded with ctypes (mlvfs_tpu_torch/_build.py). The
// kernels launch on the caller's stream, allocate nothing and do not
// synchronise; the return value is the first CUDA error of the call.

#include <cuda_runtime.h>

#include "amaze_tiles.cuh"

using namespace amaze_tiles;

namespace {

// The threads of a block of group G (1..5). Group 1's stages do the most
// work a tile and its shared memory holds 2 blocks an SM, so it takes 16
// warps a block; groups 2 and 5 read the workspace with one pass and no
// barrier. Measured on an H100 against other thread counts (PERF.md).
__host__ __device__ constexpr int threads(int G) { return G == 1 ? 512 : (G == 2 || G == 5 ? 128 : 256); }

// Group G on the block's tile: (tile column, tile row, frame) = blockIdx.
template <int G>
__device__ __forceinline__ void block_tile(float* ws, int B, int hp, int wp) {
  extern __shared__ float sm[];
  group<G, threads(G)>(block_team<threads(G)>(), ws, B, hp, wp, blockIdx.z, blockIdx.y * TILE_H,
                       blockIdx.x * TILE_W, sm);
}

__global__ void __launch_bounds__(threads(1)) k_group1(float* ws, int B, int hp, int wp) {
  block_tile<1>(ws, B, hp, wp);
}
__global__ void __launch_bounds__(threads(2)) k_group2(float* ws, int B, int hp, int wp) {
  block_tile<2>(ws, B, hp, wp);
}
__global__ void __launch_bounds__(threads(3)) k_group3(float* ws, int B, int hp, int wp) {
  block_tile<3>(ws, B, hp, wp);
}
__global__ void __launch_bounds__(threads(4)) k_group4(float* ws, int B, int hp, int wp) {
  block_tile<4>(ws, B, hp, wp);
}

__global__ void __launch_bounds__(threads(5))
    k_output(float* ws, int B, int hp, int wp, float* red, float* grn, float* blu) {
  const long long i = (long long)blockIdx.x * threads(5) + threadIdx.x;
  if (i < (long long)B * (hp - 2 * PAD) * (wp - 2 * PAD)) {
    output_px(ws, B, hp, wp, i, red, grn, blu);
  }
}

template <int G, class K>
cudaError_t launch(K kernel, int B, int hp, int wp, float* ws, cudaStream_t st) {
  const size_t smem = smem_bytes(G);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      return e;
    }
  }
  const dim3 grid(tiles_x(wp), tiles_y(hp), B);
  kernel<<<grid, threads(G), smem, st>>>(ws, B, hp, wp);
  return cudaGetLastError();
}

}  // namespace

// ws: float32 (N_SPLIT, batch, hp, wp) workspace (enum SplitSlot), slot
// S_CFA filled with the padded mosaic; red/grn/blu: float32 (batch, hp - 32,
// wp - 32), written by group 5. Returns a cudaError_t as int (0 = launched).
extern "C" int mlvfs_amaze_stage(int stage, void* ws, void* red, void* grn, void* blu,
                                 long long batch, long long hp, long long wp, void* stream) {
  if (batch < 0 || batch > 65535 || hp <= 2 * PAD || wp <= 2 * PAD || wp % 2 ||
      hp > (1 << 16) || wp > (1 << 16)) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0) {
    return 0;
  }
  const int B = (int)batch, h = (int)hp, w = (int)wp;
  const cudaStream_t st = (cudaStream_t)stream;
  float* p = (float*)ws;
  switch (stage) {
    case 1:
      return (int)launch<1>(k_group1, B, h, w, p, st);
    case 2:
      return (int)launch<2>(k_group2, B, h, w, p, st);
    case 3:
      return (int)launch<3>(k_group3, B, h, w, p, st);
    case 4:
      return (int)launch<4>(k_group4, B, h, w, p, st);
    case 5: {
      const unsigned blocks =
          (unsigned)((batch * (hp - 2 * PAD) * (wp - 2 * PAD) + threads(5) - 1) / threads(5));
      k_output<<<blocks, threads(5), 0, st>>>(p, B, h, w, (float*)red, (float*)grn, (float*)blu);
      return (int)cudaGetLastError();
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}
