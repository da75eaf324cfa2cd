// The whole AMaZE demosaic in one launch, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mlvfs_tpu/ops/amaze_pallas.py: _mega_path
// (its _kernel: cardinal -> dilate -> area -> refine -> populate -> diag ->
// refine -> gcorr -> chroma x2 -> output on one 160-row tile in VMEM),
// computing the frame-wide values of mlvfs_tpu/ops/amaze_core.py:
// amaze_demosaic, which mlvfs_tpu_torch/ops/amaze_core.py repeats as the
// plain twin; so it gives the bits of the twin and of kernels #8 + #10.
//
// Design: one cooperative, persistent launch. The TPU kernel keeps a tile
// in VMEM; on an H100 a 160-row tile plane of a 1080p frame (1.25 MB) is
// far above an SM's 228 KB of shared memory, and the raster passes chain
// across whole rows (dilate) and 160 rows down (refine), so neither one
// block per tile nor column strips with recomputed halos can hold a tile.
// Instead the grid (as many blocks as fit on the card at once) runs split
// mode's steps (ops/amaze_core.py _amaze_demosaic_cuda) in its order, with
// cooperative_groups' grid sync in place of the launch boundaries:
//   pad -> group 1 -> dilate nyq0 -> group 2 -> refine hvwt1 -> group 3 ->
//   refine pmwt0 -> group 4 -> chroma d0 (parity 1) and d1 (parity 0) ->
//   group 5 (output)
// 10 steps, 9 grid syncs, over the 18 workspace planes of enum SplitSlot:
//   * pad: x * f32(1/65535) and the 16-px reflect pad into S_CFA, a
//     grid-stride loop over the padded pixels;
//   * groups 1-4: #8's stage groups (csrc/amaze_tiles.cuh) on 32 x 32
//     tiles, the intermediates that stay inside a group in shared memory;
//     each block takes (frame, tile row, tile column) items in a
//     grid-stride loop;
//   * dilate and refine: #10's walks (csrc/amaze_passes.cuh), chosen by
//     the plane's width as #10 chooses them (the rings where they fit, else
//     the row walks), a (frame, tile) item at a time;
//   * chroma: #10's staged 32 x 256 blocks of both planes, reading through
//     L2 (the planes were written in this launch);
//   * group 5: a grid-stride loop over the output pixels.
// A block runs every step with one block size and one dynamic shared memory
// size, the most any step needs (mega_smem: group 1's 87 KiB at 32 x 32
// tiles, or a ring of wide rows), so at most two blocks an SM. Group 1 takes
// the whole block a tile; groups 2-4 and chroma split it into teams
// (csrc/team.cuh) that each run an item of their own in their own slice of
// the shared memory, behind their own named barrier, as #8 and #10 run them
// in smaller blocks; a raster walk runs on one team of 256 threads a block.
// A team's threads all run the same items, so its barriers stay uniform,
// and a barrier ends each item that leaves shared memory to the next.
//
// What bounds it on an H100: one plane in and three out, 16 B a pixel,
// against some 450 float32 operations a padded pixel and 1,500 a Nyquist
// cell, and the passes' 50 float32 and 8 int32 a pixel: the operations.
// Against #8 + #10 it saves four launches and the wrapper's pad, and pays
// for one block size for all steps (group 1 at fewer warps than #8 gives
// it) and the registers of its hungriest step.
//
// With a stamps pointer, block 0's thread 0 writes %globaltimer (ns) at the
// start and after every grid sync, and the launch ends on one more sync and
// stamp, so that stamps[k + 1] - stamps[k] is step k's time (the convert
// path passes none).
//
// Built with -fmad=false, so the results are the twin's bit for bit (see
// csrc/amaze_stages.cuh).
//
// Plain C interface, loaded with ctypes (mlvfs_tpu_torch/_build.py). The
// kernel launches on the caller's stream, allocates nothing and does not
// synchronise; the return value is the launch's cudaError_t. A launch the
// card cannot hold co-resident is refused (cudaErrorCooperativeLaunchTooLarge),
// never split.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "amaze_passes.cuh"
#include "amaze_tiles.cuh"

namespace cg = cooperative_groups;
namespace ps = amaze_passes;
using namespace amaze_tiles;

namespace {

// The block size: 512 threads, two blocks an SM (32 warps) at 64 registers
// a thread; blocks of 256 (16 warps at up to 128 registers) measured slower
// by about a quarter on an H100 despite 512's spills (PERF.md).
constexpr int NT = 512;
constexpr int N_STAMPS = 11;  // the start, 9 grid syncs, the end

// The walks for planes of wp padded columns, as kernel #10 chooses them.
inline bool refine_ring_fits(long long wp) { return ps::refine_ring_smem(wp) <= ps::MAX_SMEM; }

// Dynamic shared memory of a launch over planes of wp padded columns: the
// most any step needs.
inline size_t mega_smem(long long wp) {
  size_t s = smem_bytes(1);
  s = s > smem_bytes(3) ? s : smem_bytes(3);
  s = s > smem_bytes(4) ? s : smem_bytes(4);
  const size_t refine = refine_ring_fits(wp) ? ps::refine_ring_smem(wp) : ps::refine_smem(wp);
  const size_t dilate = ps::dilate_ring_fits(wp) ? ps::dilate_ring_smem(wp) : ps::dilate_smem(wp);
  const size_t chroma = ps::CHROMA_H * ps::CHROMA_W * sizeof(float);
  s = s > refine ? s : refine;
  s = s > dilate ? s : dilate;
  return s > chroma ? s : chroma;
}

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int reflect(int v, int n) {
  return v < 0 ? -v : (v >= n ? 2 * (n - 1) - v : v);
}

// The launch's planes: slot S of the (N_SPLIT, B, hp, wp) workspace.
struct Planes {
  float* ws;
  int B, hp, wp, T;
  long long fs, pl;  // a frame's and a plane's pixels

  __device__ __forceinline__ float* slot(int S) const { return ws + S * pl; }
};

// The padded frames on the 0..1 scale (ops/amaze_core.py pad_mosaic).
__device__ __forceinline__ void pad(const Planes& q, const float* raw, int h, int w, float inv_65535) {
  float* cfa = q.slot(S_CFA);
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < q.pl; i += (long long)gridDim.x * NT) {
    const long long b = i / q.fs;
    const int y = reflect((int)((i % q.fs) / q.wp) - PAD, h), x = reflect((int)(i % q.wp) - PAD, w);
    cfa[i] = raw[(b * h + y) * w + x] * inv_65535;
  }
}

// Threads a tile of stage group G takes (0: the whole block): group 1's
// tile planes fill the shared memory, so a block runs one of its tiles at a
// time; the others' are smaller, so a block runs a tile per team at once,
// each team behind a named barrier of its own, as #8 runs them in more and
// smaller blocks. Staged chroma blocks likewise, a team of CHROMA_TEAM each.
constexpr int TEAM_THREADS[5] = {0, 0, 128, 256, 128};
constexpr int CHROMA_TEAM = 256;

__host__ __device__ constexpr int team_threads(int G) { return TEAM_THREADS[G] == 0 ? NT : TEAM_THREADS[G]; }

// This thread's team of TT threads in the block.
template <int TT>
__device__ __forceinline__ Team<TT> team_of() {
  static_assert(NT % TT == 0, "a block is whole teams");
  return TT == NT ? block_team<TT>() : split_team<TT>();
}

// Stage group G (1..4) on every (frame, tile row, tile column) item, team k
// of block b taking items (b + m * gridDim.x) * teams + k.
template <int G>
__device__ __forceinline__ void tiles(const Planes& q, float* sm) {
  constexpr int TT = team_threads(G), TEAMS = NT / TT;
  static_assert(TEAMS * smem_bytes(G) <= smem_bytes(1), "each team has shared memory of its own");
  const Team<TT> team = team_of<TT>();
  const int k = threadIdx.x / TT;
  float* tsm = sm + k * (smem_bytes(G) / sizeof(float));
  const int ny = tiles_y(q.hp), nx = tiles_x(q.wp);
  for (int i = blockIdx.x * TEAMS + k; i < q.B * ny * nx; i += gridDim.x * TEAMS) {
    const int b = i / (ny * nx), r = i - b * (ny * nx);
    group<G, TT>(team, q.ws, q.B, q.hp, q.wp, b, (r / nx) * TILE_H, (r % nx) * TILE_W, tsm);
    if (G != 2) {
      team.sync();  // the next item reuses the shared memory
    }
  }
}

// The raster walks take one team of WALK_TEAM threads a block (the rest of
// the block waits at the next grid sync): a walk's row steps are chains of
// barriers, which a team the size of #10's block passes sooner than a
// larger one, and its items (a frame's raster tiles) are fewer than the
// blocks at 1080p.
constexpr int WALK_TEAM = 256;
static_assert(WALK_TEAM < NT, "a walk's team is a named barrier's slice of the block");

// The dilation of slot src into slot dst, a (frame, raster tile) an item.
__device__ __forceinline__ void dilate(const Planes& q, bool ring, int src, int dst, float* sm) {
  if (threadIdx.x >= WALK_TEAM) {
    return;
  }
  const Team<WALK_TEAM> team{(int)threadIdx.x, 1};
  for (int i = blockIdx.x; i < q.B * q.T; i += gridDim.x) {
    const long long fo = (i / q.T) * q.fs;
    const int* f = reinterpret_cast<const int*>(q.slot(src)) + fo;
    int* o = reinterpret_cast<int*>(q.slot(dst)) + fo;
    if (ring) {
      ps::dilate_ring(team, f, o, q.hp, q.wp, q.T, i % q.T, reinterpret_cast<int*>(sm));
    } else {
      ps::dilate_tile(team, f, o, q.hp, q.wp, q.T, i % q.T, reinterpret_cast<int*>(sm));
    }
    team.sync();  // the next item reuses the shared memory
  }
}

// The refinement of slot src into slot dst, a (frame, raster tile) an item.
__device__ __forceinline__ void refine(const Planes& q, bool ring, int src, int dst, float* sm) {
  if (threadIdx.x >= WALK_TEAM) {
    return;
  }
  const Team<WALK_TEAM> team{(int)threadIdx.x, 1};
  for (int i = blockIdx.x; i < q.B * q.T; i += gridDim.x) {
    const long long fo = (i / q.T) * q.fs;
    if (ring) {
      ps::refine_ring(team, q.slot(src) + fo, q.slot(dst) + fo, q.hp, q.wp, q.T, i % q.T, sm);
    } else {
      ps::refine_tile(team, q.slot(src) + fo, q.slot(dst) + fo, q.hp, q.wp, q.T, i % q.T, sm);
    }
    team.sync();
  }
}

// The chroma pass of slot src0 into dst0 (rows of parity par0) and of src1
// into dst1 (parity par1), a (plane, frame, row block, lane block) an item,
// taken by teams as tiles() takes its items.
__device__ __forceinline__ void chroma(const Planes& q, int src0, int dst0, int par0, int src1, int dst1,
                                       int par1, float* sm) {
  constexpr int TT = CHROMA_TEAM, TEAMS = NT / TT;
  constexpr int block_floats = ps::CHROMA_H * ps::CHROMA_W;
  static_assert(TEAMS * block_floats * sizeof(float) <= smem_bytes(1), "each team has its own block");
  const Team<TT> team = team_of<TT>();
  const int k = threadIdx.x / TT;
  const int lb = (q.wp + ps::CHROMA_LANES - 1) / ps::CHROMA_LANES;
  const int per_frame = lb * ((q.hp + ps::CHROMA_ROWS - 1) / ps::CHROMA_ROWS);
  for (int i = blockIdx.x * TEAMS + k; i < 2 * q.B * per_frame; i += gridDim.x * TEAMS) {
    const bool second = i >= q.B * per_frame;
    const int r = second ? i - q.B * per_frame : i, c = r % per_frame;
    const long long fo = (r / per_frame) * q.fs;
    ps::chroma_tile<true>(team, q.slot(second ? src1 : src0) + fo, q.slot(second ? dst1 : dst0) + fo, q.hp,
                          q.wp, q.T, second ? par1 : par0, c / lb, c % lb, sm + k * block_floats);
    team.sync();
  }
}

// Group 5: the output pixels, cropped.
__device__ __forceinline__ void output(const Planes& q, float* red, float* grn, float* blu) {
  const long long n = (long long)q.B * (q.hp - 2 * PAD) * (q.wp - 2 * PAD);
  for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < n; i += (long long)gridDim.x * NT) {
    output_px(q.ws, q.B, q.hp, q.wp, i, red, grn, blu);
  }
}

__global__ void __launch_bounds__(NT, 2)
    amaze_mega_kernel(const float* raw, float* ws, float* red, float* grn, float* blu, int B, int h,
                      int w, int T, float inv_65535, int refine_ring, int dilate_ring,
                      long long* stamps) {
  extern __shared__ __align__(16) float sm[];
  cg::grid_group grid = cg::this_grid();
  const int hp = h + 2 * PAD, wp = w + 2 * PAD;
  const long long fs = (long long)hp * wp;
  const Planes q{ws, B, hp, wp, T, fs, B * fs};
  const bool stamper = stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0;
  int k = 0;
  auto sync = [&] {
    grid.sync();
    if (stamper) {
      stamps[++k] = globaltimer();
    }
  };
  if (stamper) {
    stamps[0] = globaltimer();
  }
  // split mode's steps, in its order (ops/amaze_core.py _amaze_demosaic_cuda)
  pad(q, raw, h, w, inv_65535);
  sync();
  tiles<1>(q, sm);
  sync();
  dilate(q, dilate_ring, S_NYQ0, S_NYQ, sm);
  sync();
  tiles<2>(q, sm);
  sync();
  refine(q, refine_ring, S_HVWT1, S_HVWT, sm);
  sync();
  tiles<3>(q, sm);
  sync();
  refine(q, refine_ring, S_PMWT0, S_PMWT, sm);
  sync();
  tiles<4>(q, sm);
  sync();
  chroma(q, S_D0, S_D0S, 1, S_D1, S_D1S, 0, sm);
  sync();
  output(q, red, grn, blu);
  if (stamps != nullptr) {
    sync();  // the end of the last step, timed only when stamped
  }
}

// How a launch of (h, w) frames runs: its dynamic shared memory, its blocks
// an SM, the card's SMs and its walks.
struct Plan {
  int per_sm, sms;
  size_t smem;
  bool refine_ring, dilate_ring;
};

cudaError_t plan(long long h, long long w, Plan* p) {
  const void* kernel = (const void*)amaze_mega_kernel;
  const long long wp = w + 2 * PAD;
  p->smem = mega_smem(wp);
  p->refine_ring = refine_ring_fits(wp);
  p->dilate_ring = ps::dilate_ring_fits(wp);
  int dev = 0, coop = 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p->smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&p->sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p->per_sm, kernel, NT, p->smem);
  }
  if (e != cudaSuccess) {
    return e;
  }
  if (!coop) {
    return cudaErrorNotSupported;
  }
  return p->per_sm < 1 ? cudaErrorCooperativeLaunchTooLarge : cudaSuccess;
}

bool bad_shape(long long batch, long long h, long long w, long long T) {
  const long long hp = h + 2 * PAD, wp = w + 2 * PAD;
  return batch < 0 || batch > 65535 || h <= PAD || w <= PAD || w % 2 || hp > (1 << 16) ||
         wp > (1 << 16) || ps::bad_shape(batch, hp, wp, T);
}

}  // namespace

// raw: float32 (batch, h, w) mosaics on the 0..65535 scale; ws: float32
// (N_SPLIT, batch, h + 32, w + 32) workspace (enum SplitSlot); red/grn/blu:
// float32 (batch, h, w); T: the raster passes' tiles of the padded height,
// max(1, ceil(h / 128)) (ops/amaze_core.py n_tiles); inv_65535:
// float32(1 / 65535); stamps: nullptr, or int64[11] (N_STAMPS) on the
// device for the step times. Returns a cudaError_t as int (0 = launched).
extern "C" int mlvfs_amaze_mega(const void* raw, void* ws, void* red, void* grn, void* blu,
                                long long batch, long long h, long long w, long long T,
                                float inv_65535, void* stamps, void* stream) {
  if (bad_shape(batch, h, w, T)) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0) {
    return 0;
  }
  Plan p;
  cudaError_t e = plan(h, w, &p);
  if (e != cudaSuccess) {
    return (int)e;
  }
  const float* r = (const float*)raw;
  float* s = (float*)ws;
  float *o0 = (float*)red, *o1 = (float*)grn, *o2 = (float*)blu;
  int B = (int)batch, hh = (int)h, ww = (int)w, nt = (int)T;
  int rr = p.refine_ring, dr = p.dilate_ring;
  float inv = inv_65535;
  long long* st = (long long*)stamps;
  void* args[] = {&r, &s, &o0, &o1, &o2, &B, &hh, &ww, &nt, &inv, &rr, &dr, &st};
  e = cudaLaunchCooperativeKernel((const void*)amaze_mega_kernel, dim3(p.per_sm * p.sms), dim3(NT), args, p.smem,
                                  (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// How mlvfs_amaze_mega would launch for (h, w) frames: out = {block size,
// blocks an SM, SMs, dynamic shared memory bytes, refine by the ring (1) or
// the row walk (0), dilate likewise}. Returns a cudaError_t as int.
extern "C" int mlvfs_amaze_mega_plan(long long h, long long w, long long* out) {
  if (bad_shape(1, h, w, (h + ps::STEP - 1) / ps::STEP)) {
    return (int)cudaErrorInvalidValue;
  }
  Plan p;
  const cudaError_t e = plan(h, w, &p);
  if (e != cudaSuccess) {
    return (int)e;
  }
  const long long v[] = {NT, p.per_sm, p.sms, (long long)p.smem, p.refine_ring, p.dilate_ring};
  for (int i = 0; i < 6; ++i) {
    out[i] = v[i];
  }
  return 0;
}
