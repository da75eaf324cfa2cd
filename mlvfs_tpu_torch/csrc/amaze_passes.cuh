// AMaZE's in-place raster passes as __device__ functions, shared by
// csrc/amaze_scans.cu (kernels #10 and #11: one launch per pass) and
// csrc/amaze_mega.cu (kernel #9: the passes between the stencil stages of
// one cooperative launch), so both run one copy of the arithmetic.
//
// They compute what the XLA scans of mlvfs_tpu/ops/amaze_core.py compute on
// the CPU (_neighbor_refine_scan, _nyquist_dilate, _chroma_smooth_scan),
// which mlvfs_tpu_torch/ops/amaze_core.py repeats as the plain twins. Each
// pass reads a padded (hp, wp) plane of one frame and writes another:
//   * the passes restart on the reference's tile grid: tile t covers padded
//     rows [128 t, 128 t + 160); padded frame row y comes from the tile that
//     keeps it (rows [16, 144) of a tile, the first tile's rows [0, 16), the
//     last tile's rows from 144 on), so every tile writes only its own rows;
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
// Two walks over a tile's rows, each run by one team of threads for one
// (frame, tile), with one barrier a row and the updated rows above in
// shared memory:
//   * refine_tile / dilate_tile (planes too wide for the rings: refine past
//     about 7,260 padded columns, dilate past 2,049): each row step reads
//     its source rows from device memory, so every step waits out a load's
//     latency. Dilate's chain within a row is composed by one warp (each
//     lane a run of about wp/64 cells, a shuffle scan over the lanes, each
//     lane walking its run again from the value entering it), a second
//     barrier a row;
//   * refine_ring / dilate_ring: the source rows a tile needs stream
//     through a ring of rows in shared memory by cp.async
//     (16 B a copy where the plane's rows are 16-B aligned, else 8 or 4),
//     four rows ahead of the rows a step reads, so a step reads only shared
//     memory. Dilate holds rows as bits, 32 cells a word (each source row
//     turned into its even and its odd lanes' cells once, a step before its
//     first use): thread w takes word w of a row, counts its 32 cells'
//     eight taps with bit-sliced adders, forms their transfer functions as
//     two words (f(0), f(1)) and composes them along the word by doubling
//     over the bits (five steps), a shuffle scan composes the words, and
//     the value entering each word gives its 32 new cells in one select.
//     Composition is associative, so this grouping gives the twin's chain
//     exactly. A row is one warp's chain of up to 32 words (wp <= 2049,
//     dilate_ring_fits): the block's other warps do the copies, the bits
//     and the stores, and nothing else waits within a row. Wider planes
//     take dilate_tile.
// Both refine walks share the cell's arithmetic (refine_value); dilate_ring
// computes dilate_tile's transfer functions bit-sliced, for 0/1 cells
// (tests/test_torch_kernel_models.py holds it to every tap pattern).
// chroma_tile is a staged block of cells, over chroma_value: the rows a
// pass updates read only rows of the other parity, which it never changes,
// so there is no chain.
//
// Each walk is run by a team of NT threads (csrc/team.cuh: in kernels #10
// and #11 the block of THREADS, 256; kernel #9 picks its own). The
// pointers are plain (no __restrict__): in kernel #9 a pass reads a plane
// written by other blocks earlier in the same launch, before a grid sync.
// Its plain loads and its copies to shared memory (cp.async, .cg at 16 B
// and .ca, which may allocate in L1, at 8 or 4) are weak reads in the PTX
// memory model, which the sync's gpu-scope release and acquire order after
// those writes, whatever an SM's L1 held before; only the non-coherent
// read-only path (ld.global.nc, __ldg) is outside that order, so
// chroma_tile takes it only for a plane not written in the same launch.
//
// Compile with -fmad=false: the float operations are those of the twins,
// one rounding each, in their order, with a product fused into a sum
// (__fmaf_rn) exactly where the twin fuses one, so the results are the
// twins' bit for bit.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "team.cuh"

namespace amaze_passes {

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

// Shared memory of the row walks: refine two rows of wp floats, dilate
// three rows of wp ints and wp/2 transfer functions.
inline size_t refine_smem(long long wp) { return 2 * wp * sizeof(float); }
inline size_t dilate_smem(long long wp) { return 3 * wp * sizeof(int) + wp / 2; }

// refine (amaze:1054-1058): the cell's new value from its original value,
// its diagonal neighbours in the updated row above (pm, pp) and the
// original row below (nm, np)
__device__ __forceinline__ float refine_value(float old, float pm, float pp, float nm, float np) {
  const float alt = 0.25f * (((pm + pp) + nm) + np);
  const float nv = fabsf(0.5f - old) < fabsf(0.5f - alt) ? alt : old;
  return nv + 0.0f;  // the cell sum with the other lane's 0
}

// The refinement of tile t of one frame's (hp, wp) plane f into o; rows:
// refine_smem(wp) bytes of shared memory.
template <int NT>
__device__ void refine_tile(const Team<NT>& team, const float* f, float* o, int hp, int wp, int T, int t,
                            float* rows) {
  const int y0 = STEP * t, rlast = last_row(t, T, hp), ncell = wp / 2;
  for (int x = team.tid; x < wp; x += NT) {
    rows[x] = f[(long long)y0 * wp + x];  // the carry starts as the tile's first row
  }
  team.sync();
  for (int r = 0; r <= rlast; ++r) {
    const float* prev = rows + (r & 1) * wp;
    float* cur = rows + ((r + 1) & 1) * wp;
    const int y = y0 + r, yn = (y + 1 == hp) ? 0 : y + 1;
    const float* orow = f + (long long)y * wp;
    const float* nrow = f + (long long)yn * wp;
    const bool keep = kept(r, t, T);
    for (int c = team.tid; c < ncell; c += NT) {
      const int xs = 2 * c + (r & 1);
      const int xm = wrapx(xs - 1, wp), xp = wrapx(xs + 1, wp);
      const float v = refine_value(orow[xs], prev[xm], prev[xp], nrow[xm], nrow[xp]);
      cur[2 * c] = v;
      cur[2 * c + 1] = v;
      if (keep) {
        o[(long long)y * wp + 2 * c] = v;
        o[(long long)y * wp + 2 * c + 1] = v;
      }
    }
    team.sync();
  }
}

// transfer functions {0,1} -> {0,1} as 2 bits (f(0) | f(1) << 1)
constexpr int IDENTITY = 2;
__device__ __forceinline__ int apply(int f, int a) { return (f >> a) & 1; }
__device__ __forceinline__ int after(int f, int g) {  // f after g
  return apply(f, g & 1) | (apply(f, (g >> 1) & 1) << 1);
}

// The dilation of tile t of one frame's (hp, wp) int32 plane f into o;
// smem: dilate_smem(wp) bytes of shared memory.
template <int NT>
__device__ void dilate_tile(const Team<NT>& team, const int* f, int* o, int hp, int wp, int T, int t,
                            int* smem) {
  int* ring = smem;  // three updated rows of wp, then wp/2 transfer functions
  uint8_t* fn = reinterpret_cast<uint8_t*>(smem + 3 * wp);
  const int y0 = STEP * t, rlast = last_row(t, T, hp), ncell = wp / 2;
  for (int x = team.tid; x < 3 * wp; x += NT) {
    ring[x] = 0;  // the updated rows above the tile are 0
  }
  team.sync();
  for (int r = 0; r <= rlast; ++r) {
    const int* r2 = ring + ((r + 1) % 3) * wp;
    const int* r1 = ring + ((r + 2) % 3) * wp;
    int* cur = ring + (r % 3) * wp;
    const int y = y0 + r;
    const int* orow = f + (long long)y * wp;
    const int* d1 = f + (long long)((y + 1) % hp) * wp;
    const int* d2 = f + (long long)((y + 2) % hp) * wp;
    for (int c = team.tid; c < ncell; c += NT) {
      const int xs = 2 * c + (r & 1);
      const int xm = wrapx(xs - 1, wp), xp = wrapx(xs + 1, wp), xpp = wrapx(xs + 2, wp);
      const int K = r2[xs] + r1[xm] + r1[xp] + orow[xs] + orow[xpp] + d1[xm] + d1[xp] + d2[xs];
      const int ov = orow[xs];
      const int f0 = K > 4 ? 1 : (K < 4 ? 0 : ov);
      const int f1 = K + 1 > 4 ? 1 : (K + 1 < 4 ? 0 : ov);
      fn[c] = (uint8_t)(f0 | (f1 << 1));
    }
    team.sync();
    if (team.tid < 32) {
      const int lane = team.tid;
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
    team.sync();
    if (kept(r, t, T)) {
      for (int x = team.tid; x < wp; x += NT) {
        o[(long long)y * wp + x] = cur[x];
      }
    }
  }
}

// ------------------------------------------------------- the ring walks

constexpr int REFINE_RING = 6;  // rows r and r+1 read, four in flight
constexpr int DILATE_RING = 8;  // row r+3 turned to bits, four in flight
// the most shared memory a block may have on sm_90
constexpr size_t MAX_SMEM = 232448;

// Shared memory of the ring walks: refine the ring and two updated rows of
// wp floats; dilate the ring of wp ints, and four source rows (two rows of
// bits each) and three updated rows of bits.
inline size_t refine_ring_smem(long long wp) { return (REFINE_RING + 2) * wp * sizeof(float); }
inline size_t dilate_ring_smem(long long wp) {
  return DILATE_RING * wp * sizeof(int) + 11 * ((wp / 2 + 31) / 32) * 4;
}
// whether a plane's row of cells is one warp's chain (at most 32 words)
inline bool dilate_ring_fits(long long wp) { return wp / 2 <= 32 * 32; }

// The refinement of tile t of one frame's (hp, wp) plane f into o through
// a ring of REFINE_RING source rows; smem: refine_ring_smem(wp) bytes,
// 16-B aligned. Tile row k's source is plane row (y0 + k) % hp for
// k = 0 .. rlast + 1 (row rlast reads the row below it).
template <int NT>
__device__ void refine_ring(const Team<NT>& team, const float* f, float* o, int hp, int wp, int T, int t,
                            float* smem) {
  float* ring = smem;
  float* upd = smem + REFINE_RING * wp;  // the updated rows, r-1 and r in turn
  const int y0 = STEP * t, rlast = last_row(t, T, hp), ncell = wp / 2;
  const int bytes = async_copy::copy_bytes(f, 4ll * wp);  // 16, 8 or 4
  const bool wide = (reinterpret_cast<unsigned long long>(o) & 7) == 0;  // a cell in one store
  auto fetch = [&](int k) {  // one commit group a row, empty past the last
    if (k <= rlast + 1) {
      async_copy::copy_rows(ring + (k % REFINE_RING) * wp, 0, f + (long long)((y0 + k) % hp) * wp,
                            0, 1, 4 * wp, bytes, team.tid, NT);
    }
    async_copy::commit();
  };
  for (int k = 0; k < REFINE_RING - 1; ++k) {
    fetch(k);
  }
  for (int r = 0; r <= rlast; ++r) {
    async_copy::wait<REFINE_RING - 3>();  // rows r and r+1 have landed (this thread's copies)
    team.sync();                   // everyone's copies, and row r-1 done everywhere
    fetch(r + REFINE_RING - 1);        // into row r-1's slot
    const float* orow = ring + (r % REFINE_RING) * wp;
    const float* nrow = ring + ((r + 1) % REFINE_RING) * wp;
    const float* prev = r == 0 ? orow : upd + ((r + 1) & 1) * wp;  // row 0 reads itself
    float* cur = upd + (r & 1) * wp;
    float* out = o + (long long)(y0 + r) * wp;
    const bool keep = kept(r, t, T);
    for (int c = team.tid; c < ncell; c += NT) {
      const int xs = 2 * c + (r & 1);
      const int xm = wrapx(xs - 1, wp), xp = wrapx(xs + 1, wp);
      const float v = refine_value(orow[xs], prev[xm], prev[xp], nrow[xm], nrow[xp]);
      reinterpret_cast<float2*>(cur)[c] = make_float2(v, v);
      if (keep && wide) {
        reinterpret_cast<float2*>(out)[c] = make_float2(v, v);
      } else if (keep) {
        out[2 * c] = v;
        out[2 * c + 1] = v;
      }
    }
  }
  async_copy::wait<0>();
}

// Rows of cells as bits: word w of a row holds cells 32w .. 32w + 31, cell
// 32w + j in bit j; bits past the row's last cell are 0.

// The cells 32w + j - 1 (prev_word) and 32w + j + 1 (next_word) of row X
// of ncell cells in nwords words, both wrapping around the row.
__device__ __forceinline__ uint32_t prev_word(const uint32_t* X, int w, int ncell) {
  const uint32_t in = w > 0 ? X[w - 1] >> 31 : (X[(ncell - 1) >> 5] >> ((ncell - 1) & 31)) & 1u;
  return (X[w] << 1) | in;
}
__device__ __forceinline__ uint32_t next_word(const uint32_t* X, int w, int ncell, int nwords) {
  const uint32_t in = w + 1 < nwords ? (X[w + 1] & 1u) << 31
                                     : (X[0] & 1u) << ((ncell - 1) & 31);  // cell 0 after the last
  return (X[w] >> 1) | in;
}

// The dilation of tile t of one frame's (hp, wp) int32 plane f of 0/1
// cells into o through a ring of DILATE_RING source rows; smem:
// dilate_ring_smem(wp) bytes, 16-B aligned. Tile row k's source is plane
// row (y0 + k) % hp for k = 0 .. rlast + 2. Each source row, once landed,
// becomes two rows of bits (its even and its odd lanes' cells), a step
// before its first use; row r's cells are computed 32 to a thread (word w
// by thread w): the neighbour count K of the eight taps bit-sliced, each
// cell's transfer function as two bits (f(0) in F0, f(1) in F1), the
// chain within the word composed by doubling over the bits, across the
// words by a shuffle scan over warp 0's lanes, while the other warps do the
// copies, the rows to bits and the stores. Row r is written out at step
// r + 1, from its bits. Only for planes with dilate_ring_fits(wp).
template <int NT>
__device__ void dilate_ring(const Team<NT>& team, const int* f, int* o, int hp, int wp, int T, int t,
                            int* smem) {
  const int ncell = wp / 2, nwords = (ncell + 31) / 32;
  int* ring = smem;
  uint32_t* src = reinterpret_cast<uint32_t*>(ring + DILATE_RING * wp);  // 4 source rows: even, odd cells
  uint32_t* upd = src + 8 * nwords;                                      // updated rows r-2, r-1, r
  const int y0 = STEP * t, rlast = last_row(t, T, hp);
  const int bytes = async_copy::copy_bytes(f, 4ll * wp);
  const int lane = team.tid & 31, warp = team.tid >> 5;
  // warp 0 does only the chain, with no block-wide step within a row; the
  // other warps (tid >= 0) the copies, the rows to bits and the stores
  const int helpers = NT - 32, tid = team.tid - 32;
  auto fetch = [&](int k) {
    if (k <= rlast + 2 && tid >= 0) {
      async_copy::copy_rows(ring + (k % DILATE_RING) * wp, 0, f + (long long)((y0 + k) % hp) * wp,
                            0, 1, 4 * wp, bytes, tid, helpers);
    }
    async_copy::commit();
  };
  auto to_bits = [&](int k) {  // source row k, landed, to its even and odd cells' bits
    if (k > rlast + 2 || tid < 0) {
      return;
    }
    const int* row = ring + (k % DILATE_RING) * wp;
    uint32_t* even = src + (k & 3) * 2 * nwords;
    for (int w = tid >> 5; w < nwords; w += helpers >> 5) {
      const int c = 32 * w + lane;
      const int2 v = c < ncell ? reinterpret_cast<const int2*>(row)[c] : make_int2(0, 0);
      const uint32_t e = __ballot_sync(0xffffffffu, v.x != 0);
      const uint32_t d = __ballot_sync(0xffffffffu, v.y != 0);
      if (lane == 0) {
        even[w] = e;
        even[nwords + w] = d;
      }
    }
  };
  auto store_row = [&](const uint32_t* bits, int y) {  // a row of cells to both lanes of plane row y
    if (tid < 0) {
      return;
    }
    int* out = o + (long long)y * wp;
    for (int x = tid; x < wp; x += helpers) {
      out[x] = (bits[x >> 6] >> ((x >> 1) & 31)) & 1u;
    }
  };

  for (int k = 0; k < DILATE_RING - 1; ++k) {
    fetch(k);
  }
  for (int i = team.tid; i < 3 * nwords; i += NT) {
    upd[i] = 0;  // the updated rows above the tile are 0
  }
  async_copy::wait<DILATE_RING - 4>();  // rows 0 .. 2 have landed
  team.sync();
  for (int k = 0; k < 3; ++k) {
    to_bits(k);
  }
  const int w = lane;  // warp 0's lane w takes word w of a row
  const uint32_t valid = w + 1 < nwords ? ~0u : (w + 1 == nwords ? ~0u >> (31 - ((ncell - 1) & 31)) : 0u);
  for (int r = 0; r <= rlast; ++r) {
    async_copy::wait<DILATE_RING - 5>();  // row r+3 has landed
    team.sync();
    fetch(r + DILATE_RING - 1);  // into row r-1's slot
    to_bits(r + 3);              // into row r-1's bits
    if (r > 0 && kept(r - 1, t, T)) {
      store_row(upd + ((r - 1) % 3) * nwords, y0 + r - 1);
    }
    if (warp > 0) {
      continue;
    }
    const int par = r & 1;
    const uint32_t* r2 = upd + ((r + 1) % 3) * nwords;
    const uint32_t* r1 = upd + ((r + 2) % 3) * nwords;
    uint32_t* cur = upd + (r % 3) * nwords;
    // this row's parity's cells (M) and the other parity's (N) of the rows
    // r, r+1 and r+2
    const uint32_t* M0 = src + (r & 3) * 2 * nwords + par * nwords;
    const uint32_t* N1 = src + ((r + 1) & 3) * 2 * nwords + (1 - par) * nwords;
    const uint32_t* M2 = src + ((r + 2) & 3) * 2 * nwords + par * nwords;
    uint32_t P0 = 0, P1 = ~0u;  // the word's chain, prefix-composed over its bits
    if (w < nwords) {
      // the eight taps of cell c = 32w + j at bit j (site lane xs = 2c + par):
      // r2[xs], r1[xs -/+ 1], orow[xs], orow[xs + 2], d1[xs -/+ 1], d2[xs]
      const uint32_t a1 = r2[w];
      const uint32_t a2 = par ? r1[w] : prev_word(r1, w, ncell);
      const uint32_t a3 = par ? next_word(r1, w, ncell, nwords) : r1[w];
      const uint32_t a4 = M0[w];
      const uint32_t a5 = next_word(M0, w, ncell, nwords);
      const uint32_t a6 = par ? N1[w] : prev_word(N1, w, ncell);
      const uint32_t a7 = par ? next_word(N1, w, ncell, nwords) : N1[w];
      const uint32_t a8 = M2[w];
      // K = b0 + 2 b1 + 4 b2 + 8 b3, bit-sliced full adders
      const uint32_t x1 = a1 ^ a2, s1 = x1 ^ a3, c1 = (a1 & a2) | (a3 & x1);
      const uint32_t x2 = a4 ^ a5, s2 = x2 ^ a6, c2 = (a4 & a5) | (a6 & x2);
      const uint32_t s3 = a7 ^ a8, c3 = a7 & a8;
      const uint32_t x4 = s1 ^ s2, b0 = x4 ^ s3, c4 = (s1 & s2) | (s3 & x4);
      const uint32_t x5 = c1 ^ c2, t1 = x5 ^ c3, d1 = (c1 & c2) | (c3 & x5);
      const uint32_t b1 = t1 ^ c4, d2 = t1 & c4;
      const uint32_t b2 = d1 ^ d2, b3 = d1 & d2;
      const uint32_t ge5 = b3 | (b2 & (b1 | b0)), ge4 = b3 | b2;
      const uint32_t eq4 = b2 & ~(b1 | b0), eq3 = ~(b3 | b2) & b1 & b0;
      // transfer(K, ov): f(0) = K > 4 or (K == 4 and ov), f(1) = K > 3 or
      // (K == 3 and ov); cells past the row are the identity
      P0 = (ge5 | (eq4 & a4)) & valid;
      P1 = (ge4 | (eq3 & a4)) | ~valid;
      for (int sh = 1; sh < 32; sh *= 2) {  // bit j: cells 32w .. 32w + j composed
        const uint32_t G0 = P0 << sh, G1 = (P1 << sh) | ((1u << sh) - 1);
        const uint32_t n0 = (G0 & P1) | (~G0 & P0);
        P1 = (G1 & P1) | (~G1 & P0);
        P0 = n0;
      }
    }
    int F = (int)((P0 >> 31) | ((P1 >> 31) << 1));  // the word's cells composed
    for (int off = 1; off < 32; off *= 2) {         // inclusive scan over the lanes
      const int G = __shfl_up_sync(0xffffffffu, F, off);
      if (lane >= off) {
        F = after(F, G);
      }
    }
    int in_fn = __shfl_up_sync(0xffffffffu, F, 1);
    if (lane == 0) {
      in_fn = IDENTITY;
    }
    if (w < nwords) {
      // the chain starts from 0 at the tile's left
      cur[w] = (apply(in_fn, 0) ? P1 : P0) & valid;
    }
  }
  team.sync();
  if (kept(rlast, t, T)) {
    store_row(upd + (rlast % 3) * nwords, y0 + rlast);
  }
  async_copy::wait<0>();
}

// The chroma value of one cell from its taps: up1(dx), up3(dx) the rows
// one and three above (0 above the tile's top), dn1(dx), dn3(dx) those one
// and three below, at the cell's site lane plus dx.
template <class Up1, class Up3, class Dn1, class Dn3>
__device__ __forceinline__ float chroma_value(Up1 up1, Up3 up3, Dn1 dn1, Dn3 dn3) {
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
  return val + 0.0f;  // the cell sum with the other lane's 0
}

// The raster tile of padded row y and its row within the tile.
__device__ __forceinline__ int tile_row(int y, int T) {
  const int t = y < APRON ? 0 : min((y - APRON) / STEP, T - 1);
  return y - STEP * t;
}

// The staged chroma pass: a block takes CHROMA_ROWS rows and CHROMA_LANES
// lanes of one frame's plane, copies them with three rows and lanes around
// (wrapping as the pass does) into shared memory, and computes its cells
// from there, so each row comes from L2 about once instead of once for each
// of the four rows that read it. The plane is read through the read-only
// path (__ldg), or with COHERENT (kernel #9, which writes the plane in the
// same launch) through L2 (__ldcg).
constexpr int CHROMA_ROWS = 32, CHROMA_LANES = 256, CHROMA_HALO = 3;
constexpr int CHROMA_W = CHROMA_LANES + 2 * CHROMA_HALO, CHROMA_H = CHROMA_ROWS + 2 * CHROMA_HALO;

// Block (lane block lb, row block rb) of one frame's (hp, wp) plane f into
// o, updating the rows of parity `parity`, run by a team of NT threads;
// tile: CHROMA_H * CHROMA_W floats of shared memory.
template <bool COHERENT = false, int NT = THREADS>
__device__ void chroma_tile(const Team<NT>& team, const float* f, float* o, int hp, int wp, int T,
                            int parity, int rb, int lb, float* tile) {
  const int Y0 = rb * CHROMA_ROWS, X0 = lb * CHROMA_LANES;
  // thread t copies tile column t of every row, and the first threads
  // the columns past NT too; the loads of all rows issue together
  const int t = team.tid;
  const bool first = NT >= CHROMA_W ? t < CHROMA_W : true;
  const bool extra = t + NT < CHROMA_W;
  const int xa = ((X0 - CHROMA_HALO + t) % wp + wp) % wp;
  const int xb = ((X0 - CHROMA_HALO + NT + t) % wp + wp) % wp;
  auto load = [](const float* p) { return COHERENT ? __ldcg(p) : __ldg(p); };
#pragma unroll
  for (int rr = 0; rr < CHROMA_H; ++rr) {
    const int y = Y0 - CHROMA_HALO + rr;  // rows above 0 are never read: any row will do
    const float* row = f + (long long)(y < 0 ? 0 : (y < hp ? y : y % hp)) * wp;
    if (first) {
      tile[rr * CHROMA_W + t] = load(row + xa);
    }
    if (extra) {
      tile[rr * CHROMA_W + NT + t] = load(row + xb);
    }
  }
  team.sync();
  const bool wide = (reinterpret_cast<unsigned long long>(o) & 7) == 0;
  constexpr int CELLS = CHROMA_LANES / 2;
  for (int i = t; i < CHROMA_ROWS * CELLS; i += NT) {
    const int rr = i / CELLS, cl = i - rr * CELLS;
    const int y = Y0 + rr, c = X0 / 2 + cl;
    if (y >= hp || 2 * c >= wp) {
      continue;
    }
    const float* at = tile + (rr + CHROMA_HALO) * CHROMA_W + CHROMA_HALO + 2 * cl;  // lane 2c of row y
    float v0 = at[0], v1 = at[1];
    if ((y & 1) == parity) {
      const int r = tile_row(y, T);
      const float* site = at + (y & 1);
      const bool m1 = r >= 1, m3 = r >= 3;
      v0 = v1 = chroma_value([&](int dx) { return m1 ? site[dx - CHROMA_W] : 0.0f; },
                             [&](int dx) { return m3 ? site[dx - 3 * CHROMA_W] : 0.0f; },
                             [&](int dx) { return site[dx + CHROMA_W]; },
                             [&](int dx) { return site[dx + 3 * CHROMA_W]; });
    }
    float* out = o + (long long)y * wp + 2 * c;
    if (wide) {
      *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
    } else {
      out[0] = v0;
      out[1] = v1;
    }
  }
}

// The tile grid's shape limits, as the entry points check them.
inline bool bad_shape(long long batch, long long hp, long long wp, long long T) {
  return batch < 0 || batch > 65535 || hp < 4 || wp < 2 || wp % 2 || hp > (1 << 20) ||
         wp > (1 << 20) || T < 1 || STEP * (T - 1) >= hp;
}

}  // namespace amaze_passes
