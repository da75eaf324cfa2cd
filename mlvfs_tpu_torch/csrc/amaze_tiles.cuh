// AMaZE's five stencil stage groups on shared-memory tiles, shared by
// csrc/amaze.cu (kernel #8: one launch per group, a block per tile) and
// csrc/amaze_mega.cu (kernel #9: persistent blocks walking the tiles of each
// group in one cooperative launch), so both run one copy of the arithmetic.
//
// The groups (stage bodies in csrc/amaze_stages.cuh):
//   1. gradients, cardinal interpolation, variance selection and bounding,
//      hvwt, the Nyquist test -> hcd, vcd, hvwt0, nyq0
//      [then the raster pass dilates nyq0 -> nyq]
//   2. area interpolation in the Nyquist regions -> hvwt1
//      [refine hvwt1 -> hvwt]
//   3. populate G, the diagonal gradients, the G curvature, the Nyquist
//      refinement, diagonal interpolation -> dgrb0b, rbp, rbm, pmwt0
//      [refine pmwt0 -> pmwt]
//   4. rbint, G correction, the chroma planes -> rgbgreen2, d0, d1
//      [chroma d0 -> d0s and d1 -> d1s]
//   5. the output, cropped to (B, h, w) R, G, B on the 0..65535 scale.
//
// A group runs on one tile of one frame (TILE_H x TILE_W padded pixels at
// origin (Y0, X0)): its stages one after another over the tile and an apron
// each stage's consumers reach (reach, below), with a barrier between
// stages; aprons are recomputed by the neighbouring tiles. A 2-D tile rather
// than column strips walked row by row: a strip's row gives a block's
// threads less than one pixel each per stage and a barrier per stage per
// row, while a tile gives each barrier 1,000-2,500 pixels.
//   * the planes that cross a group (a raster pass reads them, or a later
//     group) are written by the tile's own pixels only, to a workspace of 18
//     planes (enum SplitSlot);
//   * dirwts (for gcorr) and rgbgreen (for the merge) are recomputed from
//     the mosaic where group 4 reads them, and the diagonal gradients in
//     group 3, instead of being stored: each is a pure function of the
//     mosaic (and dgrb0b), so the bits are the same;
//   * a stage whose outputs are per-cell values runs once per cell, at the
//     cell's R/B site, and writes both lanes.
// Reach, in padded pixels (y, x), of each stage's region around the tile,
// from the taps of the stage bodies:
//   group 1: hvwt (0, 0) per cell reads vcd at its site +-3 rows and hcd at
//     +-3 columns, cddiffsq at +-2 diagonals, dgintv/dginth +-2, dirwts +-1,
//     delhvsqsum +-2 -> selection over (3, 3), which reads hcd0/hcdalt at
//     +-2 columns and vcd0/vcdalt at +-2 rows -> cardinal over (5, 5), which
//     reads dirwts and the mosaic at +-2 -> gradients over (7, 7) -> the
//     mosaic loaded over (9, 9);
//   group 2: area (0, 0) per cell, from the workspace (its 7 x 7 cell sums
//     run only in Nyquist cells);
//   group 3: nyq_refine (0, 0) reads D2h/D2v at +-2 and diag (0, 0) per cell
//     reads delm/delp and dgsqm/dgsqp at +-2 -> curvature and the diagonal
//     gradients over (2, 2) per cell, curvature reading dgrb0a at +-1 ->
//     populate over (3, 4) per cell (x even, whole cells) -> the mosaic
//     over (3, 3);
//   group 4: gcorr (0, 0) per cell reads rbint at +-2 and dirwts at +-1,
//     each of the mosaic at +-2 -> rb_interp over (2, 2) per cell, the
//     mosaic over (3, 3);
//   group 5: output, a pixel at a time from the workspace.
// Wrap-around: a tile pixel's frame position is its unwrapped position
// modulo (hp, wp), so aprons across the frame's edges hold the wrapped rows
// and columns, exactly as the stencils read them.
//
// Every read of the workspace is a plain load (no __ldg, no __restrict__):
// in kernel #9 the planes a group reads were written by other blocks before
// the grid sync that precedes it, which the read-only data path would not
// see.

#pragma once

#include <cuda_runtime.h>

#include "amaze_stages.cuh"
#include "team.cuh"

namespace amaze_tiles {

using namespace amaze_stages;

// The tile: rows and columns (even: tiles hold whole cells). Measured on an
// H100 against 16 x 64 and 32 x 64 tiles (PERF.md).
constexpr int TILE_H = 32;
constexpr int TILE_W = 32;

struct Reach {
  int ry, rx;
};
constexpr Reach NONE = {-1, -1};

// The shared-memory planes of group G and their reach; NONE for a plane
// that group reads from the workspace, recomputes or does not touch.
__host__ __device__ constexpr Reach reach(int G, int P) {
  if (G == 1) {
    return P == CFA                                ? Reach{9, 9}
           : P == DW0 || P == DW1 || P == DHV      ? Reach{7, 7}
           : P == HCD0 || P == VCD0 || P == HCDA || P == VCDA || P == DGV || P == DGH
               ? Reach{5, 5}
           : P == HCD || P == VCD                  ? Reach{3, 3}
                                                   : NONE;
  }
  if (G == 3) {
    return P == CFA                                          ? Reach{3, 3}
           : P == DGRB0A                                     ? Reach{3, 4}
           : P == DELP || P == DELM || P == DGP || P == DGM  ? Reach{2, 2}
           : P == D2H || P == D2V                            ? Reach{2, 2}
                                                             : NONE;
  }
  if (G == 4) {
    return P == CFA ? Reach{3, 3} : P == RBINT ? Reach{2, 2} : NONE;
  }
  return NONE;
}
__host__ __device__ constexpr bool in_shared(int G, int P) { return reach(G, P).ry >= 0; }
__host__ __device__ constexpr int pitch(int G, int P) { return TILE_W + 2 * reach(G, P).rx; }
__host__ __device__ constexpr int plane_floats(int G, int P) {
  return in_shared(G, P) ? (TILE_H + 2 * reach(G, P).ry) * pitch(G, P) : 0;
}
// The offset of plane P in group G's shared memory: the sizes of its
// shared planes before P, summed without a loop so that it folds into a
// constant wherever P is one.
__host__ __device__ constexpr int offset(int G, int P) {
  static_assert(N_PLANES == 36, "one term per plane");
#define B(q) (P > q ? plane_floats(G, q) : 0)
  return B(0) + B(1) + B(2) + B(3) + B(4) + B(5) +
         B(6) + B(7) + B(8) + B(9) + B(10) + B(11) +
         B(12) + B(13) + B(14) + B(15) + B(16) + B(17) +
         B(18) + B(19) + B(20) + B(21) + B(22) + B(23) +
         B(24) + B(25) + B(26) + B(27) + B(28) + B(29) +
         B(30) + B(31) + B(32) + B(33) + B(34) + B(35);
#undef B
}
__host__ __device__ constexpr size_t smem_bytes(int G) { return offset(G, N_PLANES) * sizeof(float); }

// The planes group G writes to the workspace.
__host__ __device__ constexpr bool writes(int G, int P) {
  return G == 1   ? P == HCD || P == VCD || P == HVWT0 || P == NYQ0
         : G == 2 ? P == HVWT1
         : G == 3 ? P == DGRB0B || P == RBP || P == RBM || P == PMWT0
         : G == 4 ? P == RGBG2 || P == D0 || P == D1
                  : false;
}

// Where group G's planes live: shared memory (reach), the workspace
// (split_slot), or, in group 4, the mosaic (dirwts, rgbgreen). own: the
// pixel is one of the tile's own, the only ones written to the workspace.
template <int G>
struct Tile {
  float* ws;
  long long pl, fo;
  float* sm;
  bool own;

  template <class Q>
  __device__ __forceinline__ float& at_sm(int P, const Q& p, int dy, int dx) const {
    return sm[offset(G, P) + (p.ty + dy + reach(G, P).ry) * pitch(G, P) + p.tx + dx + reach(G, P).rx];
  }
  template <class Q>
  __device__ __forceinline__ long long at_ws(int P, const Q& p, int dy, int dx) const {
    return split_slot(P) * pl + fo + (long long)p.wy(dy) * p.wp + p.wx(dx);
  }
  template <class Q>
  __device__ __forceinline__ float cfa(const Q& p, int dy, int dx) const {
    return at_sm(CFA, p, dy, dx);
  }
  template <class Q>
  __device__ __forceinline__ float v(int P, const Q& p, int dy, int dx) const {
    if (in_shared(G, P)) {
      return at_sm(P, p, dy, dx);
    }
    if (G == 4 && P == DW0) {
      return dirwt(cfa(p, dy - 2, dx), cfa(p, dy - 1, dx), cfa(p, dy, dx), cfa(p, dy + 1, dx),
                   cfa(p, dy + 2, dx));
    }
    if (G == 4 && P == DW1) {
      return dirwt(cfa(p, dy, dx - 2), cfa(p, dy, dx - 1), cfa(p, dy, dx), cfa(p, dy, dx + 1),
                   cfa(p, dy, dx + 2));
    }
    if (G == 4 && P == RGBG) {
      return rgbgreen(((p.wy(dy) + p.wx(dx)) & 1) == 0, cfa(p, dy, dx), ws[at_ws(DGRB0B, p, dy, dx)]);
    }
    return ws[at_ws(P, p, dy, dx)];
  }
  template <class Q>
  __device__ __forceinline__ int iv(int P, const Q& p, int dy, int dx) const {
    return reinterpret_cast<const int*>(ws)[at_ws(P, p, dy, dx)];
  }
  template <class Q>
  __device__ __forceinline__ void put(int P, const Q& p, float val) const {
    for (int l = 0; l < p.lanes(); ++l) {
      const Q q = p.lane(l);
      if (in_shared(G, P)) {
        at_sm(P, q, 0, 0) = val;
      }
      if (writes(G, P) && own) {
        ws[at_ws(P, q, 0, 0)] = val;
      }
    }
  }
  template <class Q>
  __device__ __forceinline__ void iput(int P, const Q& p, int val) const {
    for (int l = 0; l < p.lanes(); ++l) {
      if (writes(G, P) && own) {
        reinterpret_cast<int*>(ws)[at_ws(P, p.lane(l), 0, 0)] = val;
      }
    }
  }
};

template <int G>
using TPx = PxT<Tile<G>>;

__device__ __forceinline__ int wrap(int v, int n) {
  while (v < 0) {
    v += n;
  }
  while (v >= n) {
    v -= n;
  }
  return v;
}

// Runs f on every pixel (CELLS: every cell, at its R/B site) of the tile at
// (Y0, X0) and its apron of RY rows and RX columns, the team's NT threads
// striding over them.
template <int RY, int RX, bool CELLS, int NT, int G, class F>
__device__ __forceinline__ void region(const Team<NT>& team, const Tile<G>& t, int hp, int wp, int Y0,
                                       int X0, F f) {
  static_assert(!CELLS || RX % 2 == 0, "a cell region holds whole cells");
  constexpr int per_row = CELLS ? (TILE_W + 2 * RX) / 2 : TILE_W + 2 * RX;
  for (int i = team.tid; i < (TILE_H + 2 * RY) * per_row; i += NT) {
    TPx<G> p;
    p.st = t;
    p.hp = hp;
    p.wp = wp;
    p.ty = i / per_row - RY;
    p.tx = (CELLS ? 2 * (i % per_row) : i % per_row) - RX;
    p.y = wrap(Y0 + p.ty, hp);
    p.x = wrap(X0 + p.tx, wp);
    if (CELLS) {  // the left lane is even (X0, RX and wp are): step to the site
      p.x += p.y & 1;
      p.tx += p.y & 1;
    }
    p.pair = CELLS;
    p.st.own = p.ty >= 0 && p.ty < TILE_H && p.tx >= 0 && p.tx < TILE_W && Y0 + p.ty < hp &&
               X0 + p.tx < wp;
    f(p);
  }
}

// Group G's view of frame b of a (N_SPLIT, B, hp, wp) workspace, with sm
// its shared memory (smem_bytes(G) bytes).
template <int G>
__device__ __forceinline__ Tile<G> tile(float* ws, int B, int hp, int wp, int b, float* sm) {
  const long long fs = (long long)hp * wp;
  return Tile<G>{ws, B * fs, b * fs, sm, false};
}

template <int G>
__device__ __forceinline__ void load_cfa(const TPx<G>& p) {
  p.put(CFA, p.st.ws[p.st.at_ws(CFA, p, 0, 0)]);
}

// The tiles of a (hp, wp) frame: tiles_y(hp) x tiles_x(wp), the last ones
// reaching past the frame (their pixels there wrap and are not their own).
__host__ __device__ constexpr int tiles_y(int hp) { return (hp + TILE_H - 1) / TILE_H; }
__host__ __device__ constexpr int tiles_x(int wp) { return (wp + TILE_W - 1) / TILE_W; }

// Group G (1..4) on the tile at (Y0, X0) of frame b, run by a team of NT
// threads; sm: smem_bytes(G) bytes of shared memory (none for group 2).
// A group ends on a stage without a barrier after it: a team that runs
// another tile in the same shared memory passes its barrier first.
template <int G, int NT>
__device__ __forceinline__ void group(const Team<NT>& team, float* ws, int B, int hp, int wp, int b,
                                      int Y0, int X0, float* sm) {
  const Tile<G> t = tile<G>(ws, B, hp, wp, b, sm);
  if constexpr (G == 1) {
    region<9, 9, false, NT>(team, t, hp, wp, Y0, X0, [](const TPx<1>& p) { load_cfa(p); });
    team.sync();
    region<7, 7, false, NT>(team, t, hp, wp, Y0, X0, [](const TPx<1>& p) { gradients_px(p); });
    team.sync();
    region<5, 5, false, NT>(team, t, hp, wp, Y0, X0, [](const TPx<1>& p) { cardinal(p); });
    team.sync();
    region<3, 3, false, NT>(team, t, hp, wp, Y0, X0, [](const TPx<1>& p) { selection(p); });
    team.sync();
    region<0, 0, true, NT>(team, t, hp, wp, Y0, X0, [](const TPx<1>& p) { hvwt(p); });
  } else if constexpr (G == 2) {
    region<0, 0, true, NT>(team, t, hp, wp, Y0, X0, [](const TPx<2>& p) { area(p); });
  } else if constexpr (G == 3) {
    region<3, 3, false, NT>(team, t, hp, wp, Y0, X0, [](const TPx<3>& p) { load_cfa(p); });
    team.sync();
    region<3, 4, true, NT>(team, t, hp, wp, Y0, X0, [](const TPx<3>& p) { populate(p); });
    region<2, 2, true, NT>(team, t, hp, wp, Y0, X0, [](const TPx<3>& p) { gradients_cell(p); });
    team.sync();
    region<2, 2, true, NT>(team, t, hp, wp, Y0, X0, [](const TPx<3>& p) { curvature(p); });
    team.sync();
    region<0, 0, false, NT>(team, t, hp, wp, Y0, X0, [](const TPx<3>& p) { nyq_refine(p); });
    region<0, 0, true, NT>(team, t, hp, wp, Y0, X0, [](const TPx<3>& p) { diag(p); });
  } else {
    static_assert(G == 4, "groups 1..4 run on tiles");
    region<3, 3, false, NT>(team, t, hp, wp, Y0, X0, [](const TPx<4>& p) { load_cfa(p); });
    team.sync();
    region<2, 2, true, NT>(team, t, hp, wp, Y0, X0, [](const TPx<4>& p) { rb_interp(p); });
    team.sync();
    region<0, 0, true, NT>(team, t, hp, wp, Y0, X0, [](const TPx<4>& p) { gcorr(p); });
  }
}

// Group 5: output pixel i, below B * (hp - 32) * (wp - 32), of the cropped
// (B, hp - 32, wp - 32) planes, from the workspace.
__device__ __forceinline__ void output_px(float* ws, int B, int hp, int wp, long long i, float* red,
                                          float* grn, float* blu) {
  const int h = hp - 2 * PAD, w = wp - 2 * PAD;
  const long long fs = (long long)h * w;
  TPx<5> p;
  p.st = Tile<5>{ws, (long long)B * hp * wp, (i / fs) * hp * wp, nullptr, false};
  p.hp = hp;
  p.wp = wp;
  p.y = (int)((i % fs) / w) + PAD;
  p.x = (int)(i % w) + PAD;
  p.ty = p.tx = 0;
  p.pair = false;
  output_at(p, i, red, grn, blu);
}

}  // namespace amaze_tiles
