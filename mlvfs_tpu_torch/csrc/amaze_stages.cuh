// AMaZE's stencil stages as __device__ functions, shared by csrc/amaze.cu
// (kernel #8) and csrc/amaze_mega.cu (kernel #9) through the stage groups of
// csrc/amaze_tiles.cuh, so both run one copy of the arithmetic.
//
// The stages compute the frame-wide values of mlvfs_tpu/ops/amaze_core.py:
// amaze_demosaic (the reference's CPU form, which
// mlvfs_tpu_torch/ops/amaze_core.py repeats as the plain twin): every stencil
// reads the reflect-padded (hp, wp) frame with wrap-around, and per-cell
// values (the reference's indx>>1 arrays) are the site lane's value on both
// lanes of a 2-pixel cell, summed with the other lane's 0 as the twin sums.
//
// Each stage is a function of one pixel (struct PxT), templated over where
// the planes it reads and writes live (its store S: csrc/amaze_tiles.cuh's
// Tile, which keeps the planes read only inside one stage group in the
// block's shared memory, those that cross a group in a workspace of 18
// planes (enum SplitSlot, the order of SPLIT_PLANES in ops/amaze_core.py),
// and recomputes dirwts and rgbgreen from the mosaic). Enum Plane names
// every plane a stage reads or writes (the order of PLANES in
// ops/amaze_core.py; nyq0 and nyq hold int32).
// In stage order:
//   1. gradients, cardinal, selection, hvwt -> hvwt0, nyq0
//      [the Nyquist dilation nyq0 -> nyq, csrc/amaze_passes.cuh]
//   2. area -> hvwt1
//      [refine hvwt1 -> hvwt]
//   3. populate, curvature, nyq_refine, diag -> rgbgreen, dgrb0b, pmwt0, rbp, rbm
//      [refine pmwt0 -> pmwt]
//   4. rb_interp, gcorr -> rgbgreen2, d0, d1
//      [chroma d0 -> d0s, d1 -> d1s]
//   5. output, cropped to (B, h, w) R, G, B on the 0..65535 scale.
// A stage reads at a pixel offset only planes that an earlier stage wrote
// (dirwts, hcd/vcd before their var3/var4 neighbourhoods, delhvsqsum, dgsq,
// D2h/D2v, rbint); values read only at the pixel itself, or cheap to
// recompute at a neighbour (cddiffsq, rgbgreen, the area sums' products),
// are computed where they are read. A stage whose every output is a
// per-cell value (hvwt, area, populate, gradients_cell, curvature, diag,
// rb_interp, gcorr's chroma) can run once per cell at the cell's R/B site
// with PxT::pair set: its puts then write both lanes (gcorr writes each
// lane's own rgbgreen2).
//
// Compile with -fmad=false: every float operation is one IEEE operation in
// the twin's order, divisions correctly rounded, and a product fused into a
// sum (__fmaf_rn, one rounding) exactly where the twin fuses it, at the
// products XLA on the CPU contracts for the reference; so the results are
// the twin's bit for bit, wherever a plane lives. Constants are the float32
// values of the twin's Python floats.

#pragma once

#include <cuda_runtime.h>

namespace amaze_stages {

enum Plane {
  CFA, DW0, DW1, DHV, DELP, DELM, DGP, DGM,
  HCD0, VCD0, HCDA, VCDA, DGV, DGH, HCD, VCD,
  HVWT0, NYQ0, NYQ, HVWT1, HVWT, DGRB0A, D2H, D2V, DGRB0B, RGBG,
  PMWT0, RBP, RBM, PMWT, RBINT, RGBG2, D0, D1, D0S, D1S,
  N_PLANES
};

// The workspace of kernels #8 and #9: the planes that cross a stage group
// (or a raster pass between them), S_<plane> holding plane <plane>.
enum SplitSlot {
  S_CFA, S_HCD, S_VCD, S_HVWT0, S_NYQ0, S_NYQ, S_HVWT1, S_HVWT, S_DGRB0B,
  S_RBP, S_RBM, S_PMWT0, S_PMWT, S_RGBG2, S_D0, S_D1, S_D0S, S_D1S,
  N_SPLIT
};

// The slot of plane P in the workspace, -1 for a plane it does not hold.
__host__ __device__ constexpr int split_slot(int P) {
  return P == CFA      ? S_CFA
         : P == HCD    ? S_HCD
         : P == VCD    ? S_VCD
         : P == HVWT0  ? S_HVWT0
         : P == NYQ0   ? S_NYQ0
         : P == NYQ    ? S_NYQ
         : P == HVWT1  ? S_HVWT1
         : P == HVWT   ? S_HVWT
         : P == DGRB0B ? S_DGRB0B
         : P == RBP    ? S_RBP
         : P == RBM    ? S_RBM
         : P == PMWT0  ? S_PMWT0
         : P == PMWT   ? S_PMWT
         : P == RGBG2  ? S_RGBG2
         : P == D0     ? S_D0
         : P == D1     ? S_D1
         : P == D0S    ? S_D0S
         : P == D1S    ? S_D1S
                       : -1;
}

constexpr int PAD = 16;
constexpr float EPS = 1.e-05f;
constexpr float EPSSQ = 1.e-10f;
constexpr float ARTHRESH = 0.75f;
constexpr float NYQTHRESH = 0.5f;
constexpr float CLIP_PT = 1.f;
constexpr float CLIP_PT8 = 0.8f;
__constant__ float GAUSSODD[4] = {0.14659728f, 0.103592716f, 0.073203616f, 0.036554355f};
__constant__ float GAUSSGRAD[6] = {0.07384412f, 0.06207512f, 0.05218182f,
                                0.036874194f, 0.030997323f, 0.018413194f};
__constant__ float GAUSSEVEN[2] = {0.13719495f, 0.056402527f};
__constant__ float GQUINC[4] = {0.169917f, 0.108947f, 0.069855f, 0.0287182f};

// ring offsets (dy, dx), in the twin's order
__constant__ int DIAG1[4][2] = {{-1, -1}, {-1, 1}, {1, -1}, {1, 1}};
__constant__ int AXIS1[4][2] = {{-1, 0}, {0, 1}, {0, -1}, {1, 0}};
__constant__ int AXIS2[4][2] = {{-2, 0}, {0, -2}, {0, 2}, {2, 0}};
__constant__ int DIAG2[4][2] = {{-2, -2}, {-2, 2}, {2, -2}, {2, 2}};
__constant__ int KNIGHT[8][2] = {{-2, -1}, {-2, 1}, {-1, -2}, {-1, 2},
                                 {1, -2}, {1, 2}, {2, -1}, {2, 1}};
__constant__ int GE_NEAR[4][2] = {{-1, 0}, {0, -1}, {0, 1}, {1, 0}};
__constant__ int GE_FAR[8][2] = {{-2, -2}, {-2, 0}, {-1, -1}, {-1, 1},
                                 {1, -1}, {1, 1}, {2, -2}, {2, 0}};

__device__ __forceinline__ float sq(float v) { return v * v; }
// one rounding: where the twin (and XLA on the CPU) fuses a product into a sum
__device__ __forceinline__ float fma_(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ float sqsum(float a, float b) { return fma_(a, a, b * b); }
__device__ __forceinline__ float ulim(float a, float b, float c) {
  return fminf(fmaxf(a, fminf(b, c)), fmaxf(b, c));
}
// a cell's value from its site lane's value: left lane + right lane, the
// lane that is not the site holding 0
__device__ __forceinline__ float cellsum(float v, bool site_left) {
  const float l = site_left ? v : 0.0f;
  const float r = site_left ? 0.0f : v;
  return l + r;
}
// dirwts (amaze:568-579) along one axis from the mosaic at -2, -1, 0, +1, +2
__device__ __forceinline__ float dirwt(float m2, float m1, float c, float p1, float p2) {
  return ((EPS + fabsf(p2 - c)) + fabsf(c - m2)) + fabsf(p1 - m1);
}
// rgbgreen after the Nyquist refinement, from the mosaic and dgrb0b
__device__ __forceinline__ float rgbgreen(bool rb, float cfa, float dgrb0b) {
  return rb ? cfa + dgrb0b : cfa;
}

// A pixel of one frame: reads and writes planes at wrapped offsets through
// its store S (S::v, S::iv, S::put, S::iput).
template <class S>
struct PxT {
  S st;
  int hp, wp;
  int y, x;    // the pixel in the padded frame
  int ty, tx;  // its offset from the tile origin, not wrapped (csrc/amaze_tiles.cuh's Tile)
  bool pair;   // the stage runs once per cell, at its R/B site: puts write both lanes

  __device__ __forceinline__ int wy(int dy) const {
    const int v = y + dy;
    return v < 0 ? v + hp : (v >= hp ? v - hp : v);
  }
  __device__ __forceinline__ int wx(int dx) const {
    const int v = x + dx;
    return v < 0 ? v + wp : (v >= wp ? v - wp : v);
  }
  __device__ __forceinline__ float v(int P, int dy = 0, int dx = 0) const { return st.v(P, *this, dy, dx); }
  __device__ __forceinline__ int iv(int P, int dy = 0, int dx = 0) const { return st.iv(P, *this, dy, dx); }
  __device__ __forceinline__ void put(int P, float val) const { st.put(P, *this, val); }
  __device__ __forceinline__ void iput(int P, int val) const { st.iput(P, *this, val); }
  __device__ __forceinline__ PxT at(int dy, int dx) const {
    PxT p = *this;
    p.y = wy(dy);
    p.x = wx(dx);
    p.ty += dy;
    p.tx += dx;
    return p;
  }
  __device__ __forceinline__ bool green() const { return ((y + x) & 1) == 1; }
  __device__ __forceinline__ bool rb() const { return !green(); }
  __device__ __forceinline__ bool left() const { return (x & 1) == 0; }
  // lane nx of this pixel's cell (wp is even, so a cell never wraps)
  __device__ __forceinline__ PxT lane_at(int nx) const {
    PxT p = *this;
    p.tx += nx - x;
    p.x = nx;
    return p;
  }
  // the R/B site of this pixel's cell (x % 2 == y % 2), and its green lane
  __device__ __forceinline__ PxT rb_site() const { return lane_at((x & ~1) | (y & 1)); }
  __device__ __forceinline__ PxT green_site() const { return lane_at((x & ~1) | ((y + 1) & 1)); }
  // the lanes a put covers: this pixel, and with pair its cell's other lane
  __device__ __forceinline__ int lanes() const { return pair ? 2 : 1; }
  __device__ __forceinline__ PxT lane(int l) const {
    PxT p = lane_at(l ? x ^ 1 : x);
    p.pair = false;
    return p;
  }
};

template <class Q, int N>
__device__ __forceinline__ float ring(const Q& p, int P, const int (&offs)[N][2]) {
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    acc = acc + p.v(P, offs[i][0], offs[i][1]);
  }
  return acc;
}

// ---- stage 1 --------------------------------------------------------------

// gradients (amaze:568-579), per pixel
template <class Q>
__device__ __forceinline__ void gradients_px(const Q& p) {
  const float cfa = p.v(CFA);
  const float cl = p.v(CFA, 0, -1), cr = p.v(CFA, 0, 1), cu = p.v(CFA, -1, 0), cd = p.v(CFA, 1, 0);
  const float delh = fabsf(cr - cl);
  const float delv = fabsf(cd - cu);
  p.put(DW0, dirwt(p.v(CFA, -2, 0), cu, cfa, cd, p.v(CFA, 2, 0)));
  p.put(DW1, dirwt(p.v(CFA, 0, -2), cl, cfa, cr, p.v(CFA, 0, 2)));
  p.put(DHV, fma_(delh, delh, delv * delv));
}

// the diagonal gradients (amaze:607-625), per cell
template <class Q>
__device__ __forceinline__ void gradients_cell(const Q& p) {
  const Q s = p.rb_site();
  const bool sl = s.left();
  p.put(DELP, cellsum(fabsf(s.v(CFA, -1, 1) - s.v(CFA, 1, -1)), sl));
  p.put(DELM, cellsum(fabsf(s.v(CFA, 1, 1) - s.v(CFA, -1, -1)), sl));
  const Q g = p.green_site();
  const float gc = g.v(CFA);
  const bool gl = g.left();
  p.put(DGP, cellsum(sqsum(gc - g.v(CFA, -1, 1), gc - g.v(CFA, 1, -1)), gl));
  p.put(DGM, cellsum(sqsum(gc - g.v(CFA, 1, 1), gc - g.v(CFA, -1, -1)), gl));
}

__device__ __forceinline__ float ratio(float cfa, float n, float dwfar, float dw, float far) {
  return (n * (dwfar + dw)) / fma_(dwfar, EPS + cfa, dw * (EPS + far));
}
template <class Q>
__device__ __forceinline__ float hwt_of(const Q& p) {
  return p.v(DW1, 0, -1) / (p.v(DW1, 0, -1) + p.v(DW1, 0, 1));
}
template <class Q>
__device__ __forceinline__ float vwt_of(const Q& p) {
  return p.v(DW0, -1, 0) / (p.v(DW0, 1, 0) + p.v(DW0, -1, 0));
}

// cardinal interpolation (amaze:690-746)
template <class Q>
__device__ __forceinline__ void cardinal(const Q& p) {
  const float cfa = p.v(CFA);
  const float dw0 = p.v(DW0), dw1 = p.v(DW1);
  const float cru = ratio(cfa, p.v(CFA, -1, 0), p.v(DW0, -2, 0), dw0, p.v(CFA, -2, 0));
  const float crd = ratio(cfa, p.v(CFA, 1, 0), p.v(DW0, 2, 0), dw0, p.v(CFA, 2, 0));
  const float crl = ratio(cfa, p.v(CFA, 0, -1), p.v(DW1, 0, -2), dw1, p.v(CFA, 0, -2));
  const float crr = ratio(cfa, p.v(CFA, 0, 1), p.v(DW1, 0, 2), dw1, p.v(CFA, 0, 2));
  const float guha = p.v(CFA, -1, 0) + 0.5f * (cfa - p.v(CFA, -2, 0));
  const float gdha = p.v(CFA, 1, 0) + 0.5f * (cfa - p.v(CFA, 2, 0));
  const float glha = p.v(CFA, 0, -1) + 0.5f * (cfa - p.v(CFA, 0, -2));
  const float grha = p.v(CFA, 0, 1) + 0.5f * (cfa - p.v(CFA, 0, 2));
  float guar = fabsf(1.0f - cru) < ARTHRESH ? cfa * cru : guha;
  float gdar = fabsf(1.0f - crd) < ARTHRESH ? cfa * crd : gdha;
  float glar = fabsf(1.0f - crl) < ARTHRESH ? cfa * crl : glha;
  float grar = fabsf(1.0f - crr) < ARTHRESH ? cfa * crr : grha;
  const float hwt = hwt_of(p), vwt = vwt_of(p);
  const float Gintvha = fma_(vwt, gdha, (1.0f - vwt) * guha);
  const float Ginthha = fma_(hwt, grha, (1.0f - hwt) * glha);
  const float sgn = p.green() ? -1.0f : 1.0f;
  const float vcdalt = sgn * (Gintvha - cfa);
  const float hcdalt = sgn * (Ginthha - cfa);
  const bool clip = (cfa > CLIP_PT8) || (Gintvha > CLIP_PT8) || (Ginthha > CLIP_PT8);
  if (clip) {
    guar = guha;
    gdar = gdha;
    glar = glha;
    grar = grha;
  }
  p.put(VCD0, clip ? vcdalt : sgn * (fma_(vwt, gdar, (1.0f - vwt) * guar) - cfa));
  p.put(HCD0, clip ? hcdalt : sgn * (fma_(hwt, grar, (1.0f - hwt) * glar) - cfa));
  p.put(VCDA, vcdalt);
  p.put(HCDA, hcdalt);
  p.put(DGV, fminf(sq(guha - gdha), sq(guar - gdar)));
  p.put(DGH, fminf(sq(glha - grha), sq(glar - grar)));
}

template <class Q>
__device__ __forceinline__ float var3(const Q& p, int P, int dy, int dx) {
  const float x0 = p.v(P, -dy, -dx), x1 = p.v(P), x2 = p.v(P, dy, dx);
  const float t = (x0 + x1) + x2;
  return fma_(3.0f, fma_(x2, x2, fma_(x0, x0, x1 * x1)), -(t * t));
}
__device__ __forceinline__ float bound_green(float cfa, float cdv, float lo, float hi) {
  const float gint = -cdv + cfa;
  const float wt = 1.0f - (3.0f * cdv) / ((EPS + gint) + cfa);
  const float c_hi = -ulim(gint, lo, hi) + cfa;
  float out = cdv > 0 ? (3.0f * cdv > (gint + cfa) ? c_hi : fma_(wt, cdv, (1.0f - wt) * c_hi)) : cdv;
  return gint > CLIP_PT ? c_hi : out;
}
__device__ __forceinline__ float bound_rb(float cfa, float cdv, float lo, float hi) {
  const float gint = cdv + cfa;
  const float wt = 1.0f + (3.0f * cdv) / ((EPS + gint) + cfa);
  const float c_lo = ulim(gint, lo, hi) - cfa;
  float out = cdv < 0 ? (3.0f * cdv < -(gint + cfa) ? c_lo : fma_(wt, cdv, (1.0f - wt) * c_lo)) : cdv;
  return gint > CLIP_PT ? c_lo : out;
}

// variance-based selection and bounding (amaze:805-874)
template <class Q>
__device__ __forceinline__ void selection(const Q& p) {
  const float cfa = p.v(CFA);
  const float hcd = var3(p, HCDA, 0, 2) < var3(p, HCD0, 0, 2) ? p.v(HCDA) : p.v(HCD0);
  const float vcd = var3(p, VCDA, 2, 0) < var3(p, VCD0, 2, 0) ? p.v(VCDA) : p.v(VCD0);
  const float cl = p.v(CFA, 0, -1), cr = p.v(CFA, 0, 1), cu = p.v(CFA, -1, 0), cd = p.v(CFA, 1, 0);
  if (p.green()) {
    p.put(HCD, bound_green(cfa, hcd, cl, cr));
    p.put(VCD, bound_green(cfa, vcd, cu, cd));
  } else {
    p.put(HCD, bound_rb(cfa, hcd, cl, cr));
    p.put(VCD, bound_rb(cfa, vcd, cu, cd));
  }
}

template <class Q>
__device__ __forceinline__ float var4(const Q& p, int P, int dy, int dx, float ave) {
  const float e0 = p.v(P) - ave, e1 = p.v(P, dy, dx) - ave;
  const float e2 = p.v(P, 2 * dy, 2 * dx) - ave, e3 = p.v(P, 3 * dy, 3 * dx) - ave;
  return fma_(e3, e3, fma_(e2, e2, fma_(e0, e0, e1 * e1)));
}
template <class Q>
__device__ __forceinline__ float sum4(const Q& p, int P, int dy, int dx) {
  return ((p.v(P) + p.v(P, dy, dx)) + p.v(P, 2 * dy, 2 * dx)) + p.v(P, 3 * dy, 3 * dx);
}
template <class Q>
__device__ __forceinline__ float sum3(const Q& p, int P, int dy, int dx) {
  return (p.v(P) + p.v(P, dy, dx)) + p.v(P, 2 * dy, 2 * dx);
}
template <class Q>
__device__ __forceinline__ float cddiffsq(const Q& p) { return sq(p.v(VCD) - p.v(HCD)); }
template <class Q, int N>
__device__ __forceinline__ float ring_cdd(const Q& p, const int (&offs)[N][2]) {
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    acc = acc + cddiffsq(p.at(offs[i][0], offs[i][1]));
  }
  return acc;
}

// directional weights hvwt (amaze:922-962) and the Nyquist test (:967-996),
// at the R/B site of the pixel's cell
template <class Q>
__device__ __forceinline__ void hvwt(const Q& p) {
  const Q s = p.rb_site();
  const float vwt = vwt_of(s), hwt = hwt_of(s);
  const float uave = sum4(s, VCD, -1, 0), dave = sum4(s, VCD, 1, 0);
  const float lave = sum4(s, HCD, 0, -1), rave = sum4(s, HCD, 0, 1);
  const float vvaru = var4(s, VCD, -1, 0, uave), vvard = var4(s, VCD, 1, 0, dave);
  const float hvarl = var4(s, HCD, 0, -1, lave), hvarr = var4(s, HCD, 0, 1, rave);
  const float vcdvar_w = fma_(1.0f - vwt, vvaru, fma_(vwt, vvard, EPSSQ));
  const float hcdvar_w = fma_(1.0f - hwt, hvarl, fma_(hwt, hvarr, EPSSQ));
  const float vcdvar1 = fma_(1.0f - vwt, sum3(s, DGV, -1, 0), fma_(vwt, sum3(s, DGV, 1, 0), EPSSQ));
  const float hcdvar1 = fma_(1.0f - hwt, sum3(s, DGH, 0, -1), fma_(hwt, sum3(s, DGH, 0, 1), EPSSQ));
  const float varwt = hcdvar_w / (vcdvar_w + hcdvar_w);
  const float diffwt = hcdvar1 / (vcdvar1 + hcdvar1);
  const bool agree = ((0.5f - varwt) * (0.5f - diffwt) > 0) &&
                     (fabsf(0.5f - diffwt) < fabsf(0.5f - varwt));
  p.put(HVWT0, cellsum(agree ? varwt : diffwt, s.left()));

  float nyq = fma_(GAUSSODD[0], cddiffsq(s), GAUSSODD[1] * ring_cdd(s, DIAG1));
  nyq = fma_(GAUSSODD[2], ring_cdd(s, AXIS2), nyq);
  nyq = fma_(GAUSSODD[3], ring_cdd(s, DIAG2), nyq);
  float grad = fma_(GAUSSGRAD[1], ring(s, DHV, AXIS1), GAUSSGRAD[0] * s.v(DHV));
  grad = fma_(GAUSSGRAD[2], ring(s, DHV, DIAG1), grad);
  grad = fma_(GAUSSGRAD[3], ring(s, DHV, AXIS2), grad);
  grad = fma_(GAUSSGRAD[4], ring(s, DHV, KNIGHT), grad);
  grad = fma_(GAUSSGRAD[5], ring(s, DHV, DIAG2), grad);
  p.iput(NYQ0, nyq - NYQTHRESH * grad > 0 ? 1 : 0);
}

// ---- stage 2: area interpolation in Nyquist regions (amaze:1016-1045) -----

template <class Q>
__device__ __forceinline__ bool nm_of(const Q& p) { return p.iv(NYQ) > 0 && p.rb(); }

template <class Q>
__device__ __forceinline__ void area(const Q& p) {
  const Q s = p.rb_site();
  if (!nm_of(s)) {
    p.put(HVWT1, p.v(HVWT0));
    return;
  }
  float sumh = 0.0f, sumv = 0.0f, sumsqh = 0.0f, sumsqv = 0.0f, areawt = 0.0f;
  for (int i = -6; i <= 6; i += 2) {
    float rh = 0.0f, rv = 0.0f, rsh = 0.0f, rsv = 0.0f, rw = 0.0f;
    for (int j = -6; j <= 6; j += 2) {
      const Q q = s.at(i, j);
      const float cfa = q.v(CFA);
      const float cl = q.v(CFA, 0, -1), cr = q.v(CFA, 0, 1), cu = q.v(CFA, -1, 0), cd = q.v(CFA, 1, 0);
      const float nmf = nm_of(q) ? 1.0f : 0.0f;
      rh = rh + (cfa - 0.5f * (cl + cr)) * nmf;
      rv = rv + (cfa - 0.5f * (cu + cd)) * nmf;
      rsh = rsh + (0.5f * sqsum(cfa - cl, cfa - cr)) * nmf;
      rsv = rsv + (0.5f * sqsum(cfa - cu, cfa - cd)) * nmf;
      rw = rw + nmf;
    }
    sumh = sumh + rh;
    sumv = sumv + rv;
    sumsqh = sumsqh + rsh;
    sumsqv = sumsqv + rsv;
    areawt = areawt + rw;
  }
  const float hcdvar_a = EPSSQ + fabsf(fma_(areawt, sumsqh, -(sumh * sumh)));
  const float vcdvar_a = EPSSQ + fabsf(fma_(areawt, sumsqv, -(sumv * sumv)));
  p.put(HVWT1, cellsum(hcdvar_a / (vcdvar_a + hcdvar_a), s.left()));
}

// ---- stage 3 --------------------------------------------------------------

// populate G (amaze:1060-1075): the colour difference of the R/B site
template <class Q>
__device__ __forceinline__ void populate(const Q& p) {
  const Q s = p.rb_site();
  const float hv = s.v(HVWT);
  p.put(DGRB0A, cellsum(fma_(s.v(HCD), 1.0f - hv, s.v(VCD) * hv), s.left()));
}

template <class Q>
__device__ __forceinline__ float rgbgreen0(const Q& q) {
  return q.rb() ? q.v(CFA) + q.v(DGRB0A) : q.v(CFA);
}

// G curvature in the Nyquist cells (amaze:1077-1084)
template <class Q>
__device__ __forceinline__ void curvature(const Q& p) {
  const Q s = p.rb_site();
  if (!nm_of(s)) {
    p.put(D2H, 0.0f);
    p.put(D2V, 0.0f);
    return;
  }
  const float g = rgbgreen0(s);
  p.put(D2H, cellsum(sq(g - 0.5f * (rgbgreen0(s.at(0, -1)) + rgbgreen0(s.at(0, 1)))), s.left()));
  p.put(D2V, cellsum(sq(g - 0.5f * (rgbgreen0(s.at(-1, 0)) + rgbgreen0(s.at(1, 0)))), s.left()));
}

template <class Q>
__device__ __forceinline__ float gquinc(const Q& s, int P) {
  float acc = fma_(GQUINC[1], ring(s, P, DIAG1), GQUINC[0] * s.v(P));
  acc = fma_(GQUINC[2], ring(s, P, AXIS2), acc);
  return EPSSQ + fma_(GQUINC[3], ring(s, P, DIAG2), acc);
}

// Nyquist refinement via G curvature (amaze:1085-1102)
template <class Q>
__device__ __forceinline__ void nyq_refine(const Q& p) {
  const float cfa = p.v(CFA);
  float d = p.v(DGRB0A);
  if (p.rb() && nm_of(p)) {  // an R/B pixel is its cell's site
    const float gvarh = gquinc(p, D2H), gvarv = gquinc(p, D2V);
    const float refined = fma_(p.v(HCD), gvarv, p.v(VCD) * gvarh) / (gvarv + gvarh);
    d = cellsum(refined, p.left());
  }
  p.put(DGRB0B, d);
  p.put(RGBG, rgbgreen(p.rb(), cfa, d));
}

__device__ __forceinline__ float diag_est(float cfa, float c1, float c2) {
  const float crv = (2.0f * c1) / ((EPS + cfa) + c2);
  return fabsf(1.0f - crv) < ARTHRESH ? cfa * crv : c1 + 0.5f * (cfa - c2);
}
__device__ __forceinline__ float bound_diag(float cfa, float v, float lo, float hi) {
  const float wt = (2.0f * (cfa - v)) / ((EPS + v) + cfa);
  const float vb = ulim(v, lo, hi);
  return v < cfa ? (2.0f * v < cfa ? vb : fma_(wt, v, (1.0f - wt) * vb)) : v;
}

// diagonal interpolation (amaze:1183-1256) at the R/B site
template <class Q>
__device__ __forceinline__ void diag(const Q& p) {
  const Q s = p.rb_site();
  const float cfa = s.v(CFA);
  const float cm1 = s.v(CFA, 1, 1), cm2 = s.v(CFA, 2, 2);
  const float cm1n = s.v(CFA, -1, -1), cm2n = s.v(CFA, -2, -2);
  const float cp1 = s.v(CFA, -1, 1), cp2 = s.v(CFA, -2, 2);
  const float cp1n = s.v(CFA, 1, -1), cp2n = s.v(CFA, 2, -2);
  const float rbse = diag_est(cfa, cm1, cm2), rbnw = diag_est(cfa, cm1n, cm2n);
  const float rbne = diag_est(cfa, cp1, cp2), rbsw = diag_est(cfa, cp1n, cp2n);
  const float delm = s.v(DELM), delp = s.v(DELP);
  const float wtse = ((EPS + delm) + s.v(DELM, 1, 1)) + s.v(DELM, 2, 2);
  const float wtnw = ((EPS + delm) + s.v(DELM, -1, -1)) + s.v(DELM, -2, -2);
  const float wtne = ((EPS + delp) + s.v(DELP, -1, 1)) + s.v(DELP, -2, 2);
  const float wtsw = ((EPS + delp) + s.v(DELP, 1, -1)) + s.v(DELP, 2, -2);
  float rbm = fma_(wtse, rbnw, wtnw * rbse) / (wtse + wtnw);
  float rbp = fma_(wtne, rbsw, wtsw * rbne) / (wtne + wtsw);
  const float rbvarm =
      EPSSQ + fma_(GAUSSEVEN[0], ring(s, DGM, GE_NEAR), GAUSSEVEN[1] * ring(s, DGM, GE_FAR));
  const float rbvarp =
      EPSSQ + fma_(GAUSSEVEN[0], ring(s, DGP, GE_NEAR), GAUSSEVEN[1] * ring(s, DGP, GE_FAR));
  rbp = bound_diag(cfa, rbp, cp1n, cp1);
  rbm = bound_diag(cfa, rbm, cm1n, cm1);
  rbp = rbp > CLIP_PT ? ulim(rbp, cp1n, cp1) : rbp;
  rbm = rbm > CLIP_PT ? ulim(rbm, cm1n, cm1) : rbm;
  const bool sl = s.left();
  p.put(RBP, cellsum(rbp, sl));
  p.put(RBM, cellsum(rbm, sl));
  p.put(PMWT0, cellsum(rbvarm / (rbvarp + rbvarm), sl));
}

// ---- stage 4 --------------------------------------------------------------

template <class Q>
__device__ __forceinline__ void rb_interp(const Q& p) {
  const Q s = p.rb_site();
  const float pm = s.v(PMWT);
  p.put(RBINT, cellsum(0.5f * fma_(s.v(RBP), pm, fma_(s.v(RBM), 1.0f - pm, s.v(CFA))), s.left()));
}

__device__ __forceinline__ float g_est(float rbint, float c, float far) {
  const float crv = (c * 2.0f) / ((EPS + rbint) + far);
  return fabsf(1.0f - crv) < ARTHRESH ? rbint * crv : c + 0.5f * (rbint - far);
}
__device__ __forceinline__ float bound_g(float rbint, float G, float lo, float hi) {
  const float wt = (2.0f * (rbint - G)) / ((EPS + G) + rbint);
  const float Gb = ulim(G, lo, hi);
  return G < rbint ? (2.0f * G < rbint ? Gb : fma_(wt, G, (1.0f - wt) * Gb)) : G;
}

// G correction via R+B (amaze:1287-1352), the merge, and the chroma planes
// (amaze:1358-1385): G-R on R rows (even) in d0, G-B on B rows (odd) in d1
template <class Q>
__device__ __forceinline__ void gcorr(const Q& p) {
  const Q s = p.rb_site();
  const float cfa = s.v(CFA), rbint = s.v(RBINT);
  const float cl = s.v(CFA, 0, -1), cr = s.v(CFA, 0, 1), cu = s.v(CFA, -1, 0), cd = s.v(CFA, 1, 0);
  const float gu = g_est(rbint, cu, s.v(RBINT, -2, 0)), gd = g_est(rbint, cd, s.v(RBINT, 2, 0));
  const float gl = g_est(rbint, cl, s.v(RBINT, 0, -2)), gr = g_est(rbint, cr, s.v(RBINT, 0, 2));
  float Gintv2 = fma_(s.v(DW0, -1, 0), gd, s.v(DW0, 1, 0) * gu) / (s.v(DW0, 1, 0) + s.v(DW0, -1, 0));
  float Ginth2 = fma_(s.v(DW1, 0, -1), gr, s.v(DW1, 0, 1) * gl) / (s.v(DW1, 0, -1) + s.v(DW1, 0, 1));
  Gintv2 = bound_g(rbint, Gintv2, cu, cd);
  Ginth2 = bound_g(rbint, Ginth2, cl, cr);
  Ginth2 = Ginth2 > CLIP_PT ? ulim(Ginth2, cl, cr) : Ginth2;
  Gintv2 = Gintv2 > CLIP_PT ? ulim(Gintv2, cu, cd) : Gintv2;
  const float hv = s.v(HVWT);
  const bool use_diag = fabsf(0.5f - s.v(PMWT)) >= fabsf(0.5f - hv);
  const float g_diag = fma_(Ginth2, 1.0f - hv, Gintv2 * hv);
  for (int l = 0; l < p.lanes(); ++l) {
    const Q q = p.lane(l);
    q.put(RGBG2, (q.rb() && use_diag) ? g_diag : q.v(RGBG));
  }
  const float d = cellsum(use_diag ? g_diag - cfa : s.v(DGRB0B), s.left());
  const bool brow = (p.y & 1) == 1;
  p.put(D1, brow ? d : 0.0f);
  p.put(D0, brow ? 0.0f : d);
}

// ---- stage 5: output (amaze:1401-1468), cropped ---------------------------

// Output pixel i of the cropped (B, hp - 32, wp - 32) planes, at padded
// pixel p.
template <class Q>
__device__ __forceinline__ void output_at(const Q& p, long long i, float* red, float* grn, float* blu) {
  const float hv_u = p.v(HVWT, -1, 0), hv_d = p.v(HVWT, 1, 0);
  const float hv_l = p.v(HVWT, 0, -1), hv_r = p.v(HVWT, 0, 1);
  const float wsum = ((hv_u + (1.0f - hv_r)) + (1.0f - hv_l)) + hv_d;
  const float g = p.v(RGBG2);
  float r, b;
  if (p.green()) {
    auto at_green = [&](int P) {
      const float acc = fma_(hv_d, p.v(P, 1, 0),
                             fma_(1.0f - hv_l, p.v(P, 0, -1),
                                  fma_(hv_u, p.v(P, -1, 0), (1.0f - hv_r) * p.v(P, 0, 1))));
      return acc / wsum;
    };
    r = g - at_green(D0S);
    b = g - at_green(D1S);
  } else {
    r = g - p.v(D0S);
    b = g - p.v(D1S);
  }
  red[i] = r * 65535.0f;
  grn[i] = g * 65535.0f;
  blu[i] = b * 65535.0f;
}

}  // namespace amaze_stages
