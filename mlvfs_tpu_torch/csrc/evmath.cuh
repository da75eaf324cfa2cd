// The dual-ISO reconstruction's computed EV transforms as device functions,
// each the float32 arithmetic of its plain twin in
// mlvfs_tpu_torch/ops/evmath.py, operation for operation: __fmaf_rn exactly
// where the twin calls fma (one rounding, which the twin gets from an exact
// float64 emulation), and every other operation rounded on its own. A
// source that includes this header builds with -fmad=false
// (_build.EXTRA_FLAGS), so that nvcc contracts nothing the twin does not.
//
// csrc/evmath.cu runs each one elementwise; a fused kernel of the
// reconstruction can include this header and call them on values in
// registers. The constants are the twin's float32 values, as exact hex
// literals (tests/test_torch_evmath.py holds them equal).

#pragma once

#include <cstdint>

namespace evmath {

constexpr float INV_LN2 = 0x1.715476p+0f;  // XLA's folded f32(1 / ln 2)
constexpr float LN2 = 0x1.62e430p-1f;
constexpr float EV_RESOLUTION = 32768.0f;  // luts.EV_RESOLUTION (mlvfs.h:87)

// Cephes float32 constants, as XLA's CPU backend uses them
constexpr float SQRTHF = 0x1.6a09e6p-1f;
constexpr float LOG_P0 = 0x1.204376p-4f;
constexpr float LOG_P1 = -0x1.d7a370p-4f;
constexpr float LOG_P2 = 0x1.de4a34p-4f;
constexpr float LOG_P3 = -0x1.fcba9ep-4f;
constexpr float LOG_P4 = 0x1.23d37ep-3f;
constexpr float LOG_P5 = -0x1.555ca0p-3f;
constexpr float LOG_P6 = 0x1.999d58p-3f;
constexpr float LOG_P7 = -0x1.fffff8p-3f;
constexpr float LOG_P8 = 0x1.555554p-2f;
constexpr float LOG_Q1 = -0x1.bd0106p-13f;
constexpr float LOG_Q2 = 0x1.630000p-1f;
constexpr float LOG2EF = 0x1.715476p+0f;
constexpr float EXP_C1 = 0x1.630000p-1f;
constexpr float EXP_C2 = -0x1.bd0106p-13f;
constexpr float EXP_P0 = 0x1.a0d2cep-13f;
constexpr float EXP_P1 = 0x1.6e879cp-10f;
constexpr float EXP_P2 = 0x1.111210p-7f;
constexpr float EXP_P3 = 0x1.555382p-5f;
constexpr float EXP_P4 = 0x1.555554p-3f;
constexpr float EXP_P5 = 0x1.000000p-1f;
constexpr float EXP_LO = -104.0f;
constexpr float EXP_HI = 0x1.633334p+6f;  // f32(88.8)
constexpr float MIN_NORM = 0x1p-126f;
constexpr float PI_4 = 0x1.921fb6p-1f;  // f32(pi / 4), the fullres curve's pi / transition

__device__ __forceinline__ bool is_nan(float x) {
  return (__float_as_uint(x) & 0x7fffffffu) > 0x7f800000u;
}

__device__ __forceinline__ bool is_inf(float x) {
  return (__float_as_uint(x) & 0x7fffffffu) == 0x7f800000u;
}

__device__ __forceinline__ float nan_f32() {
  return __uint_as_float(0x7fc00000u);  // torch.nan as float32
}

// torch.clamp: min(max(x, lo), hi), a NaN staying NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return is_nan(x) ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return is_nan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// natural log, as XLA's CPU backend computes it (evmath.py: log_f32_plain)
__device__ __forceinline__ float log_f32(float x) {
  const float xc = clamp_min(x, MIN_NORM);  // cut off subnormals
  const int bits = __float_as_int(xc);
  float e = __fadd_rn(1.0f, __int2float_rn((bits >> 23) - 0x7f));
  const float m = __int_as_float((bits & ~0x7f800000) | 0x3f000000);  // in [0.5, 1)
  const bool small = m < SQRTHF;
  e = __fsub_rn(e, small ? 1.0f : 0.0f);
  float t = __fadd_rn(__fsub_rn(m, 1.0f), small ? m : 0.0f);
  const float x2 = __fmul_rn(t, t);
  const float x3 = __fmul_rn(x2, t);
  float y = __fmaf_rn(t, LOG_P0, LOG_P1);
  float y1 = __fmaf_rn(t, LOG_P3, LOG_P4);
  float y2 = __fmaf_rn(t, LOG_P6, LOG_P7);
  y = __fmaf_rn(y, t, LOG_P2);
  y1 = __fmaf_rn(y1, t, LOG_P5);
  y2 = __fmaf_rn(y2, t, LOG_P8);
  y = __fmaf_rn(y, x3, y1);
  y = __fmaf_rn(y, x3, y2);
  y = __fmaf_rn(y, x3, __fmul_rn(LOG_Q1, e));
  t = __fadd_rn(__fmaf_rn(-0.5f, x2, t), y);
  float out = __fmaf_rn(LOG_Q2, e, t);
  if (is_inf(x)) {
    out = x;
  } else if (x == 0.0f) {
    out = -__int_as_float(0x7f800000);
  }
  return (x < 0.0f || is_nan(x)) ? nan_f32() : out;
}

// exp for x in about [-87, 88] (evmath.py: exp_f32_plain)
__device__ __forceinline__ float exp_f32(float x) {
  const float xc = clamp(x, EXP_LO, EXP_HI);
  const float n = floorf(__fmaf_rn(xc, LOG2EF, 0.5f));
  float r = __fmaf_rn(-EXP_C1, n, xc);
  r = __fmaf_rn(-EXP_C2, n, r);
  const float z = __fmul_rn(r, r);
  float y = __fmaf_rn(r, EXP_P0, EXP_P1);
  y = __fmaf_rn(y, r, EXP_P2);
  y = __fmaf_rn(y, r, EXP_P3);
  y = __fmaf_rn(y, r, EXP_P4);
  y = __fmaf_rn(y, r, EXP_P5);
  y = __fadd_rn(1.0f, __fmaf_rn(y, z, r));
  const int ni = min(max(__float2int_rz(n), -126), 127);
  return __fmul_rn(y, __int_as_float((ni + 127) << 23));  // y * 2^n
}

// jnp.log2 as XLA lowers it: log(x) * f32(1 / ln 2), two roundings
__device__ __forceinline__ float log2_f32(float x) {
  return __fmul_rn(log_f32(x), INV_LN2);
}

// log2(x) + c, the multiply contracted into the add
__device__ __forceinline__ float log2_add(float x, float c) {
  return __fmaf_rn(log_f32(x), INV_LN2, c);
}

// jnp.exp2 as XLA lowers it: exp(x * f32(ln 2))
__device__ __forceinline__ float exp2_f32(float x) {
  return exp_f32(__fmul_rn(x, LN2));
}

// f32(black20 / 64.0): the black level the 20-bit transforms subtract, taken
// once per launch (the twin's Python scalar)
__host__ __device__ inline float black64(int black20) {
  return static_cast<float>(static_cast<double>(black20) / 64.0);
}

// round(log2(1 + |i/64 - black/64|) * EVR) * sign (hdr.c:843-850); ``b64``
// is black64(black20)
__device__ __forceinline__ int raw2ev20(int i, float b64) {
  const float signal = clamp_min(__fsub_rn(__fdiv_rn(__int2float_rn(i), 64.0f), b64), -1023.0f);
  const float mag = rintf(__fmul_rn(log2_f32(__fadd_rn(1.0f, fabsf(signal))), EV_RESOLUTION));
  return __float2int_rz(signal > 0.0f ? mag : -mag);
}

// ev2raw20's levels as float32, the twin's Python scalars, taken once per
// launch; ``white_ev`` is raw2ev(white20) and ``zero_ev`` raw2ev20(0)
struct Ev2Raw {
  float pos_base;  // black20 - 64
  float neg_base;  // black20 + 64
  float black;
  float white;
  int white_ev, zero_ev;
};

__host__ __device__ inline Ev2Raw ev2raw_levels(int black20, int white20, int white_ev, int zero_ev) {
  return {static_cast<float>(black20 - 64.0), static_cast<float>(black20 + 64.0),
          static_cast<float>(static_cast<double>(black20)),
          static_cast<float>(static_cast<double>(white20)), white_ev, zero_ev};
}

// the inverse with the black offset and the white clamp (hdr.c:852-865)
__device__ __forceinline__ int ev2raw20(int ev, const Ev2Raw& lv) {
  const float evf = __int2float_rn(ev);
  float pos = __fadd_rn(lv.pos_base,
                        rintf(__fmul_rn(64.0f, exp2_f32(__fdiv_rn(evf, EV_RESOLUTION)))));
  pos = clamp(pos, lv.black, 1048575.0f);
  if (ev >= lv.white_ev) {
    pos = clamp_min(pos, lv.white);
  }
  const float neg = clamp(
      __fsub_rn(lv.neg_base, rintf(__fmul_rn(64.0f, exp2_f32(__fdiv_rn(-evf, EV_RESOLUTION))))),
      0.0f, lv.black);
  float out = ev < 0 ? neg : pos;
  if (ev == lv.zero_ev) {
    out = 0.0f;  // table quirk: ev2raw[raw2ev[0]] = 0 keeps fully-dead pixels (hdr.c:868)
  }
  return __float2int_rz(out);
}

// the fullres mixing curve (build_fullres_curve, hdr.c:890-913); the cosine
// is taken in float64 and rounded once, as the twin's cos_f32 takes it
__device__ __forceinline__ float fullres_weight(int i, float b64) {
  const float x = clamp_min(__fsub_rn(__fdiv_rn(__int2float_rn(i), 64.0f), b64), 1.0f);
  const float ev2 = log2_add(x, -4.0f);  // log2(x) - 4, contracted
  const float arg = __fmul_rn(clamp(ev2, 0.0f, 4.0f), PI_4);
  const float c2 = -__double2float_rn(cos(static_cast<double>(arg)));
  return __fmul_rn(__fadd_rn(c2, 1.0f), 0.5f);
}

}  // namespace evmath
