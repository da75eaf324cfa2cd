// The dual-ISO reconstruction's computed EV transforms, elementwise,
// hand-written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference computes these in plain XLA
// (mlvfs_tpu/ops/evmath.py). Their plain twins (mlvfs_tpu_torch/ops/
// evmath.py) compute each float32 fused multiply-add exactly from about two
// dozen float64 torch ops, and log_f32 and exp_f32 chain nine and eight of
// them a pixel, so the twins were some 8,000 elementwise launches a 1080p
// batch and about 85 % of the card's time in both dual-ISO cells (PERF.md
// section 5). Here each transform is one launch; __fmaf_rn is the correctly
// rounded float32 FMA those ops emulate, so the values are the same bits.
// The arithmetic is csrc/evmath.cuh's, which a fused kernel can include.
//
// Entries (plain C, loaded with ctypes by mlvfs_tpu_torch/_build.py; each
// launches on the caller's stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError() after the launch):
//   mlvfs_ev_fma           out = x * y + z, rounded once
//   mlvfs_ev_log2_add      out = log2(x) + c, the multiply contracted
//   mlvfs_ev_<f>           out = f(x) for log_f32, log2_f32, exp2_f32 (float32),
//                          raw2ev20, ev2raw20 (int32 -> int32) and
//                          fullres_weight (int32 -> float32)
// An operand of fma or log2_add is a full plane (contiguous, the result's
// shape), a strided view that broadcasts to it (a per-frame (B, 1, 1)
// vector; the analysis' (B, 1) x (1, S) products), or a value passed by
// argument: ops/evmath.py's plan_operands classifies them and merges the
// result's dimensions into at most three, (d0, d1, d2), over which a
// strided operand gives its element strides. Nothing is expanded into a
// full plane. ev2raw20's raw2ev20(0) is an argument, computed once on the
// host.
//
// What bounds it on an H100: bytes. A unary transform reads 4 B and writes
// 4 B a pixel, 8 B: 0.079 ms for a 1080p batch of 16 (33.2 M pixels) at
// 3.35 TB/s; fma over three full planes 16 B, 0.158 ms. Its operations
// (about 25 to 60 float32 a pixel; ev2raw20 two exponentials) take 0.02 to
// 0.06 ms at 33.5 Tops/s of float32 instructions outside FMAs. Design for
// the bytes: a grid-stride loop over groups of 4 pixels, each full plane
// read and the result written by one 16-B vector access a group (when every
// full plane and the result start on 16 B), the last n % 4 pixels plainly;
// blocks of 256 threads, 8 an SM, so that enough loads are in flight; a
// strided operand's (i0, i1, i2) is found once a group by 32-bit division
// and stepped, and its few distinct values are served by L1 and L2.

#include <cstdint>
#include <cuda_runtime.h>

#include "evmath.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;
constexpr long long MAX_ELEMENTS = (1LL << 31) - 1;  // 32-bit element indices

enum Kind : int { VALUE = 0, FULL = 1, STRIDED = 2 };  // ops/evmath.py: VALUE, FULL, STRIDED

struct Operand {
  const float* ptr;  // FULL, STRIDED
  float value;       // VALUE
  long long s0, s1, s2;  // STRIDED: element strides over (d0, d1, d2)
};

struct Dims {
  unsigned d1, d2;  // d0 = n / (d1 * d2)
};

__device__ __forceinline__ float strided_at(const Operand& o, unsigned i0, unsigned i1, unsigned i2) {
  return o.ptr[i0 * o.s0 + i1 * o.s1 + i2 * o.s2];
}

template <int K>
__device__ __forceinline__ float load1(const Operand& o, unsigned i, Dims d) {
  if constexpr (K == VALUE) {
    return o.value;
  } else if constexpr (K == FULL) {
    return o.ptr[i];
  } else {
    const unsigned q = i / d.d2, i0 = q / d.d1;
    return strided_at(o, i0, q - i0 * d.d1, i - q * d.d2);
  }
}

template <int K>
__device__ __forceinline__ float4 load4(const Operand& o, unsigned g, Dims d) {
  if constexpr (K == VALUE) {
    return make_float4(o.value, o.value, o.value, o.value);
  } else if constexpr (K == FULL) {
    return reinterpret_cast<const float4*>(o.ptr)[g];
  } else {
    const unsigned i = 4 * g, q = i / d.d2;
    unsigned i0 = q / d.d1, i1 = q - i0 * d.d1, i2 = i - q * d.d2;
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[k] = strided_at(o, i0, i1, i2);
      if (++i2 == d.d2) {
        i2 = 0;
        if (++i1 == d.d1) {
          i1 = 0;
          ++i0;
        }
      }
    }
    return make_float4(v[0], v[1], v[2], v[3]);
  }
}

struct Fma {
  __device__ float operator()(float x, float y, float z) const { return __fmaf_rn(x, y, z); }
};

struct Log2Add {  // z unused
  __device__ float operator()(float x, float c, float) const { return evmath::log2_add(x, c); }
};

// out[i] = f(x[i], y[i], z[i]) over operands of kinds KX, KY, KZ
template <class F, int KX, int KY, int KZ>
__global__ void __launch_bounds__(THREADS)
    operand_kernel(float* __restrict__ out, unsigned n, Dims d, Operand x, Operand y, Operand z,
                   bool vec, F f) {
  const unsigned step = gridDim.x * THREADS;
  const unsigned first = blockIdx.x * THREADS + threadIdx.x;
  unsigned done = 0;
  if (vec) {
    const unsigned groups = n / 4;
    for (unsigned g = first; g < groups; g += step) {
      const float4 a = load4<KX>(x, g, d), b = load4<KY>(y, g, d), c = load4<KZ>(z, g, d);
      reinterpret_cast<float4*>(out)[g] =
          make_float4(f(a.x, b.x, c.x), f(a.y, b.y, c.y), f(a.z, b.z, c.z), f(a.w, b.w, c.w));
    }
    done = groups * 4;
  }
  for (unsigned i = done + first; i < n; i += step) {
    out[i] = f(load1<KX>(x, i, d), load1<KY>(y, i, d), load1<KZ>(z, i, d));
  }
}

template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
};
template <>
struct Vec4<int> {
  using type = int4;
};

// out[i] = f(x[i]) over a contiguous plane
template <typename In, typename Out, class F>
__global__ void __launch_bounds__(THREADS)
    map_kernel(Out* __restrict__ out, const In* __restrict__ x, unsigned n, bool vec, F f) {
  using VIn = typename Vec4<In>::type;
  using VOut = typename Vec4<Out>::type;
  const unsigned step = gridDim.x * THREADS;
  const unsigned first = blockIdx.x * THREADS + threadIdx.x;
  unsigned done = 0;
  if (vec) {
    const unsigned groups = n / 4;
    for (unsigned g = first; g < groups; g += step) {
      const VIn a = reinterpret_cast<const VIn*>(x)[g];
      VOut r;
      r.x = f(a.x);
      r.y = f(a.y);
      r.z = f(a.z);
      r.w = f(a.w);
      reinterpret_cast<VOut*>(out)[g] = r;
    }
    done = groups * 4;
  }
  for (unsigned i = done + first; i < n; i += step) {
    out[i] = f(x[i]);
  }
}

struct LogF32 {
  __device__ float operator()(float x) const { return evmath::log_f32(x); }
};
struct Log2F32 {
  __device__ float operator()(float x) const { return evmath::log2_f32(x); }
};
struct Exp2F32 {
  __device__ float operator()(float x) const { return evmath::exp2_f32(x); }
};
struct Raw2Ev20 {
  float b64;
  __device__ int operator()(int i) const { return evmath::raw2ev20(i, b64); }
};
struct Ev2Raw20 {
  evmath::Ev2Raw lv;
  __device__ int operator()(int ev) const { return evmath::ev2raw20(ev, lv); }
};
struct FullresWeight {
  float b64;
  __device__ float operator()(int i) const { return evmath::fullres_weight(i, b64); }
};

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// blocks for ``items`` work items (groups of 4, or pixels), at most
// BLOCKS_PER_SM on each SM of the current device
unsigned blocks_for(unsigned long long items) {
  static int sms[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) {
    dev = 0;
  }
  if (sms[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    sms[dev] = n > 0 ? n : 1;
  }
  const unsigned long long want = (items + THREADS - 1) / THREADS;
  const unsigned long long cap = (unsigned long long)sms[dev] * BLOCKS_PER_SM;
  return (unsigned)(want < cap ? (want > 0 ? want : 1) : cap);
}

Operand operand(const void* ptr, float value, long long s0, long long s1, long long s2) {
  return {static_cast<const float*>(ptr), value, s0, s1, s2};
}

template <class F, int KX, int KY, int KZ>
int launch_operands(float* out, unsigned n, Dims d, const Operand& x, const Operand& y,
                    const Operand& z, F f, cudaStream_t stream) {
  const bool vec = aligned(out) && (KX != FULL || aligned(x.ptr)) && (KY != FULL || aligned(y.ptr)) &&
                   (KZ != FULL || aligned(z.ptr));
  operand_kernel<F, KX, KY, KZ>
      <<<blocks_for(vec ? n / 4 + n % 4 : n), THREADS, 0, stream>>>(out, n, d, x, y, z, vec, f);
  return (int)cudaGetLastError();
}

// the kinds as template arguments, one at a time
template <class F, int KX, int KY>
int with_z(int kz, float* out, unsigned n, Dims d, const Operand& x, const Operand& y,
           const Operand& z, F f, cudaStream_t s) {
  switch (kz) {
    case VALUE: return launch_operands<F, KX, KY, VALUE>(out, n, d, x, y, z, f, s);
    case FULL: return launch_operands<F, KX, KY, FULL>(out, n, d, x, y, z, f, s);
    default: return launch_operands<F, KX, KY, STRIDED>(out, n, d, x, y, z, f, s);
  }
}

template <class F, int KX>
int with_y(int ky, int kz, float* out, unsigned n, Dims d, const Operand& x, const Operand& y,
           const Operand& z, F f, cudaStream_t s) {
  switch (ky) {
    case VALUE: return with_z<F, KX, VALUE>(kz, out, n, d, x, y, z, f, s);
    case FULL: return with_z<F, KX, FULL>(kz, out, n, d, x, y, z, f, s);
    default: return with_z<F, KX, STRIDED>(kz, out, n, d, x, y, z, f, s);
  }
}

bool bad_shape(long long n, long long d1, long long d2) {
  return n < 0 || n > MAX_ELEMENTS || d1 < 1 || d2 < 1 || d1 > MAX_ELEMENTS ||
         d2 > MAX_ELEMENTS || (n > 0 && n % (d1 * d2) != 0);
}

bool bad_kind(int k, const void* ptr) {
  return k < VALUE || k > STRIDED || (k != VALUE && ptr == nullptr);
}

template <typename In, typename Out, class F>
int launch_map(void* out, long long n, const void* x, F f, void* stream) {
  if (n < 0 || n > MAX_ELEMENTS || (n > 0 && (out == nullptr || x == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) {
    return 0;
  }
  const unsigned un = (unsigned)n;
  const bool vec = aligned(out) && aligned(x);
  map_kernel<In, Out, F><<<blocks_for(vec ? un / 4 + un % 4 : un), THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<Out*>(out), static_cast<const In*>(x), un, vec, f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mlvfs_ev_fma(void* out, long long n, long long d1, long long d2,
                            const void* xp, int xk, float xv, long long xs0, long long xs1, long long xs2,
                            const void* yp, int yk, float yv, long long ys0, long long ys1, long long ys2,
                            const void* zp, int zk, float zv, long long zs0, long long zs1, long long zs2,
                            void* stream) {
  if (bad_shape(n, d1, d2) || bad_kind(xk, xp) || bad_kind(yk, yp) || bad_kind(zk, zp) ||
      (n > 0 && out == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) {
    return 0;
  }
  const Dims d{(unsigned)d1, (unsigned)d2};
  const Operand x = operand(xp, xv, xs0, xs1, xs2), y = operand(yp, yv, ys0, ys1, ys2),
                z = operand(zp, zv, zs0, zs1, zs2);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (xk) {
    case VALUE: return with_y<Fma, VALUE>(yk, zk, o, (unsigned)n, d, x, y, z, Fma{}, s);
    case FULL: return with_y<Fma, FULL>(yk, zk, o, (unsigned)n, d, x, y, z, Fma{}, s);
    default: return with_y<Fma, STRIDED>(yk, zk, o, (unsigned)n, d, x, y, z, Fma{}, s);
  }
}

extern "C" int mlvfs_ev_log2_add(void* out, long long n, long long d1, long long d2, const void* xp,
                                 const void* cp, int ck, float cv, long long cs0, long long cs1,
                                 long long cs2, void* stream) {
  if (bad_shape(n, d1, d2) || bad_kind(FULL, xp) || bad_kind(ck, cp) || (n > 0 && out == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) {
    return 0;
  }
  const Dims d{(unsigned)d1, (unsigned)d2};
  const Operand x = operand(xp, 0.0f, 0, 0, 0), c = operand(cp, cv, cs0, cs1, cs2);
  const Operand unused = operand(nullptr, 0.0f, 0, 0, 0);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (ck) {
    case VALUE: return launch_operands<Log2Add, FULL, VALUE, VALUE>(o, (unsigned)n, d, x, c, unused, Log2Add{}, s);
    case FULL: return launch_operands<Log2Add, FULL, FULL, VALUE>(o, (unsigned)n, d, x, c, unused, Log2Add{}, s);
    default: return launch_operands<Log2Add, FULL, STRIDED, VALUE>(o, (unsigned)n, d, x, c, unused, Log2Add{}, s);
  }
}

extern "C" int mlvfs_ev_log_f32(void* out, long long n, const void* x, void* stream) {
  return launch_map<float, float>(out, n, x, LogF32{}, stream);
}

extern "C" int mlvfs_ev_log2_f32(void* out, long long n, const void* x, void* stream) {
  return launch_map<float, float>(out, n, x, Log2F32{}, stream);
}

extern "C" int mlvfs_ev_exp2_f32(void* out, long long n, const void* x, void* stream) {
  return launch_map<float, float>(out, n, x, Exp2F32{}, stream);
}

extern "C" int mlvfs_ev_raw2ev20(void* out, long long n, const void* i, int black20, void* stream) {
  return launch_map<int, int>(out, n, i, Raw2Ev20{evmath::black64(black20)}, stream);
}

extern "C" int mlvfs_ev_ev2raw20(void* out, long long n, const void* ev, int black20, int white20,
                                 int white_ev, int zero_ev, void* stream) {
  return launch_map<int, int>(out, n, ev,
                              Ev2Raw20{evmath::ev2raw_levels(black20, white20, white_ev, zero_ev)},
                              stream);
}

extern "C" int mlvfs_ev_fullres_weight(void* out, long long n, const void* i, int black20,
                                       void* stream) {
  return launch_map<int, float>(out, n, i, FullresWeight{evmath::black64(black20)}, stream);
}
