// The dual-ISO reconstruction's float stages, fused, hand-written for Hopper
// (sm_90a): the exposure match, the full-res select and half-res EV blend
// with the alias map's EV planes and pre-map, and the final blend with the
// overexposure blur, each one launch.
//
// Replaces no Pallas kernel: the reference computes these stages in plain
// XLA (mlvfs_tpu/ops/dualiso_full.py reconstruct_batch). Their plain twins
// (mlvfs_tpu_torch/ops/dualiso_recon.py, <stage>_plain) are some 150 torch
// operations and 16 EV-transform launches a batch: about 10 ms of the main
// thread's issue and 15 ms of the card's time a 1080p batch of 16 (PERF.md
// section 5). Here each stage reads its planes once and writes its results
// once; the EV transforms are csrc/evmath.cuh's device functions, computed in
// registers.
//
// Exactness: every value is the twin's on the card, bit for bit. Each float32
// operation is rounded on its own (the source builds with -fmad=false,
// _build.EXTRA_FLAGS) and __fmaf_rn stands exactly where the twin calls
// evmath.fma; a division by a Python number is PyTorch's multiply by the
// float32 reciprocal on the card (div_true_kernel_cuda), a division by a
// tensor a correctly rounded one; cos is taken in double and rounded once,
// as torch.cos(x.double()).float(); torch.clamp, maximum and minimum keep a
// NaN as the twin's do.
//
// Entries (plain C, loaded with ctypes by mlvfs_tpu_torch/_build.py; each
// launches on the caller's stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for arguments it does not take):
//   mlvfs_recon_match         raw20 (B, hh, W) int32 from the int16 frames
//                             (a strided view: frame and row strides),
//                             promoted to 20 bits and exposure-matched
//   mlvfs_recon_blend         the full-res select, the half-res blend and
//                             the overexposed mask; with ``planes`` the alias
//                             planes of that full-res and half-res instead
//                             of the two planes (no chroma smoothing between)
//   mlvfs_recon_alias_planes  the alias planes of smoothed planes (--cs*)
//   mlvfs_recon_final         the final blend to 16-bit output
// The alias planes: the fullres curve of the bright frame, the EVs of the
// smoothed half-res and full-res (and of the unsmoothed full-res where they
// differ), the alias pre-map (build_alias_map's elementwise part) and its
// skip mask; kernel #7 (csrc/alias.cu) filters the pre-map.
//
// What bounds it on an H100: bytes. A pixel moves 6 B in match (2 in, 4
// out), 26 B in blend with the planes (8 in; 4 + 4 + 4 + 4 out, two 1-B
// masks), 27 B in final (hs_ev, fs_ev, f, the filtered alias, dark, bright
// 24, the mask 1, 2 out): 59 B, 1.96 GB for a 1080p batch of 16 (33.2 M
// pixels), 0.584 ms at 3.35 TB/s. Its operations (two log/exp chains, a
// double cos, three raw2ev and a fullres curve a pixel, about 300 float32
// and a few float64 operations) take ~0.15 ms at 67 TFLOP/s. Design for the
// bytes: a block walks one row of a frame (its per-row and per-frame values
// loaded once), its threads on neighbouring pixels, so every plane is read
// and written in whole 128-B lines; the final blend's 3 x 3 window of the
// 1-B mask comes from L1/L2.

#include <cstdint>
#include <cuda_runtime.h>

#include "evmath.cuh"

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_ROWS = (1LL << 31) - 1;  // a block a row: gridDim.x
constexpr float PI_F32 = 0x1.921fb6p+1f;  // float(np.float32(math.pi))
constexpr float FULLRES_THR = 0.8f;  // dualiso_recon.FULLRES_THR
constexpr int E_LIN_NOISE = 768;  // int(DARK_NOISE20) * 3 // 2
constexpr int ALIAS_CAP = 65530;
constexpr float SIG_SCALE = 0x1p-11f;  // 1 / (4 * DARK_NOISE20), exact
constexpr int EV_LO = -10 * 32768, EV_HI = 14 * 32768 - 1;  // the output's EV clamp

// PyTorch's multiply by the float32 reciprocal of a Python divisor on the
// card (opmath_t(1.0) / divisor), as exact hex literals
// (tests/test_torch_recon_fused.py holds them equal)
constexpr float INV_200 = 0x1.47ae14p-8f;          // f32(1) / f32(200)
constexpr float INV_ALIAS_MAX = 0x1.179ecap-14f;  // f32(1) / f32(alias.ALIAS_MAP_MAX = 15000)

struct Levels {
  int black20, white20;
  float black;  // f32(black20)
  float b64;    // evmath::black64(black20)
  float max_ev;
  evmath::Ev2Raw ev2raw;
};

Levels levels(int black20, int white20, int white_ev, int zero_ev, float max_ev) {
  return {black20, white20, static_cast<float>(black20), evmath::black64(black20), max_ev,
          evmath::ev2raw_levels(black20, white20, white_ev, zero_ev)};
}

// torch.maximum / torch.minimum: a NaN operand is the result
__device__ __forceinline__ float t_max(float a, float b) {
  return evmath::is_nan(a) ? a : evmath::is_nan(b) ? b : fmaxf(a, b);
}

__device__ __forceinline__ float t_min(float a, float b) {
  return evmath::is_nan(a) ? a : evmath::is_nan(b) ? b : fminf(a, b);
}

// ------------------------------------------------------------------ match

__global__ void __launch_bounds__(THREADS)
    match_kernel(int* __restrict__ out, const int16_t* __restrict__ imgs, long long frame_stride,
                 long long row_stride, const bool* __restrict__ row_bright, const float* __restrict__ a,
                 const float* __restrict__ b20, int hh, int w, float black) {
  const long long row = blockIdx.x;
  const int b = static_cast<int>(row / hh), y = static_cast<int>(row - static_cast<long long>(b) * hh);
  const int16_t* src = imgs + b * frame_stride + y * row_stride;
  int* dst = out + row * w;
  const bool rb = row_bright[row];
  const float av = a[b], bv = b20[b];
  for (int x = threadIdx.x; x < w; x += THREADS) {
    // promote to 20 bits (hdr.c:825-837), then match (hdr.c:783-809)
    const int raw = (static_cast<int>(static_cast<uint16_t>(src[x])) << 6) & 0xFFFFF;
    const float pf = __int2float_rn(raw);
    const float v = rb ? __fmaf_rn(bv, av, __fmaf_rn(__fsub_rn(pf, black), av, black))
                       : __fmaf_rn(bv, av, __fsub_rn(pf, bv));
    const int adj = __float2int_rz(evmath::clamp(truncf(v), 0.0f, 1048575.0f));
    dst[x] = raw == 0 ? 0 : adj;
  }
}

// ------------------------------------------------------------ alias planes

struct Planes {
  float* f;     // the fullres curve of the bright frame
  int* hs_ev;   // EV of the (smoothed) half-res
  int* fs_ev;   // EV of the (smoothed) full-res
  int* f_ev;    // EV of the unsmoothed full-res, NULL where it is fs_ev
  int* alias;   // the pre-map, NULL without the alias map
  bool* skip;
};

// the planes at pixel i of bright ``br``, smoothed full-res ``fs``,
// half-res ``hs`` and unsmoothed full-res ``fr`` (build_alias_map,
// hdr.c:1382-1486, up to kernel #7)
__device__ __forceinline__ void put_planes(const Planes& p, long long i, int br, int fs, int hs, int fr,
                                           float b64) {
  const float f = evmath::fullres_weight(br, b64);
  const int he = evmath::raw2ev20(hs, b64), fe = evmath::raw2ev20(fs, b64);
  p.f[i] = f;
  p.hs_ev[i] = he;
  p.fs_ev[i] = fe;
  if (p.f_ev != nullptr) {
    p.f_ev[i] = evmath::raw2ev20(fr, b64);
  }
  if (p.alias != nullptr) {
    const bool skip = f > FULLRES_THR;
    const int e_lin = max(abs(fs - hs) - E_LIN_NOISE, 0);
    const int e_log = abs(fe - he);
    p.alias[i] = skip ? 0 : min(min(e_lin >> 1, e_log >> 4), ALIAS_CAP);
    p.skip[i] = skip;
  }
}

__global__ void __launch_bounds__(THREADS)
    planes_kernel(Planes p, const int* __restrict__ bright, const int* __restrict__ fs,
                  const int* __restrict__ hs, const int* __restrict__ fr, long long n, float b64) {
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x; i < n; i += step) {
    const int fsv = fs[i];
    put_planes(p, i, bright[i], fsv, hs[i], fr != nullptr ? fr[i] : fsv, b64);
  }
}

// ------------------------------------------------------------------ blend

// the half-res EV blend (mix_images, hdr.c:1560-1611) of one pixel
__device__ __forceinline__ int halfres_of(int br, int dk, float ce, float ov, float max_ev_less_ov,
                                          const Levels& lv) {
  const int bright_ev = evmath::raw2ev20(br, lv.b64), dark_ev = evmath::raw2ev20(dk, lv.b64);
  const float i_f = __int2float_rn(br & 0xFFFFF);
  const float x = evmath::clamp_min(__fsub_rn(__fmul_rn(i_f, 0.015625f), lv.b64), 1.0f);  // i / 64 - black / 64
  const float evb = evmath::log2_add(x, ce);
  const float t = t_min(evmath::clamp_min(__fsub_rn(evb, max_ev_less_ov), 0.0f), ov);
  const float cmix = -__double2float_rn(cos(static_cast<double>(__fdiv_rn(__fmul_rn(t, PI_F32), ov))));
  const float k = evmath::clamp(__fmul_rn(__fadd_rn(cmix, 1.0f), 0.5f), 0.0f, 1.0f);
  const float mixed = truncf(__fmaf_rn(__int2float_rn(bright_ev), __fsub_rn(1.0f, k),
                                       __fmul_rn(__int2float_rn(dark_ev), k)));
  return evmath::ev2raw20(__float2int_rz(mixed), lv.ev2raw);
}

template <bool PLANES>
__global__ void __launch_bounds__(THREADS)
    blend_kernel(int* __restrict__ fullres_out, int* __restrict__ halfres_out, bool* __restrict__ over,
                 Planes p, const int* __restrict__ bright, const int* __restrict__ dark,
                 const bool* __restrict__ row_bright, const int* __restrict__ wd,
                 const float* __restrict__ ce, const float* __restrict__ ov, int hh, int w, Levels lv,
                 bool use_fullres) {
  const long long row = blockIdx.x;
  const int b = static_cast<int>(row / hh);
  const bool rb = row_bright[row];
  const int wdv = wd[b];
  const float cev = ce[b], ovv = ov[b];
  const float max_ev_less_ov = __fsub_rn(lv.max_ev, ovv);
  for (int x = threadIdx.x; x < w; x += THREADS) {
    const long long i = row * w + x;
    const int br = bright[i], dk = dark[i];
    // the full-res reconstruction (hdr.c:1355-1380)
    const int fullres = !use_fullres ? 0 : !rb ? dk : br < wdv ? br : max(br, dk);
    const int halfres = halfres_of(br, dk, cev, ovv, max_ev_less_ov, lv);
    over[i] = br >= wdv || dk >= lv.white20;
    if constexpr (PLANES) {
      put_planes(p, i, br, fullres, halfres, fullres, lv.b64);
    } else {
      fullres_out[i] = fullres;
      halfres_out[i] = halfres;
    }
  }
}

// ------------------------------------------------------------------ final

__global__ void __launch_bounds__(THREADS)
    final_kernel(int16_t* __restrict__ out, const int* __restrict__ hs_ev, const int* __restrict__ fs_ev,
                 const int* __restrict__ f_ev, const float* __restrict__ fcurve,
                 const int* __restrict__ alias, const bool* __restrict__ over,
                 const int* __restrict__ dark, const int* __restrict__ bright, int hh, int w, Levels lv) {
  const long long row = blockIdx.x;
  const int b = static_cast<int>(row / hh), y = static_cast<int>(row - static_cast<long long>(b) * hh);
  const bool inner_row = y >= 3 && y < hh - 3;
  for (int x = threadIdx.x; x < w; x += THREADS) {
    const long long i = row * w + x;
    // the overexposure map and its blur (hdr.c:1639-1655)
    int o = over[i] ? 100 : 0;
    if (inner_row && x >= 3 && x < w - 3) {
      const bool* c = over + i;
      const int n4 = 100 * (c[-1] + c[1] + c[-w] + c[w]);
      const int nd = 100 * (c[-w - 1] + c[-w + 1] + c[w - 1] + c[w + 1]);
      o += n4 * 820 / 1024 + nd * 657 / 1024;
    }
    // the final blend (hdr.c:1663-1758)
    const float ovf = evmath::clamp(__fmul_rn(__int2float_rn(o), INV_200), 0.0f, 1.0f);
    const float c = alias == nullptr
                        ? ovf
                        : t_max(evmath::clamp(__fmul_rn(__int2float_rn(alias[i]), INV_ALIAS_MAX), 0.0f, 1.0f),
                                ovf);
    const float f0 = fcurve[i];
    const float noisy = t_max(ovf, __fsub_rn(1.0f, f0));
    const float frsev = __int2float_rn(fs_ev[i]);
    const float frev = f_ev == nullptr ? frsev : __int2float_rn(f_ev[i]);
    const float fev = __fmaf_rn(noisy, frsev, __fmul_rn(__fsub_rn(1.0f, noisy), frev));
    const int sig = (dark[i] + bright[i]) >> 1;  // floor division by 2
    const float f = evmath::clamp_min(
        t_min(t_max(f0, c), __fmul_rn(__int2float_rn(sig - lv.black20), SIG_SCALE)), 0.0f);
    const float hrev = __int2float_rn(hs_ev[i]);
    const int output = __float2int_rz(truncf(__fmaf_rn(hrev, __fsub_rn(1.0f, f), __fmul_rn(fev, f))));
    const int final20 = evmath::ev2raw20(min(max(output, EV_LO), EV_HI), lv.ev2raw);
    // 20 -> 16 bit: trunc(v / 16 + 0.5) (hdr.c:242,1760-1772), as int16 bits
    const int v = min(max((final20 + 8) >> 4, 0), 65535);
    out[i] = static_cast<int16_t>(v - ((v & 0x8000) << 1));
  }
}

bool bad_rows(long long batch, long long hh, long long w) {
  return batch < 0 || hh < 0 || w < 0 || w > (1LL << 30) || (hh > 0 && batch > MAX_ROWS / hh) ||
         batch * hh * w > (1LL << 62);
}

unsigned blocks_for(long long n) {
  const long long want = (n + THREADS - 1) / THREADS;
  return static_cast<unsigned>(want < 132LL * 16 ? (want > 0 ? want : 1) : 132LL * 16);
}

}  // namespace

extern "C" int mlvfs_recon_match(void* out, const void* imgs, long long frame_stride, long long row_stride,
                                 const void* row_bright, const void* a, const void* b20, long long batch,
                                 long long hh, long long w, int black20, void* stream) {
  if (bad_rows(batch, hh, w) || out == nullptr || imgs == nullptr || row_bright == nullptr ||
      a == nullptr || b20 == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch * hh * w == 0) {
    return 0;
  }
  match_kernel<<<static_cast<unsigned>(batch * hh), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(out), static_cast<const int16_t*>(imgs), frame_stride, row_stride,
      static_cast<const bool*>(row_bright), static_cast<const float*>(a), static_cast<const float*>(b20),
      static_cast<int>(hh), static_cast<int>(w), static_cast<float>(black20));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mlvfs_recon_blend(void* fullres, void* halfres, void* over, void* f, void* hs_ev,
                                 void* fs_ev, void* alias, void* skip, const void* bright, const void* dark,
                                 const void* row_bright, const void* wd, const void* ce, const void* ov,
                                 long long batch, long long hh, long long w, int black20, int white20,
                                 int white_ev, int zero_ev, float max_ev, int use_fullres, int planes,
                                 void* stream) {
  const bool bad_out = planes ? (f == nullptr || hs_ev == nullptr || fs_ev == nullptr ||
                                 (alias == nullptr) != (skip == nullptr))
                              : (fullres == nullptr || halfres == nullptr);
  if (bad_rows(batch, hh, w) || bad_out || over == nullptr || bright == nullptr || dark == nullptr ||
      row_bright == nullptr || wd == nullptr || ce == nullptr || ov == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch * hh * w == 0) {
    return 0;
  }
  // without smoothing the full-res planes are one: no f_ev
  const Planes p{static_cast<float*>(f), static_cast<int*>(hs_ev), static_cast<int*>(fs_ev), nullptr,
                 static_cast<int*>(alias), static_cast<bool*>(skip)};
  const Levels lv = levels(black20, white20, white_ev, zero_ev, max_ev);
  const auto kernel = planes ? blend_kernel<true> : blend_kernel<false>;
  kernel<<<static_cast<unsigned>(batch * hh), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(fullres), static_cast<int*>(halfres), static_cast<bool*>(over), p,
      static_cast<const int*>(bright), static_cast<const int*>(dark), static_cast<const bool*>(row_bright),
      static_cast<const int*>(wd), static_cast<const float*>(ce), static_cast<const float*>(ov),
      static_cast<int>(hh), static_cast<int>(w), lv, use_fullres != 0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mlvfs_recon_alias_planes(void* f, void* hs_ev, void* fs_ev, void* f_ev, void* alias, void* skip,
                                        const void* bright, const void* fullres_smooth,
                                        const void* halfres_smooth, const void* fullres, long long n,
                                        int black20, void* stream) {
  if (n < 0 || f == nullptr || hs_ev == nullptr || fs_ev == nullptr || (alias == nullptr) != (skip == nullptr) ||
      (f_ev == nullptr) != (fullres == nullptr) || bright == nullptr || fullres_smooth == nullptr ||
      halfres_smooth == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) {
    return 0;
  }
  const Planes p{static_cast<float*>(f), static_cast<int*>(hs_ev), static_cast<int*>(fs_ev),
                 static_cast<int*>(f_ev), static_cast<int*>(alias), static_cast<bool*>(skip)};
  planes_kernel<<<blocks_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const int*>(bright), static_cast<const int*>(fullres_smooth),
      static_cast<const int*>(halfres_smooth), static_cast<const int*>(fullres), n, evmath::black64(black20));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mlvfs_recon_final(void* out, const void* hs_ev, const void* fs_ev, const void* f_ev,
                                 const void* f, const void* alias, const void* over, const void* dark,
                                 const void* bright, long long batch, long long hh, long long w, int black20,
                                 int white20, int white_ev, int zero_ev, void* stream) {
  if (bad_rows(batch, hh, w) || out == nullptr || hs_ev == nullptr || fs_ev == nullptr || f == nullptr ||
      over == nullptr || dark == nullptr || bright == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch * hh * w == 0) {
    return 0;
  }
  final_kernel<<<static_cast<unsigned>(batch * hh), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int16_t*>(out), static_cast<const int*>(hs_ev), static_cast<const int*>(fs_ev),
      static_cast<const int*>(f_ev), static_cast<const float*>(f), static_cast<const int*>(alias),
      static_cast<const bool*>(over), static_cast<const int*>(dark), static_cast<const int*>(bright),
      static_cast<int>(hh), static_cast<int>(w), levels(black20, white20, white_ev, zero_ev, 0.0f));
  return static_cast<int>(cudaGetLastError());
}
