// Bit unpack of MLV packed Bayer streams, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mlvfs_tpu/ops/unpack.py:_unpack_batch_pallas
// and computes what mlvfs_tpu/ops/unpack.py:unpack_words computes: pixel p of
// a frame starts at bit p*bpp of the big-endian-within-word u16 stream, so it
// is either bits of one word or of the word pair (w[a] << 16) | w[a+1],
// shifted by the static amount of (p mod pixels-per-block) and masked to bpp
// bits (raw.h:63-79; 14 bpp packs 8 pixels into 7 words).
//
// What bounds it on an H100: device-memory bytes. At 1920x1080 / 14 bpp a
// frame is 3.63 MB of packed words in and 4.15 MB of u16 pixels out, against
// a handful of integer operations per pixel. The layout is therefore one
// thread per output pixel on the interleaved stream: neighbouring threads
// read neighbouring u16 words (the straddling partner word of a pixel is the
// next thread's word, served from L1) and write neighbouring u16 pixels, so
// loads and stores coalesce. The TPU kernel's planar transpose was a TPU
// layout workaround and has no counterpart here.
//
// Tail and short streams: a word at or past n_words reads as 0, which is the
// zero padding of unpack_words (the stream is not block-padded at 10/12 bpp,
// and short or corrupt frames may be truncated).
//
// Plain C interface, loaded with ctypes (mlvfs_tpu_torch/_build.py). The
// kernel launches on the caller's stream, allocates nothing and does not
// synchronise; the return value is cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void unpack_kernel(const uint16_t* __restrict__ words,
                              uint16_t* __restrict__ out,
                              long long n_words, long long n_pixels, int bpp) {
  const long long frame = blockIdx.y;
  const uint16_t* w = words + frame * n_words;
  uint16_t* o = out + frame * n_pixels;
  const uint32_t mask = (1u << bpp) - 1u;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < n_pixels;
       p += stride) {
    const long long bit = p * bpp;
    const long long a = bit >> 4;
    const int sh = (int)(bit & 15);
    const uint32_t w0 = a < n_words ? (uint32_t)__ldg(w + a) : 0u;
    uint32_t v;
    if (sh + bpp <= 16) {
      v = w0 >> (16 - bpp - sh);
    } else {
      const uint32_t w1 = a + 1 < n_words ? (uint32_t)__ldg(w + a + 1) : 0u;
      v = ((w0 << 16) | w1) >> (32 - bpp - sh);
    }
    o[p] = (uint16_t)(v & mask);
  }
}

}  // namespace

// words: (batch, n_words) u16, out: (batch, n_pixels) u16, both contiguous on
// the device. Returns a cudaError_t as int (0 = launched).
extern "C" int mlvfs_unpack(const void* words, void* out, long long batch,
                            long long n_words, long long n_pixels, int bpp,
                            void* stream) {
  if (bpp < 1 || bpp > 16 || batch < 0 || batch > 65535 || n_words < 0 ||
      n_pixels < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (batch == 0 || n_pixels == 0) {
    return 0;
  }
  const int threads = 256;
  long long blocks = (n_pixels + threads - 1) / threads;
  if (blocks > (1 << 20)) {
    blocks = 1 << 20;  // the grid-stride loop covers the rest
  }
  dim3 grid((unsigned)blocks, (unsigned)batch);
  unpack_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)words, (uint16_t*)out, n_words, n_pixels, bpp);
  return (int)cudaGetLastError();
}
