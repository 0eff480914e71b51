// Composite epilogue for sm_90a: the albedo fetch, back-to-front blend of
// the two stack layers, and the vertical half of the bloom box filter, for
// one character or a crowd (the character as blockIdx.z, its planes at
// 64-bit offsets; one atlas for all). Two albedo modes, one template flag:
// nearest (one 4-byte texel per pixel and layer) and quad (QUAD: one
// 16-byte row holding the texel's 2x2 footprint, lerped by the pixel's
// own fx, fy: bilinear albedo in one gather).
//
// Replaces reze_tpu/kernels/composite_tpu.py::composite_tpu (both modes,
// _composite_kernel's quad=False and quad=True) together with the albedo
// gathers that fed it (reze_tpu/render/pipeline_tpu.py::_albedo_u32,
// _albedo_quad32). Its plain torch twin is
// reze_tpu_torch/kernels/composite_gpu.py::composite_twin.
//
// What bounds it on this card: device memory. Per output pixel it reads
// the 18 float shade channels once (72 B; the quad mode skips O_DXDY), one
// 4-byte texel or one 16-byte footprint per layer (a random gather, mostly
// cache hits on a small atlas) and writes 3 + 1.5 floats; there are a few
// dozen float ops per pixel. One thread owns a column of two rows, so the
// half-res source pixel and the bloom seed's row pair are both local to
// the thread, and consecutive threads touch consecutive addresses in every
// channel plane (coalesced).

#include <cuda_runtime.h>
#include <stdint.h>

#include "shade.cuh"

namespace reze {
namespace {

struct CompositeArgs {
  const float* o;         // (C, 18, hp, wp) shade outputs
  // nearest: (N,) rgba8 texels, r in the low byte; QUAD: (N,) 16-byte
  // footprints read as uint4 (t00, t10, t01, t11), the table 16-byte aligned
  const uint32_t* atlas;
  long long n_texels;  // N, the table's rows
  float* img;   // (C, 3, hp, wp)
  float* half;  // (C, 3, hp / 2, wp) vertical mean of row pairs
  int hp, wp, half0, half1, with_bloom;
};

template <bool QUAD>
__global__ void composite_kernel(CompositeArgs a) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;  // row pair
  if (x >= a.wp) return;
  const size_t plane = (size_t)a.hp * a.wp;
  {  // this block's character
    const size_t c = blockIdx.z;
    a.o += c * (2 * O_CH) * plane;
    a.img += c * 3 * plane;
    a.half += c * 3 * (plane / 2);
  }
  const float inv255 = (float)(1.0 / 255.0);
  float rgb[2][3];
  for (int r = 0; r < 2; ++r) {
    const size_t p = (size_t)(2 * i + r) * a.wp + x;
    float c[3] = {0.f, 0.f, 0.f};
    for (int layer = 0; layer < 2; ++layer) {
      const float* o = a.o + (size_t)layer * O_CH * plane;
      const bool half_res = layer == 0 ? a.half0 : a.half1;
      // a half-res layer fetches at the even-row, even-column pixel
      const size_t ps = half_res ? (size_t)(2 * i) * a.wp + (x & ~1) : p;
      float t[3];
      if constexpr (QUAD) {
        // the source pixel's footprint; the weights from the pixel's own
        // fx, fy, accumulated t00 first (composite_tpu.py's order)
        long long idx = (long long)fmaxf(o[O_TEX * plane + ps], 0.f);
        idx = idx < a.n_texels ? idx : a.n_texels - 1;
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(a.atlas) + idx);
        const uint32_t u[4] = {q.x, q.y, q.z, q.w};
        const float fx = o[O_FX * plane + p], fy = o[O_FY * plane + p];
        const float w[4] = {(1.f - fx) * (1.f - fy), fx * (1.f - fy), (1.f - fx) * fy, fx * fy};
        const bool valid = o[O_TEX * plane + p] >= 0.f;
        for (int ch = 0; ch < 3; ++ch) {
          float acc = 0.f;
          for (int k = 0; k < 4; ++k)
            acc = acc + (float)((u[k] >> (8 * ch)) & 255u) * inv255 * w[k];
          t[ch] = valid ? acc : 1.f;
        }
      } else {
        const float dxdy = o[O_DXDY * plane + ps];
        const float dx = fmodf(dxdy, 2.f);
        const float dy = (dxdy - dx) * 0.5f;
        const float near = (o[O_TEX * plane + ps] + (o[O_FX * plane + ps] > 0.5f ? dx : 0.f))
                           + (o[O_FY * plane + ps] > 0.5f ? dy : 0.f);
        long long idx = (long long)fmaxf(near, 0.f);
        idx = idx < a.n_texels ? idx : a.n_texels - 1;
        const uint32_t u = a.atlas[idx];
        const bool valid = o[O_TEX * plane + p] >= 0.f;
        t[0] = valid ? (float)(u & 255u) * inv255 : 1.f;
        t[1] = valid ? (float)((u >> 8) & 255u) * inv255 : 1.f;
        t[2] = valid ? (float)((u >> 16) & 255u) * inv255 : 1.f;
      }
      const float rim = o[O_RIM * plane + p];
      const float al = o[O_AEFF * plane + p];
      const float na = 1.f - al;
      for (int ch = 0; ch < 3; ++ch)
        c[ch] = ((t[ch] * o[(O_LR + ch) * plane + p] + rim) * al) + c[ch] * na;
    }
    for (int ch = 0; ch < 3; ++ch) {
      a.img[ch * plane + p] = c[ch];
      rgb[r][ch] = c[ch];
    }
  }
  if (a.with_bloom) {
    const size_t hplane = (size_t)(a.hp / 2) * a.wp;
    for (int ch = 0; ch < 3; ++ch)
      a.half[ch * hplane + (size_t)i * a.wp + x] = (rgb[0][ch] + rgb[1][ch]) * 0.5f;
  }
}

}  // namespace
}  // namespace reze

// quad: atlas is the (n_texels, 16) footprint table, else (n_texels, 4) texels
extern "C" int reze_composite(const float* o, const void* atlas, long long n_texels, int quad,
                              float* img, float* half, int hp, int wp, int half0, int half1,
                              int with_bloom, int n_chars, void* stream) {
  using namespace reze;
  if (hp <= 0 || wp <= 0 || hp % 2 || n_texels <= 0 || n_chars <= 0 || n_chars > 65535
      || (quad && ((uintptr_t)atlas & 15)))
    return (int)cudaErrorInvalidValue;
  CompositeArgs a{o, (const uint32_t*)atlas, n_texels, img, half, hp, wp, half0, half1,
                  with_bloom};
  const dim3 block(256);
  const dim3 grid((wp + 255) / 256, hp / 2, n_chars);
  if (quad)
    composite_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  else
    composite_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
