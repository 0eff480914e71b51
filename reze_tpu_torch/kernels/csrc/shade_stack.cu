// Toon/rim shade of a planar two-layer fragment stack for sm_90a, one
// 32x128 tile per thread block.
//
// Replaces reze_tpu/kernels/shade_tpu.py::shade_stack_tpu (Pallas). The
// per-pixel math is shade.cuh::shade_pixel, the same code the frame kernel
// inlines; the plain torch twin is reze_tpu_torch/kernels/shade_gpu.py::
// shade_stack_twin. What differs from the frame kernel's shade: the tile
// is 32x128, so the mip LOD's finite differences wrap at 32-row tile edges;
// the empty-layer skip is per 32x128 tile; the stack comes from device
// memory, planar (24, hp, wp).
//
// What bounds it on this card: device memory. Each pixel writes 18 floats
// and reads 4 of each layer's 12 channels (a_eff, 1/w, u/w, v/w), the other
// 8 only in tiles where the layer is present (at most 168 B per pixel); the
// shade is ~400 float operations per pixel and layer, under the card's
// float rate for that traffic. The design: 1024
// threads per tile, each owning four pixels one band (8 rows) apart, so a
// warp reads and writes 32 consecutive floats of a row (coalesced planar
// access). u and v of the tile are staged in shared memory (2 x 16 KB) for
// the neighbour differences, and __syncthreads_or decides the skip of an
// empty layer for the whole tile.
//
// Compiled with -fmad=false (see shade.cuh).

#include <cuda_runtime.h>

#include "shade.cuh"

namespace reze {
namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int NPIX = TILE_H * TILE_W;
constexpr int NTHREADS = 1024;
constexpr int PER_THREAD = NPIX / NTHREADS;  // pixels per thread, 8 rows apart
constexpr int ROW_STEP = NTHREADS / TILE_W;

__global__ void __launch_bounds__(NTHREADS) shade_stack_kernel(const float* stack, float* out,
                                                              ShadeParams sp) {
  __shared__ float su[NPIX];
  __shared__ float sv[NPIX];
  const int tid = threadIdx.x;
  const int px = tid % TILE_W, py0 = tid / TILE_W;
  const int bx_n = sp.wp / TILE_W;
  const int ti = blockIdx.x / bx_n, tj = blockIdx.x % bx_n;
  const float x0f = (float)(tj * TILE_W), y0f = (float)(ti * TILE_H);
  const size_t plane = (size_t)sp.hp * sp.wp;

  for (int layer = 0; layer < 2; ++layer) {
    const float* stk_l = stack + (size_t)layer * L_CH * plane;
    float* out_l = out + (size_t)layer * O_CH * plane;
    bool any = false;
    for (int k = 0; k < PER_THREAD; ++k) {
      const int py = py0 + k * ROW_STEP;
      const size_t pix = (size_t)(ti * TILE_H + py) * sp.wp + tj * TILE_W + px;
      const float aeff = stk_l[L_AEFF * plane + pix];
      const float inv_iw = 1.f / fmaxf(stk_l[L_IW * plane + pix], (float)1e-8);
      su[py * TILE_W + px] = stk_l[L_UIW * plane + pix] * inv_iw;
      sv[py * TILE_W + px] = stk_l[L_VIW * plane + pix] * inv_iw;
      out_l[O_AEFF * plane + pix] = aeff;
      any = any || aeff > 0.f;
    }
    // also makes su/sv visible to the whole block
    const int any_present = __syncthreads_or(any);
    for (int k = 0; k < PER_THREAD; ++k) {
      const int py = py0 + k * ROW_STEP;
      const size_t pix = (size_t)(ti * TILE_H + py) * sp.wp + tj * TILE_W + px;
      if (!any_present) {
        for (int ch = 0; ch < O_AEFF; ++ch) out_l[ch * plane + pix] = ch == O_TEX ? -1.f : 0.f;
        continue;
      }
      float stk[L_CH];
      for (int ch = 0; ch < L_CH; ++ch) stk[ch] = stk_l[ch * plane + pix];
      const float inv_iw = 1.f / fmaxf(stk[L_IW], (float)1e-8);
      const int p = py * TILE_W + px;
      const float u = su[p], v = sv[p];
      float du_x = 0.f, du_y = 0.f, dv_x = 0.f, dv_y = 0.f;
      if (sp.n_levels > 0) {
        // in-tile differences, wrapping at the tile edges
        const int right = py * TILE_W + (px + 1) % TILE_W;
        const int left = py * TILE_W + (px + TILE_W - 1) % TILE_W;
        const int down = ((py + 1) % TILE_H) * TILE_W + px;
        const int up = ((py + TILE_H - 1) % TILE_H) * TILE_W + px;
        du_x = tile_fd(u, su[right], su[left]);
        du_y = tile_fd(u, su[down], su[up]);
        dv_x = tile_fd(v, sv[right], sv[left]);
        dv_y = tile_fd(v, sv[down], sv[up]);
      }
      const float xg = ((float)px + x0f) + 0.5f, yg = ((float)py + y0f) + 0.5f;
      float res[O_AEFF];
      shade_pixel(stk, u, v, inv_iw, du_x, du_y, dv_x, dv_y, xg, yg, layer, sp, res);
      for (int ch = 0; ch < O_AEFF; ++ch) out_l[ch * plane + pix] = res[ch];
    }
    __syncthreads();  // su/sv are rewritten by the next layer
  }
}

}  // namespace
}  // namespace reze

extern "C" int reze_shade_stack(const float* stack, const float* knot, int kr, const float* tex,
                                int kt, int tex_cols, const float* edge, int ke,
                                const float* ldir, const float* lcol, const float* misc,
                                const float* inv_vp, float* out, int hp, int wp, int n_levels,
                                void* stream) {
  using namespace reze;
  ShadeParams sp{knot, tex, edge, ldir, lcol, misc, inv_vp, kr, kt, tex_cols, ke,
                 n_levels, hp, wp};
  const int n_tiles = (hp / TILE_H) * (wp / TILE_W);
  if (n_tiles <= 0) return (int)cudaErrorInvalidValue;
  shade_stack_kernel<<<n_tiles, NTHREADS, 0, (cudaStream_t)stream>>>(stack, out, sp);
  return (int)cudaGetLastError();
}
