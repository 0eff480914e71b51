// What the frame megakernels share: the 8x128 tile, the 40-float pair row,
// the sample pattern, the seven passes' fixed-function state, and for the
// kernels that keep the stack in shared memory the push of a pass's winner
// onto it (frame_hybrid.cu, frame_mxu.cu) and the shade of a tile's stack
// after the last pass (frame_hybrid.cu); frame.cu keeps references to rows
// instead and has its own forms of both. Compiled with -fmad=false, as
// every file here.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "shade.cuh"

namespace reze {
namespace {

constexpr int TILE_H = 8;
constexpr int TILE_W = 128;
constexpr int NPIX = TILE_H * TILE_W;  // threads per block, one per pixel
constexpr int CHUNK = 128;             // pairs staged per step
constexpr int ROW_W = 40;              // floats per pair row
constexpr int N_PASSES = 7;
// pair-row columns (kernels/frame_gpu.py)
constexpr int C_Z = 9, C_ALPHA = 14, C_IGRAD = 15, C_ATTR = 19;

__constant__ float SAMPLE_DX[4] = {-2.f / 16.f, 6.f / 16.f, -6.f / 16.f, 2.f / 16.f};
__constant__ float SAMPLE_DY[4] = {-6.f / 16.f, -2.f / 16.f, 2.f / 16.f, 6.f / 16.f};

// per pass: outline, depth write, write stencil, use stencil
__constant__ int PASS_CFG[N_PASSES][4] = {
    {0, 1, 0, 0},  // opaque
    {0, 1, 1, 0},  // eyes (stencil := 1)
    {1, 1, 0, 0},  // opaque outlines
    {0, 1, 0, 1},  // hair (alpha halved over the stencil)
    {1, 0, 0, 0},  // hair outlines (no depth write)
    {0, 1, 0, 0},  // transparent
    {1, 1, 0, 0},  // transparent outlines
};

// Shade both layers of tile (bi, bj) from its planar stack in shared memory
// (stack[ch * NPIX + tid], 2 * L_CH channels) and write the 2 * O_CH output
// planes. su, sv: NPIX floats of shared scratch each, free for the call.
// Every thread of the block calls it: it synchronises. A layer with no
// fragment in the tile writes texel index -1 and zeros.
__device__ __forceinline__ void shade_tile(const float* stack, float* su, float* sv, int tid,
                                           int bi, int bj, const ShadeParams& sp, float* out) {
  const int py = tid / TILE_W, px = tid % TILE_W;
  const size_t plane = (size_t)sp.hp * sp.wp;
  const size_t pix = (size_t)(bi * TILE_H + py) * sp.wp + bj * TILE_W + px;
  const float x0f = (float)(bj * TILE_W), y0f = (float)(bi * TILE_H);
  const float xg = ((float)px + x0f) + 0.5f, yg = ((float)py + y0f) + 0.5f;
  for (int layer = 0; layer < 2; ++layer) {
    float stk[L_CH];
    for (int ch = 0; ch < L_CH; ++ch) stk[ch] = stack[(layer * L_CH + ch) * NPIX + tid];
    float* o = out + (size_t)layer * O_CH * plane + pix;
    const int any_present = __syncthreads_or(stk[L_AEFF] > 0.f);
    o[O_AEFF * plane] = stk[L_AEFF];
    if (!any_present) {
      for (int ch = 0; ch < O_AEFF; ++ch) o[ch * plane] = ch == O_TEX ? -1.f : 0.f;
      continue;
    }
    const float iw = fmaxf(stk[L_IW], (float)1e-8);
    const float inv_iw = 1.f / iw;
    const float u = stk[L_UIW] * inv_iw;
    const float v = stk[L_VIW] * inv_iw;
    float du_x = 0.f, du_y = 0.f, dv_x = 0.f, dv_y = 0.f;
    if (sp.n_levels > 0) {
      // in-tile differences, wrapping at the tile edges
      su[tid] = u;
      sv[tid] = v;
      __syncthreads();
      const int right = py * TILE_W + ((px + 1) % TILE_W);
      const int left = py * TILE_W + ((px + TILE_W - 1) % TILE_W);
      const int down = ((py + 1) % TILE_H) * TILE_W + px;
      const int up = ((py + TILE_H - 1) % TILE_H) * TILE_W + px;
      du_x = tile_fd(u, su[right], su[left]);
      du_y = tile_fd(u, su[down], su[up]);
      dv_x = tile_fd(v, sv[right], sv[left]);
      dv_y = tile_fd(v, sv[down], sv[up]);
    }
    float res[O_AEFF];
    shade_pixel(stk, u, v, inv_iw, du_x, du_y, dv_x, dv_y, xg, yg, layer, sp, res);
    for (int ch = 0; ch < O_AEFF; ++ch) o[ch * plane] = res[ch];
  }
}

// The push of one pass's winner onto a pixel's two-layer stack (stack[ch *
// NPIX + tid]): opaque fragments clear it, translucent ones displace layer
// 1 into layer 0, a_eff < 0.001 is dropped; hair alpha halves over the
// stencil, which the eye pass writes. code: the winner's packed material
// code; attrs: its six attribute values; z its depth; hit: a pair won.
__device__ __forceinline__ void push_winner(float* stack, int tid, float& stencil, bool hit,
                                            float cover, float code_f, const float* attrs,
                                            float z, int p) {
  const int code = (int)rintf(code_f);
  float al = (float)(code & 1023) * (float)(1.0 / 1023.0);
  const int rest = code >> 10;
  if (PASS_CFG[p][3]) {
    const float hair = (float)((rest >> 12) & 1);
    al = al * ((stencil > 0.5f && hair > 0.5f) ? 0.5f : 1.f);
  }
  float a_eff = hit ? al * cover : 0.f;
  const bool present = a_eff >= (float)0.001;
  if (!present) a_eff = 0.f;
  const bool opaque = present && a_eff > (float)0.999;
  const bool displace = present && !opaque && stack[(L_CH + L_AEFF) * NPIX + tid] > 0.f;
  for (int ch = 0; ch < L_CH; ++ch) {
    float* l0 = stack + ch * NPIX + tid;
    if (opaque) *l0 = 0.f;
    else if (displace) *l0 = stack[(L_CH + ch) * NPIX + tid];
  }
  if (present) {
    float* l1 = stack + L_CH * NPIX + tid;
    for (int ch = 0; ch < 6; ++ch) l1[ch * NPIX] = attrs[ch];
    l1[L_Z * NPIX] = z;
    l1[L_AEFF * NPIX] = a_eff;
    l1[L_OUT * NPIX] = PASS_CFG[p][0] ? 1.f : 0.f;
    l1[L_RAMP * NPIX] = (float)(rest & 15);
    l1[L_TEX * NPIX] = (float)((rest >> 4) & 15);
    l1[L_EDGE * NPIX] = (float)((rest >> 8) & 15);
  }
  if (PASS_CFG[p][2] && hit && cover > 0.f) stencil = 1.f;
}

}  // namespace
}  // namespace reze
