// What the frame megakernels share: the 8x128 tile, the 40-float pair row,
// the sample pattern and the seven passes' fixed-function state; the push
// of a pass's winner onto a planar stack in shared memory (frame_mxu.cu);
// and the tile design of frame.cu and frame_hybrid.cu, which differ only in
// how they walk a chunk of pairs: 512 threads per tile, two pixels each, a
// two-stage ring of 128-pair chunks filled by bulk copies, stack layers
// kept as row references (Layer) and shaded from their rows after the last
// pass. Compiled with -fmad=false, as every file here.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "shade.cuh"

namespace reze {
namespace {

constexpr int TILE_H = 8;
constexpr int TILE_W = 128;
constexpr int NPIX = TILE_H * TILE_W;  // pixels of a tile
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

// --- the tile design of frame.cu and frame_hybrid.cu -----------------------

constexpr int NTHREADS = 512;
constexpr int PPT = NPIX / NTHREADS;         // pixels per thread
constexpr int ROW_STEP = NTHREADS / TILE_W;  // rows between a thread's pixels
// a prepared pair: per plane (edges 0-2, depth) a, b, c and a fourth value
// of the kernel's own, then per sample the four plane offsets or constants
constexpr int PREP_W = 32;
constexpr int PREP_OFF = 16;
constexpr float NO_HIT = 2.f;        // pass winner depth before any pair won
constexpr int STENCIL_BIT = 1 << 4;  // above the NS <= 4 coverage bits

// a stack layer: its winner's row and pass as row * 8 + pass (-1: empty,
// every channel 0), its depth and effective alpha
struct Layer {
  int ref;
  float z, a;
};

struct __align__(128) TileSmem {
  float ring[2][CHUNK * ROW_W];  // staged rows; ring[0] is the shade's u/v exchange
  float prep[CHUNK * PREP_W];
  Layer stack[2][NPIX];  // a pixel's layers, read and written by its thread only
  float shade[SHADE_SMEM_FLOATS];
  uint64_t bar[2];
  int start[N_PASSES], count[N_PASSES];
};

// how a kernel evaluates attribute plane ch of row r at a tile-local pixel
// centre (xs, ys) of the tile at (x0f, y0f): frame.cu as (a*xs + c') + b*ys
// with c' = (c + a*x0f) + b*y0f, and zero for outline passes;
// frame_hybrid.cu as (a*xs + b*ys) + c' in every pass
enum PlaneForm { FRAME_PLANES, HYBRID_PLANES };

template <int FORM>
__device__ __forceinline__ float attr_plane(const float* r, int ch, float xs, float ys,
                                            float x0f, float y0f) {
  const float ca = __ldg(r + C_ATTR + ch), cb = __ldg(r + C_ATTR + 6 + ch);
  const float cc = (__ldg(r + C_ATTR + 12 + ch) + ca * x0f) + cb * y0f;
  return FORM == FRAME_PLANES ? (ca * xs + cc) + cb * ys : (ca * xs + cb * ys) + cc;
}

// --- mbarrier and bulk copy (PTX) ------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// one thread: copy n rows from device memory into the ring's stage, the
// stage's barrier completing when the bytes have landed
__device__ __forceinline__ void stage_rows(TileSmem& sm, const float* src, int n, int stage) {
  const uint32_t bytes = (uint32_t)(n * ROW_W * sizeof(float));
  const uint32_t bar = smem_addr(&sm.bar[stage]);
  // the stage's previous rows were read through the generic proxy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(sm.ring[stage])), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// one thread: stage the chunk after chunk c0 of pass p (count pairs) in
// the sequence of all passes' chunks, if there is one
__device__ __forceinline__ void stage_next(TileSmem& sm, const float* rows, int p, int count,
                                           int c0, int stage) {
  int np = p, nc = c0 + CHUNK;
  if (nc >= count) {
    nc = 0;
    for (np = p + 1; np < N_PASSES && sm.count[np] <= 0; ++np) {
    }
  }
  if (np < N_PASSES)
    stage_rows(sm, rows + (size_t)(sm.start[np] + nc) * ROW_W, min(sm.count[np] - nc, CHUNK),
               stage);
}

// the output of a tile where neither layer has a fragment: texel index -1,
// everything else 0
__device__ __forceinline__ void store_empty_tile(float* out, int bi, int bj, int hp, int wp,
                                                 int tid) {
  const size_t plane = (size_t)hp * wp;
  constexpr int V = NPIX / 4;  // float4 per plane
  for (int i = tid; i < 2 * O_CH * V; i += NTHREADS) {
    const int ch = i / V, k = i % V;
    const int y = k / (TILE_W / 4), x4 = k % (TILE_W / 4);
    const float v = (ch % O_CH) == O_TEX ? -1.f : 0.f;
    float* o = out + ch * plane + (size_t)(bi * TILE_H + y) * wp + bj * TILE_W + 4 * x4;
    *reinterpret_cast<float4*>(o) = make_float4(v, v, v, v);
  }
}

// Every thread of the block: read the tile's pass segments, set up the
// ring's barriers and, for a tile with a pair in some pass, start the copy
// of its first chunk. -> the first pass with a pair, or N_PASSES for a tile
// with none, whose output is then written.
__device__ __forceinline__ int begin_tile(TileSmem& sm, const float* rows, const int* starts,
                                          const int* counts, float* out, const ShadeParams& g,
                                          int tid) {
  const int bx_n = g.wp / TILE_W;
  const int n_tiles = bx_n * (g.hp / TILE_H);
  const int b = blockIdx.x;
  if (tid < N_PASSES) {
    sm.count[tid] = counts[tid * n_tiles + b];
    sm.start[tid] = starts[tid * n_tiles + b];
  }
  if (tid == 0) {
    mbar_init(&sm.bar[0]);
    mbar_init(&sm.bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  int first = N_PASSES;
  for (int p = N_PASSES - 1; p >= 0; --p)
    if (sm.count[p] > 0) first = p;
  if (first == N_PASSES) {  // uniform over the block
    store_empty_tile(out, b / bx_n, b % bx_n, g.hp, g.wp, tid);
    return first;
  }
  if (tid == 0)
    stage_rows(sm, rows + (size_t)sm.start[first] * ROW_W, min(sm.count[first], CHUNK), 0);
  return first;
}

// The push of one pass's winner (push_winner above, on references):
// opaque fragments clear the stack, translucent ones displace layer 1 into
// layer 0, a_eff < 0.001 is dropped; hair alpha halves over the stencil,
// which the eye pass writes.
__device__ __forceinline__ void push_ref(Layer& l0, Layer& l1, int& bits, bool hit, float cover,
                                         float code_f, int ref, float z, int p) {
  const int code = (int)rintf(code_f);
  float al = (float)(code & 1023) * (float)(1.0 / 1023.0);
  const int rest = code >> 10;
  if (PASS_CFG[p][3]) {
    const float hair = (float)((rest >> 12) & 1);
    al = al * (((bits & STENCIL_BIT) && hair > 0.5f) ? 0.5f : 1.f);
  }
  float a_eff = hit ? al * cover : 0.f;
  const bool present = a_eff >= (float)0.001;
  if (!present) a_eff = 0.f;
  const bool opaque = present && a_eff > (float)0.999;
  const bool displace = present && !opaque && l1.a > 0.f;
  if (opaque) l0 = Layer{-1, 0.f, 0.f};
  else if (displace) l0 = l1;
  if (present) l1 = Layer{ref, z, a_eff};
  if (PASS_CFG[p][2] && hit && cover > 0.f) bits |= STENCIL_BIT;
}

// A layer's L_CH stack channels at tile-local pixel centre (xs, ys): the
// attribute planes of its row (attr_plane), its depth and alpha, its
// pass's outline flag and its material code's group ids.
template <int FORM>
__device__ __forceinline__ void layer_channels(const float* rows, const Layer& l, float xs,
                                               float ys, float x0f, float y0f, float* stk) {
  for (int ch = 0; ch < L_CH; ++ch) stk[ch] = 0.f;
  if (l.ref < 0) return;
  const float* r = rows + (size_t)(l.ref >> 3) * ROW_W;
  const int p = l.ref & 7;
  if (FORM == HYBRID_PLANES || !PASS_CFG[p][0])
    for (int ch = 0; ch < 6; ++ch) stk[L_UIW + ch] = attr_plane<FORM>(r, ch, xs, ys, x0f, y0f);
  const int rest = (int)rintf(__ldg(r + C_ALPHA)) >> 10;
  stk[L_Z] = l.z;
  stk[L_AEFF] = l.a;
  stk[L_OUT] = PASS_CFG[p][0] ? 1.f : 0.f;
  stk[L_RAMP] = (float)(rest & 15);
  stk[L_TEX] = (float)((rest >> 4) & 15);
  stk[L_EDGE] = (float)((rest >> 8) & 15);
}

// Every thread of the block, after the last pass: shade both layers of the
// tile's stack and write the 2 * O_CH output planes; a layer with no
// fragment in the tile writes texel index -1 and zeros. g: the kernel's
// shade parameters, sp: the same with the tables staged; (bi, bj): the
// tile; px, py0, xs, ys: the thread's column, first row and tile-local
// pixel centres; (x0f, y0f): the tile origin. The ring's first stage holds
// the u, v exchange.
template <int FORM>
__device__ __forceinline__ void shade_layers(TileSmem& sm, const float* rows,
                                             const ShadeParams& g, const ShadeParams& sp,
                                             float* out, int tid, int bi, int bj, int px,
                                             int py0, float xs, const float* ys, float x0f,
                                             float y0f) {
  float* su = sm.ring[0];
  float* sv = su + NPIX;
  const size_t plane = (size_t)g.hp * g.wp;
  for (int layer = 0; layer < 2; ++layer) {
    bool any = false;
#pragma unroll
    for (int k = 0; k < PPT; ++k) any = any || sm.stack[layer][tid + k * NTHREADS].a > 0.f;
    // also: every thread is done with the ring and the previous layer's u, v
    const int any_present = __syncthreads_or(any);
    float u[PPT], v[PPT], inv_iw[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const Layer l = sm.stack[layer][tid + k * NTHREADS];
      const int py = py0 + k * ROW_STEP;
      float* o = out + (size_t)layer * O_CH * plane
                 + (size_t)(bi * TILE_H + py) * g.wp + bj * TILE_W + px;
      o[O_AEFF * plane] = l.a;
      if (!any_present) {
        for (int ch = 0; ch < O_AEFF; ++ch) o[ch * plane] = ch == O_TEX ? -1.f : 0.f;
        continue;
      }
      float stk[L_CH];
      layer_channels<FORM>(rows, l, xs, ys[k], x0f, y0f, stk);
      inv_iw[k] = 1.f / fmaxf(stk[L_IW], (float)1e-8);
      u[k] = stk[L_UIW] * inv_iw[k];
      v[k] = stk[L_VIW] * inv_iw[k];
      su[py * TILE_W + px] = u[k];
      sv[py * TILE_W + px] = v[k];
    }
    if (!any_present) continue;  // uniform over the block
    if (sp.n_levels > 0) __syncthreads();
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int py = py0 + k * ROW_STEP;
      float du_x = 0.f, du_y = 0.f, dv_x = 0.f, dv_y = 0.f;
      if (sp.n_levels > 0) {
        // in-tile differences, wrapping at the tile edges
        const int right = py * TILE_W + ((px + 1) % TILE_W);
        const int left = py * TILE_W + ((px + TILE_W - 1) % TILE_W);
        const int down = ((py + 1) % TILE_H) * TILE_W + px;
        const int up = ((py + TILE_H - 1) % TILE_H) * TILE_W + px;
        du_x = tile_fd(u[k], su[right], su[left]);
        du_y = tile_fd(u[k], su[down], su[up]);
        dv_x = tile_fd(v[k], sv[right], sv[left]);
        dv_y = tile_fd(v[k], sv[down], sv[up]);
      }
      float stk[L_CH];
      layer_channels<FORM>(rows, sm.stack[layer][tid + k * NTHREADS], xs, ys[k], x0f, y0f, stk);
      const float xg = ((float)px + x0f) + 0.5f, yg = ((float)py + y0f) + 0.5f;
      float res[O_AEFF];
      shade_pixel(stk, u[k], v[k], inv_iw[k], du_x, du_y, dv_x, dv_y, xg, yg, layer, sp, res);
      float* o = out + (size_t)layer * O_CH * plane
                 + (size_t)(bi * TILE_H + py) * g.wp + bj * TILE_W + px;
      for (int ch = 0; ch < O_AEFF; ++ch) o[ch * plane] = res[ch];
    }
  }
}

}  // namespace
}  // namespace reze
