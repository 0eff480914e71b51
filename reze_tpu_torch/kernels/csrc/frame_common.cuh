// What the frame megakernels share: the 8x128 tile, the 40-float pair row,
// the sample pattern and the seven passes' fixed-function state; the push
// of a pass's winner onto a planar stack in shared memory (frame_mxu.cu);
// and the tile design of frame.cu and frame_hybrid.cu (run_tile below),
// which differ only in how they prepare and walk a chunk of pairs and push
// a pass's winner (a Walk class each). Compiled with -fmad=false, as every
// file here.
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
//
// One 8x128 tile per block of 512 threads, each owning two pixels four rows
// apart; one character or a crowd (grid (tiles, characters)). A pixel's
// depths, coverage bits and stencil and its pass winner (z, row) stay in
// registers; each stack layer is a row reference (Layer) in shared memory,
// shaded from its row after the last pass.
//
// The rows: a tile whose pairs over all seven passes fit one ring stage
// (every tile of a crowd of the synthetic model, most non-empty tiles of a
// frame) is fetched in one go, one bulk copy per non-empty pass onto one
// barrier, prepared in one step and walked pass after pass without a
// barrier; its rows stay in the stage, where the push and the shade read
// them. A fuller tile runs a two-stage ring of 128-pair chunks, the copy of
// chunk k + 1 in flight while chunk k is walked, and the push and shade
// read its rows from device memory. A tile with no pair writes its fixed
// output and stops.
//
// The shade: per layer, its present pixels are listed first (warp ballots)
// and dealt to the threads in that order, the pixels with no fragment
// after them. A present pixel takes the full toon/rim shade, a pixel with
// no fragment only its texel footprint and the character's constant colour
// (absent_colour, computed once per tile by the last thread). A thread then
// shades at most one present pixel where a layer covers at most half the
// tile, and a warp's pixels take one path, so a sparsely covered tile's
// shade lasts about one pixel's, not two pixels' of every thread.
//
// Tensor cores do not fit this walk: each product must round on its own,
// as in the twins (-fmad=false), or coverage and z ties decide otherwise,
// and wgmma has no float32 product that rounds each term; a crowd frame's
// bound is its bytes anyway.

constexpr int NTHREADS = 512;
constexpr int MAX_DEVICES = 64;  // devices whose launch attribute is remembered
constexpr int NWARPS = NTHREADS / 32;
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

// ring[1] holds a tile fetched in one go; ring[0] is the shade's u, v
// exchange and pixel order; colour: a pixel with no fragment's RGB and
// rim; rows, out: a crowd block's character's (kept here, not in registers
// through the walk)
struct __align__(128) TileSmem {
  float ring[2][CHUNK * ROW_W];
  float prep[CHUNK * PREP_W];
  Layer stack[2][NPIX];  // a pixel's layers, read and written by its thread only
  float shade[SHADE_SMEM_FLOATS];
  uint64_t bar[2];
  int start[N_PASSES], count[N_PASSES];
  float colour[4];
  const float* rows;
  float* out;
};

// how a kernel evaluates attribute plane ch of row r at a tile-local pixel
// centre (xs, ys) of the tile at (x0f, y0f): frame.cu as (a*xs + c') + b*ys
// with c' = (c + a*x0f) + b*y0f, and zero for outline passes;
// frame_hybrid.cu as (a*xs + b*ys) + c' in every pass
enum PlaneForm { FRAME_PLANES, HYBRID_PLANES };

// a pair row's value: through the read-only path (LDG: rows in device
// memory), or a plain load (rows in device or shared memory)
template <bool LDG>
__device__ __forceinline__ float row_at(const float* r, int col) {
  return LDG ? __ldg(r + col) : r[col];
}

template <int FORM>
__device__ __forceinline__ float attr_plane(const float* r, int ch, float xs, float ys,
                                            float x0f, float y0f) {
  const float ca = r[C_ATTR + ch], cb = r[C_ATTR + 6 + ch];
  const float cc = (r[C_ATTR + 12 + ch] + ca * x0f) + cb * y0f;
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

// one thread: announce `bytes` to land on barrier bar (completing its
// phase with this thread's arrival once they have)
__device__ __forceinline__ void expect_bytes(uint64_t* bar, uint32_t bytes) {
  // the destination's previous contents were read through the generic proxy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// one thread: copy n rows from device memory to dst, completing on bar
__device__ __forceinline__ void copy_rows(float* dst, const float* src, int n, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"((uint32_t)(n * ROW_W * sizeof(float))),
      "r"(smem_addr(bar))
      : "memory");
}

// one thread: copy n rows into the ring's stage, its barrier completing
// when the bytes have landed
__device__ __forceinline__ void stage_rows(TileSmem& sm, const float* src, int n, int stage) {
  expect_bytes(&sm.bar[stage], (uint32_t)(n * ROW_W * sizeof(float)));
  copy_rows(sm.ring[stage], src, n, &sm.bar[stage]);
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

// one thread: every non-empty pass's rows (total pairs in all) one after
// another into ring[1], on its barrier
__device__ __forceinline__ void fetch_tile(TileSmem& sm, const float* rows, int total) {
  expect_bytes(&sm.bar[1], (uint32_t)(total * ROW_W * sizeof(float)));
  for (int p = 0, off = 0; p < N_PASSES; ++p)
    if (sm.count[p] > 0) {
      copy_rows(sm.ring[1] + off * ROW_W, rows + (size_t)sm.start[p] * ROW_W, sm.count[p],
                &sm.bar[1]);
      off += sm.count[p];
    }
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

// A present layer's L_CH stack channels at tile-local pixel centre (xs,
// ys): the attribute planes of its row (attr_plane), its depth and alpha,
// its pass's outline flag and its material code's group ids.
template <int FORM>
__device__ __forceinline__ void layer_channels(const float* rows, const Layer& l, float xs,
                                               float ys, float x0f, float y0f, float* stk) {
  for (int ch = 0; ch < L_CH; ++ch) stk[ch] = 0.f;
  const float* r = rows + (size_t)(l.ref >> 3) * ROW_W;
  const int p = l.ref & 7;
  if (FORM == HYBRID_PLANES || !PASS_CFG[p][0])
    for (int ch = 0; ch < 6; ++ch) stk[L_UIW + ch] = attr_plane<FORM>(r, ch, xs, ys, x0f, y0f);
  const int rest = (int)rintf(r[C_ALPHA]) >> 10;
  stk[L_Z] = l.z;
  stk[L_AEFF] = l.a;
  stk[L_OUT] = PASS_CFG[p][0] ? 1.f : 0.f;
  stk[L_RAMP] = (float)(rest & 15);
  stk[L_TEX] = (float)((rest >> 4) & 15);
  stk[L_EDGE] = (float)((rest >> 8) & 15);
}

// Every thread of the block, after the last pass: shade both layers of the
// tile's stack and write the 2 * O_CH output planes; a layer with no
// fragment in the tile writes texel index -1 and zeros. rows: the rows the
// layers reference (shared or device memory); g: the kernel's shade
// parameters, sp: the same with the tables staged; (bi, bj): the tile;
// (x0f, y0f): its origin. A pixel with no fragment in a present layer has
// every stack value +0 (so u = v = +0): shade_pixel would give it the
// tile's colour (sm.colour) and its own footprint, which shade_absent
// computes with the same operations.
template <int FORM>
__device__ __forceinline__ void shade_tile(TileSmem& sm, const float* rows, const ShadeParams& g,
                                           const ShadeParams& sp, float* out, int tid, int bi,
                                           int bj, float x0f, float y0f) {
  float* su = sm.ring[0];
  float* sv = su + NPIX;
  int* order = reinterpret_cast<int*>(sv + NPIX);  // present pixels first
  int* n_present = order + NPIX;                    // per (pixel k, warp)
  const int lane = tid % 32, warp = tid / 32;
  const size_t plane = (size_t)g.hp * g.wp;
  const float xs = (float)(tid % TILE_W) + 0.5f;  // tile-local
  for (int layer = 0; layer < 2; ++layer) {
    float* o_l = out + (size_t)layer * O_CH * plane + (size_t)(bi * TILE_H) * g.wp + bj * TILE_W;
    unsigned ballot[PPT];
    // also: every thread is done with the previous layer's exchange
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int pix = tid + k * NTHREADS, py = pix / TILE_W;
      const Layer l = sm.stack[layer][pix];
      o_l[O_AEFF * plane + (size_t)py * g.wp + pix % TILE_W] = l.a;
      ballot[k] = __ballot_sync(0xffffffffu, l.a > 0.f);
      if (lane == 0) n_present[k * NWARPS + warp] = __popc(ballot[k]);
      float u = 0.f, v = 0.f;  // a pixel with no fragment: +0 * (1 / 1e-8)
      if (l.a > 0.f) {
        float stk[L_CH];
        layer_channels<FORM>(rows, l, xs, (float)py + 0.5f, x0f, y0f, stk);
        const float inv_iw = 1.f / fmaxf(stk[L_IW], (float)1e-8);
        u = stk[L_UIW] * inv_iw;
        v = stk[L_VIW] * inv_iw;
      }
      su[pix] = u;
      sv[pix] = v;
    }
    __syncthreads();
    int total = 0, before[PPT];
    for (int i = 0; i < PPT * NWARPS; ++i) {
#pragma unroll
      for (int k = 0; k < PPT; ++k)
        if (i == k * NWARPS + warp) before[k] = total;
      total += n_present[i];
    }
    if (total == 0) {  // uniform over the block
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const int pix = tid + k * NTHREADS;
        for (int ch = 0; ch < O_AEFF; ++ch)
          o_l[ch * plane + (size_t)(pix / TILE_W) * g.wp + pix % TILE_W] = ch == O_TEX ? -1.f
                                                                                      : 0.f;
      }
      continue;
    }
    // deal the present pixels first, in (pixel k, warp, lane) order
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int pix = tid + k * NTHREADS;
      const int rank = before[k] + __popc(ballot[k] & ((1u << lane) - 1u));
      order[(ballot[k] >> lane) & 1u ? rank : total + pix - rank] = pix;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int i = tid + k * NTHREADS, pix = order[i];
      const int px = pix % TILE_W, py = pix / TILE_W;
      const float u = su[pix], v = sv[pix];
      float du_x = 0.f, du_y = 0.f, dv_x = 0.f, dv_y = 0.f;
      if (sp.n_levels > 0) {
        // in-tile differences, wrapping at the tile edges
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
      if (i < total) {
        float stk[L_CH];
        layer_channels<FORM>(rows, sm.stack[layer][pix], (float)px + 0.5f, (float)py + 0.5f,
                             x0f, y0f, stk);
        const float inv_iw = 1.f / fmaxf(stk[L_IW], (float)1e-8);
        const float xg = ((float)px + x0f) + 0.5f, yg = ((float)py + y0f) + 0.5f;
        shade_pixel(stk, u, v, inv_iw, du_x, du_y, dv_x, dv_y, xg, yg, layer, sp, res);
      } else {
        shade_absent(sm.colour, du_x, du_y, dv_x, dv_y, layer, sp, res);
      }
      for (int ch = 0; ch < O_AEFF; ++ch) o_l[ch * plane + (size_t)py * g.wp + px] = res[ch];
    }
  }
}

// Every thread of a block of frame.cu's or frame_hybrid.cu's kernel: tile
// blockIdx.x (of character blockIdx.y where CROWD: each character has its
// own rows, rows_stride floats apart, segments, misc, inverse
// view-projection and output; the shade tables are shared). W: the
// kernel's walk (FrameWalk, HybridWalk), which prepares a pair's record
// (prep), walks the records of a chunk of a pass (walk) and pushes the
// pass's winner (push) over per-pixel (Pixels) and per-pass (Pass) state;
// a winner's row is an index into the rows that push is handed.
template <class W, bool CROWD>
__device__ __forceinline__ void run_tile(TileSmem& sm, const float* rows, size_t rows_stride,
                                         const int* starts, const int* counts, float* out,
                                         ShadeParams g) {
  const int tid = threadIdx.x;
  const int bx_n = g.wp / TILE_W, b = blockIdx.x;
  const int n_tiles = bx_n * (g.hp / TILE_H);
  if constexpr (CROWD) {  // this block's character (64-bit offsets: a crowd passes 4 GB)
    const size_t c = blockIdx.y;
    rows += c * rows_stride;
    starts += c * N_PASSES * n_tiles;
    counts += c * N_PASSES * n_tiles;
    out += c * (2 * O_CH) * (size_t)g.hp * g.wp;
    g.misc += c * 8;
    g.inv_vp += c * 16;
    if (tid == 0) {
      sm.rows = rows;
      sm.out = out;
    }
  }
  const int bi = b / bx_n, bj = b % bx_n;
  const float x0f = (float)(bj * TILE_W), y0f = (float)(bi * TILE_H);
  const float xs = (float)(tid % TILE_W) + 0.5f;  // tile-local
  float ys[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) ys[k] = (float)(tid / TILE_W + k * ROW_STEP) + 0.5f;

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
  int first = N_PASSES, total = 0;
  for (int p = N_PASSES - 1; p >= 0; --p)
    if (sm.count[p] > 0) {
      first = p;
      total += sm.count[p];
    }
  if (first == N_PASSES) {  // uniform over the block
    store_empty_tile(out, bi, bj, g.hp, g.wp, tid);
    return;
  }
  // a crowd block's rows and output, read back from shared memory
  auto rows_c = [&]() -> const float* {
    if constexpr (CROWD) return sm.rows;
    else return rows;
  };
  const bool resident = total <= CHUNK;  // uniform over the block
  if (tid == 0) {
    if (resident) fetch_tile(sm, rows, total);
    else stage_rows(sm, rows + (size_t)sm.start[first] * ROW_W, min(sm.count[first], CHUNK), 0);
  }
  // the last thread, idle in a tile's first prep: the colour of a pixel with
  // no fragment (from the tables in device memory; read after a barrier)
  if (tid == NTHREADS - 1) absent_colour(g, sm.colour);
  const ShadeParams sp = stage_shade_params(g, sm.shade, tid, NTHREADS);

  typename W::Pixels pix;
  W::begin_tile(pix);
#pragma unroll
  for (int k = 0; k < PPT; ++k)
    sm.stack[0][tid + k * NTHREADS] = sm.stack[1][tid + k * NTHREADS] = Layer{-1, 0.f, 0.f};

  if (resident) {
    if (tid < total) {
      mbar_wait(&sm.bar[1], 0);
      W::prep(sm.ring[1] + tid * ROW_W, sm.prep + tid * PREP_W, x0f, y0f);
    }
    __syncthreads();
    for (int p = first, off = 0; p < N_PASSES; ++p) {
      const int n = sm.count[p];
      if (n <= 0) continue;  // uniform over the block
      typename W::Pass w;
      W::begin_pass(pix, w);
      W::walk(sm.prep + off * PREP_W, n, off, p, xs, ys, pix, w);
      W::template push<false>(sm.stack, tid, sm.ring[1], p, xs, ys, x0f, y0f, pix, w);
      off += n;
    }
  } else {
    int chunk = 0;  // position in the sequence of all passes' chunks
    for (int p = first; p < N_PASSES; ++p) {
      const int count = sm.count[p];
      if (count <= 0) continue;  // uniform over the block
      const int start = sm.start[p];
      typename W::Pass w;
      W::begin_pass(pix, w);
      for (int c0 = 0; c0 < count; c0 += CHUNK, ++chunk) {
        const int n = min(count - c0, CHUNK);
        const int stage = chunk & 1;
        // the next chunk into the other stage (read before the last barrier)
        if (tid == 0) stage_next(sm, rows_c(), p, count, c0, stage ^ 1);
        __syncthreads();  // the previous chunk's walk is done with prep
        if (tid < n) {
          mbar_wait(&sm.bar[stage], (chunk >> 1) & 1);
          W::prep(sm.ring[stage] + tid * ROW_W, sm.prep + tid * PREP_W, x0f, y0f);
        }
        __syncthreads();
        W::walk(sm.prep, n, start + c0, p, xs, ys, pix, w);
      }
      W::template push<true>(sm.stack, tid, rows_c(), p, xs, ys, x0f, y0f, pix, w);
    }
  }

  float* out_c = out;
  if constexpr (CROWD) out_c = sm.out;
  shade_tile<W::FORM>(sm, resident ? sm.ring[1] : rows_c(), g, sp, out_c, tid, bi, bj, x0f, y0f);
}

}  // namespace
}  // namespace reze
