// Frame megakernel for sm_90a: all seven raster passes, the two-layer
// fragment stack and the toon/rim shade of one 8x128 tile per thread block.
//
// Replaces reze_tpu/kernels/frame_tpu.py::render_megakernel (Pallas, with
// shade_tpu._shade_layer inlined). Its plain torch twin is
// reze_tpu_torch/kernels/frame_gpu.py::render_megakernel_twin; the module
// docstring there states the semantics both keep (32-pair groups tested
// against the depth buffer as it stood before the group, latest-drawn
// winner at minimum centre z, tile-local planes, stack push rules).
//
// What bounds it on this card: with few pairs per tile, the fixed cost of a
// tile (its state, the shade of both layers, the 18-plane store: 72 B per
// pixel, the one term of the byte bound that every tile pays); with many,
// the per-pixel float work of the walk (per pixel and pair 3 edge planes
// and the depth plane, then per sample 4 sums and 6 tests). A pixel's state
// is 7 passes of depths, coverage, a pass winner and a two-layer stack.
//
// The design: 512 threads per tile, each owning two pixels four rows apart,
// and no copied channel: a pixel's depths, its coverage bits and the
// stencil (one int; one float of coverage in analytic mode) and its pass
// winner as (z, global row index) stay in registers, and each stack layer
// is (row index and pass, z, a_eff) in shared memory, read and written by
// the pixel's thread alone. The attributes and the material code are
// evaluated from the row when the tile is shaded, with the same products
// in the same order as the twin. That takes 85 KB of shared memory per
// block and at most 64 registers per thread, so two tiles are resident per
// SM and one tile's shade and store overlap the other's walk. The 128-pair
// chunks of all passes form one sequence: one thread copies chunk k + 1
// (160 B rows) into a two-stage ring with the Tensor Memory Accelerator
// (cp.async.bulk, completion on an mbarrier) while the block walks chunk
// k. The threads of a chunk's pairs then move each plane constant to the
// tile origin and compute the sample offsets once per pair into a 128 B
// record that the walk reads as broadcast 16-byte loads, two pixels per
// load; a pixel outside an edge at all samples skips the sample tests. A
// tile with no pair in any pass writes its fixed output and stops. The
// shade tables are staged in shared memory once per tile.
//
// Compiled with -fmad=false: each product rounds on its own, as in the
// twin, so coverage and z-ties decide the same way.

#include <cuda_runtime.h>
#include <stdint.h>

#include "frame_common.cuh"

namespace reze {
namespace {

constexpr int GROUP = 32;
constexpr int NTHREADS = 512;
constexpr int PPT = NPIX / NTHREADS;         // pixels per thread
constexpr int ROW_STEP = NTHREADS / TILE_W;  // rows between a thread's pixels
// a prepared pair: per plane (edges 0-2, depth) a, b, c at the tile origin
// and, for an edge, 1/|grad| (analytic) or its largest sample offset
// (MSAA), then per sample the four plane offsets
constexpr int PREP_W = 32;
constexpr int PREP_OFF = 16;
constexpr float NO_HIT = 2.f;  // pass winner depth before any pair won

struct FrameArgs {
  const float* rows;
  const int* starts;  // (7, B)
  const int* counts;  // (7, B)
  float* out;         // (18, hp, wp)
  ShadeParams sp;
};

// a stack layer: its winner's row and pass as row * 8 + pass (-1: empty,
// every channel 0), its depth and effective alpha
struct Layer {
  int ref;
  float z, a;
};

struct __align__(128) Smem {
  float ring[2][CHUNK * ROW_W];  // staged rows; ring[0] is the shade's u/v exchange
  float prep[CHUNK * PREP_W];
  Layer stack[2][NPIX];  // a pixel's layers, read and written by its thread only
  float shade[SHADE_SMEM_FLOATS];
  uint64_t bar[2];
  int start[N_PASSES], count[N_PASSES];
};

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
__device__ __forceinline__ void stage_rows(Smem& sm, const float* src, int n, int stage) {
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

// --- per-pixel state -------------------------------------------------------

constexpr int STENCIL_BIT = 1 << 4;  // above the NS <= 4 coverage bits

// The push of one pass's winner (push_winner in frame_common.cuh, on
// references): opaque fragments clear the stack, translucent ones displace
// layer 1 into layer 0, a_eff < 0.001 is dropped; hair alpha halves over
// the stencil, which the eye pass writes.
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
// attribute planes of its row with the constant moved to the tile origin
// (zero for outline passes), its depth and alpha, its pass's outline flag
// and its material code's group ids.
__device__ __forceinline__ void layer_channels(const float* rows, const Layer& l, float xs,
                                               float ys, float x0f, float y0f, float* stk) {
  for (int ch = 0; ch < L_CH; ++ch) stk[ch] = 0.f;
  if (l.ref < 0) return;
  const float* r = rows + (size_t)(l.ref >> 3) * ROW_W;
  const int p = l.ref & 7;
  if (!PASS_CFG[p][0])
    for (int ch = 0; ch < 6; ++ch) {
      const float ca = __ldg(r + C_ATTR + ch), cb = __ldg(r + C_ATTR + 6 + ch);
      const float cc = (__ldg(r + C_ATTR + 12 + ch) + ca * x0f) + cb * y0f;
      stk[L_UIW + ch] = (ca * xs + cc) + cb * ys;
    }
  const int rest = (int)rintf(__ldg(r + C_ALPHA)) >> 10;
  stk[L_Z] = l.z;
  stk[L_AEFF] = l.a;
  stk[L_OUT] = PASS_CFG[p][0] ? 1.f : 0.f;
  stk[L_RAMP] = (float)(rest & 15);
  stk[L_TEX] = (float)((rest >> 4) & 15);
  stk[L_EDGE] = (float)((rest >> 8) & 15);
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

template <int NS, bool ANALYTIC>
__global__ void __launch_bounds__(NTHREADS, 2) frame_kernel(FrameArgs a) {
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_bytes);

  const int tid = threadIdx.x;
  const int px = tid % TILE_W, py0 = tid / TILE_W;
  const int bx_n = a.sp.wp / TILE_W;
  const int n_tiles = bx_n * (a.sp.hp / TILE_H);
  const int b = blockIdx.x;
  const int bi = b / bx_n, bj = b % bx_n;
  const float x0f = (float)(bj * TILE_W), y0f = (float)(bi * TILE_H);
  const float xs = (float)px + 0.5f;  // tile-local
  float ys[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) ys[k] = (float)(py0 + k * ROW_STEP) + 0.5f;

  if (tid < N_PASSES) {
    sm.count[tid] = a.counts[tid * n_tiles + b];
    sm.start[tid] = a.starts[tid * n_tiles + b];
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
    store_empty_tile(a.out, bi, bj, a.sp.hp, a.sp.wp, tid);
    return;
  }
  if (tid == 0) stage_rows(sm, a.rows + (size_t)sm.start[first] * ROW_W,
                           min(sm.count[first], CHUNK), 0);
  const ShadeParams sp = stage_shade_params(a.sp, sm.shade, tid, NTHREADS);

  float zbuf[PPT][NS];
  int bits[PPT];  // coverage of the pass per sample, the stencil
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    for (int s = 0; s < NS; ++s) zbuf[k][s] = 1.f;
    sm.stack[0][tid + k * NTHREADS] = sm.stack[1][tid + k * NTHREADS] = Layer{-1, 0.f, 0.f};
    bits[k] = 0;
  }

  int chunk = 0;  // position in the sequence of all passes' chunks
  for (int p = first; p < N_PASSES; ++p) {
    const int count = sm.count[p];
    if (count <= 0) continue;  // uniform over the block
    const int start = sm.start[p];
    const bool depth_write = PASS_CFG[p][1];
    float gz[PPT], won_a[PPT];  // pass winner depth; analytic coverage
    int gidx[PPT];              // pass winner row
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      gz[k] = NO_HIT;
      gidx[k] = -1;
      won_a[k] = 0.f;
      bits[k] &= STENCIL_BIT;
    }

    for (int c0 = 0; c0 < count; c0 += CHUNK, ++chunk) {
      const int n = min(count - c0, CHUNK);
      const int stage = chunk & 1;
      if (tid == 0) {  // the next chunk into the other stage (read before the last barrier)
        int np = p, nc = c0 + CHUNK;
        if (nc >= count) {
          nc = 0;
          for (np = p + 1; np < N_PASSES && sm.count[np] <= 0; ++np) {
          }
        }
        if (np < N_PASSES)
          stage_rows(sm, a.rows + (size_t)(sm.start[np] + nc) * ROW_W,
                     min(sm.count[np] - nc, CHUNK), stage ^ 1);
      }
      __syncthreads();  // the previous chunk's walk is done with prep
      if (tid < n) {
        mbar_wait(&sm.bar[stage], (chunk >> 1) & 1);
        const float* r = sm.ring[stage] + tid * ROW_W;
        float* d = sm.prep + tid * PREP_W;
        for (int e = 0; e < 4; ++e) {
          const int k = e < 3 ? 3 * e : C_Z;
          d[4 * e] = r[k];
          d[4 * e + 1] = r[k + 1];
          d[4 * e + 2] = (r[k + 2] + r[k] * x0f) + r[k + 1] * y0f;
          float omax = 0.f;
          for (int s = 0; s < NS; ++s) {
            const float o = r[k] * SAMPLE_DX[s] + r[k + 1] * SAMPLE_DY[s];
            d[PREP_OFF + s * 4 + e] = o;
            omax = s ? fmaxf(omax, o) : o;
          }
          d[4 * e + 3] = e == 3 ? 0.f : ANALYTIC ? r[C_IGRAD + e] : omax;
        }
      }
      __syncthreads();

      for (int g0 = 0; g0 < n; g0 += GROUP) {
        const int nv = min(GROUP, n - g0);
        float zmin[PPT][NS], covmax[PPT], best_z[PPT];
        int hit[PPT], best_j[PPT];
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          for (int s = 0; s < NS; ++s) zmin[k][s] = 2.f;
          hit[k] = 0;
          covmax[k] = 0.f;
          best_z[k] = 2.f;
          best_j[k] = -1;
        }
        for (int j = 0; j < nv; ++j) {
          const float4* q = reinterpret_cast<const float4*>(sm.prep + (g0 + j) * PREP_W);
          float e0[PPT], e1[PPT], e2[PPT], zz[PPT];
          bool any_pass[PPT], live[PPT], any_live = false;
          {
            const float4 P0 = q[0], P1 = q[1], P2 = q[2], P3 = q[3];
            const float ax0 = P0.x * xs, ax1 = P1.x * xs, ax2 = P2.x * xs, axz = P3.x * xs;
#pragma unroll
            for (int k = 0; k < PPT; ++k) {
              e0[k] = (ax0 + P0.z) + P0.y * ys[k];
              e1[k] = (ax1 + P1.z) + P1.y * ys[k];
              e2[k] = (ax2 + P2.z) + P2.y * ys[k];
              zz[k] = (axz + P3.z) + P3.y * ys[k];
              any_pass[k] = false;
              if (ANALYTIC) {
                const float cov = (fminf(fmaxf(e0[k] * P0.w + 0.5f, 0.f), 1.f)
                                   * fminf(fmaxf(e1[k] * P1.w + 0.5f, 0.f), 1.f))
                                  * fminf(fmaxf(e2[k] * P2.w + 0.5f, 0.f), 1.f);
                any_pass[k] = cov > 0.f && zz[k] <= zbuf[k][0] && zz[k] >= 0.f;
                const float mn = fminf(fminf(e0[k], e1[k]), fminf(e2[k], zz[k]));
                if (mn >= 0.f && zz[k] <= zbuf[k][0]) zmin[k][0] = fminf(zmin[k][0], zz[k]);
                if (any_pass[k]) covmax[k] = fmaxf(covmax[k], cov);
              } else {
                // a pixel outside an edge at every sample fails them all:
                // e + o <= e + omax < 0 for each sample offset o, as
                // rounding is monotonic
                live[k] = !(e0[k] + P0.w < 0.f || e1[k] + P1.w < 0.f || e2[k] + P2.w < 0.f);
                any_live = any_live || live[k];
              }
            }
          }
          if (!ANALYTIC && any_live) {
#pragma unroll
            for (int s = 0; s < NS; ++s) {
              const float4 o = q[PREP_OFF / 4 + s];
#pragma unroll
              for (int k = 0; k < PPT; ++k) {
                const float zs = zz[k] + o.w;
                const float mn = fminf(fminf(e0[k] + o.x, e1[k] + o.y), fminf(e2[k] + o.z, zs));
                if (live[k] && mn >= 0.f && zs <= zbuf[k][s]) {
                  zmin[k][s] = fminf(zmin[k][s], zs);
                  hit[k] |= 1 << s;
                  any_pass[k] = true;
                }
              }
            }
          }
          // winner: latest-drawn pair at minimum centre z
#pragma unroll
          for (int k = 0; k < PPT; ++k)
            if (any_pass[k] && zz[k] <= best_z[k]) {
              best_z[k] = zz[k];
              best_j[k] = j;
            }
        }
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          if (depth_write)
            for (int s = 0; s < NS; ++s) zbuf[k][s] = fminf(zbuf[k][s], zmin[k][s]);
          if (ANALYTIC) won_a[k] = fmaxf(won_a[k], covmax[k]);
          else bits[k] |= hit[k];
          if (best_j[k] >= 0 && best_z[k] <= gz[k] && best_z[k] < 2.f) {
            gz[k] = best_z[k];
            gidx[k] = start + c0 + g0 + best_j[k];
          }
        }
      }
    }

    // push the pass's fragments onto the two-layer stack
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      float cover = 0.f;
      for (int s = 0; s < NS; ++s)
        cover = cover + (ANALYTIC ? won_a[k] : (float)((bits[k] >> s) & 1));
      cover = cover * (float)(1.0 / NS);
      const bool hit = gz[k] < NO_HIT;
      const float code = hit ? __ldg(a.rows + (size_t)gidx[k] * ROW_W + C_ALPHA) : 0.f;
      push_ref(sm.stack[0][tid + k * NTHREADS], sm.stack[1][tid + k * NTHREADS], bits[k], hit,
               cover, code, gidx[k] * 8 + p, gz[k], p);
    }
  }

  // shade both layers; the ring's first stage holds the u, v exchange
  float* su = sm.ring[0];
  float* sv = su + NPIX;
  const size_t plane = (size_t)a.sp.hp * a.sp.wp;
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
      float* o = a.out + (size_t)layer * O_CH * plane
                 + (size_t)(bi * TILE_H + py) * a.sp.wp + bj * TILE_W + px;
      o[O_AEFF * plane] = l.a;
      if (!any_present) {
        for (int ch = 0; ch < O_AEFF; ++ch) o[ch * plane] = ch == O_TEX ? -1.f : 0.f;
        continue;
      }
      float stk[L_CH];
      layer_channels(a.rows, l, xs, ys[k], x0f, y0f, stk);
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
      layer_channels(a.rows, sm.stack[layer][tid + k * NTHREADS], xs, ys[k], x0f, y0f, stk);
      const float xg = ((float)px + x0f) + 0.5f, yg = ((float)py + y0f) + 0.5f;
      float res[O_AEFF];
      shade_pixel(stk, u[k], v[k], inv_iw[k], du_x, du_y, dv_x, dv_y, xg, yg, layer, sp, res);
      float* o = a.out + (size_t)layer * O_CH * plane
                 + (size_t)(bi * TILE_H + py) * a.sp.wp + bj * TILE_W + px;
      for (int ch = 0; ch < O_AEFF; ++ch) o[ch * plane] = res[ch];
    }
  }
}

template <int NS, bool ANALYTIC>
void launch(const FrameArgs& a, int n_tiles, cudaStream_t stream) {
  static bool configured = false;  // the attribute holds for the process
  if (!configured) {
    cudaFuncSetAttribute(frame_kernel<NS, ANALYTIC>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem));
    configured = true;
  }
  frame_kernel<NS, ANALYTIC><<<n_tiles, NTHREADS, sizeof(Smem), stream>>>(a);
}

}  // namespace
}  // namespace reze

extern "C" int reze_frame(const float* rows, const int* starts, const int* counts,
                          const float* knot, int kr, const float* tex, int kt, int tex_cols,
                          const float* edge, int ke, const float* ldir, const float* lcol,
                          const float* misc, const float* inv_vp, float* out, int hp, int wp,
                          int n_samples, int analytic, int n_levels, void* stream) {
  using namespace reze;
  FrameArgs a{rows, starts, counts, out,
              ShadeParams{knot, tex, edge, ldir, lcol, misc, inv_vp, kr, kt, tex_cols, ke,
                          n_levels, hp, wp}};
  const int n_tiles = (hp / TILE_H) * (wp / TILE_W);
  cudaStream_t st = (cudaStream_t)stream;
  if (n_tiles <= 0 || kr > MAX_GROUPS || kt > MAX_GROUPS || ke > MAX_GROUPS
      || tex_cols > MAX_TEX_COLS || ((uintptr_t)rows & 15) || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  if (analytic) {
    launch<1, true>(a, n_tiles, st);
  } else {
    switch (n_samples) {
      case 1: launch<1, false>(a, n_tiles, st); break;
      case 2: launch<2, false>(a, n_tiles, st); break;
      case 3: launch<3, false>(a, n_tiles, st); break;
      case 4: launch<4, false>(a, n_tiles, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
