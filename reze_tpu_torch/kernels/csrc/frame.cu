// Frame megakernel for sm_90a: all seven raster passes, the two-layer
// fragment stack and the toon/rim shade of one 8x128 tile per thread block,
// for one character or a crowd (grid (tiles, characters)).
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
// shade tables are staged in shared memory once per tile. All of this but
// the walk of a chunk is frame_common.cuh's tile design, which the hybrid
// kernel (frame_hybrid.cu) shares.
//
// A crowd launch adds the character as blockIdx.y: each character has its
// own pair rows (rows_stride floats apart, every block 16-byte aligned for
// the bulk copies), starts and counts, eye position (misc) and inverse
// view-projection, and writes its own output; the shade tables are shared.
// One character is the launch with one row of blocks, compiled without the
// per-character offsets (CROWD false): they cost registers and spills.
//
// Compiled with -fmad=false: each product rounds on its own, as in the
// twin, so coverage and z-ties decide the same way.

#include <cuda_runtime.h>
#include <stdint.h>

#include "frame_common.cuh"

namespace reze {
namespace {

constexpr int GROUP = 32;

struct FrameArgs {
  const float* rows;  // per character (N, ROW_W), rows_stride floats apart
  size_t rows_stride;
  const int* starts;  // (C, 7, B)
  const int* counts;  // (C, 7, B)
  float* out;         // (C, 18, hp, wp)
  ShadeParams sp;     // misc (C, 8) and inv_vp (C, 4, 4) per character
};

template <int NS, bool ANALYTIC, bool CROWD>
__global__ void __launch_bounds__(NTHREADS, 2) frame_kernel(FrameArgs a) {
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  TileSmem& sm = *reinterpret_cast<TileSmem*>(smem_bytes);

  const int tid = threadIdx.x;
  const int px = tid % TILE_W, py0 = tid / TILE_W;
  const int bx_n = a.sp.wp / TILE_W, b = blockIdx.x;
  if constexpr (CROWD) {  // this block's character (64-bit offsets: a crowd passes 4 GB)
    const size_t c = blockIdx.y, n_tiles = (size_t)bx_n * (a.sp.hp / TILE_H);
    a.rows += c * a.rows_stride;
    a.starts += c * N_PASSES * n_tiles;
    a.counts += c * N_PASSES * n_tiles;
    a.out += c * (2 * O_CH) * (size_t)a.sp.hp * a.sp.wp;
    a.sp.misc += c * 8;
    a.sp.inv_vp += c * 16;
  }
  const int bi = b / bx_n, bj = b % bx_n;
  const float x0f = (float)(bj * TILE_W), y0f = (float)(bi * TILE_H);
  const float xs = (float)px + 0.5f;  // tile-local
  float ys[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) ys[k] = (float)(py0 + k * ROW_STEP) + 0.5f;

  const int first = begin_tile(sm, a.rows, a.starts, a.counts, a.out, a.sp, tid);
  if (first == N_PASSES) return;  // uniform over the block
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
      // the next chunk into the other stage (read before the last barrier)
      if (tid == 0) stage_next(sm, a.rows, p, count, c0, stage ^ 1);
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

  shade_layers<FRAME_PLANES>(sm, a.rows, a.sp, sp, a.out, tid, bi, bj, px, py0, xs, ys, x0f,
                            y0f);
}

template <int NS, bool ANALYTIC, bool CROWD>
void launch_as(const FrameArgs& a, dim3 grid, cudaStream_t stream) {
  static bool configured = false;  // the attribute holds for the process
  if (!configured) {
    cudaFuncSetAttribute(frame_kernel<NS, ANALYTIC, CROWD>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(TileSmem));
    configured = true;
  }
  frame_kernel<NS, ANALYTIC, CROWD><<<grid, NTHREADS, sizeof(TileSmem), stream>>>(a);
}

template <int NS, bool ANALYTIC>
void launch(const FrameArgs& a, int n_tiles, int n_chars, cudaStream_t stream) {
  if (n_chars == 1)
    launch_as<NS, ANALYTIC, false>(a, dim3(n_tiles), stream);
  else
    launch_as<NS, ANALYTIC, true>(a, dim3(n_tiles, n_chars), stream);
}

}  // namespace
}  // namespace reze

// n_chars characters: rows_stride floats between their pair rows (a
// multiple of 4, so every character's rows stay 16-byte aligned); starts,
// counts, misc, inv_vp and out are stacked per character
extern "C" int reze_frame(const float* rows, long long rows_stride, const int* starts,
                          const int* counts, const float* knot, int kr, const float* tex,
                          int kt, int tex_cols, const float* edge, int ke, const float* ldir,
                          const float* lcol, const float* misc, const float* inv_vp,
                          float* out, int hp, int wp, int n_samples, int analytic,
                          int n_levels, int n_chars, void* stream) {
  using namespace reze;
  FrameArgs a{rows, (size_t)rows_stride, starts, counts, out,
              ShadeParams{knot, tex, edge, ldir, lcol, misc, inv_vp, kr, kt, tex_cols, ke,
                          n_levels, hp, wp}};
  const int n_tiles = (hp / TILE_H) * (wp / TILE_W);
  cudaStream_t st = (cudaStream_t)stream;
  if (n_tiles <= 0 || n_chars <= 0 || n_chars > 65535 || rows_stride < 0 || (rows_stride & 3)
      || kr > MAX_GROUPS || kt > MAX_GROUPS || ke > MAX_GROUPS || tex_cols > MAX_TEX_COLS
      || ((uintptr_t)rows & 15) || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  if (analytic) {
    launch<1, true>(a, n_tiles, n_chars, st);
  } else {
    switch (n_samples) {
      case 1: launch<1, false>(a, n_tiles, n_chars, st); break;
      case 2: launch<2, false>(a, n_tiles, n_chars, st); break;
      case 3: launch<3, false>(a, n_tiles, n_chars, st); break;
      case 4: launch<4, false>(a, n_tiles, n_chars, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
