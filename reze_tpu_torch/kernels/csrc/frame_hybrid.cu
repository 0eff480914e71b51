// Hybrid frame megakernel for sm_90a: the seven raster passes in 128-pair
// chunks with exact-z winners, the two-layer fragment stack and the
// toon/rim shade of one 8x128 tile per thread block.
//
// Replaces reze_tpu/kernels/frame_hybrid.py::render_megakernel_hybrid
// (Pallas, plane evaluation as matrix products over a bfloat16 split). Its
// plain torch twin is reze_tpu_torch/kernels/frame_hybrid.py::
// render_megakernel_hybrid_twin; the module docstring there states the
// rules both keep (chunks from the segment start tested against the depth
// buffer as it stood before the chunk, normalised edge planes, tile-folded
// and sample-folded constants, the exact-z winner with the highest lane on
// a tie, the winner re-evaluated at the pixel centre, stack push rules).
//
// What bounds it on this card: as frame.cu, the per-pixel float work of
// the pair walk (per pixel and pair 4 planes of 2 products and a sum, then
// per sample 4 sums and 6 tests, ~45 operations at 4 samples) and one
// 1024-thread block per SM; device traffic is the pair rows once per tile,
// the winners' rows once per pixel and pass from L2, and the 18-plane
// output. The design: one thread per pixel; its depths, coverage, winner
// and stencil in registers, the 24-channel stack in shared memory (96 KB);
// each 128-pair chunk is staged once per tile into shared memory with the
// normalised coefficients and the per-sample plane constants computed
// there (so a plane at a sample is one shared product pair plus one sum),
// and every thread then reads the same pair at the same time (broadcast).
// The winner's row is kept as an index and read back at the end of the
// pass, not carried through the walk.
//
// Compiled with -fmad=false: each product rounds on its own, as in the
// twin, so coverage and z-ties decide the same way.

#include <cuda_runtime.h>
#include <stdint.h>

#include "frame_common.cuh"

namespace reze {
namespace {

constexpr float NO_HIT = 2.f;  // winner depth before any pair passed
// staged per pair: a[4], b[4], c[4] of the normalised edges 0-2 and the
// depth plane (c at the tile origin), then per sample c with its offset
constexpr int Q_A = 0, Q_B = 4, Q_C = 8, Q_S = 12;
__host__ __device__ constexpr int pair_floats(int ns) { return Q_S + 4 * ns; }

__host__ __device__ constexpr int smem_floats(int ns) {
  // the staging area doubles as the shade's 2 x NPIX scratch
  return 2 * L_CH * NPIX + (CHUNK * pair_floats(ns) > 2 * NPIX ? CHUNK * pair_floats(ns)
                                                                 : 2 * NPIX);
}

struct HybridArgs {
  const float* rows;
  const int* starts;  // (7, B)
  const int* counts;  // (7, B)
  float* out;         // (18, hp, wp)
  ShadeParams sp;
};

template <int NS, bool ANALYTIC>
__global__ void __launch_bounds__(NPIX, 1) hybrid_kernel(HybridArgs a) {
  constexpr int PW = pair_floats(NS);
  extern __shared__ float sm[];
  float* stack = sm;                   // [2 * L_CH][NPIX]
  float* q = stack + 2 * L_CH * NPIX;  // [CHUNK][PW] staged pairs

  const int tid = threadIdx.x;
  const int py = tid / TILE_W, px = tid % TILE_W;
  const int bx_n = a.sp.wp / TILE_W;
  const int n_tiles = bx_n * (a.sp.hp / TILE_H);
  const int b = blockIdx.x;
  const int bi = b / bx_n, bj = b % bx_n;
  const float x0f = (float)(bj * TILE_W), y0f = (float)(bi * TILE_H);
  const float xs = (float)px + 0.5f, ys = (float)py + 0.5f;  // tile-local

  float zbuf[NS];
  for (int s = 0; s < NS; ++s) zbuf[s] = 1.f;
  for (int ch = 0; ch < 2 * L_CH; ++ch) stack[ch * NPIX + tid] = 0.f;
  float stencil = 0.f;

  for (int p = 0; p < N_PASSES; ++p) {
    const int count = a.counts[p * n_tiles + b];
    if (count <= 0) continue;  // uniform over the block
    const int start = a.starts[p * n_tiles + b];
    const bool depth_write = PASS_CFG[p][1];
    float won[NS];
    for (int s = 0; s < NS; ++s) won[s] = 0.f;
    float best = NO_HIT;
    int idx = -1;  // the winner's row

    for (int c0 = 0; c0 < count; c0 += CHUNK) {
      const int n = min(count - c0, CHUNK);
      __syncthreads();  // the previous chunk is consumed
      if (tid < n) {
        const float* r = a.rows + (size_t)(start + c0 + tid) * ROW_W;
        float* d = q + tid * PW;
        for (int e = 0; e < 4; ++e) {
          float ae, be, ce;
          if (e < 3) {
            const float ig = r[C_IGRAD + e];
            ae = r[3 * e] * ig;
            be = r[3 * e + 1] * ig;
            ce = r[3 * e + 2] * ig;
          } else {
            ae = r[C_Z];
            be = r[C_Z + 1];
            ce = r[C_Z + 2];
          }
          ce = ce + (ae * x0f + be * y0f);
          d[Q_A + e] = ae;
          d[Q_B + e] = be;
          d[Q_C + e] = ce;
          if (!ANALYTIC)
            for (int s = 0; s < NS; ++s)
              d[Q_S + 4 * s + e] = ce + (ae * SAMPLE_DX[s] + be * SAMPLE_DY[s]);
        }
      }
      __syncthreads();

      float zmin[NS];
      bool hit_s[NS];
      for (int s = 0; s < NS; ++s) {
        zmin[s] = NO_HIT;
        hit_s[s] = false;
      }
      float covmax = 0.f, bz = NO_HIT;
      int bl = -1;
      for (int j = 0; j < n; ++j) {
        const float* d = q + j * PW;
        const float ab0 = d[Q_A] * xs + d[Q_B] * ys;
        const float ab1 = d[Q_A + 1] * xs + d[Q_B + 1] * ys;
        const float ab2 = d[Q_A + 2] * xs + d[Q_B + 2] * ys;
        const float ab3 = d[Q_A + 3] * xs + d[Q_B + 3] * ys;
        const float zc = ab3 + d[Q_C + 3];
        bool any_pass = false;
        if (ANALYTIC) {
          const float se0 = ab0 + d[Q_C], se1 = ab1 + d[Q_C + 1], se2 = ab2 + d[Q_C + 2];
          const float cov = (fminf(fmaxf(se0 + 0.5f, 0.f), 1.f)
                             * fminf(fmaxf(se1 + 0.5f, 0.f), 1.f))
                            * fminf(fmaxf(se2 + 0.5f, 0.f), 1.f);
          const bool zok = zc <= zbuf[0] && zc >= 0.f && zc <= 1.f;
          any_pass = cov > 0.f && zok;
          if (se0 >= 0.f && se1 >= 0.f && se2 >= 0.f && zok) zmin[0] = fminf(zmin[0], zc);
          if (any_pass) covmax = fmaxf(covmax, cov);
        } else {
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const float* cs = d + Q_S + 4 * s;
            const float e0 = ab0 + cs[0], e1 = ab1 + cs[1], e2 = ab2 + cs[2];
            const float zs = ab3 + cs[3];
            if (e0 >= 0.f && e1 >= 0.f && e2 >= 0.f && zs <= zbuf[s] && zs >= 0.f
                && zs <= 1.f) {
              zmin[s] = fminf(zmin[s], zs);
              hit_s[s] = true;
              any_pass = true;
            }
          }
        }
        // winner: minimum centre z, the highest lane on a tie
        if (any_pass && zc <= bz) {
          bz = zc;
          bl = j;
        }
      }
      for (int s = 0; s < NS; ++s) {
        if (depth_write) zbuf[s] = fminf(zbuf[s], zmin[s]);
        won[s] = ANALYTIC ? fmaxf(won[s], covmax) : (hit_s[s] ? 1.f : won[s]);
      }
      if (bz < NO_HIT && bz <= best) {  // a later chunk takes a tie
        best = bz;
        idx = start + c0 + bl;
      }
    }

    // the winner's depth and attributes at the pixel centre, then the push
    float cover = won[0];
    for (int s = 1; s < NS; ++s) cover = cover + won[s];
    if (!ANALYTIC) cover = cover * (float)(1.0 / NS);
    const bool hit = best < NO_HIT;
    float attrs[6], z = 0.f, code = 0.f;
    for (int ch = 0; ch < 6; ++ch) attrs[ch] = 0.f;
    if (hit) {
      const float* r = a.rows + (size_t)idx * ROW_W;
      z = (r[C_Z] * xs + r[C_Z + 1] * ys) + ((r[C_Z + 2] + r[C_Z] * x0f) + r[C_Z + 1] * y0f);
      code = r[C_ALPHA];
      for (int ch = 0; ch < 6; ++ch) {
        const float ca = r[C_ATTR + ch], cb = r[C_ATTR + 6 + ch], cc = r[C_ATTR + 12 + ch];
        attrs[ch] = (ca * xs + cb * ys) + ((cc + ca * x0f) + cb * y0f);
      }
    }
    push_winner(stack, tid, stencil, hit, cover, code, attrs, z, p);
  }

  __syncthreads();  // every thread is done with the staged pairs
  shade_tile(stack, q, q + NPIX, tid, bi, bj, a.sp, a.out);
}

template <int NS, bool ANALYTIC>
void launch_hybrid(const HybridArgs& a, int n_tiles, cudaStream_t stream) {
  const int smem = smem_floats(NS) * (int)sizeof(float);
  cudaFuncSetAttribute(hybrid_kernel<NS, ANALYTIC>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  hybrid_kernel<NS, ANALYTIC><<<n_tiles, NPIX, smem, stream>>>(a);
}

}  // namespace
}  // namespace reze

extern "C" int reze_frame_hybrid(const float* rows, const int* starts, const int* counts,
                                 const float* knot, int kr, const float* tex, int kt,
                                 int tex_cols, const float* edge, int ke, const float* ldir,
                                 const float* lcol, const float* misc, const float* inv_vp,
                                 float* out, int hp, int wp, int n_samples, int analytic,
                                 int n_levels, void* stream) {
  using namespace reze;
  HybridArgs a{rows, starts, counts, out,
               ShadeParams{knot, tex, edge, ldir, lcol, misc, inv_vp, kr, kt, tex_cols, ke,
                           n_levels, hp, wp}};
  const int n_tiles = (hp / TILE_H) * (wp / TILE_W);
  cudaStream_t st = (cudaStream_t)stream;
  if (n_tiles <= 0) return (int)cudaErrorInvalidValue;
  if (analytic) {
    launch_hybrid<1, true>(a, n_tiles, st);
  } else {
    switch (n_samples) {
      case 1: launch_hybrid<1, false>(a, n_tiles, st); break;
      case 2: launch_hybrid<2, false>(a, n_tiles, st); break;
      case 3: launch_hybrid<3, false>(a, n_tiles, st); break;
      case 4: launch_hybrid<4, false>(a, n_tiles, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
