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
// What bounds it on this card: per pixel and per pair, 3 edge planes + 1
// depth plane at up to 4 samples (~60 float ops), with 7 passes of state
// per pixel (4 depth samples, 4 coverage flags, an 8-channel G-buffer, a
// 24-channel stack, a stencil: 41 floats x 1024 pixels = 168 KB). That is
// far more than 1024 threads' registers (64 each), so the design keeps it
// in dynamic shared memory, one pixel per thread, each thread the sole
// owner of its pixel's state (no synchronisation on it). The tile's pair
// rows are staged in 128-pair chunks in shared memory, with the per-pair
// constants moved to the tile origin and the sample offsets computed once
// per chunk; every thread then reads the same pair at the same time
// (broadcast). Device memory traffic is the pair rows once per tile and
// the 18-channel output once: the kernel is bound by the per-pixel float
// work and by one block per SM (the shared-memory footprint).
//
// Compiled with -fmad=false: each product rounds on its own, as in the
// twin, so coverage and z-ties decide the same way.

#include <cuda_runtime.h>
#include <stdint.h>

#include "frame_common.cuh"

namespace reze {
namespace {

constexpr int GROUP = 32;
constexpr int G_UIW = 0, G_Z = 6, G_ALPHA = 7, G_CH = 8;

struct FrameArgs {
  const float* rows;
  const int* starts;  // (7, B)
  const int* counts;  // (7, B)
  float* out;         // (18, hp, wp)
  ShadeParams sp;
};

__host__ __device__ constexpr int smem_floats(int ns) {
  return (2 * ns + G_CH + 2 * L_CH + 1) * NPIX + CHUNK * ROW_W + CHUNK * 16;
}

template <int NS, bool ANALYTIC>
__global__ void __launch_bounds__(NPIX, 1) frame_kernel(FrameArgs a) {
  extern __shared__ float sm[];
  float* zbuf = sm;                         // [NS][NPIX]
  float* won = zbuf + NS * NPIX;            // [NS][NPIX] coverage per sample
  float* gbuf = won + NS * NPIX;            // [G_CH][NPIX] pass G-buffer
  float* stack = gbuf + G_CH * NPIX;        // [2 * L_CH][NPIX]
  float* stencil = stack + 2 * L_CH * NPIX;  // [NPIX]
  float* rows = stencil + NPIX;             // [CHUNK][ROW_W] staged pairs
  float* offs = rows + CHUNK * ROW_W;       // [CHUNK][16] sample offsets

  const int tid = threadIdx.x;
  const int py = tid / TILE_W, px = tid % TILE_W;
  const int bx_n = a.sp.wp / TILE_W;
  const int n_tiles = bx_n * (a.sp.hp / TILE_H);
  const int b = blockIdx.x;
  const int bi = b / bx_n, bj = b % bx_n;
  const float x0f = (float)(bj * TILE_W), y0f = (float)(bi * TILE_H);
  const float xs = (float)px + 0.5f, ys = (float)py + 0.5f;  // tile-local

  for (int s = 0; s < NS; ++s) zbuf[s * NPIX + tid] = 1.f;
  for (int ch = 0; ch < 2 * L_CH; ++ch) stack[ch * NPIX + tid] = 0.f;
  stencil[tid] = 0.f;

  for (int p = 0; p < N_PASSES; ++p) {
    const int count = a.counts[p * n_tiles + b];
    if (count <= 0) continue;  // uniform over the block
    const int start = a.starts[p * n_tiles + b];
    const bool outline = PASS_CFG[p][0], depth_write = PASS_CFG[p][1];
    for (int ch = 0; ch < G_CH; ++ch) gbuf[ch * NPIX + tid] = 0.f;
    gbuf[G_Z * NPIX + tid] = 2.f;
    for (int s = 0; s < NS; ++s) won[s * NPIX + tid] = 0.f;

    for (int c0 = 0; c0 < count; c0 += CHUNK) {
      const int n = min(count - c0, CHUNK);
      __syncthreads();  // the previous chunk is consumed
      const float* src = a.rows + (size_t)(start + c0) * ROW_W;
      for (int i = tid; i < n * ROW_W; i += NPIX) rows[i] = src[i];
      __syncthreads();
      if (tid < n) {
        // move plane constants to the tile origin; sample offsets per pair
        float* r = rows + tid * ROW_W;
        for (int e = 0; e < 4; ++e) {
          const int k = e < 3 ? 3 * e : C_Z;
          r[k + 2] = (r[k + 2] + r[k] * x0f) + r[k + 1] * y0f;
          for (int s = 0; s < NS; ++s)
            offs[tid * 16 + s * 4 + e] = r[k] * SAMPLE_DX[s] + r[k + 1] * SAMPLE_DY[s];
        }
        for (int ch = 0; ch < 6; ++ch) {
          float* c = r + C_ATTR + 12 + ch;
          *c = (*c + r[C_ATTR + ch] * x0f) + r[C_ATTR + 6 + ch] * y0f;
        }
      }
      __syncthreads();

      for (int g0 = 0; g0 < n; g0 += GROUP) {
        const int nv = min(GROUP, n - g0);
        float zrow[NS], zmin_s[NS];
        bool hit_s[NS];
        float covmax = 0.f;
        for (int s = 0; s < NS; ++s) {
          zrow[s] = zbuf[s * NPIX + tid];
          zmin_s[s] = 2.f;
          hit_s[s] = false;
        }
        float best_z = 2.f;
        int best_j = -1;
        for (int j = 0; j < nv; ++j) {
          const float* r = rows + (g0 + j) * ROW_W;
          const float e0 = (r[0] * xs + r[2]) + r[1] * ys;
          const float e1 = (r[3] * xs + r[5]) + r[4] * ys;
          const float e2 = (r[6] * xs + r[8]) + r[7] * ys;
          const float zz = (r[C_Z] * xs + r[C_Z + 2]) + r[C_Z + 1] * ys;
          bool any_pass = false;
          if (ANALYTIC) {
            const float cov = (fminf(fmaxf(e0 * r[C_IGRAD] + 0.5f, 0.f), 1.f)
                               * fminf(fmaxf(e1 * r[C_IGRAD + 1] + 0.5f, 0.f), 1.f))
                              * fminf(fmaxf(e2 * r[C_IGRAD + 2] + 0.5f, 0.f), 1.f);
            any_pass = cov > 0.f && zz <= zrow[0] && zz >= 0.f;
            const float mn = fminf(fminf(e0, e1), fminf(e2, zz));
            if (mn >= 0.f && zz <= zrow[0]) zmin_s[0] = fminf(zmin_s[0], zz);
            if (any_pass) covmax = fmaxf(covmax, cov);
          } else {
            const float* o = offs + (g0 + j) * 16;
#pragma unroll
            for (int s = 0; s < NS; ++s) {
              const float zs = zz + o[s * 4 + 3];
              const float mn = fminf(fminf(e0 + o[s * 4], e1 + o[s * 4 + 1]),
                                     fminf(e2 + o[s * 4 + 2], zs));
              if (mn >= 0.f && zs <= zrow[s]) {
                zmin_s[s] = fminf(zmin_s[s], zs);
                hit_s[s] = true;
                any_pass = true;
              }
            }
          }
          // winner: latest-drawn pair at minimum centre z
          if (any_pass && zz <= best_z) {
            best_z = zz;
            best_j = j;
          }
        }
        for (int s = 0; s < NS; ++s) {
          if (depth_write) zbuf[s * NPIX + tid] = fminf(zrow[s], zmin_s[s]);
          float* w = won + s * NPIX + tid;
          *w = ANALYTIC ? fmaxf(*w, covmax) : (hit_s[s] ? fmaxf(*w, 1.f) : *w);
        }
        float* gz = gbuf + G_Z * NPIX + tid;
        if (best_j >= 0 && best_z <= *gz && best_z < 2.f) {
          const float* r = rows + (g0 + best_j) * ROW_W;
          *gz = best_z;
          gbuf[G_ALPHA * NPIX + tid] = r[C_ALPHA];
          if (!outline)
            for (int ch = 0; ch < 6; ++ch)
              gbuf[(G_UIW + ch) * NPIX + tid] =
                  (r[C_ATTR + ch] * xs + r[C_ATTR + 12 + ch]) + r[C_ATTR + 6 + ch] * ys;
        }
      }
    }

    // push the pass's fragments onto the two-layer stack
    float cover = 0.f;
    for (int s = 0; s < NS; ++s) cover = cover + won[s * NPIX + tid];
    cover = cover * (float)(1.0 / NS);
    float attrs[6];
    for (int ch = 0; ch < 6; ++ch) attrs[ch] = gbuf[(G_UIW + ch) * NPIX + tid];
    const float gz = gbuf[G_Z * NPIX + tid];
    push_winner(stack, tid, stencil[tid], gz < 2.f, cover, gbuf[G_ALPHA * NPIX + tid], attrs,
                gz, p);
  }

  // shade both layers in place; the G-buffer is free now (its first two
  // channels hold the neighbour exchange of u, v)
  shade_tile(stack, gbuf, gbuf + NPIX, tid, bi, bj, a.sp, a.out);
}

template <int NS, bool ANALYTIC>
void launch(const FrameArgs& a, int n_tiles, cudaStream_t stream) {
  const int smem = smem_floats(NS) * (int)sizeof(float);
  cudaFuncSetAttribute(frame_kernel<NS, ANALYTIC>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  frame_kernel<NS, ANALYTIC><<<n_tiles, NPIX, smem, stream>>>(a);
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
  if (n_tiles <= 0) return (int)cudaErrorInvalidValue;
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
