// mxu frame megakernel for sm_90a: the seven raster passes in row-aligned
// 128-pair windows with packed (depth, draw order) winner keys, pushed onto
// the two-layer fragment stack, of one 8x128 tile per thread block; the
// stack goes to device memory planar for the stack shade (shade_stack.cu).
//
// Replaces reze_tpu/kernels/frame_mxu.py::render_megakernel_mxu (Pallas,
// plane evaluation and fragment resolve as matrix products). Its plain
// torch twin is reze_tpu_torch/kernels/frame_mxu.py::
// render_megakernel_mxu_twin; the module docstring there states the rules
// both keep (windows aligned to the global row index, raw planes at
// tile-local sample positions, the key clip(z_c 2^18) << 13 | reversed id,
// the winner's row taken in the window that holds the key's id, the key's
// quantised depth and global-centre attributes on the stack).
//
// What bounds it on this card: the per-pixel float work of the walk (per
// pixel and pair, per sample 4 planes of 2 products and 2 sums and 6 tests,
// plus the centre depth: ~90 operations at 4 samples), and writing the
// 24-plane stack (96 B per pixel). The design: one thread per pixel; its
// depths, coverage bits, best key, winner row and stencil in registers, the
// stack in shared memory (96 KB); each window is staged once per tile into
// shared memory with the plane constants moved to the tile origin, and
// every thread reads the same pair at the same time (broadcast). The
// winner's fragment is read from its row at the end of the pass.
//
// Compiled with -fmad=false: each product rounds on its own, as in the
// twin, so coverage and keys decide the same way.

#include <cuda_runtime.h>
#include <stdint.h>

#include "frame_common.cuh"

namespace reze {
namespace {

constexpr float ZQ = (float)(1 << 18);  // depth quantisation of the key
constexpr int IDB = 1 << 13;            // id bits of the key
constexpr int SENTINEL = 0x7fffffff;
constexpr int PW = 12;  // staged per pair: a[4], b[4], c[4] (edges 0-2, depth)

struct MxuArgs {
  const float* rows;
  const int* starts;  // (7, B)
  const int* counts;  // (7, B)
  float* out;         // (24, hp, wp) planar stack
  int hp, wp;
};

template <int NS>
__global__ void __launch_bounds__(NPIX, 1) mxu_kernel(MxuArgs a) {
  extern __shared__ float sm[];
  float* stack = sm;                   // [2 * L_CH][NPIX]
  float* q = stack + 2 * L_CH * NPIX;  // [CHUNK][PW] staged window

  const int tid = threadIdx.x;
  const int py = tid / TILE_W, px = tid % TILE_W;
  const int bx_n = a.wp / TILE_W;
  const int n_tiles = bx_n * (a.hp / TILE_H);
  const int b = blockIdx.x;
  const int bi = b / bx_n, bj = b % bx_n;
  const float x0f = (float)(bj * TILE_W), y0f = (float)(bi * TILE_H);
  const float xs = (float)px + 0.5f, ys = (float)py + 0.5f;  // tile-local centre
  float sx[NS], sy[NS];  // tile-local sample positions (exact)
  for (int s = 0; s < NS; ++s) {
    sx[s] = xs + SAMPLE_DX[s];
    sy[s] = ys + SAMPLE_DY[s];
  }

  float zbuf[NS];
  for (int s = 0; s < NS; ++s) zbuf[s] = 1.f;
  for (int ch = 0; ch < 2 * L_CH; ++ch) stack[ch * NPIX + tid] = 0.f;
  float stencil = 0.f;
  int idx = -1;  // the winner's row, kept across passes as the reference keeps its fragment

  for (int p = 0; p < N_PASSES; ++p) {
    const int count = a.counts[p * n_tiles + b];
    if (count <= 0) continue;  // uniform over the block
    const int start = a.starts[p * n_tiles + b];
    const bool depth_write = PASS_CFG[p][1];
    unsigned won = 0;  // bit s: sample s covered in this pass
    int best = SENTINEL;
    const int astart = (start / CHUNK) * CHUNK;

    for (int wb = astart; wb < start + count; wb += CHUNK) {
      const int lo = max(start, wb) - wb, hi = min(start + count, wb + CHUNK) - wb;
      __syncthreads();  // the previous window is consumed
      if (tid >= lo && tid < hi) {
        const float* r = a.rows + (size_t)(wb + tid) * ROW_W;
        float* d = q + tid * PW;
        for (int e = 0; e < 4; ++e) {
          const float ae = r[3 * e], be = r[3 * e + 1];
          d[e] = ae;
          d[4 + e] = be;
          d[8 + e] = r[3 * e + 2] + (ae * x0f + be * y0f);
        }
      }
      __syncthreads();

      float zmin[NS];
      for (int s = 0; s < NS; ++s) zmin[s] = 2.f;
      unsigned hit_s = 0;
      int kmin = SENTINEL;
      for (int j = lo; j < hi; ++j) {
        const float* d = q + j * PW;
        bool any_pass = false;
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const float e0 = (d[0] * sx[s] + d[4] * sy[s]) + d[8];
          const float e1 = (d[1] * sx[s] + d[5] * sy[s]) + d[9];
          const float e2 = (d[2] * sx[s] + d[6] * sy[s]) + d[10];
          const float zz = (d[3] * sx[s] + d[7] * sy[s]) + d[11];
          if (e0 >= 0.f && e1 >= 0.f && e2 >= 0.f && zz <= zbuf[s] && zz >= 0.f
              && zz <= 1.f) {
            zmin[s] = fminf(zmin[s], zz);
            hit_s |= 1u << s;
            any_pass = true;
          }
        }
        if (any_pass) {
          const float zc = (d[3] * xs + d[7] * ys) + d[11];
          const int zq = (int)fminf(fmaxf(zc * ZQ, 0.f), ZQ - 1.f);
          const int seg = min(max(wb + j - start, 0), IDB - 1);
          kmin = min(kmin, (zq << 13) | (IDB - 1 - seg));
        }
      }
      for (int s = 0; s < NS; ++s)
        if (depth_write) zbuf[s] = fminf(zbuf[s], zmin[s]);
      won |= hit_s;
      best = min(best, kmin);
      // the row of the key's id, if this window holds it
      const int local = ((IDB - 1) - (best & (IDB - 1))) - (wb - start);
      if (best < SENTINEL && local >= 0 && local < CHUNK) idx = wb + local;
    }

    float cover = (float)(won & 1u);
    for (int s = 1; s < NS; ++s) cover = cover + (float)((won >> s) & 1u);
    cover = cover * (float)(1.0 / NS);
    const bool hit = best < SENTINEL;
    const float z = (float)(best >> 13) * (float)(1.0 / (1 << 18));
    float attrs[6], code = 0.f;
    for (int ch = 0; ch < 6; ++ch) attrs[ch] = 0.f;
    if (hit && idx >= 0) {
      const float* r = a.rows + (size_t)idx * ROW_W;
      const float xg = xs + x0f, yg = ys + y0f;  // global pixel centre
      code = r[C_ALPHA];
      for (int ch = 0; ch < 6; ++ch)
        attrs[ch] = (r[C_ATTR + ch] * xg + r[C_ATTR + 6 + ch] * yg) + r[C_ATTR + 12 + ch];
    }
    push_winner(stack, tid, stencil, hit, cover, code, attrs, z, p);
  }

  const size_t plane = (size_t)a.hp * a.wp;
  const size_t pix = (size_t)(bi * TILE_H + py) * a.wp + bj * TILE_W + px;
  for (int ch = 0; ch < 2 * L_CH; ++ch) a.out[ch * plane + pix] = stack[ch * NPIX + tid];
}

template <int NS>
void launch_mxu(const MxuArgs& a, int n_tiles, cudaStream_t stream) {
  const int smem = (2 * L_CH * NPIX + CHUNK * PW) * (int)sizeof(float);
  cudaFuncSetAttribute(mxu_kernel<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  mxu_kernel<NS><<<n_tiles, NPIX, smem, stream>>>(a);
}

}  // namespace
}  // namespace reze

extern "C" int reze_frame_mxu(const float* rows, const int* starts, const int* counts,
                              float* out, int hp, int wp, int n_samples, void* stream) {
  using namespace reze;
  MxuArgs a{rows, starts, counts, out, hp, wp};
  const int n_tiles = (hp / TILE_H) * (wp / TILE_W);
  cudaStream_t st = (cudaStream_t)stream;
  if (n_tiles <= 0) return (int)cudaErrorInvalidValue;
  switch (n_samples) {
    case 1: launch_mxu<1>(a, n_tiles, st); break;
    case 2: launch_mxu<2>(a, n_tiles, st); break;
    case 3: launch_mxu<3>(a, n_tiles, st); break;
    case 4: launch_mxu<4>(a, n_tiles, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
