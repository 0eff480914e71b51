// One raster pass for sm_90a: per-sample depth test and a 9-channel
// G-buffer over 32x128 tiles, one triangle at a time in draw order.
//
// Replaces reze_tpu/kernels/raster_tpu.py::raster_pass_tpu (Pallas). Its
// plain torch twin is reze_tpu_torch/kernels/raster_gpu.py::
// raster_pass_twin; the module docstring there states the semantics both
// keep (absolute-coordinate planes, band skipping by the triangle's y
// range, last winning triangle takes the G-buffer, CH_MAT = -1 and zeros
// where nothing won).
//
// What bounds it on this card: device memory traffic is small and fixed
// (4 depths in and out and 9 channels out, 68 B per pixel at 4 samples),
// and the work grows with the pairs: per pixel and pair, 3 edge planes and
// 1 depth plane (16 float ops) plus ~8 per sample. A tile walks its pairs
// in order, so the parallelism is across pixels. The design: one block per
// 8x128 band of a tile (4 blocks per tile), one thread per pixel, holding
// its depths, a won-bit per sample and its 9 channels in registers. The
// tile's pair rows are staged through shared memory in 128-pair chunks
// (ids first, then the rows they name), with the per-sample plane offsets
// computed once per pair; every thread then reads the same row at the same
// time (broadcast). A pair whose y range misses the band is skipped by the
// whole block.
//
// Compiled with -fmad=false: each product rounds on its own, as in the
// twin, so coverage and depth ties decide the same way.

#include <cuda_runtime.h>
#include <stdint.h>

namespace reze {
namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int BAND_H = 8;
constexpr int BANDS = TILE_H / BAND_H;
constexpr int NPIX = BAND_H * TILE_W;  // threads per block, one per pixel
constexpr int CHUNK = 128;
constexpr int ROW_W = 40;
constexpr int C_Z = 9, C_YMIN = 12, C_YMAX = 13, C_ATTR = 16, C_MAT = 34;
constexpr int CH_UIW = 0, CH_MAT = 6, CH_COVER = 7, CH_Z = 8, N_CH = 9;

__constant__ float SAMPLE_DX[4] = {-2.f / 16.f, 6.f / 16.f, -6.f / 16.f, 2.f / 16.f};
__constant__ float SAMPLE_DY[4] = {-6.f / 16.f, -2.f / 16.f, 2.f / 16.f, 6.f / 16.f};

struct RasterArgs {
  const float* tab;   // (T, ROW_W)
  const int* ids;     // (n_ids,)
  const int* starts;  // (B,)
  const int* counts;  // (B,)
  float* zbuf;        // (S, hp, wp), in place
  float* gbuf;        // (N_CH, hp, wp)
  int n_ids, hp, wp;
};

template <int NS, bool DEPTH_WRITE, bool ATTRS>
__global__ void __launch_bounds__(NPIX) raster_kernel(RasterArgs a) {
  __shared__ int ids_s[CHUNK];
  __shared__ float rows[CHUNK * ROW_W];
  __shared__ float offs[CHUNK * 16];  // per pair: [sample][3 edges + depth]

  const int tid = threadIdx.x;
  const int py = tid / TILE_W, px = tid % TILE_W;
  const int bx_n = a.wp / TILE_W;
  const int tile = blockIdx.x / BANDS, band = blockIdx.x % BANDS;
  const int ti = tile / bx_n, tj = tile % bx_n;
  const float x0f = (float)(tj * TILE_W), y0f = (float)(ti * TILE_H);
  const int y = ti * TILE_H + band * BAND_H + py;
  const int x = tj * TILE_W + px;
  const float xs = ((float)px + x0f) + 0.5f;
  const float ys = ((float)(band * BAND_H + py) + y0f) + 0.5f;
  const size_t plane = (size_t)a.hp * a.wp;
  const size_t pix = (size_t)y * a.wp + x;
  const float bandf = (float)band;

  const int count = a.counts[tile];
  const int start = a.starts[tile];
  float z[NS];
  for (int s = 0; s < NS; ++s) z[s] = a.zbuf[s * plane + pix];
  float g[N_CH];
  for (int ch = 0; ch < N_CH; ++ch) g[ch] = 0.f;
  g[CH_MAT] = -1.f;
  unsigned won = 0u;

  for (int c0 = 0; c0 < count; c0 += CHUNK) {
    const int n = min(count - c0, CHUNK);
    __syncthreads();  // the previous chunk is consumed
    if (tid < n) {
      const int k = start + c0 + tid;
      ids_s[tid] = a.ids[min(k, a.n_ids - 1)];
    }
    __syncthreads();
    for (int i = tid; i < n * ROW_W; i += NPIX)
      rows[i] = a.tab[(size_t)ids_s[i / ROW_W] * ROW_W + i % ROW_W];
    __syncthreads();
    if (tid < n) {
      const float* r = rows + tid * ROW_W;
      for (int s = 0; s < NS; ++s) {
        for (int e = 0; e < 3; ++e)
          offs[tid * 16 + s * 4 + e] = r[e] * SAMPLE_DX[s] + r[3 + e] * SAMPLE_DY[s];
        offs[tid * 16 + s * 4 + 3] = r[C_Z] * SAMPLE_DX[s] + r[C_Z + 1] * SAMPLE_DY[s];
      }
    }
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      const float* r = rows + j * ROW_W;
      // bands of this tile that the triangle's y range touches (uniform)
      const float b0 = fminf(fmaxf(floorf(((r[C_YMIN] - 0.5f) - y0f) / (float)BAND_H), 0.f),
                             (float)(BANDS - 1));
      const float b1 = fminf(fmaxf(floorf(((r[C_YMAX] + 0.5f) - y0f) / (float)BAND_H), 0.f),
                             (float)(BANDS - 1));
      if (bandf < b0 || bandf > b1) continue;
      const float e0 = (r[0] * xs + r[3] * ys) + r[6];
      const float e1 = (r[1] * xs + r[4] * ys) + r[7];
      const float e2 = (r[2] * xs + r[5] * ys) + r[8];
      const float zz = (r[C_Z] * xs + r[C_Z + 1] * ys) + r[C_Z + 2];
      const float* o = offs + j * 16;
      bool any_pass = false;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const bool inside = (e0 + o[s * 4]) >= 0.f && (e1 + o[s * 4 + 1]) >= 0.f &&
                            (e2 + o[s * 4 + 2]) >= 0.f;
        const float zs = zz + o[s * 4 + 3];
        if (inside && zs <= z[s] && zs >= 0.f && zs <= 1.f) {
          if (DEPTH_WRITE) z[s] = zs;
          won |= 1u << s;
          any_pass = true;
        }
      }
      if (any_pass) {
        g[CH_MAT] = r[C_MAT];
        g[CH_Z] = zz;
        if (ATTRS) {
#pragma unroll
          for (int ch = 0; ch < 6; ++ch)
            g[CH_UIW + ch] = (r[C_ATTR + ch] * xs + r[C_ATTR + 6 + ch] * ys) + r[C_ATTR + 12 + ch];
        }
      }
    }
  }

  float cover = 0.f;
  for (int s = 0; s < NS; ++s) cover = cover + (float)((won >> s) & 1u);
  g[CH_COVER] = cover * (float)(1.0 / NS);
  if (DEPTH_WRITE)
    for (int s = 0; s < NS; ++s) a.zbuf[s * plane + pix] = z[s];
  for (int ch = 0; ch < N_CH; ++ch) a.gbuf[ch * plane + pix] = g[ch];
}

template <int NS>
void launch_ns(const RasterArgs& a, int blocks, bool depth_write, bool attrs,
               cudaStream_t st) {
  if (depth_write && attrs) raster_kernel<NS, true, true><<<blocks, NPIX, 0, st>>>(a);
  else if (depth_write) raster_kernel<NS, true, false><<<blocks, NPIX, 0, st>>>(a);
  else if (attrs) raster_kernel<NS, false, true><<<blocks, NPIX, 0, st>>>(a);
  else raster_kernel<NS, false, false><<<blocks, NPIX, 0, st>>>(a);
}

}  // namespace
}  // namespace reze

extern "C" int reze_raster(const float* tab, const int* ids, int n_ids, const int* starts,
                           const int* counts, float* zbuf, float* gbuf, int hp, int wp,
                           int n_samples, int depth_write, int with_attrs, void* stream) {
  using namespace reze;
  RasterArgs a{tab, ids, starts, counts, zbuf, gbuf, n_ids, hp, wp};
  const int blocks = (hp / TILE_H) * (wp / TILE_W) * BANDS;
  cudaStream_t st = (cudaStream_t)stream;
  if (blocks <= 0 || n_ids <= 0) return (int)cudaErrorInvalidValue;
  switch (n_samples) {
    case 1: launch_ns<1>(a, blocks, depth_write, with_attrs, st); break;
    case 2: launch_ns<2>(a, blocks, depth_write, with_attrs, st); break;
    case 3: launch_ns<3>(a, blocks, depth_write, with_attrs, st); break;
    case 4: launch_ns<4>(a, blocks, depth_write, with_attrs, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
