// Stream frame megakernel for sm_90a: one walk of a tile's pairs of all
// seven passes, merged in (tile, pass, draw) order, emitting the raw
// per-pass winners of one 8x128 tile per thread block, for one character
// or a crowd (grid (tiles, characters)).
//
// Replaces reze_tpu/kernels/frame_stream.py::render_megakernel_stream
// (Pallas, plane evaluation and fragment resolve as matrix products). Its
// plain torch twin is reze_tpu_torch/kernels/frame_stream.py::
// render_megakernel_stream_twin; the module docstring there states the
// rules both keep (row-aligned 128-pair windows, the passes in order inside
// each window, each (window, pass) group tested against the depth buffer
// as it stood before the group, centre planes with sample offsets, the key
// clip(z_c 2^17) << 14 | reversed id, the winner's row taken where the key
// strictly improves and lies in the window).
//
// What bounds it on this card: writing the raw state, 147 floats (588 B)
// per pixel, 1.23 GB at 1088x1920; the walk is ~60 float operations per
// pixel and pair at 4 samples. The reference keeps 7 x 24 floats per
// pixel of state (688 KB per tile), more than a block's 227 KB of shared
// memory. This design keeps per pass and pixel only the key, the winner's
// row index and 4 coverage bits (the bits of all passes in one register),
// 57 KB of shared memory for the tile, and gathers the 19 fragment values
// from the winners' rows (L2-resident) while writing the output. Each
// window is staged once into shared memory with the plane constants moved
// to the tile origin and the per-sample offsets computed there; every
// thread reads the same pair at the same time (broadcast). Output stores
// are planar, consecutive threads on consecutive pixels of a row.
//
// A crowd launch adds the character as blockIdx.y: each character has its
// own pair rows (rows_stride floats apart), bounds and output, at 64-bit
// offsets (a crowd's raw output passes 4 GB: 38.5 MB per character at
// 256x256). One character is the launch with one row of blocks, compiled
// without the per-character offsets (CROWD false).
//
// Compiled with -fmad=false: each product rounds on its own, as in the
// twin, so coverage and keys decide the same way.

#include <cuda_runtime.h>
#include <stdint.h>

#include "frame_common.cuh"

namespace reze {
namespace {

constexpr float ZQ = (float)(1 << 17);  // depth quantisation of the key
constexpr int IDB = 1 << 14;            // id bits of the key
constexpr int SENTINEL = 0x7fffffff;
constexpr int N_FRAG = 19;  // [code, a0..5, b0..5, c0..5]
// output planes: 7 keys, 7 coverages, 7 x 19 fragment values (147)
constexpr int O_COVER = N_PASSES, O_FRAG = 2 * N_PASSES;
// staged per pair: a[4], b[4], c[4] (edges 0-2, depth; c at the tile
// origin), then per sample the offsets a*dx + b*dy of the four planes
constexpr int Q_A = 0, Q_B = 4, Q_C = 8, Q_O = 12;
__host__ __device__ constexpr int pair_floats(int ns) { return Q_O + 4 * ns; }

struct StreamArgs {
  const float* rows;  // per character (N, ROW_W), rows_stride floats apart
  size_t rows_stride;
  const int* bounds;  // (C, 8, B)
  float* out;         // (C, 147, hp, wp)
  int hp, wp;
};

template <int NS, bool CROWD>
__global__ void __launch_bounds__(NPIX, 1) stream_kernel(StreamArgs a) {
  constexpr int PW = pair_floats(NS);
  extern __shared__ float sm[];
  int* keys = (int*)sm;               // [N_PASSES][NPIX]
  int* wrow = keys + N_PASSES * NPIX;  // [N_PASSES][NPIX] winner rows
  float* q = (float*)(wrow + N_PASSES * NPIX);  // [CHUNK][PW] staged window

  const int tid = threadIdx.x;
  const int py = tid / TILE_W, px = tid % TILE_W;
  const int bx_n = a.wp / TILE_W;
  const int n_tiles = bx_n * (a.hp / TILE_H);
  const int b = blockIdx.x;
  const int bi = b / bx_n, bj = b % bx_n;
  const float x0f = (float)(bj * TILE_W), y0f = (float)(bi * TILE_H);
  const float xs = (float)px + 0.5f, ys = (float)py + 0.5f;  // tile-local centre
  if constexpr (CROWD) {  // this block's character
    const size_t c = blockIdx.y;
    a.rows += c * a.rows_stride;
    a.bounds += c * (N_PASSES + 1) * (size_t)n_tiles;
    a.out += c * (O_FRAG + N_PASSES * N_FRAG) * (size_t)a.hp * a.wp;
  }

  for (int p = 0; p < N_PASSES; ++p) {
    keys[p * NPIX + tid] = SENTINEL;
    wrow[p * NPIX + tid] = -1;
  }
  float zbuf[NS];
  for (int s = 0; s < NS; ++s) zbuf[s] = 1.f;
  unsigned won = 0;  // bit 4p + s: sample s covered in pass p

  const int t0 = a.bounds[b], t1 = a.bounds[N_PASSES * n_tiles + b];
  for (int wb = (t0 / CHUNK) * CHUNK; wb < t1; wb += CHUNK) {
    const int lo = max(t0, wb) - wb, hi = min(t1, wb + CHUNK) - wb;
    __syncthreads();  // the previous window is consumed
    if (tid >= lo && tid < hi) {
      const float* r = a.rows + (size_t)(wb + tid) * ROW_W;
      float* d = q + tid * PW;
      for (int e = 0; e < 4; ++e) {
        const float ae = r[3 * e], be = r[3 * e + 1];
        d[Q_A + e] = ae;
        d[Q_B + e] = be;
        d[Q_C + e] = r[3 * e + 2] + (ae * x0f + be * y0f);
        for (int s = 0; s < NS; ++s) d[Q_O + 4 * s + e] = ae * SAMPLE_DX[s] + be * SAMPLE_DY[s];
      }
    }
    __syncthreads();

    for (int p = 0; p < N_PASSES; ++p) {
      const int b0 = a.bounds[p * n_tiles + b], b1 = a.bounds[(p + 1) * n_tiles + b];
      const int g0 = max(b0, wb), g1 = min(b1, wb + CHUNK);
      if (g1 <= g0) continue;  // uniform over the block
      float zmin[NS];
      for (int s = 0; s < NS; ++s) zmin[s] = 2.f;
      unsigned hit_s = 0;
      int kmin = SENTINEL;
      for (int g = g0; g < g1; ++g) {
        const float* d = q + (g - wb) * PW;
        const float e0 = (d[Q_A] * xs + d[Q_B] * ys) + d[Q_C];
        const float e1 = (d[Q_A + 1] * xs + d[Q_B + 1] * ys) + d[Q_C + 1];
        const float e2 = (d[Q_A + 2] * xs + d[Q_B + 2] * ys) + d[Q_C + 2];
        const float zc = (d[Q_A + 3] * xs + d[Q_B + 3] * ys) + d[Q_C + 3];
        bool any_pass = false;
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const float* o = d + Q_O + 4 * s;
          const float zs = zc + o[3];
          if (e0 >= -o[0] && e1 >= -o[1] && e2 >= -o[2] && zs <= zbuf[s] && zs >= 0.f
              && zs <= 1.f) {
            zmin[s] = fminf(zmin[s], zs);
            hit_s |= 1u << s;
            any_pass = true;
          }
        }
        if (any_pass) {
          const int zq = (int)fminf(fmaxf(zc * ZQ, 0.f), ZQ - 1.f);
          const int seg = min(max(g - b0, 0), IDB - 1);
          kmin = min(kmin, (zq << 14) | (IDB - 1 - seg));
        }
      }
      if (PASS_CFG[p][1])
        for (int s = 0; s < NS; ++s) zbuf[s] = fminf(zbuf[s], zmin[s]);
      won |= hit_s << (4 * p);
      const int old = keys[p * NPIX + tid];
      const int nb = min(old, kmin);
      const int local = ((IDB - 1) - (nb & (IDB - 1))) + (b0 - wb);
      if (nb < old && nb < SENTINEL && local >= 0 && local < CHUNK)
        wrow[p * NPIX + tid] = wb + local;
      keys[p * NPIX + tid] = nb;
    }
  }

  const size_t plane = (size_t)a.hp * a.wp;
  float* out = a.out + (size_t)(bi * TILE_H + py) * a.wp + bj * TILE_W + px;
  for (int p = 0; p < N_PASSES; ++p) {
    out[p * plane] = __int_as_float(keys[p * NPIX + tid]);
    float cover = (float)((won >> (4 * p)) & 1u);
    for (int s = 1; s < NS; ++s) cover = cover + (float)((won >> (4 * p + s)) & 1u);
    out[(O_COVER + p) * plane] = cover;
    const int r = wrow[p * NPIX + tid];
    float* f = out + (size_t)(O_FRAG + p * N_FRAG) * plane;
    if (r < 0) {
      for (int c = 0; c < N_FRAG; ++c) f[c * plane] = 0.f;
    } else {
      const float* row = a.rows + (size_t)r * ROW_W;
      f[0] = row[C_ALPHA];
      for (int c = 0; c < N_FRAG - 1; ++c) f[(1 + c) * plane] = row[C_ATTR + c];
    }
  }
}

template <int NS, bool CROWD>
void launch_as(const StreamArgs& a, dim3 grid, cudaStream_t stream) {
  const int smem = 2 * N_PASSES * NPIX * (int)sizeof(int)
                   + CHUNK * pair_floats(NS) * (int)sizeof(float);
  cudaFuncSetAttribute(stream_kernel<NS, CROWD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  stream_kernel<NS, CROWD><<<grid, NPIX, smem, stream>>>(a);
}

template <int NS>
void launch_stream(const StreamArgs& a, int n_tiles, int n_chars, cudaStream_t stream) {
  if (n_chars == 1)
    launch_as<NS, false>(a, dim3(n_tiles), stream);
  else
    launch_as<NS, true>(a, dim3(n_tiles, n_chars), stream);
}

}  // namespace
}  // namespace reze

// n_chars characters: rows_stride floats between their pair rows; bounds
// and out are stacked per character
extern "C" int reze_frame_stream(const float* rows, long long rows_stride, const int* bounds,
                                 float* out, int hp, int wp, int n_samples, int n_chars,
                                 void* stream) {
  using namespace reze;
  StreamArgs a{rows, (size_t)rows_stride, bounds, out, hp, wp};
  const int n_tiles = (hp / TILE_H) * (wp / TILE_W);
  cudaStream_t st = (cudaStream_t)stream;
  if (n_tiles <= 0 || n_chars <= 0 || n_chars > 65535 || rows_stride < 0)
    return (int)cudaErrorInvalidValue;
  switch (n_samples) {
    case 1: launch_stream<1>(a, n_tiles, n_chars, st); break;
    case 2: launch_stream<2>(a, n_tiles, n_chars, st); break;
    case 3: launch_stream<3>(a, n_tiles, n_chars, st); break;
    case 4: launch_stream<4>(a, n_tiles, n_chars, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
