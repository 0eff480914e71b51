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
// What bounds it on this card: device memory traffic. Every pixel gets
// its 9-channel G-buffer (36 B); depths (4 B a sample) are read only in the
// 8-row bands of a tile that some pair's y range touches and written only
// where a sample was won. With many pairs, the per-pixel float work (per
// pixel and pair 3 edge planes and the depth plane, then per sample 4 sums
// and 6 tests) takes over.
//
// The design: one block of 256 threads per 8x128 band of a tile (4 blocks
// per tile); a warp per row, four adjacent pixels per thread, so every
// G-buffer and depth access is a 16-byte access and a warp's are 512
// contiguous bytes. A pixel keeps its depths, a won bit per sample and the
// position of its last winning pair in registers; the G-buffer channels
// are evaluated from the winner's row once, after the walk, with the
// twin's products in the twin's order. The band's depths are loaded when
// the first pair that touches the band comes up (the test is uniform over
// the block), so a band no pair touches reads no depth, and a depth-write
// pass stores four pixels' depths of a sample where one of them won it. A
// tile with no pair, or a band that no pair touches, only stores the fixed
// G-buffer. Pairs are staged in 128-pair chunks: 16-byte cp.async copies
// gather the next chunk's rows by id while the block walks this one; the
// threads of a chunk's pairs compute each pair's sample offsets, each
// edge's largest offset and its band flag once into a 128 B record read by
// broadcast. A pixel whose edge value plus that edge's largest offset is <
// 0 fails the edge at every sample (rounding is monotonic) and skips its
// sample tests. 37 KB of shared memory per block; registers set the
// residency (4 blocks per SM at 64).
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
constexpr int NTHREADS = 256;  // 8 rows x 32 threads
constexpr int PPT = 4;         // adjacent pixels per thread
constexpr int CHUNK = 128;
constexpr int ROW_W = 40;
constexpr int ROW_V = ROW_W / 4;  // 16-byte pieces of a row
// a prepared pair: per plane (edges 0-2, depth) a, b, c and, for an edge,
// its largest sample offset (for the depth plane: the band flag), then per
// sample the four plane offsets
constexpr int PREP_W = 32;
constexpr int PREP_OFF = 16;
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

struct __align__(16) Smem {
  float rows[CHUNK * ROW_W];  // the rows of the chunk being staged
  float prep[CHUNK * PREP_W];
};

// torch.clamp's: NaN stays NaN
__device__ __forceinline__ float clamp_band(float b) {
  return b < 0.f ? 0.f : b > (float)(BANDS - 1) ? (float)(BANDS - 1) : b;
}

// every thread: start 16-byte copies of the rows of pairs [k0, k0 + n) of
// the id list into sm.rows
__device__ __forceinline__ void stage_chunk(Smem& sm, const RasterArgs& a, int k0, int n,
                                            int tid) {
  for (int i = tid; i < n * ROW_V; i += NTHREADS) {
    const int id = __ldg(a.ids + min(k0 + i / ROW_V, a.n_ids - 1));
    const float* src = a.tab + (size_t)id * ROW_W + (i % ROW_V) * 4;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     (uint32_t)__cvta_generic_to_shared(sm.rows + i * 4)),
                 "l"(src)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int NS, bool DEPTH_WRITE, bool ATTRS>
__global__ void __launch_bounds__(NTHREADS, 4) raster_kernel(RasterArgs a) {
  __shared__ Smem sm;

  const int tid = threadIdx.x;
  const int py = tid / 32, px0 = (tid % 32) * PPT;
  const int bx_n = a.wp / TILE_W;
  const int tile = blockIdx.x / BANDS, band = blockIdx.x % BANDS;
  const int ti = tile / bx_n, tj = tile % bx_n;
  const float x0f = (float)(tj * TILE_W), y0f = (float)(ti * TILE_H);
  float xs[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) xs[k] = ((float)(px0 + k) + x0f) + 0.5f;
  const float ys = ((float)(band * BAND_H + py) + y0f) + 0.5f;
  const size_t plane = (size_t)a.hp * a.wp;
  const size_t pix = (size_t)(ti * TILE_H + band * BAND_H + py) * a.wp + tj * TILE_W + px0;
  const float bandf = (float)band;

  const int count = a.counts[tile];
  const int start = a.starts[tile];
  float z[PPT][NS];
  bool z_loaded = false;  // uniform over the block
  unsigned won = 0u;      // bit k * 4 + s: pixel k won sample s
  int win[PPT];           // position of the pixel's last winning pair
#pragma unroll
  for (int k = 0; k < PPT; ++k) win[k] = -1;

  if (count > 0) stage_chunk(sm, a, start, min(count, CHUNK), tid);
  for (int c0 = 0; c0 < count; c0 += CHUNK) {
    const int n = min(count - c0, CHUNK);
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();  // the rows have landed; the previous chunk's walk is done with prep
    if (tid < n) {
      const float* r = sm.rows + tid * ROW_W;
      float* d = sm.prep + tid * PREP_W;
      for (int e = 0; e < 4; ++e) {
        const int k = e < 3 ? e : C_Z;
        const int kb = e < 3 ? 3 + e : C_Z + 1;
        d[4 * e] = r[k];
        d[4 * e + 1] = r[kb];
        d[4 * e + 2] = e < 3 ? r[6 + e] : r[C_Z + 2];
        float omax = 0.f;
        for (int s = 0; s < NS; ++s) {
          const float o = r[k] * SAMPLE_DX[s] + r[kb] * SAMPLE_DY[s];
          d[PREP_OFF + s * 4 + e] = o;
          omax = s ? fmaxf(omax, o) : o;
        }
        d[4 * e + 3] = omax;
      }
      // the bands of this tile that the triangle's y range touches
      const float b0 = clamp_band(floorf(((r[C_YMIN] - 0.5f) - y0f) / (float)BAND_H));
      const float b1 = clamp_band(floorf(((r[C_YMAX] + 0.5f) - y0f) / (float)BAND_H));
      d[15] = (bandf >= b0 && bandf <= b1) ? 1.f : 0.f;
    }
    __syncthreads();
    if (c0 + CHUNK < count)  // the rows are free: stage the next chunk
      stage_chunk(sm, a, start + c0 + CHUNK, min(count - c0 - CHUNK, CHUNK), tid);

    for (int j = 0; j < n; ++j) {
      const float4* q = reinterpret_cast<const float4*>(sm.prep + j * PREP_W);
      const float4 P3 = q[3];
      if (P3.w == 0.f) continue;  // the band is not touched (uniform)
      if (!z_loaded) {
        for (int s = 0; s < NS; ++s) {
          const float4 v = *reinterpret_cast<const float4*>(a.zbuf + s * plane + pix);
          z[0][s] = v.x;
          z[1][s] = v.y;
          z[2][s] = v.z;
          z[3][s] = v.w;
        }
        z_loaded = true;
      }
      const float4 P0 = q[0], P1 = q[1], P2 = q[2];
      const float by0 = P0.y * ys, by1 = P1.y * ys, by2 = P2.y * ys, byz = P3.y * ys;
      float e0[PPT], e1[PPT], e2[PPT], zz[PPT];
      bool live[PPT], any_live = false;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        e0[k] = (P0.x * xs[k] + by0) + P0.z;
        e1[k] = (P1.x * xs[k] + by1) + P1.z;
        e2[k] = (P2.x * xs[k] + by2) + P2.z;
        zz[k] = (P3.x * xs[k] + byz) + P3.z;
        // outside an edge at every sample: e + o <= e + omax < 0 for each
        // sample offset o, as rounding is monotonic
        live[k] = !(e0[k] + P0.w < 0.f || e1[k] + P1.w < 0.f || e2[k] + P2.w < 0.f);
        any_live = any_live || live[k];
      }
      if (!any_live) continue;
      unsigned passed = 0u;  // bit k: pixel k won a sample of this pair
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float4 o = q[PREP_OFF / 4 + s];
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const float zs = zz[k] + o.w;
          if (live[k] && (e0[k] + o.x) >= 0.f && (e1[k] + o.y) >= 0.f && (e2[k] + o.z) >= 0.f
              && zs <= z[k][s] && zs >= 0.f && zs <= 1.f) {
            if (DEPTH_WRITE) z[k][s] = zs;
            won |= 1u << (k * 4 + s);
            passed |= 1u << k;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < PPT; ++k)
        if (passed & (1u << k)) win[k] = c0 + j;
    }
  }

  // depths back where a sample was won (four pixels per store)
  if (DEPTH_WRITE)
    for (int s = 0; s < NS; ++s)
      if (won & (0x1111u << s))
        *reinterpret_cast<float4*>(a.zbuf + s * plane + pix) =
            make_float4(z[0][s], z[1][s], z[2][s], z[3][s]);

  // the G-buffer from each pixel's winner row
  const float* r[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k)
    r[k] = win[k] < 0 ? nullptr
                      : a.tab + (size_t)__ldg(a.ids + min(start + win[k], a.n_ids - 1)) * ROW_W;
  // a plane of pixel k's winner row: (a*x + b*y) + c
  auto plane_at = [&](int k, int col_a, int col_b, int col_c) {
    return (__ldg(r[k] + col_a) * xs[k] + __ldg(r[k] + col_b) * ys) + __ldg(r[k] + col_c);
  };
  float4* g = reinterpret_cast<float4*>(a.gbuf + pix);
  const size_t plane4 = plane / 4;
  float v[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) v[k] = r[k] ? __ldg(r[k] + C_MAT) : -1.f;
  g[CH_MAT * plane4] = make_float4(v[0], v[1], v[2], v[3]);
#pragma unroll
  for (int k = 0; k < PPT; ++k) v[k] = r[k] ? plane_at(k, C_Z, C_Z + 1, C_Z + 2) : 0.f;
  g[CH_Z * plane4] = make_float4(v[0], v[1], v[2], v[3]);
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    float cover = 0.f;
    for (int s = 0; s < NS; ++s) cover = cover + (float)((won >> (k * 4 + s)) & 1u);
    v[k] = cover * (float)(1.0 / NS);
  }
  g[CH_COVER * plane4] = make_float4(v[0], v[1], v[2], v[3]);
  for (int ch = 0; ch < 6; ++ch) {
#pragma unroll
    for (int k = 0; k < PPT; ++k)
      v[k] = ATTRS && r[k] ? plane_at(k, C_ATTR + ch, C_ATTR + 6 + ch, C_ATTR + 12 + ch) : 0.f;
    g[(CH_UIW + ch) * plane4] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <int NS>
void launch_ns(const RasterArgs& a, int blocks, bool depth_write, bool attrs,
               cudaStream_t st) {
  if (depth_write && attrs) raster_kernel<NS, true, true><<<blocks, NTHREADS, 0, st>>>(a);
  else if (depth_write) raster_kernel<NS, true, false><<<blocks, NTHREADS, 0, st>>>(a);
  else if (attrs) raster_kernel<NS, false, true><<<blocks, NTHREADS, 0, st>>>(a);
  else raster_kernel<NS, false, false><<<blocks, NTHREADS, 0, st>>>(a);
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
  if (blocks <= 0 || n_ids <= 0 || ((uintptr_t)tab & 15) || ((uintptr_t)zbuf & 15)
      || ((uintptr_t)gbuf & 15))
    return (int)cudaErrorInvalidValue;
  switch (n_samples) {
    case 1: launch_ns<1>(a, blocks, depth_write, with_attrs, st); break;
    case 2: launch_ns<2>(a, blocks, depth_write, with_attrs, st); break;
    case 3: launch_ns<3>(a, blocks, depth_write, with_attrs, st); break;
    case 4: launch_ns<4>(a, blocks, depth_write, with_attrs, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
