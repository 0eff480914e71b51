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
// The design (frame_common.cuh's tile design, which the hybrid kernel
// frame_hybrid.cu shares): 512 threads per tile, each owning two pixels
// four rows apart; a pixel's depths, its coverage bits and the stencil
// (one int; one float of coverage in analytic mode) and its pass winner as
// (z, row index) stay in registers, and each stack layer is (row index and
// pass, z, a_eff) in shared memory. The attributes and the material code
// are evaluated from the row when the tile is shaded, with the same
// products in the same order as the twin. 85 KB of shared memory per block
// and at most 64 registers per thread: two tiles per SM. A tile whose pairs
// over all passes fit 128 rows is fetched in one go (cp.async.bulk, one
// copy per non-empty pass onto one mbarrier) and its rows stay in shared
// memory for the push and the shade; a fuller tile runs a two-stage ring of
// 128-pair chunks, chunk k + 1 in flight while chunk k is walked. The
// threads of a chunk's pairs move each plane constant to the tile origin
// and compute the sample offsets once per pair into a 128 B record that the
// walk reads as broadcast 16-byte loads, two pixels per load; a pixel
// outside an edge at all samples skips the sample tests. The shade deals a
// layer's present pixels to the threads first, so that a sparsely covered
// tile (a crowd character's, most of whose covered tiles hold a layer on a
// third of their pixels) shades about one pixel per thread. A tile with no
// pair writes its fixed output and stops. FrameWalk below is the part that
// is this kernel's own: the record, the walk of a chunk, the push.
//
// A crowd launch adds the character as blockIdx.y: each character has its
// own pair rows (rows_stride floats apart, every block 16-byte aligned for
// the bulk copies), starts and counts, eye position (misc) and inverse
// view-projection, and writes its own output; the shade tables are shared.
// One character is the launch with one row of blocks, compiled without the
// per-character offsets (CROWD false).
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

// The frame kernel's part of the tile design (frame_common.cuh): a pair's
// record, the walk of a chunk's records in 32-pair groups, the push.
template <int NS, bool ANALYTIC>
struct FrameWalk {
  static constexpr int FORM = FRAME_PLANES;
  struct Pixels {
    float zbuf[PPT][NS];
    int bits[PPT];  // coverage of the pass per sample, the stencil
  };
  struct Pass {
    float gz[PPT], won_a[PPT];  // pass winner depth; analytic coverage
    int gidx[PPT];              // pass winner row
  };

  __device__ __forceinline__ static void begin_tile(Pixels& px) {
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      for (int s = 0; s < NS; ++s) px.zbuf[k][s] = 1.f;
      px.bits[k] = 0;
    }
  }

  __device__ __forceinline__ static void begin_pass(Pixels& px, Pass& w) {
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      w.gz[k] = NO_HIT;
      w.gidx[k] = -1;
      w.won_a[k] = 0.f;
      px.bits[k] &= STENCIL_BIT;
    }
  }

  // the record of the pair of row r (shared memory) in the tile at (x0f,
  // y0f): per plane a, b, the constant at the tile origin and the largest
  // sample offset (analytic: the edge's 1/|grad|); per sample the offsets
  __device__ __forceinline__ static void prep(const float* r, float* d, float x0f, float y0f) {
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

  // the walk of n records of pass p in 32-pair groups, each tested against
  // the depths as they stood before the group; a winner's row is base plus
  // its record
  __device__ __forceinline__ static void walk(const float* prep, int n, int base, int p,
                                              float xs, const float* ys, Pixels& px, Pass& w) {
    const bool depth_write = PASS_CFG[p][1];
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
        const float4* q = reinterpret_cast<const float4*>(prep + (g0 + j) * PREP_W);
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
              any_pass[k] = cov > 0.f && zz[k] <= px.zbuf[k][0] && zz[k] >= 0.f;
              const float mn = fminf(fminf(e0[k], e1[k]), fminf(e2[k], zz[k]));
              if (mn >= 0.f && zz[k] <= px.zbuf[k][0]) zmin[k][0] = fminf(zmin[k][0], zz[k]);
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
              if (live[k] && mn >= 0.f && zs <= px.zbuf[k][s]) {
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
          for (int s = 0; s < NS; ++s) px.zbuf[k][s] = fminf(px.zbuf[k][s], zmin[k][s]);
        if (ANALYTIC) w.won_a[k] = fmaxf(w.won_a[k], covmax[k]);
        else px.bits[k] |= hit[k];
        if (best_j[k] >= 0 && best_z[k] <= w.gz[k] && best_z[k] < 2.f) {
          w.gz[k] = best_z[k];
          w.gidx[k] = base + g0 + best_j[k];
        }
      }
    }
  }

  // push the pass's fragments onto the two-layer stack; the winners' rows
  // in `rows` (LDG: device memory)
  template <bool LDG>
  __device__ __forceinline__ static void push(Layer (*stack)[NPIX], int tid, const float* rows,
                                              int p, float xs, const float* ys, float x0f,
                                              float y0f, Pixels& px, Pass& w) {
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      float cover = 0.f;
      for (int s = 0; s < NS; ++s)
        cover = cover + (ANALYTIC ? w.won_a[k] : (float)((px.bits[k] >> s) & 1));
      cover = cover * (float)(1.0 / NS);
      const bool hit = w.gz[k] < NO_HIT;
      const float code = hit ? row_at<LDG>(rows + (size_t)w.gidx[k] * ROW_W, C_ALPHA) : 0.f;
      push_ref(stack[0][tid + k * NTHREADS], stack[1][tid + k * NTHREADS], px.bits[k], hit,
               cover, code, w.gidx[k] * 8 + p, w.gz[k], p);
    }
  }
};

template <int NS, bool ANALYTIC, bool CROWD>
__global__ void __launch_bounds__(NTHREADS, 2) frame_kernel(FrameArgs a) {
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  run_tile<FrameWalk<NS, ANALYTIC>, CROWD>(*reinterpret_cast<TileSmem*>(smem_bytes), a.rows,
                                           a.rows_stride, a.starts, a.counts, a.out, a.sp);
}

template <int NS, bool ANALYTIC, bool CROWD>
void launch_as(const FrameArgs& a, dim3 grid, cudaStream_t stream) {
  // the attribute belongs to the current device's context: set it once per device
  static bool configured[MAX_DEVICES] = {};
  int device = 0;
  cudaGetDevice(&device);
  if (device >= MAX_DEVICES || !configured[device]) {
    cudaFuncSetAttribute(frame_kernel<NS, ANALYTIC, CROWD>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(TileSmem));
    if (device < MAX_DEVICES) configured[device] = true;
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
