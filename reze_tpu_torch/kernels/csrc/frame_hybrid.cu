// Hybrid frame megakernel for sm_90a: the seven raster passes in 128-pair
// chunks with exact-z winners, the two-layer fragment stack and the
// toon/rim shade of one 8x128 tile per thread block, for one character or
// a crowd (grid (tiles, characters)).
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
// What bounds it on this card: as frame.cu, with few pairs per tile the
// fixed cost of a tile (the 18-plane store, 72 B per pixel), with many the
// per-pixel float work of the walk (per pixel and pair 4 planes of 2
// products and a sum, then per sample 4 sums and 6 tests).
//
// The design is frame.cu's (frame_common.cuh's tile design): 512 threads
// per tile, two pixels each; depths, coverage bits and stencil (coverage
// as one float in analytic mode), the chunk's minima and the pass winner
// as (z, row index) in registers; each stack layer as (row * 8 + pass,
// z, a_eff) in shared memory, its attributes and material code evaluated
// from the row at shade time in the twin's form; 85 KB of shared memory,
// two tiles per SM; a sparse tile's rows fetched in one go and kept in
// shared memory, a fuller tile's chunks bulk-copied into a two-stage ring;
// the shade's present pixels dealt first; a tile with no pair writes its
// fixed output and stops. HybridWalk below is this kernel's own part: each
// pair's normalised coefficients and its tile- and sample-folded constants
// formed once into a 128 B record, with each edge's largest sample
// constant (a pixel whose edge value a*x + b*y plus that constant is < 0
// fails the edge at every sample, as rounding is monotonic, and skips its
// sample tests); one depth test per chunk, not per 32-pair group; the
// exact-z winner and the analytic mode's centre-gated depth write.
//
// A crowd launch adds the character as blockIdx.y, as frame.cu's does:
// each character has its own pair rows (rows_stride floats apart, every
// block 16-byte aligned for the bulk copies), starts and counts, eye
// position (misc) and inverse view-projection, and writes its own output;
// the shade tables are shared. One character is the launch with one row of
// blocks, compiled without the per-character offsets (CROWD false).
//
// Compiled with -fmad=false: each product rounds on its own, as in the
// twin, so coverage and z-ties decide the same way.

#include <cuda_runtime.h>
#include <stdint.h>

#include "frame_common.cuh"

namespace reze {
namespace {

struct HybridArgs {
  const float* rows;  // per character (N, ROW_W), rows_stride floats apart
  size_t rows_stride;
  const int* starts;  // (C, 7, B)
  const int* counts;  // (C, 7, B)
  float* out;         // (C, 18, hp, wp)
  ShadeParams sp;     // misc (C, 8) and inv_vp (C, 4, 4) per character
};

__device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.f), 1.f); }

// The hybrid kernel's part of the tile design (frame_common.cuh): a pair's
// record, the walk of a chunk's records with one depth test, the push.
template <int NS, bool ANALYTIC>
struct HybridWalk {
  static constexpr int FORM = HYBRID_PLANES;
  struct Pixels {
    float zbuf[PPT][NS];
    int bits[PPT];  // coverage of the pass per sample, the stencil
  };
  struct Pass {
    float best[PPT], won_a[PPT];  // pass winner depth; analytic coverage
    int idx[PPT];                 // pass winner row
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
      w.best[k] = NO_HIT;
      w.idx[k] = -1;
      w.won_a[k] = 0.f;
      px.bits[k] &= STENCIL_BIT;
    }
  }

  // the record of the pair of row r (shared memory) in the tile at (x0f,
  // y0f): per plane a, b, c (normalised edges, the constant at the tile
  // origin) and an edge's largest sample constant; per sample the
  // constants c + (a*dx + b*dy)
  __device__ __forceinline__ static void prep(const float* r, float* d, float x0f, float y0f) {
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
      d[4 * e] = ae;
      d[4 * e + 1] = be;
      d[4 * e + 2] = ce;
      float cmax = 0.f;
      if (!ANALYTIC)
        for (int s = 0; s < NS; ++s) {
          const float cs = ce + (ae * SAMPLE_DX[s] + be * SAMPLE_DY[s]);
          d[PREP_OFF + s * 4 + e] = cs;
          cmax = s ? fmaxf(cmax, cs) : cs;
        }
      d[4 * e + 3] = cmax;
    }
  }

  // the walk of a chunk of n records of pass p, tested against the depths
  // as they stood before the chunk; a winner's row is base plus its record
  __device__ __forceinline__ static void walk(const float* prep, int n, int base, int p,
                                              float xs, const float* ys, Pixels& px, Pass& w) {
    const bool depth_write = PASS_CFG[p][1];
    float zmin[PPT][NS], covmax[PPT], bz[PPT];
    int hit[PPT], bl[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      for (int s = 0; s < NS; ++s) zmin[k][s] = NO_HIT;
      hit[k] = 0;
      covmax[k] = 0.f;
      bz[k] = NO_HIT;
      bl[k] = -1;
    }
    for (int j = 0; j < n; ++j) {
      const float4* q = reinterpret_cast<const float4*>(prep + j * PREP_W);
      float ab0[PPT], ab1[PPT], ab2[PPT], ab3[PPT], zc[PPT];
      bool any_pass[PPT], live[PPT], any_live = false;
      {
        const float4 P0 = q[0], P1 = q[1], P2 = q[2], P3 = q[3];
        const float ax0 = P0.x * xs, ax1 = P1.x * xs, ax2 = P2.x * xs, axz = P3.x * xs;
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          ab0[k] = ax0 + P0.y * ys[k];
          ab1[k] = ax1 + P1.y * ys[k];
          ab2[k] = ax2 + P2.y * ys[k];
          ab3[k] = axz + P3.y * ys[k];
          zc[k] = ab3[k] + P3.z;
          any_pass[k] = false;
          if (ANALYTIC) {
            const float se0 = ab0[k] + P0.z, se1 = ab1[k] + P1.z, se2 = ab2[k] + P2.z;
            const float cov = (clip01(se0 + 0.5f) * clip01(se1 + 0.5f)) * clip01(se2 + 0.5f);
            const bool zok = zc[k] <= px.zbuf[k][0] && zc[k] >= 0.f && zc[k] <= 1.f;
            any_pass[k] = cov > 0.f && zok;
            if (se0 >= 0.f && se1 >= 0.f && se2 >= 0.f && zok)
              zmin[k][0] = fminf(zmin[k][0], zc[k]);
            if (any_pass[k]) covmax[k] = fmaxf(covmax[k], cov);
          } else {
            // outside an edge at every sample: a*x + b*y + c_s <= a*x +
            // b*y + max_s c_s < 0 for each sample, as rounding is
            // monotonic
            live[k] = !(ab0[k] + P0.w < 0.f || ab1[k] + P1.w < 0.f || ab2[k] + P2.w < 0.f);
            any_live = any_live || live[k];
          }
        }
      }
      if (!ANALYTIC && any_live) {
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const float4 cs = q[PREP_OFF / 4 + s];
#pragma unroll
          for (int k = 0; k < PPT; ++k) {
            const float zs = ab3[k] + cs.w;
            if (live[k] && ab0[k] + cs.x >= 0.f && ab1[k] + cs.y >= 0.f
                && ab2[k] + cs.z >= 0.f && zs <= px.zbuf[k][s] && zs >= 0.f && zs <= 1.f) {
              zmin[k][s] = fminf(zmin[k][s], zs);
              hit[k] |= 1 << s;
              any_pass[k] = true;
            }
          }
        }
      }
      // winner: minimum centre z, the highest lane on a tie
#pragma unroll
      for (int k = 0; k < PPT; ++k)
        if (any_pass[k] && zc[k] <= bz[k]) {
          bz[k] = zc[k];
          bl[k] = j;
        }
    }
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      if (depth_write)
        for (int s = 0; s < NS; ++s) px.zbuf[k][s] = fminf(px.zbuf[k][s], zmin[k][s]);
      if (ANALYTIC) w.won_a[k] = fmaxf(w.won_a[k], covmax[k]);
      else px.bits[k] |= hit[k];
      if (bz[k] < NO_HIT && bz[k] <= w.best[k]) {  // a later chunk takes a tie
        w.best[k] = bz[k];
        w.idx[k] = base + bl[k];
      }
    }
  }

  // the winner's depth at the pixel centre, then the push; the winners'
  // rows in `rows` (LDG: device memory)
  template <bool LDG>
  __device__ __forceinline__ static void push(Layer (*stack)[NPIX], int tid, const float* rows,
                                              int p, float xs, const float* ys, float x0f,
                                              float y0f, Pixels& px, Pass& w) {
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      float cover;
      if (ANALYTIC) {
        cover = w.won_a[k];
      } else {
        cover = (float)(px.bits[k] & 1);
        for (int s = 1; s < NS; ++s) cover = cover + (float)((px.bits[k] >> s) & 1);
        cover = cover * (float)(1.0 / NS);
      }
      const bool hit = w.best[k] < NO_HIT;
      float z = 0.f, code = 0.f;
      if (hit) {
        const float* r = rows + (size_t)w.idx[k] * ROW_W;
        const float za = row_at<LDG>(r, C_Z), zb = row_at<LDG>(r, C_Z + 1);
        z = (za * xs + zb * ys[k]) + ((row_at<LDG>(r, C_Z + 2) + za * x0f) + zb * y0f);
        code = row_at<LDG>(r, C_ALPHA);
      }
      push_ref(stack[0][tid + k * NTHREADS], stack[1][tid + k * NTHREADS], px.bits[k], hit,
               cover, code, w.idx[k] * 8 + p, z, p);
    }
  }
};

template <int NS, bool ANALYTIC, bool CROWD>
__global__ void __launch_bounds__(NTHREADS, 2) hybrid_kernel(HybridArgs a) {
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  run_tile<HybridWalk<NS, ANALYTIC>, CROWD>(*reinterpret_cast<TileSmem*>(smem_bytes), a.rows,
                                           a.rows_stride, a.starts, a.counts, a.out, a.sp);
}

template <int NS, bool ANALYTIC, bool CROWD>
void launch_as(const HybridArgs& a, dim3 grid, cudaStream_t stream) {
  // the attribute belongs to the current device's context: set it once per device
  static bool configured[MAX_DEVICES] = {};
  int device = 0;
  cudaGetDevice(&device);
  if (device >= MAX_DEVICES || !configured[device]) {
    cudaFuncSetAttribute(hybrid_kernel<NS, ANALYTIC, CROWD>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(TileSmem));
    if (device < MAX_DEVICES) configured[device] = true;
  }
  hybrid_kernel<NS, ANALYTIC, CROWD><<<grid, NTHREADS, sizeof(TileSmem), stream>>>(a);
}

template <int NS, bool ANALYTIC>
void launch_hybrid(const HybridArgs& a, int n_tiles, int n_chars, cudaStream_t stream) {
  if (n_chars == 1)
    launch_as<NS, ANALYTIC, false>(a, dim3(n_tiles), stream);
  else
    launch_as<NS, ANALYTIC, true>(a, dim3(n_tiles, n_chars), stream);
}

}  // namespace
}  // namespace reze

// the arguments of frame.cu's reze_frame: n_chars characters, rows_stride
// floats between their pair rows (a multiple of 4); starts, counts, misc,
// inv_vp and out stacked per character
extern "C" int reze_frame_hybrid(const float* rows, long long rows_stride, const int* starts,
                                 const int* counts, const float* knot, int kr,
                                 const float* tex, int kt, int tex_cols, const float* edge,
                                 int ke, const float* ldir, const float* lcol,
                                 const float* misc, const float* inv_vp, float* out, int hp,
                                 int wp, int n_samples, int analytic, int n_levels, int n_chars,
                                 void* stream) {
  using namespace reze;
  HybridArgs a{rows, (size_t)rows_stride, starts, counts, out,
               ShadeParams{knot, tex, edge, ldir, lcol, misc, inv_vp, kr, kt, tex_cols, ke,
                           n_levels, hp, wp}};
  const int n_tiles = (hp / TILE_H) * (wp / TILE_W);
  cudaStream_t st = (cudaStream_t)stream;
  if (n_tiles <= 0 || n_chars <= 0 || n_chars > 65535 || rows_stride < 0 || (rows_stride & 3)
      || kr > MAX_GROUPS || kt > MAX_GROUPS || ke > MAX_GROUPS || tex_cols > MAX_TEX_COLS
      || ((uintptr_t)rows & 15) || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  if (analytic) {
    launch_hybrid<1, true>(a, n_tiles, n_chars, st);
  } else {
    switch (n_samples) {
      case 1: launch_hybrid<1, false>(a, n_tiles, n_chars, st); break;
      case 2: launch_hybrid<2, false>(a, n_tiles, n_chars, st); break;
      case 3: launch_hybrid<3, false>(a, n_tiles, n_chars, st); break;
      case 4: launch_hybrid<4, false>(a, n_tiles, n_chars, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
