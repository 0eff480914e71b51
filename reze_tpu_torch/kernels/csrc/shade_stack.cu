// Toon/rim shade of a planar two-layer fragment stack for sm_90a, one
// quarter (8 rows) of a 32x128 tile per thread block, for one character or
// a crowd (grid (quarter tiles, characters)).
//
// Replaces reze_tpu/kernels/shade_tpu.py::shade_stack_tpu (Pallas). The
// per-pixel math is shade.cuh::shade_pixel, the same code the frame kernel
// inlines; the plain torch twin is reze_tpu_torch/kernels/shade_gpu.py::
// shade_stack_twin. What differs from the frame kernel's shade: the tile
// is 32x128, so the mip LOD's finite differences wrap at 32-row tile edges;
// the empty-layer skip is per 32x128 tile; the stack comes from device
// memory, planar (24, hp, wp).
//
// What bounds it on this card: device memory. Each pixel writes 18 floats
// and reads a_eff of both layers, and the other 11 channels of a layer only
// in tiles where it is present (at most 168 B per pixel); the shade is ~400
// float operations per pixel and layer, under the card's float rate for
// that traffic. Present layers are few and clustered (on the main path, 150
// of 1,020 tile-layers at 1080p), so a design with one block per tile
// leaves their SMs to set the pace.
//
// The design: a block of 8 warps per quarter tile (4 blocks per tile, at
// least two resident per SM), so a present tile's work spreads over four
// SMs; each warp owns one 128-pixel row and each lane four adjacent pixels,
// so every channel is read once and every output written once with 16-byte
// accesses. The horizontal neighbours for the LOD come from the next and
// previous lane (a warp's row is the tile's width, so the shuffle wraps as
// the tile does); vertical ones from the block's rows in shared memory, and
// at the quarter's top and bottom rows from the tile's neighbouring row,
// recomputed from the stack with the same operations. A block decides a
// layer's skip from its own rows and reads the other three quarters' a_eff
// only when its own rows have no fragment. The shade tables are staged in
// shared memory once per block, when a layer is present.
//
// A crowd launch adds the character as blockIdx.y: each character has its
// own stack, output, eye position (misc) and inverse view-projection, at
// 64-bit offsets; the shade tables are shared. One character is the
// launch with one row of blocks, compiled without the per-character
// offsets (CROWD false).
//
// Compiled with -fmad=false (see shade.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "shade.cuh"

namespace reze {
namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int QUARTERS = 4;
constexpr int ROWS = TILE_H / QUARTERS;  // rows per block, one per warp
constexpr int NTHREADS = ROWS * 32;
constexpr int PX = TILE_W / 32;  // adjacent pixels per lane

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void st4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void split4(float4 c, float* v) {
  v[0] = c.x;
  v[1] = c.y;
  v[2] = c.z;
  v[3] = c.w;
}

// u and v of four pixels from their 1/w, u/w and v/w
__device__ __forceinline__ void uv_of(const float* iw, const float* uw, const float* vw,
                                      float* u, float* v, float* inv_iw) {
  for (int j = 0; j < PX; ++j) {
    inv_iw[j] = 1.f / fmaxf(iw[j], (float)1e-8);
    u[j] = uw[j] * inv_iw[j];
    v[j] = vw[j] * inv_iw[j];
  }
}

// the same at offset i of a layer's planes
__device__ __forceinline__ void load_uv(const float* stk_l, size_t plane, size_t i, float* u,
                                        float* v) {
  float iw[PX], uw[PX], vw[PX], inv_iw[PX];
  split4(ld4(stk_l + L_IW * plane + i), iw);
  split4(ld4(stk_l + L_UIW * plane + i), uw);
  split4(ld4(stk_l + L_VIW * plane + i), vw);
  uv_of(iw, uw, vw, u, v, inv_iw);
}

template <bool CROWD>
__global__ void __launch_bounds__(NTHREADS, 2) shade_stack_kernel(const float* stack, float* out,
                                                                 ShadeParams g) {
  // u, v of the block's rows (1..ROWS) and of the tile's rows above (0)
  // and below (ROWS + 1) them, wrapping at the tile edges
  __shared__ float su[ROWS + 2][TILE_W];
  __shared__ float sv[ROWS + 2][TILE_W];
  __shared__ float tabs[SHADE_SMEM_FLOATS];
  const int tid = threadIdx.x;
  const int w = tid / 32, lane = tid % 32;
  const int bx_n = g.wp / TILE_W;
  const int tile = blockIdx.x / QUARTERS, q = blockIdx.x % QUARTERS;
  const int ti = tile / bx_n, tj = tile % bx_n;
  const int ty = q * ROWS + w;  // row in the tile
  const int x0 = tj * TILE_W + PX * lane;
  const size_t plane = (size_t)g.hp * g.wp;
  if constexpr (CROWD) {  // this block's character
    const size_t c = blockIdx.y;
    stack += c * (2 * L_CH) * plane;
    out += c * (2 * O_CH) * plane;
    g.misc += c * 8;
    g.inv_vp += c * 16;
  }
  const size_t i = (size_t)(ti * TILE_H + ty) * g.wp + x0;
  const float yg = ((float)ty + (float)(ti * TILE_H)) + 0.5f;
  ShadeParams sp = g;
  bool staged = false;

  for (int layer = 0; layer < 2; ++layer) {
    const float* stk_l = stack + (size_t)layer * L_CH * plane;
    float* out_l = out + (size_t)layer * O_CH * plane;
    const float4 a4 = ld4(stk_l + L_AEFF * plane + i);
    const float aeff[PX] = {a4.x, a4.y, a4.z, a4.w};
    st4(out_l + O_AEFF * plane + i, aeff);
    bool any = a4.x > 0.f || a4.y > 0.f || a4.z > 0.f || a4.w > 0.f;
    // also: every thread is done with the previous layer's u, v
    int present = __syncthreads_or(any);
    if (!present) {  // the tile's other quarters
      for (int k = 1; k < QUARTERS; ++k) {
        const int r = ti * TILE_H + ((q + k) % QUARTERS) * ROWS + w;
        const float4 b4 = ld4(stk_l + L_AEFF * plane + (size_t)r * g.wp + x0);
        any = any || b4.x > 0.f || b4.y > 0.f || b4.z > 0.f || b4.w > 0.f;
      }
      present = __syncthreads_or(any);
    }
    if (!present) {
      for (int ch = 0; ch < O_AEFF; ++ch) {
        const float e = ch == O_TEX ? -1.f : 0.f;
        const float ev[PX] = {e, e, e, e};
        st4(out_l + ch * plane + i, ev);
      }
      continue;
    }
    if (!staged) {
      sp = stage_shade_params(g, tabs, tid, NTHREADS);
      staged = true;
    }

    float ch4[L_CH][PX];  // the layer's channels of the four pixels
    for (int ch = 0; ch < L_CH; ++ch)
      split4(ch == L_AEFF ? a4 : ld4(stk_l + ch * plane + i), ch4[ch]);
    float u[PX], v[PX], inv_iw[PX];
    uv_of(ch4[L_IW], ch4[L_UIW], ch4[L_VIW], u, v, inv_iw);
    for (int j = 0; j < PX; ++j) {
      su[w + 1][PX * lane + j] = u[j];
      sv[w + 1][PX * lane + j] = v[j];
    }
    if (sp.n_levels > 0 && (w == 0 || w == ROWS - 1)) {
      // the tile's row next to the quarter, recomputed from the stack
      const int side = w == 0 ? 0 : ROWS + 1;
      const int r = ti * TILE_H + (w == 0 ? ty + TILE_H - 1 : ty + 1) % TILE_H;
      float un[PX], vn[PX];
      load_uv(stk_l, plane, (size_t)r * g.wp + x0, un, vn);
      for (int j = 0; j < PX; ++j) {
        su[side][PX * lane + j] = un[j];
        sv[side][PX * lane + j] = vn[j];
      }
    }
    __syncthreads();  // the tables and this layer's u, v
    // in-tile differences along the row through the neighbouring lanes (the
    // warp's row is the tile's width, so the lanes wrap as the tile does)
    const float u_r = __shfl_sync(0xffffffffu, u[0], (lane + 1) % 32);
    const float v_r = __shfl_sync(0xffffffffu, v[0], (lane + 1) % 32);
    const float u_l = __shfl_sync(0xffffffffu, u[PX - 1], (lane + 31) % 32);
    const float v_l = __shfl_sync(0xffffffffu, v[PX - 1], (lane + 31) % 32);

    float res[O_AEFF][PX];
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      float du_x = 0.f, du_y = 0.f, dv_x = 0.f, dv_y = 0.f;
      if (sp.n_levels > 0) {
        const int c = PX * lane + j;
        du_x = tile_fd(u[j], j + 1 < PX ? u[j + 1] : u_r, j > 0 ? u[j - 1] : u_l);
        du_y = tile_fd(u[j], su[w + 2][c], su[w][c]);
        dv_x = tile_fd(v[j], j + 1 < PX ? v[j + 1] : v_r, j > 0 ? v[j - 1] : v_l);
        dv_y = tile_fd(v[j], sv[w + 2][c], sv[w][c]);
      }
      float stk[L_CH], r[O_AEFF];
      for (int ch = 0; ch < L_CH; ++ch) stk[ch] = ch4[ch][j];
      const float xg = (float)(x0 + j) + 0.5f;
      shade_pixel(stk, u[j], v[j], inv_iw[j], du_x, du_y, dv_x, dv_y, xg, yg, layer, sp, r);
      for (int ch = 0; ch < O_AEFF; ++ch) res[ch][j] = r[ch];
    }
    for (int ch = 0; ch < O_AEFF; ++ch) st4(out_l + ch * plane + i, res[ch]);
  }
}

}  // namespace
}  // namespace reze

extern "C" int reze_shade_stack(const float* stack, const float* knot, int kr, const float* tex,
                                int kt, int tex_cols, const float* edge, int ke,
                                const float* ldir, const float* lcol, const float* misc,
                                const float* inv_vp, float* out, int hp, int wp, int n_levels,
                                int n_chars, void* stream) {
  using namespace reze;
  ShadeParams sp{knot, tex, edge, ldir, lcol, misc, inv_vp, kr, kt, tex_cols, ke,
                 n_levels, hp, wp};
  const int n_tiles = (hp / TILE_H) * (wp / TILE_W);
  if (n_tiles <= 0 || n_chars <= 0 || n_chars > 65535 || kr > MAX_GROUPS || kt > MAX_GROUPS
      || ke > MAX_GROUPS || tex_cols > MAX_TEX_COLS || ((uintptr_t)stack & 15)
      || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  if (n_chars == 1)
    shade_stack_kernel<false><<<n_tiles * QUARTERS, NTHREADS, 0, (cudaStream_t)stream>>>(
        stack, out, sp);
  else
    shade_stack_kernel<true><<<dim3(n_tiles * QUARTERS, n_chars), NTHREADS, 0,
                               (cudaStream_t)stream>>>(stack, out, sp);
  return (int)cudaGetLastError();
}
