// Toon/rim shade of one pixel of one stack layer: the CUDA form of
// reze_tpu_torch/kernels/shade_gpu.py::shade_layer (itself the port of
// reze_tpu/kernels/shade_tpu.py::_shade_layer). Inlined by the frame
// kernels after the last raster pass and by the stack shade.
//
// Every float operation mirrors the torch twin's order, and the file is
// compiled with -fmad=false, so products and sums round separately as in
// the twin. Division and sqrt are IEEE (no fast-math); 1/sqrt stands in
// for rsqrt on both sides. One exception keeps the bits: the toon ramp
// sums only the two knots whose hat weight can be nonzero (see the ramp).
#pragma once

#include <cuda_runtime.h>

namespace reze {

constexpr int N_KNOTS = 9;
// table sizes the kernels stage in shared memory (shade_gpu.check_shade_args)
constexpr int MAX_GROUPS = 16;
constexpr int MAX_TEX_COLS = 20;
constexpr int SHADE_SMEM_FLOATS =
    MAX_GROUPS * (3 * N_KNOTS + MAX_TEX_COLS + 3) + 12 + 12 + 8 + 16;

// layer-stack channels (per layer)
constexpr int L_UIW = 0, L_VIW = 1, L_NXIW = 2, L_NYIW = 3, L_NZIW = 4, L_IW = 5,
              L_Z = 6, L_AEFF = 7, L_OUT = 8, L_RAMP = 9, L_TEX = 10, L_EDGE = 11;
constexpr int L_CH = 12;

// shade outputs (per layer)
constexpr int O_LR = 0, O_LG = 1, O_LB = 2, O_RIM = 3, O_TEX = 4, O_DXDY = 5,
              O_FX = 6, O_FY = 7, O_AEFF = 8;
constexpr int O_CH = 9;

struct ShadeParams {
  const float* knot;  // (kr, 27)
  const float* tex;   // (kt, tex_cols) [h, w, base, valid, mip bases...]
  const float* edge;  // (ke, 3)
  const float* ldir;  // (4, 3)
  const float* lcol;  // (4, 3) colour * intensity, 0 for inactive lights
  const float* misc;  // [ambient, rim, eye xyz, atlas stride, lod bias 0, 1]
  const float* inv_vp;  // (4, 4)
  int kr, kt, tex_cols, ke, n_levels, hp, wp;
};

// Copy the shade tables into dst (SHADE_SMEM_FLOATS floats of shared
// memory), each of the block's nthreads threads a share; -> the same
// parameters reading from there. Visible after the caller's next
// __syncthreads.
__device__ __forceinline__ ShadeParams stage_shade_params(const ShadeParams& g, float* dst,
                                                          int tid, int nthreads) {
  ShadeParams s = g;
  float* d = dst;
  auto copy = [&](const float*& tab, int n) {
    for (int i = tid; i < n; i += nthreads) d[i] = tab[i];
    tab = d;
    d += n;
  };
  copy(s.knot, g.kr * 3 * N_KNOTS);
  copy(s.tex, g.kt * g.tex_cols);
  copy(s.edge, g.ke * 3);
  copy(s.ldir, 12);
  copy(s.lcol, 12);
  copy(s.misc, 8);
  copy(s.inv_vp, 16);
  return s;
}

// value of a tiny group table at an integral float id; ids outside the
// table give `init`
__device__ __forceinline__ float group_sel(float gid, const float* tab, int n, int cols,
                                           int col, float init) {
  if (!(gid >= 0.f) || !(gid < (float)n)) return init;
  return tab[(int)gid * cols + col];
}

// smaller-magnitude of the forward and backward difference
__device__ __forceinline__ float tile_fd(float a, float fwd, float bwd) {
  float f = fwd - a;
  float b = a - bwd;
  return fabsf(f) < fabsf(b) ? f : b;
}

// The texel index and bilinear footprint of texture group tex_gid at u, v
// (in-tile differences du_x.. for the mip level): res[O_DXDY], O_FX, O_FY;
// -> the texel index and whether the group is textured.
__device__ __forceinline__ float tex_footprint(float tex_gid, float u, float v, float du_x,
                                               float du_y, float dv_x, float dv_y, int layer,
                                               const ShadeParams& sp, float* res,
                                               float& tex_ok) {
  const float tex_h = group_sel(tex_gid, sp.tex, sp.kt, sp.tex_cols, 0, 1.f);
  const float tex_w = group_sel(tex_gid, sp.tex, sp.kt, sp.tex_cols, 1, 1.f);
  tex_ok = group_sel(tex_gid, sp.tex, sp.kt, sp.tex_cols, 3, 0.f);
  float wl, hl, base_l, stride;
  if (sp.n_levels > 0) {
    const float rho = fmaxf(fmaxf(fabsf(du_x), fabsf(du_y)) * tex_w,
                            fmaxf(fabsf(dv_x), fabsf(dv_y)) * tex_h);
    const float lod = log2f(fmaxf(rho, (float)1e-6)) + sp.misc[6 + layer];
    const float level = fminf(fmaxf(rintf(lod), 0.f), (float)(sp.n_levels - 1));
    const float scale = ldexpf(1.f, -(int)level);  // exact 2^-level
    wl = fmaxf(floorf(tex_w * scale), 1.f);
    hl = fmaxf(floorf(tex_h * scale), 1.f);
    base_l = group_sel(tex_gid, sp.tex, sp.kt, sp.tex_cols, 4 + (int)level, 0.f);
    stride = wl;
  } else {
    wl = tex_w;
    hl = tex_h;
    base_l = group_sel(tex_gid, sp.tex, sp.kt, sp.tex_cols, 2, 0.f);
    stride = sp.misc[5];
  }
  const float tu = (u - floorf(u)) * wl - 0.5f;
  const float tv = (v - floorf(v)) * hl - 0.5f;
  const float x0 = fminf(fmaxf(floorf(tu), 0.f), wl - 1.f);
  const float y0 = fminf(fmaxf(floorf(tv), 0.f), hl - 1.f);
  const float fx = fminf(fmaxf(tu - x0, 0.f), 1.f);
  const float fy = fminf(fmaxf(tv - y0, 0.f), 1.f);
  const float dx = (x0 + 1.f <= wl - 1.f) ? 1.f : 0.f;
  const float dy = (y0 + 1.f <= hl - 1.f) ? stride : 0.f;
  res[O_DXDY] = dx + 2.f * dy;
  res[O_FX] = fx;
  res[O_FY] = fy;
  return (base_l + y0 * stride) + x0;
}

// The toon ramp at unit normal (nx, ny, nz) of ramp group ramp_gid -> acc.
__device__ __forceinline__ void toon_ramp(float nx, float ny, float nz, float ramp_gid,
                                          const ShadeParams& sp, float* acc) {
  // toon ramp: 9-knot hat basis over four lights plus ambient. The twin
  // sums all nine knots in order from t = +0; a knot whose hat weight is 0
  // adds a signed zero, which leaves t's bits as they are (t is never -0),
  // so for finite knots the sum of the knots at floor(f) and floor(f) + 1
  // in that order has the same bits. An unknown group's knots are 0.
  const bool ramp_ok = ramp_gid >= 0.f && ramp_gid < (float)sp.kr;
  const float* knots = sp.knot + (ramp_ok ? (int)ramp_gid : 0) * (N_KNOTS * 3);
  const float ambient = sp.misc[0];
  acc[0] = acc[1] = acc[2] = ambient;
  for (int li = 0; li < 4; ++li) {
    const float* ld = sp.ldir + li * 3;
    const float ndotl = fmaxf(-((nx * ld[0] + ny * ld[1]) + nz * ld[2]), 0.f);
    const float f = ndotl * (float)(N_KNOTS - 1);  // >= 0
    float t[3] = {0.f, 0.f, 0.f};
    if (ramp_ok && f < (float)N_KNOTS) {
      const int s0 = (int)floorf(f);
      for (int s = s0; s <= s0 + 1 && s < N_KNOTS; ++s) {
        const float w_hat = fmaxf(1.f - fabsf(f - (float)s), 0.f);
        for (int c = 0; c < 3; ++c) t[c] = t[c] + knots[s * 3 + c] * w_hat;
      }
    }
    for (int c = 0; c < 3; ++c) acc[c] = acc[c] + t[c] * (sp.lcol[li * 3 + c] * ndotl);
  }
}

// stk: the pixel's L_CH stack values; u, v: its texture coordinates (the
// caller computed them and the in-tile differences du_x.. from neighbours);
// xs, ys: pixel centre in frame coordinates. Writes O_LR..O_FY to res.
__device__ __forceinline__ void shade_pixel(const float* stk, float u, float v, float inv_iw,
                                            float du_x, float du_y, float dv_x, float dv_y,
                                            float xs, float ys, int layer,
                                            const ShadeParams& sp, float* res) {
  const bool mat_present = stk[L_AEFF] > 0.f;
  float nx = stk[L_NXIW] * inv_iw;
  float ny = stk[L_NYIW] * inv_iw;
  float nz = stk[L_NZIW] * inv_iw;
  const float inv_len = 1.f / sqrtf(fmaxf((nx * nx + ny * ny) + nz * nz, (float)1e-16));
  nx = nx * inv_len;
  ny = ny * inv_len;
  nz = nz * inv_len;

  float tex_ok;
  const float texidx = tex_footprint(stk[L_TEX], u, v, du_x, du_y, dv_x, dv_y, layer, sp, res,
                                     tex_ok);
  float acc[3];
  toon_ramp(nx, ny, nz, stk[L_RAMP], sp, acc);

  // world position from depth, then rim = (1 - n.v)^2
  const float ndc_x = xs * (float)(2.0 / sp.wp) - 1.f;
  const float ndc_y = 1.f - ys * (float)(2.0 / sp.hp);
  const float z_ndc = stk[L_Z];
  float wpos[3];
  for (int r = 0; r < 3; ++r) {
    const float* m = sp.inv_vp + r * 4;
    wpos[r] = (((ndc_x * m[0] + ndc_y * m[1]) + z_ndc * m[2]) + m[3]) * inv_iw;
  }
  const float vx = sp.misc[2] - wpos[0];
  const float vy = sp.misc[3] - wpos[1];
  const float vz = sp.misc[4] - wpos[2];
  const float inv_vlen = 1.f / sqrtf(fmaxf((vx * vx + vy * vy) + vz * vz, (float)1e-16));
  const float ndotv = fmaxf(((nx * vx + ny * vy) + nz * vz) * inv_vlen, 0.f);
  const float rim_f = 1.f - ndotv;
  float rim = (rim_f * rim_f) * sp.misc[1];

  // outline fragments: flat edge colour, no albedo, no rim
  const bool outline = stk[L_OUT] > 0.5f;
  const float edge_gid = stk[L_EDGE];
  for (int c = 0; c < 3; ++c)
    res[O_LR + c] = outline ? group_sel(edge_gid, sp.edge, sp.ke, 3, c, 0.f) : acc[c];
  if (outline) rim = 0.f;
  const bool no_tex = outline || !mat_present || tex_ok <= 0.5f;
  res[O_RIM] = rim;
  res[O_TEX] = no_tex ? -1.f : texidx;
}

// What shade_pixel gives a pixel with no fragment (every stack value +0,
// so u = v = +0 and the unit normal +0): its colour is the toon ramp of
// that normal in ramp group 0 and its rim (1 - n.v)^2 * rim with n.v = 0
// (a product with the +0 normal, or NaN, which fmaxf drops), the same for
// every such pixel of a character: the caller computes them once with
// absent_colour. Only the footprint varies, through the mip level.
__device__ __forceinline__ void absent_colour(const ShadeParams& sp, float* acc) {
  toon_ramp(0.f, 0.f, 0.f, 0.f, sp, acc);
  const float rim_f = 1.f - 0.f;
  acc[3] = (rim_f * rim_f) * sp.misc[1];
}

__device__ __forceinline__ void shade_absent(const float* colour, float du_x, float du_y,
                                             float dv_x, float dv_y, int layer,
                                             const ShadeParams& sp, float* res) {
  float tex_ok;
  tex_footprint(0.f, 0.f, 0.f, du_x, du_y, dv_x, dv_y, layer, sp, res, tex_ok);
  for (int c = 0; c < 4; ++c) res[O_LR + c] = colour[c];
  res[O_TEX] = -1.f;
}

}  // namespace reze
