// One internal step's lanes on the device, shared by ext_step.cu (K1,
// inside its internal-step loop) and step_lanes.cu (K3, one launch per
// internal step of the per-step route).
//
// What the lanes read: the launch's Args (the raw record table, boundary
// cell rows, the params vector and the Threefry key pairs), the polygon
// tables (Settle), the curvilinear map (Curv) and the searched axes
// (Axes).  Here: the cell location off any staged tiles (locate), the
// raw records' corner path (record_lane), boundary reflection (reflect,
// in_water), the settlement ray cast (settle_id), the counter-based
// streams (particle_bits: ltjax.rng bit for bit) and the Visser fit
// (visser_dz), then step_lanes, the lanes themselves, templated on the
// corner source of their lane reads.  The including source defines its
// LTX_* macros first.

#pragma once

#include <stdint.h>

#include "find_currents.cuh"
#include "curv.cuh"

// params head (f32); must match ltjax_torch/kernels/ext_step.py
enum {
  P_X0 = 0, P_DX, P_Y0, P_DY,          // rho axes: origin, spacing
  P_BX0, P_BDX, P_BY0, P_BDY,          // boundary cell-edge axes
  P_BX1, P_BY1,                        // last cell edges (domain box)
  P_HC, P_Z0M, P_T0, P_IDT, P_SIGMA,
  P_HSCALE, P_VCONST,                  // turbulence scales
  P_SINK, P_DEADAGE,                   // type-6 sinking, death age
  P_SWIMSTART, P_SWIMDEN, P_SWIMSLOW, P_SWIMDIFF,   // swim ramp
  P_KP, P_THRESH, P_HSWIM, P_SWIMDEPTH,             // DVM, TST
  P_PEDIAGE, P_SGRAD,                  // settlement age, 4/5 cue
  P_ROW0, P_NYG,                       // LTX_TILE: the strip's first row,
                                       // the whole grid's rows
  P_PDIE,                              // step_lanes.cu: 1 - exp(-idt/deadage)
  P_HEAD = 32                          // then s_rho, Cs_r, s_w, Cs_w,
                                       // then 9 polintd weights per step,
                                       // then (type 3) E0 per step
};

enum { NOT_RELEASED = 0, ACTIVE = 1, SETTLED = 2, DEAD = 3,
       OUT_OF_DOMAIN = 4, ERROR = 5 };
enum { HTURB = 0, VTURB = 1, BEHAVE = 2, MORTALITY = 3,   // substreams
       DEATH = 4 };
enum { LAND = 0, OPEN = 1 };

// one set of padded polygons (ltjax_torch.physics.settlement.Polygons)
struct PolySet {
  const double* vx;       // (n, vmax) vertices, padded with the last one
  const double* vy;
  const int* nverts;      // (n,)
  const int* id;          // (n,) external polygon ids
  const int* cands;       // (C, cmax) candidate rows of each cell, -1 pad
  int n, vmax, cmax;
};

// the settlement tables, a kernel argument of their own: kept out of
// Args, whose size changes the register allocation of every variant
// (120 -> 96 registers for advection when they were in it)
struct Settle {
  const double* edge;               // cell-edge lattice x0, dx, y0, dy
  PolySet poly, hole;               // habitat polygons and holes
};

struct Args {
  const float* __restrict__ rtab;   // (3, C, nl) raw record lanes
  const pos_t* __restrict__ brows;  // (C, bl) boundary cell rows
  const float* __restrict__ par;    // head + ladders + weights
  const uint32_t* __restrict__ rngk;  // per-step derived key pairs
  int nx, ny, us, ws, nv, nl, vt, n_int, n_iter, open_exits, s_max, bl;
  int salt0;                        // first salt lane (temp follows)
  long long C;
#if LTX_POS64
  const double* __restrict__ dpar;  // par's layout in float64
#endif
};

// the params in the positions' type: par's layout, in float64 under
// LTX_POS64 (every head scalar, ladder and E0 that the plain version
// computes in the particles' dtype); par itself keeps the float32 ones
// (sigma of the float32 fits, the polintd weights)
__device__ __forceinline__ const pos_t* ppar(const Args& a) {
#if LTX_POS64
  return a.dpar;
#else
  return a.par;
#endif
}

// searched axes (LTX_AXES), a kernel argument of its own (Args's size
// sets every variant's register allocation): the rho axes where the grid
// is not uniform (null: arithmetic, grid.locate), the boundary cell edges
// where they are not (null: arithmetic, boundary.cell_of), in the
// positions' type, and the same edges in float64 for settlement
struct Axes {
  const pos_t* xr;
  const pos_t* yr;
  const pos_t* xe;
  const pos_t* ye;
  const double* sxe;
  const double* sye;
};

// the bilinear blend of four corner values (every corner source)
__device__ __forceinline__ float blend(const Stencil& s, float c00, float c01,
                                       float c10, float c11) {
  return (c00 * (1.0f - s.fx) + c01 * s.fx) * (1.0f - s.fy)
         + (c10 * (1.0f - s.fx) + c11 * s.fx) * s.fy;
}

// one record triple collapsed with the polintd weights l of a stage
// (the staged and the global path alike)
__device__ __forceinline__ float collapse(float v0, float v1, float v2,
                                          const float* l) {
  return fmaf(v2, l[2], fmaf(v1, l[1], v0 * l[0]));
}

// lane k of the raw records collapsed with the stage weights w (3 of a
// step's polintd weights) and blended at stencil s, from device memory
__device__ __forceinline__ float record_lane(const Args& a, const Stencil& s,
                                             const float* w, int k) {
  const long long R = a.C * a.nl;
  const float* t0 = a.rtab + k;
  const float* t1 = t0 + R;
  const float* t2 = t1 + R;
  const long long r01 = s.r00 + a.nl;
  const long long r10 = s.r00 + (long long)a.nx * a.nl;
  const long long r11 = r10 + a.nl;
  return blend(s, collapse(t0[s.r00], t1[s.r00], t2[s.r00], w),
               collapse(t0[r01], t1[r01], t2[r01], w),
               collapse(t0[r10], t1[r10], t2[r10], w),
               collapse(t0[r11], t1[r11], t2[r11], w));
}

// the cell (i, j) and stencil of (x, y), not staged: the inverse map on a
// curvilinear grid, a binary search on rho axes that are not uniform
// (LTX_AXES), else arithmetic
__device__ __forceinline__ Stencil locate(const Args& a, const Curv& cv,
                                          const Axes& ax, pos_t x, pos_t y,
                                          int& i, int& j) {
#if LTX_CURV
  return locate_curv(cv, a.nx, a.ny, a.nl, x, y, i, j);
#elif LTX_TILE
  // on the whole grid's axes (ax.yr is the whole grid's), into the strip
  const pos_t* par = ppar(a);
  const int ny_g = (int)par[P_NYG], row0 = (int)par[P_ROW0];
  // (located first: to_strip reads the i that the location writes)
#if LTX_AXES
  if (ax.xr) {
    const Stencil s = locate_searched(ax.xr, ax.yr, a.nx, ny_g, a.nl, x, y,
                                      i, j);
    return to_strip(s, a.nx, a.ny, a.nl, row0, i, j);
  }
#endif
  const Stencil s = locate_rect(par, a.nx, ny_g, a.nl, x, y, i, j);
  return to_strip(s, a.nx, a.ny, a.nl, row0, i, j);
#else
#if LTX_AXES
  if (ax.xr)
    return locate_searched(ax.xr, ax.yr, a.nx, a.ny, a.nl, x, y, i, j);
#endif
  return locate_rect(ppar(a), a.nx, a.ny, a.nl, x, y, i, j);
#endif
}

// the boundary cell row of (x, y): on a curvilinear grid boundary cell
// (j, i) spans the rho logical range [i - 0.5, i + 0.5]; the cell edges
// are searched where they are not uniform (LTX_AXES, boundary.cell_of)
__device__ __forceinline__ const pos_t* cell_row(const Args& a,
                                                 const Curv& cv,
                                                 const Axes& ax, pos_t x,
                                                 pos_t y) {
#if LTX_CURV
  pos_t ti, tj, r2;
  curv_logical<false>(cv, a.nx, a.ny, x, y, ti, tj, r2);
  const int i = (int)m_min(m_max(m_floor(ti + pos_t(0.5)), pos_t(0)),
                           (pos_t)(a.nx - 1));
  const int j = (int)m_min(m_max(m_floor(tj + pos_t(0.5)), pos_t(0)),
                           (pos_t)(a.ny - 1));
#else
  const pos_t* par = ppar(a);
  int i, j;
#if LTX_AXES
  if (ax.xe) {
    i = search_right(ax.xe, a.nx + 1, x) - 1;
#if LTX_TILE
    j = search_right(ax.ye, (int)par[P_NYG] + 1, y) - 1;
#else
    j = search_right(ax.ye, a.ny + 1, y) - 1;
#endif
  } else
#endif
  {
    i = (int)m_floor((x - par[P_BX0]) / par[P_BDX]);
    j = (int)m_floor((y - par[P_BY0]) / par[P_BDY]);
  }
  i = min(max(i, 0), a.nx - 1);
#if LTX_TILE
  // the whole grid's boundary cell (ax.ye its edges), into the strip
  j = min(max(min(max(j, 0), (int)par[P_NYG] - 1) - (int)par[P_ROW0], 0),
          a.ny - 1);
#else
  j = min(max(j, 0), a.ny - 1);
#endif
#endif
  return a.brows + ((long long)j * a.nx + i) * a.bl;
}

// inside the domain (the box; on a curvilinear grid the map's residual
// within tol) and in a water cell
__device__ __forceinline__ bool in_water(const Args& a, const Curv& cv,
                                         const Axes& ax, pos_t x, pos_t y) {
#if LTX_CURV
  pos_t ti, tj, r2;
  curv_logical<true>(cv, a.nx, a.ny, x, y, ti, tj, r2);
  const int i = (int)m_min(m_max(m_floor(ti + pos_t(0.5)), pos_t(0)),
                           (pos_t)(a.nx - 1));
  const int j = (int)m_min(m_max(m_floor(tj + pos_t(0.5)), pos_t(0)),
                           (pos_t)(a.ny - 1));
  return r2 <= cv.tol2
         && a.brows[((long long)j * a.nx + i) * a.bl] > pos_t(0.5);
#else
  const pos_t* par = ppar(a);
  bool inside = (x >= par[P_BX0]) && (x <= par[P_BX1])
                && (y >= par[P_BY0]) && (y <= par[P_BY1]);
  return inside && cell_row(a, cv, ax, x, y)[0] > pos_t(0.5);
#endif
}

// boundary.reflect for one particle: (x0, y0) -> (x1, y1) becomes the
// reflected endpoint; returns exited/stuck and the land-hit count.  On a
// curvilinear grid a pass skips the segment that the previous pass
// reflected from, as the plain version does: the f32 restart point lies
// on either side of a slanted wall, and re-crossing it at tp ~ 0 would
// reflect the particle into land.
__device__ void reflect(const Args& a, const Curv& cv, const Axes& axs,
                        pos_t x0, pos_t y0, pos_t& x1, pos_t& y1,
                        bool& exited, bool& stuck, int& hits) {
  const pos_t eps = pos_t(1e-6);
  const pos_t tiny = pos_t(1e-30);
  pos_t px0 = x0, py0 = y0, px1 = x1, py1 = y1;
  pos_t ms2x = pos_t(0), ms2y = pos_t(0);
  exited = false;
  hits = 0;
#if LTX_CURV
  pos_t lax = NAN, lay = NAN, lbx = NAN, lby = NAN;   // last reflected from
  pos_t sax = pos_t(0), say = pos_t(0), sbx = pos_t(0), sby = pos_t(0);
#endif
  for (int it = 0; it < a.n_iter; ++it) {
    const pos_t* row = cell_row(a, cv, axs, px0, py0);
    if (it == 0) { ms2x = row[3]; ms2y = row[4]; }
    pos_t dx = px1 - px0, dy = py1 - py0;
    pos_t tpm = INFINITY, exf = pos_t(0), eyf = pos_t(0), kindf = pos_t(0);
    bool any = false;
    for (int s = 0; s < a.s_max; ++s) {
      const pos_t* sl = row + 8 + 8 * s;
      if (!(sl[5] > pos_t(0.5))) continue;
#if LTX_CURV
      if (sl[0] == lax && sl[1] == lay && sl[2] == lbx && sl[3] == lby)
        continue;
#endif
      pos_t ax = sl[0], ay = sl[1];
      pos_t ex = sl[2] - ax, ey = sl[3] - ay;
      pos_t apx = ax - px0, apy = ay - py0;
      pos_t denom = dx * ey - dy * ex;
      pos_t dsafe = m_abs(denom) < tiny ? tiny : denom;
      pos_t tp = (apx * ey - apy * ex) / dsafe;
      pos_t ts = (apx * dy - apy * dx) / dsafe;
      bool cross = m_abs(denom) > tiny && tp > pos_t(0) && tp <= pos_t(1)
                   && ts >= pos_t(0) && ts <= pos_t(1);
      if (cross && tp < tpm) {          // first minimum wins (argmin)
        tpm = tp; exf = ex; eyf = ey; kindf = sl[4]; any = true;
#if LTX_CURV
        sax = sl[0]; say = sl[1]; sbx = sl[2]; sby = sl[3];
#endif
      }
    }
    bool act = any && !exited;
    if (!act) continue;
    pos_t ix = px0 + tpm * (px1 - px0);
    pos_t iy = py0 + tpm * (py1 - py0);
    pos_t rx = px1 - ix, ry = py1 - iy;
    pos_t elen2 = m_max(exf * exf + eyf * eyf, tiny);
    pos_t proj = (rx * exf + ry * eyf) / elen2;
    pos_t rrx = pos_t(2) * proj * exf - rx;
    pos_t rry = pos_t(2) * proj * eyf - ry;
    int kind = (int)kindf;
    bool newly_exited = a.open_exits && kind == OPEN;
    bool do_reflect = a.open_exits ? kind == LAND : true;
    if (do_reflect) {
      pos_t nrm = m_sqrt(m_max(rrx * rrx + rry * rry, tiny));
      px0 = ix + eps * rrx / nrm;
      py0 = iy + eps * rry / nrm;
      px1 = ix + rrx;
      py1 = iy + rry;
      if (kind == LAND) hits += 1;
#if LTX_CURV
      lax = sax; lay = say; lbx = sbx; lby = sby;
#endif
    }
    if (newly_exited) { px1 = ix; py1 = iy; exited = true; }
  }
  stuck = !exited && !in_water(a, cv, axs, px1, py1);
  // tunnel guard on the straight path of non-interacting particles
  if (hits == 0 && !exited && !stuck
      && !in_water(a, cv, axs, pos_t(0.5) * (x0 + px1),
                   pos_t(0.5) * (y0 + py1)))
    stuck = true;
  // displacement guard: per-axis reach of the pre-move cell's bucket
  pos_t ddx = x1 - x0, ddy = y1 - y0;
  if (!exited && (ddx * ddx > ms2x || ddy * ddy > ms2y)) stuck = true;
  x1 = px1;
  y1 = py1;
}

// ---- settlement (ltjax.physics.settlement.test_settlement) ------------

// ray casting of polygon k of set s at (px, py): edges i -> i+1 and the
// closing edge nverts-1 -> 0 (the padded roll of point_in_polygon; its
// padding edges are degenerate and cross nothing)
__device__ bool in_polygon(const PolySet& s, int k, double px, double py) {
  const double* vx = s.vx + (long long)k * s.vmax;
  const double* vy = s.vy + (long long)k * s.vmax;
  const int n = s.nverts[k];
  bool odd = false;
  for (int i = 0; i < n; ++i) {
    const int j = i + 1 == n ? 0 : i + 1;
    const double x1 = vx[i], y1 = vy[i], x2 = vx[j], y2 = vy[j];
    if ((y1 > py) != (y2 > py)) {
      const double xc = x1 + (py - y1) * (x2 - x1) / (y2 - y1);
      if (px < xc) odd = !odd;
    }
  }
  return odd;
}

// id of the first candidate habitat polygon of the point's cell that
// contains it, unless a candidate hole does; -1 otherwise.  The cell is
// searched on the f64 edges where they are not uniform (LTX_AXES).
#if LTX_TILE
// (on a tile: the whole grid's cell of ny_b rows, then row0 rows into the
// strip's candidate rows)
__device__ int settle_id(const Settle& sg, const Axes& ax, int nx, int ny,
                         pos_t x, pos_t y, int ny_b, int row0) {
#else
__device__ int settle_id(const Settle& sg, const Axes& ax, int nx, int ny,
                         pos_t x, pos_t y) {
  const int ny_b = ny;
#endif
  const double px = (double)x, py = (double)y;
  int i, j;
#if LTX_AXES
  if (ax.sxe) {
    i = min(max(search_right(ax.sxe, nx + 1, px) - 1, 0), nx - 1);
    j = min(max(search_right(ax.sye, ny_b + 1, py) - 1, 0), ny_b - 1);
  } else
#endif
  {
    i = (int)fmin(fmax(floor((px - sg.edge[0]) / sg.edge[1]), 0.0),
                  (double)(nx - 1));
    j = (int)fmin(fmax(floor((py - sg.edge[2]) / sg.edge[3]), 0.0),
                  (double)(ny_b - 1));
  }
#if LTX_TILE
  j = min(max(j - row0, 0), ny - 1);      // into the strip's rows
#endif
  const long long cell = (long long)j * nx + i;
  int id = -1;
  const int* c = sg.poly.cands + cell * sg.poly.cmax;
  for (int m = 0; m < sg.poly.cmax && id < 0; ++m)
    if (c[m] >= 0 && in_polygon(sg.poly, c[m], px, py))
      id = sg.poly.id[c[m]];
  if (id < 0 || sg.hole.n == 0) return id;
  const int* h = sg.hole.cands + cell * sg.hole.cmax;
  for (int m = 0; m < sg.hole.cmax; ++m)
    if (h[m] >= 0 && in_polygon(sg.hole, h[m], px, py)) return -1;
  return id;
}

// ---- counter-based random streams (ltjax.rng, bit for bit) -----------

__device__ __forceinline__ uint32_t rotl32(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

// Threefry-2x32, 20 rounds: (x0, x1) <- block of key (k0, k1)
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const int ROT[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int block = 0; block < 5; ++block) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl32(x1, ROT[(block % 2) * 4 + r]);
      x1 ^= x0;
    }
    x0 += ks[(block + 1) % 3];
    x1 += ks[(block + 2) % 3] + (uint32_t)(block + 1);
  }
}

// the two words of particle pid under substream sub of internal step i
__device__ __forceinline__ void particle_bits(const Args& a, int stride,
                                              int i, int sub, uint32_t pid,
                                              uint32_t& b0, uint32_t& b1) {
  const uint32_t* k = a.rngk + stride * i + 2 * sub;
  b0 = pid;
  b1 = 0u;
  threefry2x32(k[0], k[1], b0, b1);
}

// word -> (0, 1): the top 24 bits, offset half an ulp from 0, in the
// positions' type (rng.bits_to_uniform in the particles' dtype)
__device__ __forceinline__ pos_t bits_to_uniform(uint32_t b) {
  return (pos_t)(int)(b >> 8) * pos_t(5.9604644775390625e-08)
         + pos_t(2.98023223876953125e-08);
}

// ---- Visser random displacement on the Aks profile ---------------------

// spline value (deriv = false) or derivative at zq of the fitted Aks
// column: knots zk, second derivatives z2, values re-read from the lanes;
// in the positions' type (physics.turb.vturb fits in the particles'
// dtype)
template <class Rec>
__device__ pos_t aks_eval(const Rec& r, const TensionT<pos_t>& T,
                          const Stencil& st, const pos_t* zk,
                          const pos_t* z2, int K, pos_t zq, bool deriv) {
  zq = m_min(m_max(zq, zk[0]), zk[K - 1]);
  int j = 0;
  for (int k = 1; k < K; ++k) j += zq >= zk[k] ? 1 : 0;
  j = min(j, K - 2);
  pos_t x0 = zk[j], x1 = zk[j + 1];
  pos_t y0 = m_max((pos_t)r.lane(st, r.nv() + j), pos_t(0));
  pos_t y1 = m_max((pos_t)r.lane(st, r.nv() + j + 1), pos_t(0));
  pos_t h = x1 - x0;
  pos_t B2 = (zq - x0) / h;
  pos_t B1 = pos_t(1) - B2;
  if (deriv)
    return (y1 - y0) / h + h * (z2[j] * ds_fn(T, B1) - z2[j + 1] * ds_fn(T, B2));
  return y0 * B1 + y1 * B2 + h * h * (z2[j] * gs_fn(T, B1)
                                      + z2[j + 1] * gs_fn(T, B2));
}

// dz = K'(z) idt + R sqrt(2 K(z_mid) idt / (1/3)) on the Aks lanes (after
// the nv value lanes) blended at stencil st of the
// corner source r (stage 1);
// physics.turb.vturb: Aks clipped at >= 0 before a natural tension fit
// on the w ladder, z_mid = clip(z + K' idt / 2) to the knot range.
template <class Rec>
__device__ pos_t visser_dz(const Rec& r, const Args& a, pos_t sigma,
                           const Stencil& st, pos_t zeta, pos_t h, pos_t z,
                           pos_t R, pos_t idt, pos_t* cp, pos_t* z2,
                           pos_t* zk) {
  TensionT<pos_t> T;         // tension.evaluate: series at sigma = 0
  T.sigma = sigma;
  T.small = POS_SMALL;
  T.cubic = false;
  const pos_t* par = ppar(a);
  const pos_t* s_w = par + P_HEAD + 2 * a.us;
  const pos_t* cs_w = s_w + a.ws;
  const int K = a.ws;
  pos_t zprev = knot_depth(par[P_HC], a.vt, s_w[0], cs_w[0], zeta, h);
  pos_t yprev = m_max((pos_t)r.lane(st, a.nv), pos_t(0));
  zk[0] = zprev;
  cp[0] = pos_t(0);
  z2[0] = pos_t(0);
  pos_t offp = pos_t(0), diap = pos_t(0), dyp = pos_t(0);
  for (int k = 1; k < K; ++k) {           // Thomas forward sweep
    pos_t zc = knot_depth(par[P_HC], a.vt, s_w[k], cs_w[k], zeta, h);
    pos_t yk = m_max((pos_t)r.lane(st, a.nv + k), pos_t(0));
    pos_t hk = zc - zprev;
    pos_t dy = (yk - yprev) / hk;
    pos_t offc, diac;
    coefs(T, hk, offc, diac);
    if (k >= 2) {
      int i = k - 1;
      pos_t denom = (diap + diac) - offp * cp[i - 1];
      cp[i] = offc / denom;
      z2[i] = ((dy - dyp) - offp * z2[i - 1]) / denom;
    }
    zk[k] = zc;
    zprev = zc; yprev = yk;
    offp = offc; diap = diac; dyp = dy;
  }
  pos_t x = pos_t(0);                     // natural end: z2[K-1] = 0
  z2[K - 1] = pos_t(0);
  for (int i = K - 2; i >= 0; --i) {
    x = z2[i] - cp[i] * x;
    z2[i] = x;
  }
  pos_t kprime = aks_eval(r, T, st, zk, z2, K, z, true);
  pos_t zmid = m_min(m_max(z + pos_t(0.5) * kprime * idt, zk[0]), zk[K - 1]);
  pos_t kmid = m_max(aks_eval(r, T, st, zk, z2, K, zmid, false),
                     pos_t(0));
  return kprime * idt
         + R * m_sqrt(pos_t(2) * kmid * idt / (pos_t(1) / pos_t(3)));
}

// ---- one internal step's lanes -----------------------------------------
//
// The lanes after the RK4 displacement (dx, dy, dz) of one ACTIVE
// particle at (x, y, z): horizontal random walk and Visser vertical
// displacement (HT, VT), behavior BEH on the free surface and depth at
// its stage-1 position (stage-1 currents u1, v1 for type 7), horizontal
// reflection with exits, vertical reflection about zeta/h of the new
// column at t + idt, the status updates (exit, ERROR, death: MORT 0 none,
// 1 at deadage, 2 on the DEATH draw), settlement (SETTLE) and salt/temp
// at the new position (SALT).  The random words are those of internal
// step i of the key vector (stride words a step); age_pre is the age at
// the step's start.  ``Src`` is the corner source of every lane read:
//
//   Stencil at(pos_t x, pos_t y)          the stencil of (x, y)
//   float lane(const Stencil& s, int q, int k)  lane k at stage time q
//       (0: t, 1: t + idt/2, 2: t + idt) blended at s
//   Rec rec(int q)                        find_currents.cuh's corner
//       source of stage q (fit_eval, visser_dz)
//
// ext_step.cu's is the block's staged tiles with the raw records behind
// them, step_lanes.cu's the raw records in device memory.
template <int HT, int VT, int BEH, int MORT, int SETTLE, int SALT, class Src>
__device__ __forceinline__ void step_lanes(
    const Src& c, const Args& a, const Settle& sg, const Curv& cv,
    const Axes& ax, const TensionT<pos_t>& Ts, pos_t* cq, pos_t* dq0,
    pos_t* dq1, int stride, int i, uint32_t pid, pos_t age_pre, pos_t u1,
    pos_t v1, pos_t dx, pos_t dy, pos_t dz, pos_t& x, pos_t& y, pos_t& z,
    int& st, int& spoly, pos_t& salt, pos_t& temp, int& hitl, int& hitb) {
  constexpr bool SWIM = BEH >= 1 && BEH <= 5;
  const pos_t* par = ppar(a);
  const pos_t idt = par[P_IDT];
  const pos_t* pcoef = par + P_HEAD + 2 * (a.us + a.ws);
  // --- turbulence ------------------------------------------------------
  if constexpr (HT) {
    uint32_t b0, b1;
    particle_bits(a, stride, i, HTURB, pid, b0, b1);
    pos_t r = m_sqrt(pos_t(-2) * m_log(bits_to_uniform(b0)));
    pos_t th = (pos_t)(2.0 * 3.14159265358979) * bits_to_uniform(b1);
    dx = dx + r * m_cos(th) * par[P_HSCALE];
    dy = dy + r * m_sin(th) * par[P_HSCALE];
  }
  if constexpr (VT != 0) {
    uint32_t b0, b1;
    particle_bits(a, stride, i, VTURB, pid, b0, b1);
    pos_t R = pos_t(-1) + pos_t(2) * bits_to_uniform(b0);
    if constexpr (VT == 1) {
      dz = dz + R * par[P_VCONST];
    } else {
      // Aks blended at the stage-1 position and time
      Stencil sv = c.at(x, y);
      pos_t zeta1 = (pos_t)c.lane(sv, 0, a.nv - 2);
      pos_t h1 = (pos_t)c.lane(sv, 0, a.nv - 1);
      dz = dz + visser_dz(c.rec(0), a, Ts.sigma, sv, zeta1, h1, z, R, idt, cq,
                          dq0, dq1);
    }
  }

  // --- behavior (free surface and depth at stage 1) -----------------------
  if constexpr (BEH != 0) {
    pos_t bx = pos_t(0), by = pos_t(0), bz = pos_t(0);
    Stencil sb = c.at(x, y);
    pos_t zeta_b = (pos_t)c.lane(sb, 0, a.nv - 2);
    pos_t h_b = (pos_t)c.lane(sb, 0, a.nv - 1);
    // ontogenetic swim speed at the pre-step age
    pos_t frac = m_min(m_max((age_pre - par[P_SWIMSTART]) / par[P_SWIMDEN],
                             pos_t(0)), pos_t(1));
    pos_t wsw = par[P_SWIMSLOW] + par[P_SWIMDIFF] * frac;
    wsw = age_pre >= par[P_SWIMSTART] ? wsw : pos_t(0);
    if constexpr (SWIM) {
      uint32_t b0, b1;
      particle_bits(a, stride, i, BEHAVE, pid, b0, b1);
      pos_t r_dir = bits_to_uniform(b0);
      particle_bits(a, stride, i, MORTALITY, pid, b0, b1);
      pos_t r_mix = pos_t(-1) + pos_t(2) * bits_to_uniform(b0);
      pos_t rnd = r_mix * wsw * idt;
      pos_t toward = BEH == 2 ? pos_t(-1) : pos_t(1);   // biased walk
      pos_t biased = (r_dir < pos_t(0.8) ? toward : -toward) * wsw * idt;
      if constexpr (BEH == 1) {
        bz = z < (zeta_b - pos_t(2)) ? biased : rnd;   // SURFACE_ZONE
      } else if constexpr (BEH == 2) {
        bz = z > (-h_b + pos_t(2)) ? biased : rnd;     // BOTTOM_ZONE
      } else if constexpr (BEH == 3) {
        pos_t e0 = pcoef[9 * a.n_int + i];
        pos_t light = e0 * m_exp(-par[P_KP] * m_max(zeta_b - z, pos_t(0)));
        bz = light > par[P_THRESH] ? -wsw * idt
             : (e0 > pos_t(0) ? wsw * idt : rnd);
      } else {
        // halocline cue: dS/dz of the salt spline at the pre-step
        // position and time (stage-1 stencil, weights and knots)
        pos_t dsdz, unused, zf;
        fit_eval<true>(c.rec(0), Ts, sb, par + P_HEAD,
                       par + P_HEAD + a.us, a.us, a.salt0, -1, zeta_b, h_b,
                       z, cq, dq0, dq1, dsdz, unused, zf);
        bool cue = m_abs(dsdz) >= par[P_SGRAD];
        bool young = age_pre < par[P_PEDIAGE];
        pos_t down = -biased;                          // toward the bottom
        if constexpr (BEH == 4)
          bz = young ? (cue ? biased : rnd) : down;
        else
          bz = young ? (cue ? biased : biased * pos_t(0.5)
                                           + rnd * pos_t(0.5))
                     : down;
      }
    } else if constexpr (BEH == 6) {
      bz = -par[P_SINK] * idt * pos_t(1);
    } else if constexpr (BEH == 7) {
      // tidal-stream transport on the stage-1 currents
      pos_t speed = m_sqrt(u1 * u1 + v1 * v1);
      bool riding = speed > pos_t(0.05);             // TST_MIN_SPEED
      pos_t target = riding ? zeta_b - par[P_SWIMDEPTH] : -h_b + pos_t(0.5);
      bz = m_min(m_max(target - z, -wsw * idt - pos_t(1)),
                 wsw * idt + pos_t(1));
      pos_t spd = m_max(speed, pos_t(1e-12));
      bx = riding ? par[P_HSWIM] * u1 / spd * idt : pos_t(0);
      by = riding ? par[P_HSWIM] * v1 / spd * idt : pos_t(0);
    }
    dx = dx + bx;
    dy = dy + by;
    dz = dz + bz;
  }
  pos_t x1 = x + dx;
  pos_t y1 = y + dy;
  pos_t z1 = z + dz;

  bool exited, stuck;
  int hits;
  reflect(a, cv, ax, x, y, x1, y1, exited, stuck, hits);

  // vertical reflection about zeta/h of the new column at t + idt
  Stencil s4 = c.at(x1, y1);
  pos_t zeta = (pos_t)c.lane(s4, 2, a.nv - 2);
  pos_t h = (pos_t)c.lane(s4, 2, a.nv - 1);
  bool above = z1 > zeta;
  pos_t za = above ? pos_t(2) * zeta - z1 : z1;
  bool below = za < -h;
  pos_t zb = below ? pos_t(-2) * h - za : za;

  x = x1;
  y = y1;
  z = m_min(m_max(zb, -h), zeta);
  hitl += hits;
  hitb += below ? 1 : 0;
  if (exited) st = OUT_OF_DOMAIN;
  if (stuck) st = ERROR;
  // death at the pre-step age: overrides a same-step ERROR, not an exit
  // (step.internal_step's order); MORT 1 at deadage, MORT 2 on the DEATH
  // draw (u < P_PDIE from age 0, behavior.behave's constant hazard)
  if constexpr (MORT == 1) {
    if (age_pre >= par[P_DEADAGE] && !exited) st = DEAD;
  } else if constexpr (MORT == 2) {
    uint32_t b0, b1;
    particle_bits(a, stride, i, DEATH, pid, b0, b1);
    if (age_pre >= pos_t(0) && bits_to_uniform(b0) < par[P_PDIE] && !exited)
      st = DEAD;
  }
  // settlement at the reflected position: a particle still ACTIVE
  // after the exit, error and death updates, old enough at the
  // pre-step age + idt; the polygon id is kept from the first time
  if constexpr (SETTLE) {
    if (st == ACTIVE && sg.poly.n > 0
        && age_pre + idt >= par[P_PEDIAGE]) {
#if LTX_TILE
      int id = settle_id(sg, ax, a.nx, a.ny, x, y, (int)ppar(a)[P_NYG],
                         (int)ppar(a)[P_ROW0]);
#else
      int id = settle_id(sg, ax, a.nx, a.ny, x, y);
#endif
      if (id >= 0) {
        st = SETTLED;
        if (spoly < 0) spoly = id;
      }
    }
  }
  // SaltTempOn: salt and temp at the new position at t + idt, for every
  // particle active at the step's start (those that exited, died or
  // settled in it included): stage-4 weights, the stencil and knots of
  // the vertical reflection
  if constexpr (SALT) {
    pos_t zf;
    fit_eval(c.rec(2), Ts, s4, par + P_HEAD,
             par + P_HEAD + a.us, a.us, a.salt0, a.salt0 + a.us, zeta, h,
             z, cq, dq0, dq1, salt, temp, zf);
  }
}

// ---- host: a launch's tables from its C entry's arguments ---------------

// whether the tables do not fit the variant: levels above MAX_LEVELS, lane
// offsets other than the record table's layout (nv value lanes, then ws
// Aks lanes from aks0 = nv, then us salt and us temp lanes from salt0; -1
// without them), a lane the variant reads missing (Aks for LTX_VTURB 2,
// salt for SaltTempOn and behaviors 4/5), polygons without their tables,
// a curvilinear map given to a build without LTX_CURV or the reverse,
// float64 params given to a build without LTX_POS64 or the reverse,
// searched axes given to a build without LTX_AXES, or half of a pair
static inline bool bad_tables(int us, int ws, int nl, int aks0, int salt0,
                              int n_poly, const double* settle_d,
                              const int* settle_i, const pos_t* curv_xy,
                              const int* curv_seed, int curv_mx,
                              int curv_my, const double* dparams,
                              const pos_t* axis_x, const pos_t* axis_y,
                              const pos_t* edge_x, const pos_t* edge_y,
                              const double* settle_ex,
                              const double* settle_ey) {
  if (us > MAX_LEVELS || ws > MAX_LEVELS) return true;
  const int nv = 2 * us + ws + 2;
  const int after_aks = aks0 >= 0 ? nv + ws : nv;
  return (aks0 != -1 && aks0 != nv) || (salt0 != -1 && salt0 != after_aks)
         || nl != (salt0 >= 0 ? salt0 + 2 * us : after_aks)
         || (LTX_VTURB == 2 && aks0 < 0)
         || ((LTX_SALT || LTX_BEHAVIOR == 4 || LTX_BEHAVIOR == 5)
             && salt0 < 0)
         || (LTX_SETTLE && n_poly > 0 && (!settle_d || !settle_i))
         || (LTX_CURV != 0) != (curv_xy != nullptr)
         || (LTX_CURV && (!curv_seed || curv_mx < 1 || curv_my < 1))
         || (LTX_POS64 != 0) != (dparams != nullptr)
         || (!LTX_AXES && (axis_x || axis_y || edge_x || edge_y || settle_ex
                           || settle_ey))
         || (!axis_x) != (!axis_y) || (!edge_x) != (!edge_y)
         || (!settle_ex) != (!settle_ey);
}

static inline Args make_args(const float* rtab, const pos_t* brows,
                             const float* params, const double* dparams,
                             const uint32_t* rngk, int nx, int ny, int us,
                             int ws, int nl, int salt0, int vtransform,
                             int n_int, int n_iter, int open_exits,
                             int s_max) {
  Args a;
  a.rtab = rtab;
  a.brows = brows;
  a.par = params;
#if LTX_POS64
  a.dpar = dparams;
#else
  (void)dparams;
#endif
  a.rngk = rngk;
  a.nx = nx;
  a.ny = ny;
  a.us = us;
  a.ws = ws;
  a.nv = 2 * us + ws + 2;
  a.nl = nl;
  a.salt0 = salt0;
  a.vt = vtransform;
  a.n_int = n_int;
  a.n_iter = n_iter;
  a.open_exits = open_exits;
  a.s_max = s_max;
  a.bl = 8 + 8 * s_max;
  a.C = (long long)nx * ny;
  return a;
}

// the polygon tables: sub-arrays of settle_d (the cell-edge lattice, then
// the f64 vertices, x then y, of the polygons and then of the holes) and
// settle_i (vertex counts, ids and per-cell candidate rows, polygons
// first) on C cells
static inline Settle make_settle(const double* settle_d, const int* settle_i,
                                 int n_poly, int vmax_poly, int cmax_poly,
                                 int n_hole, int vmax_hole, int cmax_hole,
                                 long long C) {
  Settle sg;
  sg.edge = settle_d;
  const long long pv = (long long)n_poly * vmax_poly;
  const long long hv = (long long)n_hole * vmax_hole;
  sg.poly = {settle_d ? settle_d + 4 : nullptr,
             settle_d ? settle_d + 4 + pv : nullptr,
             settle_i, settle_i ? settle_i + n_poly : nullptr,
             settle_i ? settle_i + 2 * n_poly : nullptr,
             n_poly, vmax_poly, cmax_poly};
  const int* hi = settle_i ? settle_i + 2 * n_poly + C * cmax_poly
                           : nullptr;
  sg.hole = {settle_d ? settle_d + 4 + 2 * pv : nullptr,
             settle_d ? settle_d + 4 + 2 * pv + hv : nullptr,
             hi, hi ? hi + n_hole : nullptr, hi ? hi + 2 * n_hole : nullptr,
             n_hole, vmax_hole, cmax_hole};
  return sg;
}

// the curvilinear map: the (Ny*Nx, 2) rho xy rows, the seed_i then seed_j
// raster (each my x mx), its origin and inverse spacings, the squared
// residual tolerance of the inside test
static inline Curv make_curv(const pos_t* curv_xy, const int* curv_seed,
                             int curv_mx, int curv_my, double curv_rx0,
                             double curv_ry0, double curv_inv_rdx,
                             double curv_inv_rdy, double curv_tol2) {
  const long long ms = (long long)curv_mx * curv_my;
  return {reinterpret_cast<const pos2_t*>(curv_xy), curv_seed,
          curv_seed ? curv_seed + ms : nullptr, curv_mx, curv_my,
          (pos_t)curv_rx0, (pos_t)curv_ry0, (pos_t)curv_inv_rdx,
          (pos_t)curv_inv_rdy, (pos_t)curv_tol2};
}
