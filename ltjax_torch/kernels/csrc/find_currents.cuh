// find_currents on the device, shared by the kernels of this directory.
//
// The collapsed scheme of ltjax_torch.packed.find_currents_collapsed for
// one particle: the bilinear blend of every value lane at the particle's
// rho cell, the natural tension-spline fit and clamped evaluation of u/v
// on the rho ladder and w on the w ladder (s-level knots from the blended
// zeta and h), and the log-layer decay of u/v near the bottom.
//
// Where the blended lanes come from is the caller's: a corner source
// ``Src`` and the stencil type ``St`` of its lookups, with
//
//   float lane(const St& s, int k)  lane k blended at stencil s
//   pos_t knot(pos_t s, pos_t cs, Z zeta, Z h)  s-level depth (Z: the
//       fit's scalar type)
//   const pos_t* ladders()  s_rho (us), Cs_r (us), s_w (ws), Cs_w (ws)
//   pos_t z0m()  bottom roughness
//   int us(), ws(), nv()  levels and value lanes (nv = 2us + ws + 2)
//
// ext_step.cu blends the three raw records collapsed with the polintd
// weights of the stage, from a block's shared-memory tiles where it can
// (its staged corner source); rk4_step.cu gathers the four corner rows of
// one time-collapsed stage table from device memory.  Stencil carries a
// position's cell weights, its corner-00 offset r00 in the table (rows
// `stride` floats apart) and, for a staged source, its offset t in the
// tiles (-1: not staged) and the tiles' row stride rs.
//
// The vertical fit streams the levels: knots and blended values are
// computed level by level inside the Thomas forward sweep, so only the
// sweep's cp/dp columns live in local memory (MAX_LEVELS floats each);
// the evaluation interval is captured on the fly and the backward sweep
// stops there.  Arithmetic mirrors the plain PyTorch version operation
// for operation (IEEE divides, the same small-tension series).
//
// Positions.  pos_t is the positions' type: float, or double where the
// including source is built with LTX_POS64=1 (dtype_pos = "float64").
// The plain version then locates cells, computes the knot depths and the
// log layer, and sums the RK4 stages in float64, but blends the float32
// tables and fits their profiles in float32 (packed.py casts the cell
// fractions and the knots to the tables' dtype and the currents back):
// so does find_currents_at below.  The spline routines take their scalar
// type R as a template parameter (float here; pos_t for the scalar fits
// of ext_step.cu, which the plain version runs in the positions' dtype).

#pragma once

#include <math.h>

#ifndef MAX_LEVELS
#define MAX_LEVELS 64
#endif

#if LTX_POS64
typedef double pos_t;
typedef double2 pos2_t;
#define POS_SMALL 0.02      // tension._u_small(float64)
#else
typedef float pos_t;
typedef float2 pos2_t;
#define POS_SMALL 0.5f      // tension._u_small(float32)
#endif

// the math of either type (float: the f-suffixed functions)
__device__ __forceinline__ float m_floor(float v) { return floorf(v); }
__device__ __forceinline__ double m_floor(double v) { return floor(v); }
__device__ __forceinline__ float m_min(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double m_min(double a, double b) {
  return fmin(a, b);
}
__device__ __forceinline__ float m_max(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double m_max(double a, double b) {
  return fmax(a, b);
}
__device__ __forceinline__ float m_abs(float v) { return fabsf(v); }
__device__ __forceinline__ double m_abs(double v) { return fabs(v); }
__device__ __forceinline__ float m_log(float v) { return logf(v); }
__device__ __forceinline__ double m_log(double v) { return log(v); }
__device__ __forceinline__ float m_exp(float v) { return expf(v); }
__device__ __forceinline__ double m_exp(double v) { return exp(v); }
__device__ __forceinline__ float m_expm1(float v) { return expm1f(v); }
__device__ __forceinline__ double m_expm1(double v) { return expm1(v); }
__device__ __forceinline__ float m_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double m_sqrt(double v) { return sqrt(v); }
__device__ __forceinline__ float m_cos(float v) { return cosf(v); }
__device__ __forceinline__ double m_cos(double v) { return cos(v); }
__device__ __forceinline__ float m_sin(float v) { return sinf(v); }
__device__ __forceinline__ double m_sin(double v) { return sin(v); }

template <class R>
struct TensionT {           // static-sigma spline constants of one thread
  R sigma, small;           // small: series/exact crossover (f32: 0.5,
  bool cubic;               // f64: 0.02)
};
typedef TensionT<float> Tension;

template <class R>
__device__ __forceinline__ R gs_fn(const TensionT<R>& T, R B) {
  if (T.cubic) return (B * B * B - B) / R(6);
  R u = T.sigma;
  if (u < T.small) {
    R u2 = u * u, B2 = B * B;
    R c = u2 / R(6) + u2 * u2 / R(120) + u2 * u2 * u2 / R(5040);
    return B * ((B2 - R(1)) / R(6) + u2 * (B2 * B2 - R(1)) / R(120)
                + u2 * u2 * (B2 * B2 * B2 - R(1)) / R(5040)) / (R(1) + c);
  }
  R ratio = m_exp(u * (B - R(1))) * (-m_expm1(R(-2) * u * B))
            / (-m_expm1(R(-2) * u));
  return (ratio - B) / (u * u);
}

// (1 - u cosh(uB)/sinh(u))/u^2 (the spline derivative's basis; series
// below T.small, as tension._ds)
template <class R>
__device__ __forceinline__ R ds_fn(const TensionT<R>& T, R B) {
  R u = T.sigma;
  if (u < T.small) {
    R u2 = u * u, B2 = B * B;
    R c = u2 / R(6) + u2 * u2 / R(120) + u2 * u2 * u2 / R(5040);
    return ((R(1) / R(6) - B2 / R(2)) + u2 * (R(1) / R(120) - B2 * B2 / R(24))
            + u2 * u2 * (R(1) / R(5040) - B2 * B2 * B2 / R(720))) / (R(1) + c);
  }
  R ratio = u * m_exp(u * (B - R(1))) * (R(1) + m_exp(R(-2) * u * B))
            / (-m_expm1(R(-2) * u));
  return (R(1) - ratio) / (u * u);
}

// tridiagonal coefficients (off, diag) of one interval of width h
template <class R>
__device__ __forceinline__ void coefs(const TensionT<R>& T, R h, R& off,
                                      R& dia) {
  R u = T.sigma;
  if (u < T.small) {
    R u2 = u * u;
    off = h * (R(1) / R(6) - R(7) * u2 / R(360) + R(31) * u2 * u2 / R(15120));
    dia = h * (R(1) / R(3) - u2 / R(45) + R(2) * u2 * u2 / R(945));
    return;
  }
  R em = -m_expm1(R(-2) * u);
  R u_over_sinh = R(2) * u * m_exp(-u) / em;
  R u_coth = u * (R(1) + m_exp(R(-2) * u)) / em;
  off = (h / (u * u)) * (R(1) - u_over_sinh);
  dia = (h / (u * u)) * (u_coth - R(1));
}

// bilinear corner offsets + weights of one position on the rho lattice:
// corner 00 at r00 in the table (rows `stride` floats apart, corner 01 at
// r00 + stride, 10 at r00 + nx * stride) and at t in the block's tiles
// (-1: not staged; corner 01 at t + tile_lanes, 10 at t + rs)
struct Stencil {
  long long r00;
  int t, rs;
  float fx, fy;
};

// the rectilinear cell (i, j) of (x, y) on uniform rho axes (par[0..3]:
// x0, dx, y0, dy in the positions' type), as grid.locate; not staged
__device__ __forceinline__ Stencil locate_rect(const pos_t* par, int nx,
                                               int ny, int stride, pos_t x,
                                               pos_t y, int& i, int& j) {
  Stencil s;
  pos_t tx = (x - par[0]) / par[1];
  pos_t ty = (y - par[2]) / par[3];
  i = min(max((int)m_floor(tx), 0), nx - 2);
  j = min(max((int)m_floor(ty), 0), ny - 2);
  s.fx = (float)m_min(m_max(tx - (pos_t)i, pos_t(0)), pos_t(1));
  s.fy = (float)m_min(m_max(ty - (pos_t)j, pos_t(0)), pos_t(1));
  s.r00 = ((long long)j * nx + i) * stride;
  s.t = -1;
  s.rs = 0;
  return s;
}

// the number of entries of the increasing axis a[0..n) that are <= v
// (torch.searchsorted(a, v, right=True))
template <class T>
__device__ __forceinline__ int search_right(const T* a, int n, T v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// the cell index and fraction of v on a searched axis a[0..n), as
// grid.locate(..., uniform=False): i in [0, n-2], f clipped to [0, 1]
__device__ __forceinline__ int locate_axis(const pos_t* a, int n, pos_t v,
                                           float& f) {
  const int i = min(max(search_right(a, n, v) - 1, 0), n - 2);
  const pos_t c0 = a[i], c1 = a[i + 1];
  f = (float)m_min(m_max((v - c0) / (c1 - c0), pos_t(0)), pos_t(1));
  return i;
}

// the rectilinear cell (i, j) of (x, y) found by binary search on the rho
// axes xr (nx) and yr (ny); not staged
__device__ __forceinline__ Stencil locate_searched(const pos_t* xr,
                                                   const pos_t* yr, int nx,
                                                   int ny, int stride,
                                                   pos_t x, pos_t y, int& i,
                                                   int& j) {
  Stencil s;
  i = locate_axis(xr, nx, x, s.fx);
  j = locate_axis(yr, ny, y, s.fy);
  s.r00 = ((long long)j * nx + i) * stride;
  s.t = -1;
  s.rs = 0;
  return s;
}

// s-level depth of knot (s, cs) in a column with surface zeta, depth h
template <class P>
__device__ __forceinline__ P knot_depth(P hc, int vt, P s, P cs, P zeta,
                                        P h) {
  if (vt == 1) {
    P z0 = hc * s + (h - hc) * cs;
    return z0 + zeta * (P(1) + z0 / h);
  }
  P s_ = (hc * s + h * cs) / (hc + h);
  return zeta + (zeta + h) * s_;
}

// Natural tension-spline fit of up to two profiles sharing one knot
// ladder (lanes lane0 [, lane1]) and clamped evaluation at zq: the
// value, or (DERIV) the derivative, in the scalar type R (the blended
// lanes and the knots rounded to it).  Returns the first knot depth
// through z_first (log layer).
template <bool DERIV = false, class R, class Src, class St, class L>
__device__ void fit_eval(const Src& src, const TensionT<R>& T, const St& st,
                         const L* s_lad, const L* cs_lad, int K, int lane0,
                         int lane1, R zeta, R h, R zq, R* cp, R* dp0, R* dp1,
                         R& out0, R& out1, R& z_first) {
  const bool two = lane1 >= 0;
  R zprev = (R)src.knot(s_lad[0], cs_lad[0], zeta, h);
  R y0prev = (R)src.lane(st, lane0);
  R y1prev = two ? (R)src.lane(st, lane1) : R(0);
  z_first = zprev;
  cp[0] = R(0); dp0[0] = R(0); dp1[0] = R(0);
  // evaluation interval j (left/right knots and values), captured on
  // the fly: the last k <= K-2 with zq >= z_k, or 0
  int j = 0;
  R zl = zprev, y0l = y0prev, y1l = y1prev;
  R zr = zprev, y0r = y0prev, y1r = y1prev;
  R offp = R(0), diap = R(0), dy0p = R(0), dy1p = R(0);
  R zlast = zprev;
  for (int k = 1; k < K; ++k) {
    R zk = (R)src.knot(s_lad[k], cs_lad[k], zeta, h);
    R y0k = (R)src.lane(st, lane0 + k);
    R y1k = two ? (R)src.lane(st, lane1 + k) : R(0);
    R hk = zk - zprev;                           // interval k-1
    R dy0 = (y0k - y0prev) / hk;
    R dy1 = two ? (y1k - y1prev) / hk : R(0);
    R offc, diac;
    coefs(T, hk, offc, diac);
    if (k >= 2) {                                // Thomas row i = k-1
      int i = k - 1;
      R denom = (diap + diac) - offp * cp[i - 1];
      cp[i] = offc / denom;
      dp0[i] = ((dy0 - dy0p) - offp * dp0[i - 1]) / denom;
      if (two) dp1[i] = ((dy1 - dy1p) - offp * dp1[i - 1]) / denom;
    }
    if (k == j + 1) { zr = zk; y0r = y0k; y1r = y1k; }
    if (k <= K - 2 && zq >= zk) { j = k; zl = zk; y0l = y0k; y1l = y1k; }
    zprev = zk; y0prev = y0k; y1prev = y1k;
    offp = offc; diap = diac; dy0p = dy0; dy1p = dy1;
    zlast = zk;
  }
  // backward sweep from the natural end (z2[K-1] = 0) down to j
  R x0 = R(0), x1 = R(0);
  R s00 = R(0), s01 = R(0), s10 = R(0), s11 = R(0);
  for (int i = K - 2; i >= j; --i) {
    x0 = dp0[i] - cp[i] * x0;
    if (two) x1 = dp1[i] - cp[i] * x1;
    if (i == j + 1) { s01 = x0; s11 = x1; }
    if (i == j) { s00 = x0; s10 = x1; }
  }
  R zc = m_min(m_max(zq, z_first), zlast);
  R hh = zr - zl;
  R B2 = (zc - zl) / hh;
  R B1 = R(1) - B2;
  if constexpr (DERIV) {
    R d1 = ds_fn(T, B1), d2 = ds_fn(T, B2);
    out0 = (y0r - y0l) / hh + hh * (s00 * d1 - s01 * d2);
    out1 = (y1r - y1l) / hh + hh * (s10 * d1 - s11 * d2);
  } else {
    R g1 = gs_fn(T, B1), g2 = gs_fn(T, B2);
    out0 = y0l * B1 + y0r * B2 + hh * hh * (s00 * g1 + s01 * g2);
    out1 = y1l * B1 + y1r * B2 + hh * hh * (s10 * g1 + s11 * g2);
  }
}

// find_currents at depth z in the column of stencil st: (u, v, w).  The
// blend and the fits in float32 at zq = (float)z, knots from the source in
// the positions' type rounded to float32, the log layer in the positions'
// type (packed.find_currents_collapsed).
template <class Src, class St>
__device__ void find_currents_at(const Src& src, const Tension& T,
                                 const St& st, pos_t z, float* cp,
                                 float* dp0, float* dp1, pos_t& u, pos_t& v,
                                 pos_t& w) {
  const int us = src.us(), ws = src.ws();
  float zeta = src.lane(st, src.nv() - 2);
  float h = src.lane(st, src.nv() - 1);
  const pos_t* s_r = src.ladders();
  const pos_t* cs_r = s_r + us;
  const pos_t* s_w = cs_r + us;
  const pos_t* cs_w = s_w + ws;
  const float zq = (float)z;
  float uf, vf, wf, zr0, zw0, dummy;
  fit_eval(src, T, st, s_r, cs_r, us, 0, us, zeta, h, zq,
           cp, dp0, dp1, uf, vf, zr0);
  fit_eval(src, T, st, s_w, cs_w, ws, 2 * us, -1, zeta, h, zq,
           cp, dp0, dp1, wf, dummy, zw0);
  // near-bottom log layer on u and v
  const pos_t z0m = src.z0m();
  const pos_t hp = (pos_t)h;
  pos_t zab = z + hp;
  pos_t ztb = m_max((pos_t)zr0 + hp, pos_t(2) * z0m);
  pos_t decay = m_log(m_max(zab, z0m) / z0m) / m_log(ztb / z0m);
  pos_t factor = zab < ztb ? m_min(m_max(decay, pos_t(0)), pos_t(1))
                           : pos_t(1);
  u = (pos_t)uf * factor;
  v = (pos_t)vf * factor;
  w = (pos_t)wf;
}
