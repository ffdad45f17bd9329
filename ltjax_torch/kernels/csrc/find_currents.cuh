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
//   float knot(float s, float cs, float zeta, float h)  s-level depth
//   const float* ladders()  s_rho (us), Cs_r (us), s_w (ws), Cs_w (ws)
//   float z0m()  bottom roughness
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

#pragma once

#include <math.h>

#ifndef MAX_LEVELS
#define MAX_LEVELS 64
#endif

struct Tension {            // static-sigma spline constants of one thread
  float sigma, small;       // small: series/exact crossover (f32: 0.5)
  bool cubic;
};

__device__ __forceinline__ float gs_fn(const Tension& T, float B) {
  if (T.cubic) return (B * B * B - B) / 6.0f;
  float u = T.sigma;
  if (u < T.small) {
    float u2 = u * u, B2 = B * B;
    float c = u2 / 6.0f + u2 * u2 / 120.0f + u2 * u2 * u2 / 5040.0f;
    return B * ((B2 - 1.0f) / 6.0f + u2 * (B2 * B2 - 1.0f) / 120.0f
                + u2 * u2 * (B2 * B2 * B2 - 1.0f) / 5040.0f) / (1.0f + c);
  }
  float ratio = expf(u * (B - 1.0f)) * (-expm1f(-2.0f * u * B))
                / (-expm1f(-2.0f * u));
  return (ratio - B) / (u * u);
}

// (1 - u cosh(uB)/sinh(u))/u^2 (the spline derivative's basis; series
// below T.small, as tension._ds)
__device__ __forceinline__ float ds_fn(const Tension& T, float B) {
  float u = T.sigma;
  if (u < T.small) {
    float u2 = u * u, B2 = B * B;
    float c = u2 / 6.0f + u2 * u2 / 120.0f + u2 * u2 * u2 / 5040.0f;
    return ((1.0f / 6.0f - B2 / 2.0f) + u2 * (1.0f / 120.0f - B2 * B2 / 24.0f)
            + u2 * u2 * (1.0f / 5040.0f - B2 * B2 * B2 / 720.0f)) / (1.0f + c);
  }
  float ratio = u * expf(u * (B - 1.0f)) * (1.0f + expf(-2.0f * u * B))
                / (-expm1f(-2.0f * u));
  return (1.0f - ratio) / (u * u);
}

// tridiagonal coefficients (off, diag) of one interval of width h
__device__ __forceinline__ void coefs(const Tension& T, float h,
                                      float& off, float& dia) {
  float u = T.sigma;
  if (u < T.small) {
    float u2 = u * u;
    off = h * (1.0f / 6.0f - 7.0f * u2 / 360.0f + 31.0f * u2 * u2 / 15120.0f);
    dia = h * (1.0f / 3.0f - u2 / 45.0f + 2.0f * u2 * u2 / 945.0f);
    return;
  }
  float em = -expm1f(-2.0f * u);
  float u_over_sinh = 2.0f * u * expf(-u) / em;
  float u_coth = u * (1.0f + expf(-2.0f * u)) / em;
  off = (h / (u * u)) * (1.0f - u_over_sinh);
  dia = (h / (u * u)) * (u_coth - 1.0f);
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
// x0, dx, y0, dy), as grid.locate; not staged
__device__ __forceinline__ Stencil locate_rect(const float* par, int nx,
                                               int ny, int stride, float x,
                                               float y, int& i, int& j) {
  Stencil s;
  float tx = (x - par[0]) / par[1];
  float ty = (y - par[2]) / par[3];
  i = min(max((int)floorf(tx), 0), nx - 2);
  j = min(max((int)floorf(ty), 0), ny - 2);
  s.fx = fminf(fmaxf(tx - (float)i, 0.0f), 1.0f);
  s.fy = fminf(fmaxf(ty - (float)j, 0.0f), 1.0f);
  s.r00 = ((long long)j * nx + i) * stride;
  s.t = -1;
  s.rs = 0;
  return s;
}

// s-level depth of knot (s, cs) in a column with surface zeta, depth h
__device__ __forceinline__ float knot_depth(float hc, int vt, float s,
                                            float cs, float zeta, float h) {
  if (vt == 1) {
    float z0 = hc * s + (h - hc) * cs;
    return z0 + zeta * (1.0f + z0 / h);
  }
  float s_ = (hc * s + h * cs) / (hc + h);
  return zeta + (zeta + h) * s_;
}

// Natural tension-spline fit of up to two profiles sharing one knot
// ladder (lanes lane0 [, lane1]) and clamped evaluation at zq: the
// value, or (DERIV) the derivative.  Returns the first knot depth
// through z_first (log layer).
template <bool DERIV = false, class Src, class St>
__device__ void fit_eval(const Src& src, const Tension& T, const St& st,
                         const float* s_lad, const float* cs_lad, int K,
                         int lane0, int lane1, float zeta, float h, float zq,
                         float* cp, float* dp0, float* dp1,
                         float& out0, float& out1, float& z_first) {
  const bool two = lane1 >= 0;
  float zprev = src.knot(s_lad[0], cs_lad[0], zeta, h);
  float y0prev = src.lane(st, lane0);
  float y1prev = two ? src.lane(st, lane1) : 0.0f;
  z_first = zprev;
  cp[0] = 0.0f; dp0[0] = 0.0f; dp1[0] = 0.0f;
  // evaluation interval j (left/right knots and values), captured on
  // the fly: the last k <= K-2 with zq >= z_k, or 0
  int j = 0;
  float zl = zprev, y0l = y0prev, y1l = y1prev;
  float zr = zprev, y0r = y0prev, y1r = y1prev;
  float offp = 0.0f, diap = 0.0f, dy0p = 0.0f, dy1p = 0.0f;
  float zlast = zprev;
  for (int k = 1; k < K; ++k) {
    float zk = src.knot(s_lad[k], cs_lad[k], zeta, h);
    float y0k = src.lane(st, lane0 + k);
    float y1k = two ? src.lane(st, lane1 + k) : 0.0f;
    float hk = zk - zprev;                       // interval k-1
    float dy0 = (y0k - y0prev) / hk;
    float dy1 = two ? (y1k - y1prev) / hk : 0.0f;
    float offc, diac;
    coefs(T, hk, offc, diac);
    if (k >= 2) {                                // Thomas row i = k-1
      int i = k - 1;
      float denom = (diap + diac) - offp * cp[i - 1];
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
  float x0 = 0.0f, x1 = 0.0f;
  float s00 = 0.0f, s01 = 0.0f, s10 = 0.0f, s11 = 0.0f;
  for (int i = K - 2; i >= j; --i) {
    x0 = dp0[i] - cp[i] * x0;
    if (two) x1 = dp1[i] - cp[i] * x1;
    if (i == j + 1) { s01 = x0; s11 = x1; }
    if (i == j) { s00 = x0; s10 = x1; }
  }
  float zc = fminf(fmaxf(zq, z_first), zlast);
  float hh = zr - zl;
  float B2 = (zc - zl) / hh;
  float B1 = 1.0f - B2;
  if constexpr (DERIV) {
    float d1 = ds_fn(T, B1), d2 = ds_fn(T, B2);
    out0 = (y0r - y0l) / hh + hh * (s00 * d1 - s01 * d2);
    out1 = (y1r - y1l) / hh + hh * (s10 * d1 - s11 * d2);
  } else {
    float g1 = gs_fn(T, B1), g2 = gs_fn(T, B2);
    out0 = y0l * B1 + y0r * B2 + hh * hh * (s00 * g1 + s01 * g2);
    out1 = y1l * B1 + y1r * B2 + hh * hh * (s10 * g1 + s11 * g2);
  }
}

// find_currents at depth z in the column of stencil st: (u, v, w)
template <class Src, class St>
__device__ void find_currents_at(const Src& src, const Tension& T,
                                 const St& st, float z, float* cp,
                                 float* dp0, float* dp1, float& u, float& v,
                                 float& w) {
  const int us = src.us(), ws = src.ws();
  float zeta = src.lane(st, src.nv() - 2);
  float h = src.lane(st, src.nv() - 1);
  const float* s_r = src.ladders();
  const float* cs_r = s_r + us;
  const float* s_w = cs_r + us;
  const float* cs_w = s_w + ws;
  float zr0, zw0, dummy;
  fit_eval(src, T, st, s_r, cs_r, us, 0, us, zeta, h, z,
           cp, dp0, dp1, u, v, zr0);
  fit_eval(src, T, st, s_w, cs_w, ws, 2 * us, -1, zeta, h, z,
           cp, dp0, dp1, w, dummy, zw0);
  // near-bottom log layer on u and v
  float z0m = src.z0m();
  float zab = z + h;
  float ztb = fmaxf(zr0 + h, 2.0f * z0m);
  float decay = logf(fmaxf(zab, z0m) / z0m) / logf(ztb / z0m);
  float factor = zab < ztb ? fminf(fmaxf(decay, 0.0f), 1.0f) : 1.0f;
  u *= factor;
  v *= factor;
}
