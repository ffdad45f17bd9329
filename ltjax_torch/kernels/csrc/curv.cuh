// The inverse curvilinear map on the device, shared by the kernels of
// this directory (ext_step.cu under LTX_CURV, rk4_step.cu under LTX_CURV).
//
// ltjax_torch.grid.curv_logical for one point: the seed cell from a
// uniform raster over the grid's bounding box, then 3 Newton steps on the
// bilinear quad map of the four rho points around the current estimate,
// each bounded to [-1.5, 2.5] cells, the result clamped to the lattice.
// The map is built in the positions' dtype (run.grid_from_roms,
// grid.make_curv_grid), so it runs in pos_t (find_currents.cuh), reading
// the rho points as pos2_t rows.

#pragma once

#include "find_currents.cuh"

// the curvilinear inverse map (ltjax_torch.grid.CurvMap), a kernel
// argument of its own
struct Curv {
  const pos2_t* xy;                 // (Ny*Nx) projected rho points
  const int* seed_i;                // (my, mx) seed raster: nearest cell
  const int* seed_j;
  int mx, my;
  pos_t rx0, ry0, inv_rdx, inv_rdy; // raster origin and inverse spacing
  pos_t tol2;                       // squared inside-mesh residual tol
};

// ltjax_torch.grid.curv_logical: logical coordinates (ti, tj) of (x, y)
// from the raster seed and 3 bounded Newton steps on the bilinear quad
// map, clamped to the lattice; RESID adds r2, the squared residual of
// the forward map at the clamped solution
template <bool RESID>
__device__ __forceinline__ void curv_logical(const Curv& c, int nx, int ny,
                                             pos_t x, pos_t y, pos_t& ti,
                                             pos_t& tj, pos_t& r2) {
  const pos_t ri = m_min(m_max(m_floor((x - c.rx0) * c.inv_rdx), pos_t(0)),
                         (pos_t)(c.mx - 1));
  const pos_t rj = m_min(m_max(m_floor((y - c.ry0) * c.inv_rdy), pos_t(0)),
                         (pos_t)(c.my - 1));
  const int rflat = (int)rj * c.mx + (int)ri;
  ti = (pos_t)c.seed_i[rflat] + pos_t(0.5);
  tj = (pos_t)c.seed_j[rflat] + pos_t(0.5);
  for (int it = 0; it < 3; ++it) {
    const pos_t i = m_min(m_max(m_floor(ti), pos_t(0)), (pos_t)(nx - 2));
    const pos_t j = m_min(m_max(m_floor(tj), pos_t(0)), (pos_t)(ny - 2));
    const pos_t fx = ti - i, fy = tj - j;
    const int base = (int)j * nx + (int)i;
    const pos2_t c00 = c.xy[base], c01 = c.xy[base + 1];
    const pos2_t c10 = c.xy[base + nx], c11 = c.xy[base + nx + 1];
    const pos_t ax0 = c01.x - c00.x, ax1 = c01.y - c00.y;
    const pos_t ay0 = c10.x - c00.x, ay1 = c10.y - c00.y;
    const pos_t b0 = c11.x - c01.x - c10.x + c00.x;
    const pos_t b1 = c11.y - c01.y - c10.y + c00.y;
    const pos_t fxy = fx * fy;
    const pos_t p0 = c00.x + fx * ax0 + fy * ay0 + fxy * b0;
    const pos_t p1 = c00.y + fx * ax1 + fy * ay1 + fxy * b1;
    const pos_t jx0 = ax0 + fy * b0, jx1 = ax1 + fy * b1;   // dP/dfx
    const pos_t jy0 = ay0 + fx * b0, jy1 = ay1 + fx * b1;   // dP/dfy
    pos_t det = jx0 * jy1 - jx1 * jy0;
    det = m_abs(det) < pos_t(1e-30) ? pos_t(1e-30) : det;
    const pos_t rx = x - p0, ry = y - p1;
    const pos_t dfx = (jy1 * rx - jy0 * ry) / det;
    const pos_t dfy = (-jx1 * rx + jx0 * ry) / det;
    ti = i + m_min(m_max(fx + dfx, pos_t(-1.5)), pos_t(2.5));
    tj = j + m_min(m_max(fy + dfy, pos_t(-1.5)), pos_t(2.5));
  }
  ti = m_min(m_max(ti, pos_t(0)), (pos_t)(nx - 1));
  tj = m_min(m_max(tj, pos_t(0)), (pos_t)(ny - 1));
  if constexpr (RESID) {
    const pos_t i = m_min(m_max(m_floor(ti), pos_t(0)), (pos_t)(nx - 2));
    const pos_t j = m_min(m_max(m_floor(tj), pos_t(0)), (pos_t)(ny - 2));
    const pos_t fx = ti - i, fy = tj - j;
    const int base = (int)j * nx + (int)i;
    const pos2_t c00 = c.xy[base], c01 = c.xy[base + 1];
    const pos2_t c10 = c.xy[base + nx], c11 = c.xy[base + nx + 1];
    const pos_t fxy = fx * fy;
    const pos_t p0 = c00.x + fx * (c01.x - c00.x) + fy * (c10.x - c00.x)
                     + fxy * (c11.x - c01.x - c10.x + c00.x);
    const pos_t p1 = c00.y + fx * (c01.y - c00.y) + fy * (c10.y - c00.y)
                     + fxy * (c11.y - c01.y - c10.y + c00.y);
    r2 = (x - p0) * (x - p0) + (y - p1) * (y - p1);
  }
}

// the cell (i, j) and stencil of (x, y) through the inverse map, as
// grid.locate_rho_ij: i = floor(ti) clamped to [0, nx-2], the fractions
// clamped to [0, 1] (float32: the tables' blend); not staged
__device__ __forceinline__ Stencil locate_curv(const Curv& cv, int nx, int ny,
                                               int stride, pos_t x, pos_t y,
                                               int& i, int& j) {
  Stencil s;
  pos_t ti, tj, r2;
  curv_logical<false>(cv, nx, ny, x, y, ti, tj, r2);
  const pos_t fi = m_min(m_max(m_floor(ti), pos_t(0)), (pos_t)(nx - 2));
  const pos_t fj = m_min(m_max(m_floor(tj), pos_t(0)), (pos_t)(ny - 2));
  i = (int)fi;
  j = (int)fj;
  s.fx = (float)m_min(m_max(ti - fi, pos_t(0)), pos_t(1));
  s.fy = (float)m_min(m_max(tj - fj, pos_t(0)), pos_t(1));
  s.r00 = ((long long)j * nx + i) * stride;
  s.t = -1;
  s.rs = 0;
  return s;
}
