// One internal step's RK4 displacement for Hopper (sm_90a).
//
// Replaces ltjax/kernels/gather_interp.py::rk4_displacement_fused (the
// Pallas TPU kernel of the per-internal-step path).  Per particle: four
// find_currents stages on the three time-collapsed stage tables (t,
// t + idt/2, t + idt; stages 2 and 3 share the midpoint table), and
// (dx, dy, dz) = idt/6 (k1 + 2 k2 + 2 k3 + k4); optionally the stage-1
// currents (u1, v1), which behavior 7 (tidal-stream transport) rides.
// Each stage is the collapsed scheme of find_currents.cuh (shared with
// ext_step.cu): bilinear blend of the nv value lanes [u | v | w | zeta |
// h] of one stage table, natural tension-spline fit and clamped
// evaluation of u/v on the rho ladder and w on the w ladder, log-layer
// decay of u/v.  Its plain version is
// ltjax_torch.packed.rk4_displacement_collapsed.
//
// Design.  One thread per particle, 128 threads a block, one launch per
// internal step.  Each stage gathers its 4 corner rows x nv lanes straight
// from device memory: the TPU kernel's VMEM windows, one-hot MXU blends,
// out-of-window flag and exact patch, and its particle-block padding are
// not ported.  Tension: the static sigma >= 0.
//
// Variants (compile-time macros, present in the build flags only when
// on, so the rectilinear float32 build is the source as it was): LTX_CURV
// locates each stage through the inverse curvilinear map (curv.cuh, the
// code of ext_step.cu's K1f lanes); LTX_AXES by binary search on rho axes
// that are not uniform (grid.locate(..., uniform=False)); LTX_POS64 takes
// float64 positions (dtype_pos = "float64"): cell location, the knots, the
// log layer and the RK4 sums in float64, the blend and the fits in
// float32, as packed.rk4_displacement_collapsed casts them; LTX_TILE
// runs a tile of a sharded run (ltjax_torch.shard): the tables are the
// strip's, and each stage locates on the whole grid's axes and moves into
// the strip (find_currents.cuh to_strip).
//
// The staged corner source of find_currents.cuh (a block's box of the
// three tables in shared memory) was measured on this kernel and lost: 2.15-2.26 ms a launch at 1M
// against 1.97 gathered (H100 80GB HBM3, 700 W), from more registers
// (112-126, 4 blocks an SM, against 96 and 5) on a quarter of ext_step's
// words per lane, one launch per internal step to stage for.
//
// What bounds it.  Per particle 4 stages x 4 corners x nv lanes of
// gathers (~1 KB per stage at us = 20) from three tables of
// Ny*Nx*nv*4 bytes (10 MB each on the 200x200x20 bench grid: the three fit
// the 50 MB L2), and per stage two spline fits (us levels, 2 profiles;
// ws levels, 1 profile).  The caller's Hilbert sort keeps neighbouring
// threads on neighbouring rows.

#include <cuda_runtime.h>
#include <math.h>

#ifndef LTX_CURV
#define LTX_CURV 0
#endif
#ifndef LTX_POS64
#define LTX_POS64 0
#endif
#ifndef LTX_AXES
#define LTX_AXES 0
#endif
#ifndef LTX_TILE
#define LTX_TILE 0
#endif

#include "find_currents.cuh"
#include "curv.cuh"

// params (pos_t); must match ltjax_torch/kernels/rk4_step.py
enum { Q_X0 = 0, Q_DX, Q_Y0, Q_DY,   // rho axes: origin, spacing
       Q_HC, Q_Z0M, Q_SIGMA,
       Q_HEAD };                      // then s_rho, Cs_r, s_w, Cs_w

struct Grid {
  const pos_t* __restrict__ par;    // head + ladders
  int nx, ny, us, ws, nv, vt;
};

// the rho axes searched where they are not uniform (LTX_AXES), a kernel
// argument of its own
struct Axes {
  const pos_t* xr;
  const pos_t* yr;
};

// the four corner rows (nv floats apart) + weights of one position
struct Rows {
  long long r00, r01, r10, r11;
  float fx, fy;
};

__device__ __forceinline__ Rows locate_rows(const Grid& g, const Curv& cv,
                                            const Axes& ax, pos_t x,
                                            pos_t y) {
  int i, j;
#if LTX_CURV
  const Stencil c = locate_curv(cv, g.nx, g.ny, g.nv, x, y, i, j);
#elif LTX_TILE
  // a tile of a sharded run: on the whole grid's axes (ny_g rows; ax.yr
  // the whole grid's), row0 rows into the strip's tables (the two values
  // after the ladders)
  const pos_t* tl = g.par + Q_HEAD + 2 * (g.us + g.ws);
  const int row0 = (int)tl[0], ny_g = (int)tl[1];
  const Stencil c = to_strip(
      (LTX_AXES && ax.xr)
          ? locate_searched(ax.xr, ax.yr, g.nx, ny_g, g.nv, x, y, i, j)
          : locate_rect(g.par, g.nx, ny_g, g.nv, x, y, i, j),
      g.nx, g.ny, g.nv, row0, i, j);
#elif LTX_AXES
  const Stencil c = ax.xr ? locate_searched(ax.xr, ax.yr, g.nx, g.ny, g.nv,
                                            x, y, i, j)
                          : locate_rect(g.par, g.nx, g.ny, g.nv, x, y, i, j);
#else
  const Stencil c = locate_rect(g.par, g.nx, g.ny, g.nv, x, y, i, j);
#endif
  Rows s;
  s.fx = c.fx;
  s.fy = c.fy;
  s.r00 = c.r00;
  s.r01 = s.r00 + g.nv;
  s.r10 = s.r00 + (long long)g.nx * g.nv;
  s.r11 = s.r10 + g.nv;
  return s;
}

// the corner source of find_currents_at: one stage table (C, nv)
struct StageTable {
  const Grid& g;
  const float* __restrict__ tab;
  __device__ __forceinline__ float lane(const Rows& s, int k) const {
    return (tab[s.r00 + k] * (1.0f - s.fx) + tab[s.r01 + k] * s.fx)
               * (1.0f - s.fy)
           + (tab[s.r10 + k] * (1.0f - s.fx) + tab[s.r11 + k] * s.fx) * s.fy;
  }
  // the knot depth in the positions' type (the fit rounds it to f32)
  template <class Z>
  __device__ __forceinline__ pos_t knot(pos_t s, pos_t cs, Z zeta,
                                        Z h) const {
    return knot_depth<pos_t>(g.par[Q_HC], g.vt, s, cs, (pos_t)zeta,
                             (pos_t)h);
  }
  __device__ __forceinline__ const pos_t* ladders() const {
    return g.par + Q_HEAD;
  }
  __device__ __forceinline__ pos_t z0m() const { return g.par[Q_Z0M]; }
  __device__ __forceinline__ int us() const { return g.us; }
  __device__ __forceinline__ int ws() const { return g.ws; }
  __device__ __forceinline__ int nv() const { return g.nv; }
};

__device__ __forceinline__ void stage(const Grid& g, const Curv& cv,
                                      const Axes& ax, const Tension& T,
                                      const float* tab, pos_t x, pos_t y,
                                      pos_t z, float* cp, float* dp0,
                                      float* dp1, pos_t& u, pos_t& v,
                                      pos_t& w) {
  find_currents_at(StageTable{g, tab}, T, locate_rows(g, cv, ax, x, y), z,
                   cp, dp0, dp1, u, v, w);
}

// no __launch_bounds__(128): with it ptxas spilled 32 B at the same 96
// registers (CUDA 12.8, sm_90a)
__global__ void
rk4_step_kernel(Grid g, const float* __restrict__ t1,
                const float* __restrict__ t2, const float* __restrict__ t4,
                int n, pos_t idt, const pos_t* __restrict__ x_in,
                const pos_t* __restrict__ y_in,
                const pos_t* __restrict__ z_in, pos_t* __restrict__ dx_out,
                pos_t* __restrict__ dy_out, pos_t* __restrict__ dz_out,
                pos_t* __restrict__ u1_out, pos_t* __restrict__ v1_out,
                Curv cv, Axes ax) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  Tension T;                 // f32 fits: sigma rounded as tension.fit does
  T.sigma = (float)g.par[Q_SIGMA];
  T.small = 0.5f;
  T.cubic = T.sigma == 0.0f;
  float cp[MAX_LEVELS], dp0[MAX_LEVELS], dp1[MAX_LEVELS];
  const pos_t x = x_in[p], y = y_in[p], z = z_in[p];
  const pos_t half = pos_t(0.5) * idt;
  const pos_t sixth = idt / pos_t(6);
  pos_t u1, v1, w1, u2, v2, w2, u3, v3, w3, u4, v4, w4;
  stage(g, cv, ax, T, t1, x, y, z, cp, dp0, dp1, u1, v1, w1);
  stage(g, cv, ax, T, t2, x + u1 * half, y + v1 * half, z + w1 * half, cp,
        dp0, dp1, u2, v2, w2);
  stage(g, cv, ax, T, t2, x + u2 * half, y + v2 * half, z + w2 * half, cp,
        dp0, dp1, u3, v3, w3);
  stage(g, cv, ax, T, t4, x + u3 * idt, y + v3 * idt, z + w3 * idt, cp, dp0,
        dp1, u4, v4, w4);
  dx_out[p] = sixth * (u1 + pos_t(2) * u2 + pos_t(2) * u3 + u4);
  dy_out[p] = sixth * (v1 + pos_t(2) * v2 + pos_t(2) * v3 + v4);
  dz_out[p] = sixth * (w1 + pos_t(2) * w2 + pos_t(2) * w3 + w4);
  if (u1_out) {
    u1_out[p] = u1;
    v1_out[p] = v1;
  }
}

// The RK4 displacement of n particles over one internal step from the
// stage tables t1, t2, t4 (each (Ny*Nx, nv) f32, nv = 2us + ws + 2) and
// the params vector (see Q_*; pos_t, as the positions x, y, z and the
// outputs dx, dy, dz, u1, v1); u1/v1 (both or neither) receive the
// stage-1 currents.  curv_* is the inverse curvilinear map, given exactly
// to an LTX_CURV variant (curv.cuh; curv_seed the seed_i then the seed_j
// raster, each curv_my x curv_mx); axis_x/axis_y the rho axes (nx, ny),
// given only to an LTX_AXES variant, null where the grid is uniform (on
// an LTX_TILE variant the whole grid's y axis, and params ends with the
// strip's first row and the whole grid's rows).
// Returns the launch's cudaError_t.
extern "C" int ltx_rk4_step(const float* t1, const float* t2,
                            const float* t4, const pos_t* params,
                            const pos_t* x, const pos_t* y, const pos_t* z,
                            pos_t* dx, pos_t* dy, pos_t* dz, pos_t* u1,
                            pos_t* v1, int n, int nx, int ny, int us, int ws,
                            int vtransform, double idt, const pos_t* curv_xy,
                            const int* curv_seed, int curv_mx, int curv_my,
                            double curv_rx0, double curv_ry0,
                            double curv_inv_rdx, double curv_inv_rdy,
                            const pos_t* axis_x, const pos_t* axis_y,
                            void* stream) {
  if (us > MAX_LEVELS || ws > MAX_LEVELS || us < 2 || ws < 2 || nx < 2
      || ny < 2 || (u1 == nullptr) != (v1 == nullptr)
      || (LTX_CURV != 0) != (curv_xy != nullptr)
      || (LTX_CURV && (!curv_seed || curv_mx < 1 || curv_my < 1))
      || (!LTX_AXES && axis_x) || (axis_x == nullptr) != (axis_y == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  Grid g = {params, nx, ny, us, ws, 2 * us + ws + 2, vtransform};
  const long long ms = (long long)curv_mx * curv_my;
  Curv cv = {reinterpret_cast<const pos2_t*>(curv_xy), curv_seed,
             curv_seed ? curv_seed + ms : nullptr, curv_mx, curv_my,
             (pos_t)curv_rx0, (pos_t)curv_ry0, (pos_t)curv_inv_rdx,
             (pos_t)curv_inv_rdy, pos_t(0)};
  Axes ax = {axis_x, axis_y};
  int threads = 128;
  int blocks = (n + threads - 1) / threads;
  rk4_step_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      g, t1, t2, t4, n, (pos_t)idt, x, y, z, dx, dy, dz, u1, v1, cv, ax);
  return (int)cudaGetLastError();
}
