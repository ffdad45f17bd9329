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
// not ported.  Grids: uniform rectilinear (arithmetic cell location);
// tension: the static sigma >= 0.  The staged corner source of
// find_currents.cuh (a block's box of the three tables in shared memory)
// was measured on this kernel and lost: 2.15-2.26 ms a launch at 1M
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

#include "find_currents.cuh"

// params (f32); must match ltjax_torch/kernels/rk4_step.py
enum { Q_X0 = 0, Q_DX, Q_Y0, Q_DY,   // rho axes: origin, spacing
       Q_HC, Q_Z0M, Q_SIGMA,
       Q_HEAD };                      // then s_rho, Cs_r, s_w, Cs_w

struct Grid {
  const float* __restrict__ par;    // head + ladders
  int nx, ny, us, ws, nv, vt;
};

// the four corner rows (nv floats apart) + weights of one position
struct Rows {
  long long r00, r01, r10, r11;
  float fx, fy;
};

__device__ __forceinline__ Rows locate_rows(const Grid& g, float x,
                                            float y) {
  int i, j;
  const Stencil c = locate_rect(g.par, g.nx, g.ny, g.nv, x, y, i, j);
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
  __device__ __forceinline__ float knot(float s, float cs, float zeta,
                                        float h) const {
    return knot_depth(g.par[Q_HC], g.vt, s, cs, zeta, h);
  }
  __device__ __forceinline__ const float* ladders() const {
    return g.par + Q_HEAD;
  }
  __device__ __forceinline__ float z0m() const { return g.par[Q_Z0M]; }
  __device__ __forceinline__ int us() const { return g.us; }
  __device__ __forceinline__ int ws() const { return g.ws; }
  __device__ __forceinline__ int nv() const { return g.nv; }
};

__device__ __forceinline__ void stage(const Grid& g, const Tension& T,
                                      const float* tab, float x, float y,
                                      float z, float* cp, float* dp0,
                                      float* dp1, float& u, float& v,
                                      float& w) {
  find_currents_at(StageTable{g, tab}, T, locate_rows(g, x, y), z, cp, dp0,
                   dp1, u, v, w);
}

// no __launch_bounds__(128): with it ptxas spilled 32 B at the same 96
// registers (CUDA 12.8, sm_90a)
__global__ void
rk4_step_kernel(Grid g, const float* __restrict__ t1,
                const float* __restrict__ t2, const float* __restrict__ t4,
                int n, float idt, const float* __restrict__ x_in,
                const float* __restrict__ y_in,
                const float* __restrict__ z_in, float* __restrict__ dx_out,
                float* __restrict__ dy_out, float* __restrict__ dz_out,
                float* __restrict__ u1_out, float* __restrict__ v1_out) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  Tension T;
  T.sigma = g.par[Q_SIGMA];
  T.small = 0.5f;
  T.cubic = T.sigma == 0.0f;
  float cp[MAX_LEVELS], dp0[MAX_LEVELS], dp1[MAX_LEVELS];
  const float x = x_in[p], y = y_in[p], z = z_in[p];
  const float half = 0.5f * idt;
  const float sixth = idt / 6.0f;
  float u1, v1, w1, u2, v2, w2, u3, v3, w3, u4, v4, w4;
  stage(g, T, t1, x, y, z, cp, dp0, dp1, u1, v1, w1);
  stage(g, T, t2, x + u1 * half, y + v1 * half, z + w1 * half, cp, dp0, dp1,
        u2, v2, w2);
  stage(g, T, t2, x + u2 * half, y + v2 * half, z + w2 * half, cp, dp0, dp1,
        u3, v3, w3);
  stage(g, T, t4, x + u3 * idt, y + v3 * idt, z + w3 * idt, cp, dp0, dp1, u4,
        v4, w4);
  dx_out[p] = sixth * (u1 + 2.0f * u2 + 2.0f * u3 + u4);
  dy_out[p] = sixth * (v1 + 2.0f * v2 + 2.0f * v3 + v4);
  dz_out[p] = sixth * (w1 + 2.0f * w2 + 2.0f * w3 + w4);
  if (u1_out) {
    u1_out[p] = u1;
    v1_out[p] = v1;
  }
}

// The RK4 displacement of n particles over one internal step from the
// stage tables t1, t2, t4 (each (Ny*Nx, nv) f32, nv = 2us + ws + 2) and
// the params vector (see Q_*); u1/v1 (both or neither) receive the
// stage-1 currents.  Returns the launch's cudaError_t.
extern "C" int ltx_rk4_step(const float* t1, const float* t2,
                            const float* t4, const float* params,
                            const float* x, const float* y, const float* z,
                            float* dx, float* dy, float* dz, float* u1,
                            float* v1, int n, int nx, int ny, int us, int ws,
                            int vtransform, float idt, void* stream) {
  if (us > MAX_LEVELS || ws > MAX_LEVELS || us < 2 || ws < 2 || nx < 2
      || ny < 2 || (u1 == nullptr) != (v1 == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  Grid g = {params, nx, ny, us, ws, 2 * us + ws + 2, vtransform};
  int threads = 128;
  int blocks = (n + threads - 1) / threads;
  rk4_step_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      g, t1, t2, t4, n, idt, x, y, z, dx, dy, dz, u1, v1);
  return (int)cudaGetLastError();
}
