// One internal step's lanes for Hopper (sm_90a): K3 of the per-step route.
//
// Replaces the lanes of ltjax's per-step route (ltjax.step's scan of
// internal_step(mode="kernel"), which stochastic mortality takes): after
// the RK4 kernel (K2, rk4_step.cu) ltjax runs them as XLA ops, the same
// lanes that its whole-step kernel runs inside
// ltjax/kernels/ext_step.py:993-1359 (turbulence, behavior, mortality,
// reflection, vertical reflection, status, settlement, SaltTempOn).  Here
// they are lanes.cuh's step_lanes, the code of ext_step.cu's internal-step
// loop, plus the DEATH draw: one thread per particle, one launch per
// internal step, after K2.
//
// Per particle: release at the date of birth and the age (ext_step.cu's
// order), then, for an ACTIVE particle, step_lanes from K2's displacement
// (dx, dy, dz) and, for behavior 7, its stage-1 currents (u1, v1); death
// on the DEATH draw (u < p_die at the pre-step age, age >= 0, with p_die
// = 1 - exp(-idt/deadage) computed by the caller as the plain version
// computes it, params slot P_PDIE) overrides a same-step ERROR, not an
// exit.  The plain version is ltjax_torch.kernels.step_lanes.lanes.
//
// Corners.  Every lane read is the step's three raw records (the packed
// record table, its Aks and salt/temp lanes where the variant reads them)
// collapsed with the step's 9 polintd weights and blended at a stencil
// located in device memory (lanes.cuh record_lane): no staging, since a
// launch reads at most the two columns of zeta/h, the Aks column and the
// salt/temp columns of a particle, one internal step each.
//
// Variants follow ext_step.cu's flags (LTX_HTURB, LTX_VTURB 0/1/2,
// LTX_BEHAVIOR 0-7, LTX_SETTLE, LTX_SALT, LTX_CURV, LTX_POS64, LTX_AXES,
// LTX_TILE); mortality is always the DEATH draw (the per-step route is
// stochastic mortality's).  The key vector holds the derived Threefry
// pairs of the step's substreams HTURB, VTURB, BEHAVE, MORTALITY and DEATH
// (ltjax_torch.rng.stream_key), so every draw equals the plain version's
// bit for bit.
//
// What bounds it.  Per particle it reads its state (x, y, z, dob, age,
// pid, status; settle_poly, salt, temp where the variant carries them) and
// K2's 3 or 5 outputs and writes 7-10 columns: 64-96 bytes at float32.
// The corner reads (zeta and h at the stage-1 and the new position: 2 x
// 12 floats; the Aks column ws x 12, the salt column us x 12 or both
// columns 2us x 12) come mostly from L2 on a sorted batch.  Counted
// operations (Threefry words at the f32 rate, a reflection pass, the
// vertical fits) are ~600-3,000 a particle, so at 1M particles the bytes
// (20-30 us at 3.35 TB/s) and the operations (10-45 us at 67 TFLOP/s)
// are of one order; chip_smoke.py's lanes bound takes the larger.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_LEVELS 64

#ifndef LTX_HTURB
#define LTX_HTURB 0
#endif
#ifndef LTX_VTURB
#define LTX_VTURB 0
#endif
#ifndef LTX_BEHAVIOR
#define LTX_BEHAVIOR 0
#endif
#ifndef LTX_SETTLE
#define LTX_SETTLE 0
#endif
#ifndef LTX_SALT
#define LTX_SALT 0
#endif
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
#include "lanes.cuh"

#define K3_BLOCK 128

// key words of the step: the pairs of substreams 0-4 (lanes.cuh HTURB ..
// DEATH), read as internal step 0
#define K3_STRIDE 10

// find_currents.cuh's corner source of stage q: the raw records collapsed
// with the stage's weights l + 3q, gathered from device memory
struct RecordLanes {
  const Args& a;
  const float* w;
  __device__ __forceinline__ float lane(const Stencil& s, int k) const {
    return record_lane(a, s, w, k);
  }
  template <class Z>
  __device__ __forceinline__ pos_t knot(pos_t s, pos_t cs, Z zeta,
                                        Z h) const {
    return knot_depth<pos_t>(ppar(a)[P_HC], a.vt, s, cs, (pos_t)zeta,
                             (pos_t)h);
  }
  __device__ __forceinline__ const pos_t* ladders() const {
    return ppar(a) + P_HEAD;
  }
  __device__ __forceinline__ pos_t z0m() const { return ppar(a)[P_Z0M]; }
  __device__ __forceinline__ int us() const { return a.us; }
  __device__ __forceinline__ int ws() const { return a.ws; }
  __device__ __forceinline__ int nv() const { return a.nv; }
};

// the corner source of step_lanes: every stencil located in device
// memory, every lane from the raw records (weights l of the step)
struct Global {
  const Args& a;
  const Curv& cv;
  const Axes& ax;
  const float* l;
  __device__ __forceinline__ Stencil at(pos_t x, pos_t y) const {
    int i, j;
    return locate(a, cv, ax, x, y, i, j);
  }
  __device__ __forceinline__ float lane(const Stencil& s, int q,
                                        int k) const {
    return record_lane(a, s, l + 3 * q, k);
  }
  __device__ __forceinline__ RecordLanes rec(int q) const {
    return RecordLanes{a, l + 3 * q};
  }
};

// K2's outputs: the RK4 displacement and (behavior 7) the stage-1 currents
struct Disp {
  const pos_t* dx;
  const pos_t* dy;
  const pos_t* dz;
  const pos_t* u1;
  const pos_t* v1;
};

template <int HT, int VT, int BEH, int SETTLE, int SALT>
__global__ void __launch_bounds__(K3_BLOCK)
step_lanes_kernel(Args a, Settle sg, Curv cv, Disp d, int n,
                  const pos_t* __restrict__ x_in,
                  const pos_t* __restrict__ y_in,
                  const pos_t* __restrict__ z_in,
                  const pos_t* __restrict__ dob_in,
                  const pos_t* __restrict__ age_in,
                  const int* __restrict__ pid_in,
                  const int* __restrict__ st_in,
                  const int* __restrict__ spoly_in,
                  const pos_t* __restrict__ salt_in,
                  const pos_t* __restrict__ temp_in,
                  pos_t* __restrict__ x_out, pos_t* __restrict__ y_out,
                  pos_t* __restrict__ z_out, pos_t* __restrict__ age_out,
                  int* __restrict__ st_out, int* __restrict__ hitl_out,
                  int* __restrict__ hitb_out, int* __restrict__ spoly_out,
                  pos_t* __restrict__ salt_out,
                  pos_t* __restrict__ temp_out, Axes ax) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const pos_t* par = ppar(a);
  pos_t x = x_in[p], y = y_in[p], z = z_in[p];
  const pos_t dob = dob_in[p], age_pre = age_in[p];
  int st = st_in[p];
  int spoly = 0;
  if constexpr (SETTLE) spoly = spoly_in[p];
  pos_t salt = pos_t(0), temp = pos_t(0);
  if constexpr (SALT) { salt = salt_in[p]; temp = temp_in[p]; }
  // release and age (ext_step.cu's order)
  const pos_t t = par[P_T0], idt = par[P_IDT];
  if (st == NOT_RELEASED && t >= dob) st = ACTIVE;
  pos_t age = age_pre;
  if (st >= ACTIVE) age = (t + idt) - dob;
  int hitl = 0, hitb = 0;
  if (st == ACTIVE) {
    TensionT<pos_t> Ts;      // Visser, the 4/5 cue, salt/temp (ext_step.cu)
    Ts.sigma = par[P_SIGMA];
    Ts.small = POS_SMALL;
    Ts.cubic = false;
    constexpr int FIT = VT == 2 || SALT || BEH == 4 || BEH == 5
                            ? MAX_LEVELS : 1;
    pos_t cq[FIT], dq0[FIT], dq1[FIT];
    const pos_t u1 = BEH == 7 ? d.u1[p] : pos_t(0);
    const pos_t v1 = BEH == 7 ? d.v1[p] : pos_t(0);
    step_lanes<HT, VT, BEH, 2, SETTLE, SALT>(
        Global{a, cv, ax, a.par + P_HEAD + 2 * (a.us + a.ws)}, a, sg, cv, ax,
        Ts, cq, dq0, dq1, K3_STRIDE, 0, (uint32_t)pid_in[p], age_pre, u1, v1,
        d.dx[p], d.dy[p], d.dz[p], x, y, z, st, spoly, salt, temp, hitl,
        hitb);
  }
  x_out[p] = x;
  y_out[p] = y;
  z_out[p] = z;
  age_out[p] = age;
  st_out[p] = st;
  hitl_out[p] = hitl;
  hitb_out[p] = hitb;
  if constexpr (SETTLE) spoly_out[p] = spoly;
  if constexpr (SALT) { salt_out[p] = salt; temp_out[p] = temp; }
}

// One internal step's lanes of n particles, in the variant this library
// was compiled for (LTX_* macros).  The arguments are ext_step.cu's
// ltx_ext_step's, for one internal step (params: the head with P_T0 the
// step's start and P_PDIE its death probability, the ladders, the step's
// 9 polintd weights, for behavior 3 its surface irradiance; rngk the 10
// key words of substreams 0-4), less the staging, plus K2's outputs dx,
// dy, dz (pos_t) and, for behavior 7, u1, v1.  age/age_out are always
// read/written; spoly, salt and temp and their outputs only where the
// variant carries them.  Returns the launch's cudaError_t.
extern "C" int ltx_step_lanes(
    const float* rtab, const pos_t* brows, const float* params,
    const double* dparams, const uint32_t* rngk, const pos_t* x,
    const pos_t* y, const pos_t* z, const pos_t* dob, const pos_t* age,
    const int* pid, const int* status, const int* spoly, const pos_t* salt,
    const pos_t* temp, const pos_t* dx, const pos_t* dy, const pos_t* dz,
    const pos_t* u1, const pos_t* v1, pos_t* x_out, pos_t* y_out,
    pos_t* z_out, pos_t* age_out, int* st_out, int* hitl_out,
    int* hitb_out, int* spoly_out, pos_t* salt_out, pos_t* temp_out,
    const double* settle_d, const int* settle_i, int n, int nx, int ny,
    int us, int ws, int nl, int aks0, int salt0, int vtransform, int n_iter,
    int open_exits, int s_max, int n_poly, int vmax_poly, int cmax_poly,
    int n_hole, int vmax_hole, int cmax_hole, const pos_t* curv_xy,
    const int* curv_seed, int curv_mx, int curv_my, double curv_rx0,
    double curv_ry0, double curv_inv_rdx, double curv_inv_rdy,
    double curv_tol2, const pos_t* axis_x, const pos_t* axis_y,
    const pos_t* edge_x, const pos_t* edge_y, const double* settle_ex,
    const double* settle_ey, void* stream) {
  if (bad_tables(us, ws, nl, aks0, salt0, n_poly, settle_d, settle_i,
                 curv_xy, curv_seed, curv_mx, curv_my, dparams, axis_x,
                 axis_y, edge_x, edge_y, settle_ex, settle_ey)
      || !rngk || !dx || !dy || !dz
      || (LTX_BEHAVIOR == 7 && (!u1 || !v1))
      || (LTX_SETTLE && (!spoly || !spoly_out))
      || (LTX_SALT && (!salt || !temp || !salt_out || !temp_out)))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const Args a = make_args(rtab, brows, params, dparams, rngk, nx, ny, us,
                           ws, nl, salt0, vtransform, 1, n_iter, open_exits,
                           s_max);
  const Settle sg = make_settle(settle_d, settle_i, n_poly, vmax_poly,
                                cmax_poly, n_hole, vmax_hole, cmax_hole, a.C);
  const Curv cv = make_curv(curv_xy, curv_seed, curv_mx, curv_my, curv_rx0,
                            curv_ry0, curv_inv_rdx, curv_inv_rdy, curv_tol2);
  const Axes ax = {axis_x, axis_y, edge_x, edge_y, settle_ex, settle_ey};
  const Disp d = {dx, dy, dz, u1, v1};
  const int blocks = (n + K3_BLOCK - 1) / K3_BLOCK;
  step_lanes_kernel<LTX_HTURB, LTX_VTURB, LTX_BEHAVIOR, LTX_SETTLE, LTX_SALT>
      <<<blocks, K3_BLOCK, 0, (cudaStream_t)stream>>>(
          a, sg, cv, d, n, x, y, z, dob, age, pid, status, spoly, salt, temp,
          x_out, y_out, z_out, age_out, st_out, hitl_out, hitb_out,
          spoly_out, salt_out, temp_out, ax);
  return (int)cudaGetLastError();
}
