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
// Corners.  Every lane read is one of the step's time-collapsed tables,
// blended at a stencil located in device memory (the Tables source): zeta
// and h from the route's stage value tables at t and t + idt (the tables
// K2 reads), the Aks and salt lanes at t (Visser, the 4/5 cue) and the
// salt and temp lanes at t + idt (SaltTempOn) from the step's aux tables,
// which the route collapses with the step's polintd weights once per
// internal step (ltjax_torch.kernels.step_lanes.aux_tables), only those
// the variant reads.  A lane read is 4 corner loads of one table.  No
// staging: a launch reads a few columns of a particle, one internal step
// each.
//
// Per launch.  The static params (head, ladders, P_PDIE) are built once
// per context, configuration and positions' dtype and stay on the
// device; the step's start t, behavior 3's surface irradiance, the seed
// words and the step index come as arguments by value, and each block
// derives the step's 5 key pairs (HTURB .. DEATH: rng.stream_key(seed,
// step, substream), the Threefry of lanes.cuh) into shared memory.  A
// launch allocates nothing, copies nothing from the host and does not
// synchronize.
//
// Variants follow ext_step.cu's flags (LTX_HTURB, LTX_VTURB 0/1/2,
// LTX_BEHAVIOR 0-7, LTX_SETTLE, LTX_SALT, LTX_CURV, LTX_POS64, LTX_AXES,
// LTX_TILE); mortality is always the DEATH draw (the per-step route is
// stochastic mortality's), and every draw equals the plain version's bit
// for bit.
//
// What bounds it.  Per particle it reads its state (x, y, z, dob, age,
// pid, status; settle_poly, salt, temp where the variant carries them) and
// K2's 3 or 5 outputs and writes 7-10 columns: 64-96 bytes at float32.
// The corner reads (zeta and h at the stage-1 and the new position: 2 x 2
// lanes; the Aks column ws, the salt column us, salt and temp 2us, 4
// corners each) come mostly from L2 on a sorted batch.  Counted operations
// (Threefry words at the f32 rate, a reflection pass, the vertical fits)
// are ~500-2,500 a particle, so at 1M particles the bytes (20-30 us at
// 3.35 TB/s) and the operations (8-70 us at 67 TFLOP/s) are of one order;
// chip_smoke.py's lanes bound takes the larger.  Measured at 1M (H100
// 80GB HBM3, 700 W, tools/lanes_limiter_ab.py): where the variant fits
// (Visser, the 4/5 cue, SaltTempOn) the fits' dependent sweeps with their
// IEEE divides take 84% of the time, at a tenth of the operations bound;
// the builds that fit nothing run at ~40% of the bytes bound, and neither
// the key derivation nor the launch bounds move them.

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

// the scalar fits' scratch (Visser, the 4/5 cue, SaltTempOn): three
// columns of max(us, ws) words a thread in dynamic shared memory, where
// the float32 builds that fit run 5.8% faster than with three
// MAX_LEVELS arrays in local memory (the oyster build at 1M, H100 80GB
// HBM3, 700 W: tools/lanes_limiter_ab.py smem_scratch); the builds that
// fit nothing keep no scratch, the float64 ones their local arrays
#define K3_FITS (LTX_VTURB == 2 || LTX_SALT || LTX_BEHAVIOR == 4 \
                 || LTX_BEHAVIOR == 5)
#define K3_SHARED_SCRATCH (K3_FITS && !LTX_POS64)

// key words of the step: the pairs of substreams 0-4 (lanes.cuh HTURB ..
// DEATH), read as internal step 0
#define K3_STRIDE 10
#define K3_SUBSTREAMS 5

// lane k of a table of w lanes a cell, blended at stencil s (r00: the
// cell of corner 00, located with stride 1)
__device__ __forceinline__ float table_lane(const float* __restrict__ tab,
                                            int w, int nx, const Stencil& s,
                                            int k) {
  const float* r = tab + s.r00 * w + k;
  const long long dn = (long long)nx * w;
  return blend(s, __ldg(r), __ldg(r + w), __ldg(r + dn), __ldg(r + dn + w));
}

// find_currents.cuh's corner source of one of the step's aux tables: lane
// k of the record layout (Aks from nv, salt from salt0, temp after it) is
// column k - lo of the table's w
struct TableRec {
  const Args& a;
  const float* tab;
  int w, lo;
  __device__ __forceinline__ float lane(const Stencil& s, int k) const {
    return table_lane(tab, w, a.nx, s, k - lo);
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

// the step's tables: the stage value tables at t and t + idt (nv lanes a
// cell), the aux tables at t (w0 lanes from record lane lo0) and at
// t + idt (w2 from lo2), null where the variant reads none
struct Tabs {
  const float* zh0;
  const float* zh2;
  const float* aux0;
  const float* aux2;
};

// the corner source of step_lanes: every stencil located in device
// memory (stride 1), zeta and h from the stage value tables, the Aks,
// salt and temp lanes from the aux tables; behavior 3's surface
// irradiance of the step
struct Tables {
  const Args& a;
  const Curv& cv;
  const Axes& ax;
  const Tabs& tb;
  int w0, lo0, w2, lo2;
  pos_t irr;
  __device__ __forceinline__ Stencil at(pos_t x, pos_t y, int) const {
    int i, j;
    return locate(a, cv, ax, x, y, i, j);
  }
  __device__ __forceinline__ float lane(const Stencil& s, int q,
                                        int k) const {
    return table_lane(q == 0 ? tb.zh0 : tb.zh2, a.nv, a.nx, s, k);
  }
  __device__ __forceinline__ TableRec rec(int q) const {
    return q == 0 ? TableRec{a, tb.aux0, w0, lo0}
                  : TableRec{a, tb.aux2, w2, lo2};
  }
  __device__ __forceinline__ pos_t e0(int) const { return irr; }
};

// the per-launch values, by value: the step's start t, behavior 3's
// surface irradiance at t (both in float64, rounded to pos_t as the
// plain version's scalars are), the seed words and the step index
struct Step {
  double t, e0;
  uint32_t k0, k1, step;
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
step_lanes_kernel(Args a, Settle sg, Curv cv, Disp d, Tabs tb, Step sv,
                  int n, const pos_t* __restrict__ x_in,
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
  // the step's key pairs, one substream a thread: rng.stream_key
  __shared__ uint32_t keys[K3_STRIDE];
  if (threadIdx.x < K3_SUBSTREAMS) {
    uint32_t x0 = sv.step, x1 = threadIdx.x;
    threefry2x32(sv.k0, sv.k1, x0, x1);
    keys[2 * threadIdx.x] = x0;
    keys[2 * threadIdx.x + 1] = x1;
  }
  __syncthreads();
  a.rngk = keys;
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
  const pos_t t = (pos_t)sv.t, idt = par[P_IDT];
  if (st == NOT_RELEASED && t >= dob) st = ACTIVE;
  pos_t age = age_pre;
  if (st >= ACTIVE) age = (t + idt) - dob;
  int hitl = 0, hitb = 0;
  if (st == ACTIVE) {
    TensionT<pos_t> Ts;      // Visser, the 4/5 cue, salt/temp (ext_step.cu)
    Ts.sigma = par[P_SIGMA];
    Ts.small = POS_SMALL;
    Ts.cubic = false;
#if K3_SHARED_SCRATCH
    // the fits' columns in shared memory, the block's threads side by
    // side (sized by the launch)
    extern __shared__ unsigned char k3_smem[];
    const int lv = a.us > a.ws ? a.us : a.ws;
    pos_t* col = reinterpret_cast<pos_t*>(k3_smem) + threadIdx.x;
    const Column<pos_t, K3_BLOCK> cq{col}, dq0{col + K3_BLOCK * lv},
        dq1{col + 2 * K3_BLOCK * lv};
#else
    constexpr int FIT = VT == 2 || SALT || BEH == 4 || BEH == 5
                            ? MAX_LEVELS : 1;
    pos_t cq[FIT], dq0[FIT], dq1[FIT];
#endif
    const pos_t u1 = BEH == 7 ? d.u1[p] : pos_t(0);
    const pos_t v1 = BEH == 7 ? d.v1[p] : pos_t(0);
    // record lanes: Aks from nv, salt from salt0 (after the Aks), temp
    // after the salt; the aux table at t holds those the variant reads at
    // t, the one at t + idt salt and temp
    constexpr bool CUE = BEH == 4 || BEH == 5;
    const int w0 = (VT == 2 ? a.ws : 0) + (CUE ? a.us : 0);
    const int lo0 = VT == 2 ? a.nv : a.salt0;
    step_lanes<HT, VT, BEH, 2, SETTLE, SALT>(
        Tables{a, cv, ax, tb, w0, lo0, 2 * a.us, a.salt0, (pos_t)sv.e0}, a,
        sg, cv, ax, Ts, cq, dq0, dq1, K3_STRIDE, 0, (uint32_t)pid_in[p],
        age_pre, u1, v1, d.dx[p], d.dy[p], d.dz[p], x, y, z, st, spoly, salt,
        temp, hitl, hitb);
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
// was compiled for (LTX_* macros).  zh0, zh2: the stage value tables at t
// and t + idt ((Ny*Nx, nv) float32, the route's, K2's); aux0: the aux
// table at t, (Ny*Nx, w0) with the ws Aks lanes (LTX_VTURB 2) then the us
// salt lanes (behaviors 4/5), null without them; aux2: at t + idt, (Ny*Nx,
// 2us) salt then temp (LTX_SALT), else null.  params/dparams: the static
// head (P_PDIE the step's death probability) and ladders, float32 and
// (LTX_POS64) float64; t the step's start and e0 behavior 3's surface
// irradiance at t; k0, k1 the seed words and step the step index of the
// random draws.  Then K2's outputs dx, dy, dz (pos_t) and, for behavior 7,
// u1, v1, and ext_step.cu's ltx_ext_step's tables.  age/age_out are always
// read/written; spoly, salt and temp and their outputs only where the
// variant carries them.  Returns the launch's cudaError_t.
extern "C" int ltx_step_lanes(
    const float* zh0, const float* zh2, const float* aux0, const float* aux2,
    const pos_t* brows, const float* params, const double* dparams,
    double t, double e0, uint32_t k0, uint32_t k1, uint32_t step,
    const pos_t* x, const pos_t* y, const pos_t* z, const pos_t* dob,
    const pos_t* age, const int* pid, const int* status, const int* spoly,
    const pos_t* salt, const pos_t* temp, const pos_t* dx, const pos_t* dy,
    const pos_t* dz, const pos_t* u1, const pos_t* v1, pos_t* x_out,
    pos_t* y_out, pos_t* z_out, pos_t* age_out, int* st_out, int* hitl_out,
    int* hitb_out, int* spoly_out, pos_t* salt_out, pos_t* temp_out,
    const double* settle_d, const int* settle_i, int n, int nx, int ny,
    int us, int ws, int vtransform, int n_iter, int open_exits, int s_max,
    int n_poly, int vmax_poly, int cmax_poly, int n_hole, int vmax_hole,
    int cmax_hole, const pos_t* curv_xy, const int* curv_seed, int curv_mx,
    int curv_my, double curv_rx0, double curv_ry0, double curv_inv_rdx,
    double curv_inv_rdy, double curv_tol2, const pos_t* axis_x,
    const pos_t* axis_y, const pos_t* edge_x, const pos_t* edge_y,
    const double* settle_ex, const double* settle_ey, void* stream) {
  // the record layout of the lanes the variant reads (lanes.cuh)
  const bool cue = LTX_BEHAVIOR == 4 || LTX_BEHAVIOR == 5;
  const int nv = 2 * us + ws + 2;
  const int aks0 = LTX_VTURB == 2 ? nv : -1;
  const int salt0 = (LTX_SALT || cue) ? (aks0 >= 0 ? nv + ws : nv) : -1;
  const int nl = salt0 >= 0 ? salt0 + 2 * us : (aks0 >= 0 ? nv + ws : nv);
  if (bad_tables(us, ws, nl, aks0, salt0, n_poly, settle_d, settle_i,
                 curv_xy, curv_seed, curv_mx, curv_my, dparams, axis_x,
                 axis_y, edge_x, edge_y, settle_ex, settle_ey)
      || !zh0 || !zh2 || !params || !dx || !dy || !dz
      || (LTX_VTURB == 2 || cue) != (aux0 != nullptr)
      || (LTX_SALT != 0) != (aux2 != nullptr)
      || (LTX_BEHAVIOR == 7 && (!u1 || !v1))
      || (LTX_SETTLE && (!spoly || !spoly_out))
      || (LTX_SALT && (!salt || !temp || !salt_out || !temp_out)))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  // stencils at stride 1 (r00: the cell), keys set per block
  const Args a = make_args(nullptr, brows, params, dparams, nullptr, nx, ny,
                           us, ws, 1, salt0, vtransform, 1, n_iter,
                           open_exits, s_max);
  const Settle sg = make_settle(settle_d, settle_i, n_poly, vmax_poly,
                                cmax_poly, n_hole, vmax_hole, cmax_hole, a.C);
  const Curv cv = make_curv(curv_xy, curv_seed, curv_mx, curv_my, curv_rx0,
                            curv_ry0, curv_inv_rdx, curv_inv_rdy, curv_tol2);
  const Axes ax = {axis_x, axis_y, edge_x, edge_y, settle_ex, settle_ey};
  const Disp d = {dx, dy, dz, u1, v1};
  const Tabs tb = {zh0, zh2, aux0, aux2};
  const Step sv = {t, e0, k0, k1, step};
  const int blocks = (n + K3_BLOCK - 1) / K3_BLOCK;
  const size_t smem = K3_SHARED_SCRATCH
                          ? 3 * K3_BLOCK * sizeof(pos_t) * (us > ws ? us : ws)
                          : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        step_lanes_kernel<LTX_HTURB, LTX_VTURB, LTX_BEHAVIOR, LTX_SETTLE,
                          LTX_SALT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  step_lanes_kernel<LTX_HTURB, LTX_VTURB, LTX_BEHAVIOR, LTX_SETTLE, LTX_SALT>
      <<<blocks, K3_BLOCK, smem, (cudaStream_t)stream>>>(
          a, sg, cv, d, tb, sv, n, x, y, z, dob, age, pid, status, spoly,
          salt, temp, x_out, y_out, z_out, age_out, st_out, hitl_out,
          hitb_out, spoly_out, salt_out, temp_out, ax);
  return (int)cudaGetLastError();
}
