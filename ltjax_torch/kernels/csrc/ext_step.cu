// Whole-external-step kernel for Hopper (sm_90a).
//
// Replaces ltjax/kernels/ext_step.py::ext_step_fused (the Pallas TPU
// megakernel) in its advection, turbulence, behavior, mortality,
// settlement and salt lanes: DOB release, four RK4 find_currents stages
// per internal step (quadratic time collapse of the three raw records,
// bilinear blend, natural tension-spline fit and clamped evaluation of
// u/v on the rho ladder and w on the w ladder, log-layer decay of u/v),
// horizontal random walk and Visser vertical random displacement on
// in-kernel Threefry-2x32 streams, behaviors 1-7 (4/5 cue on the spline
// derivative of the salt profile), horizontal specular reflection with
// open boundary exits and the tunnel/displacement guards of
// ltjax.physics.boundary.reflect, vertical reflection about zeta/h at
// t+idt, deterministic death, settlement on habitat polygons with holes
// (the exact ray-casting test of ltjax.physics.settlement, in double),
// salt and temperature sampled at the new position (SaltTempOn), and the
// status lattice.  Under LTX_CURV (the TPU kernel's curv_mode, K1f) every
// lane runs on a curvilinear grid: each cell location is the inverse
// bilinear map of ltjax.grid.curv_logical (seed raster + 3 Newton steps),
// boundary cells are floor(ti + 0.5) and the inside test is the map's
// residual, so reflection on the curved psi-mesh segments happens in the
// kernel (the TPU kernel defers every particle near a boundary to its
// exact patch; this one has no patch and defers nothing).
//
// Variants.  The options are compile-time macros (LTX_HTURB, LTX_VTURB
// 0 off / 1 constant / 2 Aks, LTX_BEHAVIOR, LTX_MORTALITY, LTX_SETTLE,
// LTX_SALT, LTX_CURV, LTX_POS64, LTX_AXES; the wrapper builds one library
// per combination), so each configuration carries only its own lanes;
// with all of them 0 the kernel is the advection kernel alone.
// LTX_POS64 (dtype_pos = "float64") makes the particle state pos_t =
// double (find_currents.cuh): cell location, the RK4 sums, turbulence,
// behavior, reflection on f64 boundary rows, the vertical bounds, the age
// and the scalar fits (Visser, the 4/5 cue, SaltTempOn) run in f64, as
// the plain version runs them in the particles' dtype, while the
// tables' blend and find_currents' fits stay f32, as packed.py casts
// them; the f64 head scalars come in a params vector of their own
// (Args.dpar).  LTX_AXES locates cells by binary search on the rho axes
// (a grid whose axes are not uniform, grid.locate) and on the boundary
// cell edges (boundary.cell_of, settlement), each where it is not
// uniform: the two are tested with different tolerances (1e-9 and
// 1e-4), so the kernel takes each pair or its absence at run time
// (Axes, a kernel argument of its own).
//
// Design.  One thread per particle, LTX_BLOCK = 128 threads a block, one
// launch per external step; the n_int internal steps run inside the
// thread with x, y, z, status (and the age, where behavior or mortality
// read it) in registers.  find_currents.cuh (shared with rk4_step.cu)
// fits and evaluates; every lane read of a step goes through the staged
// corner source below: at the top of each internal step the block
// reduces the box of its active particles' stage-1 cells, and when the
// box (grown by a cell on each side) holds at most tile_points rho
// points it collapses the three raw records into three shared-memory
// tiles (t, t + idt/2, t + idt) of every lane of the table, once per
// point (stage_records: each box row is bw * nl consecutive floats of a
// record, so the loads are coalesced; 4-byte loads, no 16-byte ones).
// The fit scratch stays in local memory: its frame size measured no
// cost.  __launch_bounds__(128, 4): every float32 variant at <= 128
// registers with no spills, where ptxas alone chose 96 with spills in 6
// variants; measured, the bound makes the advect and behavior cells 4-5%
// faster at 1M particles and 15-23% at 65,536, turb 1-5% slower.  The
// float64 variants' bound is LTX_MIN_BLOCKS below (measured too).
// The four RK4 stages, the Visser Aks fit, the behavior column and the
// 4/5 salt cue (stage 1), the vertical reflection's column and SaltTempOn
// (t + idt) then blend 4 shared words per lane where the global path
// loads 12 scattered ones.  A lookup outside the box and every lookup of
// a block whose box is too large read the raw records with the same
// arithmetic (collapse, blend), and are counted (staged_misses,
// global_block_steps, beside staged_block_steps): the result does not
// depend on which path a lookup took.  The inverse curvilinear map, the
// boundary rows and the polygons stay direct reads.  The TPU kernel's
// VMEM windows, one-hot MXU blends and out-of-window patch are not
// ported: a miss is served in the kernel.  The vertical fit streams the
// levels: knots and blended values are computed level by level inside
// the Thomas forward sweep, so only the sweep's cp/dp columns live in
// local memory (MAX_LEVELS floats each); the evaluation interval is
// captured on the fly and the backward sweep stops there.  The Visser
// term needs the Aks spline's derivative at z and its value at z_mid, an
// interval known only after the derivative: its fit keeps the whole z2
// column and the knots in those same local arrays and evaluates twice.
//
// Random streams.  The host passes the derived key pair of every
// (internal step, substream) (ext_step.py rng_keys_array, the words of
// ltjax.rng.stream_key); each thread runs Threefry-2x32 on (pid, 0), so
// the draws equal ltjax's and the plain version's bit for bit.  The
// Box-Muller and uniform maps use logf/cosf/sinf/sqrtf (no fast-math
// intrinsics).
//
// Settlement.  The TPU kernel settles in-kernel only in cells that lie
// fully inside one polygon and defers rim and hole cells to its exact
// out-of-window patch.  This kernel has no patch and no window: every
// eligible particle walks its cell's candidate list and ray-casts each
// candidate's edges in double on its position (f32 ones promoted), as
// test_settlement does on the f64 vertices, so both versions decide
// alike on equal positions.
//
// What bounds it.  Without staging every stage gathers 4 x 3 x nv
// scattered floats (nv = 2us+ws+2; ~3 KB per stage at us =
// 20), 12 loads per lane, each warp load touching as many cache lines as
// its threads have distinct corner rows; so built, the kernel ran at 5-7%
// of its bound (operations, an IEEE divide of the Thomas sweeps counted
// as one).  Staged, a block-step loads its box once (points x nl x 3 records,
// ~40 floats a thread on the bench grid's sorted blocks) and the stages
// read shared memory; what is left is the spline arithmetic (~15k f32
// operations a particle-step, two dependent Thomas recurrences per
// stage), the fit scratch in local memory, and the misses.  Shared
// memory: 3 x tile_points x (nl | 1) x 4 bytes a block (27 KB for
// advection at 36 points, 48 KB for the oyster lanes at 32), beside 128
// bytes of static reduction scratch; at 4 blocks of 128 threads an SM
// (the register limit) the tiles leave the rest of the SM's 256 KB to L1.
// The record table is 3*Ny*Nx*nl*4 bytes: 30 MB for the 200x200x20 bench
// grid (40 MB with Aks, 49 MB with salt and temp), which fits the 50 MB
// L2; a production 800x600x25 grid (~420 MB) does not, and then the
// staging loads come from device memory.  A curvilinear grid adds an
// inverse-map solve to every cell location (4 stages, the vertical
// reflection's column, each reflection pass and the two inside tests:
// ~9-11 per internal step), each 3 Newton steps of 4 float2 corner loads
// and ~60 f32 operations; the map itself recomputes from the raster seed
// every time, as the plain version does.  Settlement adds, per eligible
// particle and internal step, its cell's candidate polygons: a few KB of
// f64 vertices in all.  The caller's Hilbert sort (once per
// ext_sort_every external steps) is what makes a block's box small.
//
// Arithmetic mirrors the plain PyTorch version (ltjax_torch.packed,
// .physics.turb, .physics.behavior and .physics.boundary) operation for
// operation: IEEE divides (not reciprocals), the same collapse-then-blend
// order and the same small-tension series; differences are f32
// round-off and FMA contraction.

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
#ifndef LTX_MORTALITY
#define LTX_MORTALITY 0
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
  P_HEAD = 32                          // then s_rho, Cs_r, s_w, Cs_w,
                                       // then 9 polintd weights per step,
                                       // then (type 3) E0 per step
};

enum { NOT_RELEASED = 0, ACTIVE = 1, SETTLED = 2, DEAD = 3,
       OUT_OF_DOMAIN = 4, ERROR = 5 };
enum { HTURB = 0, VTURB = 1, BEHAVE = 2, MORTALITY = 3 };  // substreams
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

// ---- the staged corner source ------------------------------------------
//
// At the top of each internal step a block reduces the rho-cell bounding
// box of its active particles' stage-1 positions (block_box), grows it by
// one cell on each side (a stage moves a particle by less than a cell at
// the speeds of the bench cases: 4.2 m/s x 120 s = 0.5 km on 1 km cells)
// and, if its points fit the launch's budget (Stage::points), writes
// three tiles into dynamic shared memory, one per stage time (t,
// t + idt/2, t + idt), each point and lane the three raw records
// collapsed once (collapse(), the arithmetic of the global path).  A tile
// is [row][column][lane], ls = nl | 1 floats per point (odd, so the
// distinct points that a warp reads fall in distinct banks; threads of
// one point read one word, a broadcast), rows bw points wide; the three
// tiles are Stage::ts floats apart.

// the bilinear blend of four corner values (every corner source)
__device__ __forceinline__ float blend(const Stencil& s, float c00, float c01,
                                       float c10, float c11) {
  return (c00 * (1.0f - s.fx) + c01 * s.fx) * (1.0f - s.fy)
         + (c10 * (1.0f - s.fx) + c11 * s.fx) * s.fy;
}

// threads a block (the launch's); not an #ifndef option: build.tag reads
// those as the variant's macros
#define LTX_BLOCK 128

// the staged rho points [i0, i0 + bw) x [j0, j0 + bh) of a block's tiles;
// bw = 0: nothing staged
struct Box {
  int i0, j0, bw, bh;
};

enum { BOX_EMPTY = 0, BOX_STAGED = 1, BOX_GLOBAL = 2 };

// the box of the cells (i, j) of the block's active threads (act), grown
// by one cell on each side and clipped to the nx x ny points; staged
// (bw > 0) if it holds at most max_points points.  kind: BOX_EMPTY (no
// active thread), BOX_STAGED or BOX_GLOBAL.  Every thread of the block
// calls it (it holds a barrier); red is 2 x 4 x LTX_BLOCK/32 ints of
// shared memory, used by half per call (parity), so that the next call
// may write the other half while a slow warp still reads this one.
__device__ __forceinline__ Box block_box(bool act, int i, int j, int nx,
                                         int ny, int max_points, int* red,
                                         int parity, int& kind) {
  constexpr int NW = LTX_BLOCK / 32;
  const unsigned full = 0xffffffffu;
  const int big = 0x7fffffff;
  int v0 = __reduce_min_sync(full, act ? i : big);
  int v1 = __reduce_min_sync(full, act ? -i : big);
  int v2 = __reduce_min_sync(full, act ? j : big);
  int v3 = __reduce_min_sync(full, act ? -j : big);
  int* r = red + parity * 4 * NW;
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    r[w] = v0;
    r[NW + w] = v1;
    r[2 * NW + w] = v2;
    r[3 * NW + w] = v3;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    v0 = min(v0, r[k]);
    v1 = min(v1, r[NW + k]);
    v2 = min(v2, r[2 * NW + k]);
    v3 = min(v3, r[3 * NW + k]);
  }
  Box b = {0, 0, 0, 0};
  if (v0 == big) {
    kind = BOX_EMPTY;
    return b;
  }
  b.i0 = max(v0 - 1, 0);
  b.j0 = max(v2 - 1, 0);
  const int bw = min(2 - v1, nx - 1) - b.i0 + 1;
  const int bh = min(2 - v3, ny - 1) - b.j0 + 1;
  kind = bw * bh <= max_points ? BOX_STAGED : BOX_GLOBAL;
  if (kind == BOX_STAGED) {
    b.bw = bw;
    b.bh = bh;
  }
  return b;
}

// stencil s of cell (i, j) into the tiles of box b (tile_lanes ls), or
// a miss: counted when the block staged
__device__ __forceinline__ void stage_in(Stencil& s, const Box& b, int i,
                                         int j, int ls, int& miss) {
  const int di = i - b.i0, dj = j - b.j0;
  if (di >= 0 && di + 1 < b.bw && dj >= 0 && dj + 1 < b.bh) {
    s.t = (dj * b.bw + di) * ls;
    s.rs = b.bw * ls;
  } else if (b.bw > 0) {
    ++miss;
  }
}

// the launch's staging counters: staged_block_steps, global_block_steps,
// staged_misses (one atomic per block and warp at the kernel's end; every
// thread calls it)
__device__ __forceinline__ void count_staging(unsigned long long* cnt,
                                              int staged, int global,
                                              int miss) {
  const int m = __reduce_add_sync(0xffffffffu, miss);
  if ((threadIdx.x & 31) == 0 && m > 0)
    atomicAdd(cnt + 2, (unsigned long long)m);
  if (threadIdx.x == 0) {
    if (staged > 0) atomicAdd(cnt, (unsigned long long)staged);
    if (global > 0) atomicAdd(cnt + 1, (unsigned long long)global);
  }
}

// the launch's staged corner source: a kernel argument of its own, like
// Settle
struct Stage {
  unsigned long long* cnt;   // staged_block_steps, global_block_steps,
                             // staged_misses
  int points;                // rho points a block may stage (tile_points)
  int ls, ts;                // tile_lanes (nl | 1); floats between tiles
};

extern __shared__ float ltx_tiles[];   // three tiles of Stage::ts floats

// the cell (i, j) and stencil of (x, y), not staged: the inverse map on a
// curvilinear grid, a binary search on rho axes that are not uniform
// (LTX_AXES), else arithmetic
__device__ __forceinline__ Stencil locate(const Args& a, const Curv& cv,
                                          const Axes& ax, pos_t x, pos_t y,
                                          int& i, int& j) {
#if LTX_CURV
  return locate_curv(cv, a.nx, a.ny, a.nl, x, y, i, j);
#else
#if LTX_AXES
  if (ax.xr)
    return locate_searched(ax.xr, ax.yr, a.nx, a.ny, a.nl, x, y, i, j);
#endif
  return locate_rect(ppar(a), a.nx, a.ny, a.nl, x, y, i, j);
#endif
}

// the stencil of (x, y) in the tiles of box b, or a (counted) miss
__device__ __forceinline__ Stencil locate(const Args& a, const Stage& sp,
                                          const Curv& cv, const Axes& ax,
                                          const Box& b, pos_t x, pos_t y,
                                          int& miss) {
  int i, j;
  Stencil s = locate(a, cv, ax, x, y, i, j);
  stage_in(s, b, i, j, sp.ls, miss);
  return s;
}

// one record triple collapsed with the polintd weights l of a stage
// (the staged and the global path alike)
__device__ __forceinline__ float collapse(float v0, float v1, float v2,
                                          const float* l) {
  return fmaf(v2, l[2], fmaf(v1, l[1], v0 * l[0]));
}

// lane k of the table collapsed to stage time q (weights l + 3q: t,
// t + idt/2, t + idt), blended at stencil s: from the tiles where s is
// staged, else from the raw records
__device__ __forceinline__ float lane(const Args& a, const Stage& sp,
                                      const Stencil& s, const float* l,
                                      int q, int k) {
  if (s.t >= 0) {
    const float* t = ltx_tiles + q * sp.ts + s.t + k;
    return blend(s, t[0], t[sp.ls], t[s.rs], t[s.rs + sp.ls]);
  }
  const long long R = a.C * a.nl;
  const float* t0 = a.rtab + k;
  const float* t1 = t0 + R;
  const float* t2 = t1 + R;
  const float* w = l + 3 * q;
  const long long r01 = s.r00 + a.nl;
  const long long r10 = s.r00 + (long long)a.nx * a.nl;
  const long long r11 = r10 + a.nl;
  return blend(s, collapse(t0[s.r00], t1[s.r00], t2[s.r00], w),
               collapse(t0[r01], t1[r01], t2[r01], w),
               collapse(t0[r10], t1[r10], t2[r10], w),
               collapse(t0[r11], t1[r11], t2[r11], w));
}

// the three tiles of box b: at every point and lane the raw records
// collapsed with the weights of stage q = 0, 1, 2 (l + 3q).  Each box row
// is bw * nl consecutive floats of every record: coalesced loads.
__device__ void stage_records(const Args& a, const Stage& sp, const Box& b,
                              const float* l) {
  const long long R = a.C * a.nl;
  const int span = b.bw * a.nl;
  for (int r = 0; r < b.bh; ++r) {
    const float* src = a.rtab + ((long long)(b.j0 + r) * a.nx + b.i0) * a.nl;
    float* dst = ltx_tiles + r * b.bw * sp.ls;
    for (int e = threadIdx.x; e < span; e += LTX_BLOCK) {
      float* d = dst + e + (e / a.nl) * (sp.ls - a.nl);   // point, lane
      const float v0 = src[e], v1 = src[e + R], v2 = src[e + 2 * R];
      d[0] = collapse(v0, v1, v2, l);
      d[sp.ts] = collapse(v0, v1, v2, l + 3);
      d[2 * sp.ts] = collapse(v0, v1, v2, l + 6);
    }
  }
}

// the corner source of find_currents_at: stage q of the internal step
// whose weights start at l (lane above)
struct Records {
  const Args& a;
  const Stage& sp;
  const float* l;
  int q;
  __device__ __forceinline__ float lane(const Stencil& s, int k) const {
    return ::lane(a, sp, s, l, q, k);
  }
  // the knot depth in the positions' type (the fit rounds it to its own)
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

// find_currents at (x, y, z) on stage q of the internal step (weights l)
__device__ void find_currents(const Args& a, const Stage& sp, const Curv& cv,
                              const Axes& ax, const Tension& T, const Box& b,
                              const float* l, int q, pos_t x, pos_t y,
                              pos_t z, float* cp, float* dp0, float* dp1,
                              int& miss, pos_t& u, pos_t& v, pos_t& w) {
  find_currents_at(Records{a, sp, l, q}, T,
                   locate(a, sp, cv, ax, b, x, y, miss), z, cp, dp0, dp1, u,
                   v, w);
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
    j = search_right(ax.ye, a.ny + 1, y) - 1;
  } else
#endif
  {
    i = (int)m_floor((x - par[P_BX0]) / par[P_BDX]);
    j = (int)m_floor((y - par[P_BY0]) / par[P_BDY]);
  }
  i = min(max(i, 0), a.nx - 1);
  j = min(max(j, 0), a.ny - 1);
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
__device__ int settle_id(const Settle& sg, const Axes& ax, int nx, int ny,
                         pos_t x, pos_t y) {
  const double px = (double)x, py = (double)y;
  int i, j;
#if LTX_AXES
  if (ax.sxe) {
    i = min(max(search_right(ax.sxe, nx + 1, px) - 1, 0), nx - 1);
    j = min(max(search_right(ax.sye, ny + 1, py) - 1, 0), ny - 1);
  } else
#endif
  {
    i = (int)fmin(fmax(floor((px - sg.edge[0]) / sg.edge[1]), 0.0),
                  (double)(nx - 1));
    j = (int)fmin(fmax(floor((py - sg.edge[2]) / sg.edge[3]), 0.0),
                  (double)(ny - 1));
  }
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
__device__ pos_t aks_eval(const Args& a, const Stage& sp,
                          const TensionT<pos_t>& T, const Stencil& st,
                          const float* l, const pos_t* zk, const pos_t* z2,
                          int K, pos_t zq, bool deriv) {
  zq = m_min(m_max(zq, zk[0]), zk[K - 1]);
  int j = 0;
  for (int k = 1; k < K; ++k) j += zq >= zk[k] ? 1 : 0;
  j = min(j, K - 2);
  pos_t x0 = zk[j], x1 = zk[j + 1];
  pos_t y0 = m_max((pos_t)lane(a, sp, st, l, 0, a.nv + j), pos_t(0));
  pos_t y1 = m_max((pos_t)lane(a, sp, st, l, 0, a.nv + j + 1), pos_t(0));
  pos_t h = x1 - x0;
  pos_t B2 = (zq - x0) / h;
  pos_t B1 = pos_t(1) - B2;
  if (deriv)
    return (y1 - y0) / h + h * (z2[j] * ds_fn(T, B1) - z2[j + 1] * ds_fn(T, B2));
  return y0 * B1 + y1 * B2 + h * h * (z2[j] * gs_fn(T, B1)
                                      + z2[j + 1] * gs_fn(T, B2));
}

// dz = K'(z) idt + R sqrt(2 K(z_mid) idt / (1/3)) on the Aks lanes (after
// the nv value lanes) blended at stencil st at stage 1 (weights l);
// physics.turb.vturb: Aks clipped at >= 0 before a natural tension fit
// on the w ladder, z_mid = clip(z + K' idt / 2) to the knot range.
__device__ pos_t visser_dz(const Args& a, const Stage& sp, pos_t sigma,
                           const Stencil& st, const float* l, pos_t zeta,
                           pos_t h, pos_t z, pos_t R, pos_t idt, pos_t* cp,
                           pos_t* z2, pos_t* zk) {
  TensionT<pos_t> T;         // tension.evaluate: series at sigma = 0
  T.sigma = sigma;
  T.small = POS_SMALL;
  T.cubic = false;
  const pos_t* par = ppar(a);
  const pos_t* s_w = par + P_HEAD + 2 * a.us;
  const pos_t* cs_w = s_w + a.ws;
  const int K = a.ws;
  pos_t zprev = knot_depth(par[P_HC], a.vt, s_w[0], cs_w[0], zeta, h);
  pos_t yprev = m_max((pos_t)lane(a, sp, st, l, 0, a.nv), pos_t(0));
  zk[0] = zprev;
  cp[0] = pos_t(0);
  z2[0] = pos_t(0);
  pos_t offp = pos_t(0), diap = pos_t(0), dyp = pos_t(0);
  for (int k = 1; k < K; ++k) {           // Thomas forward sweep
    pos_t zc = knot_depth(par[P_HC], a.vt, s_w[k], cs_w[k], zeta, h);
    pos_t yk = m_max((pos_t)lane(a, sp, st, l, 0, a.nv + k), pos_t(0));
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
  pos_t kprime = aks_eval(a, sp, T, st, l, zk, z2, K, z, true);
  pos_t zmid = m_min(m_max(z + pos_t(0.5) * kprime * idt, zk[0]), zk[K - 1]);
  pos_t kmid = m_max(aks_eval(a, sp, T, st, l, zk, z2, K, zmid, false),
                     pos_t(0));
  return kprime * idt
         + R * m_sqrt(pos_t(2) * kmid * idt / (pos_t(1) / pos_t(3)));
}

// blocks of 128 threads an SM that __launch_bounds__ asks for: 4 (at most
// 128 registers) for the float32 variants.  The float64 ones (LTX_POS64)
// carry twice the position registers; measured (tools/bounds_ab.py pos64,
// kernel ms at 1M, H100 80GB HBM3, 700 W), 4 blocks with spills beat 3
// without: advect 88.05 against 97.29 ms (2 blocks: 133.70), behavior
// 85.05 / 95.99, turb 120.62 / 124.25, but salt 139.98 / 130.94 (452 B
// of spill loads at 4), so the SaltTempOn builds ask for 3.
#ifndef POS64_MIN_BLOCKS
#if LTX_SALT
#define POS64_MIN_BLOCKS 3
#else
#define POS64_MIN_BLOCKS 4
#endif
#endif
#if LTX_POS64
#define LTX_MIN_BLOCKS POS64_MIN_BLOCKS
#else
#define LTX_MIN_BLOCKS 4
#endif

template <int HT, int VT, int BEH, int MORT, int SETTLE, int SALT>
__global__ void __launch_bounds__(LTX_BLOCK, LTX_MIN_BLOCKS)
ext_step_kernel(Args a, Settle sg, Curv cv, Stage sp, int n,
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
                int* __restrict__ st_out,
                int* __restrict__ hitl_out, int* __restrict__ hitb_out,
                int* __restrict__ spoly_out, pos_t* __restrict__ salt_out,
                pos_t* __restrict__ temp_out, Axes ax) {
  // behaviors that swim read the age and draw BEHAVE/MORTALITY words;
  // settlement reads the age too (eligible from pediage on)
  constexpr bool SWIM = BEH >= 1 && BEH <= 5;
  constexpr bool AGE = MORT || SWIM || BEH == 7 || SETTLE;
  constexpr bool RNG = HT || VT != 0 || SWIM;
  constexpr int STRIDE = SWIM ? 8 : 4;    // key words per internal step
  __shared__ int red[2 * 4 * (LTX_BLOCK / 32)];
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = p < n;   // every thread reaches the staging barriers
  const pos_t* par = ppar(a);
  Tension T;                 // find_currents: float32 fits
  T.sigma = a.par[P_SIGMA];
  T.small = 0.5f;
  T.cubic = T.sigma == 0.0f;
  TensionT<pos_t> Ts;        // Visser, the 4/5 cue, salt/temp: tension
  Ts.sigma = par[P_SIGMA];   // .evaluate's series at sigma = 0, in the
  Ts.small = POS_SMALL;      // particles' dtype, as the plain version
  Ts.cubic = false;
  float cp[MAX_LEVELS], dp0[MAX_LEVELS], dp1[MAX_LEVELS];
#if LTX_POS64
  // the scratch of those fits in float64
  constexpr int FIT64 = VT == 2 || SALT || BEH == 4 || BEH == 5
                            ? MAX_LEVELS : 1;
  double cq[FIT64], dq0[FIT64], dq1[FIT64];
#else
  float* cq = cp;
  float* dq0 = dp0;
  float* dq1 = dp1;
#endif

  const int q = live ? p : 0;
  pos_t x = x_in[q], y = y_in[q], z = z_in[q], dob = dob_in[q];
  pos_t age = pos_t(0);
  if constexpr (AGE) age = age_in[q];
  uint32_t pid = 0u;
  if constexpr (RNG) pid = (uint32_t)pid_in[q];
  int st = live ? st_in[q] : -1;   // past the batch: never active
  int spoly = 0;
  if constexpr (SETTLE) spoly = spoly_in[q];
  pos_t salt = pos_t(0), temp = pos_t(0);
  if constexpr (SALT) { salt = salt_in[q]; temp = temp_in[q]; }
  int hitl = 0, hitb = 0;
  int miss = 0, blocks = 0;   // staged misses; block-steps staged + 2^16 x
                              // global (thread 0's count)
  const pos_t idt = par[P_IDT];
  const pos_t half = pos_t(0.5) * idt;
  const pos_t sixth = idt / pos_t(6);
  const float* coef = a.par + P_HEAD + 2 * (a.us + a.ws);
  const pos_t* pcoef = par + P_HEAD + 2 * (a.us + a.ws);

  for (int i = 0; i < a.n_int; ++i) {
    pos_t t_i = par[P_T0] + (pos_t)i * idt;
    if (st == NOT_RELEASED && t_i >= dob) st = ACTIVE;
    const pos_t age_pre = age;  // behavior, mortality, settlement read it
    if constexpr (AGE) {
      if (st >= ACTIVE) age = (t_i + idt) - dob;
    }
    const float* l = coef + 9 * i;        // stage weights: t, t+idt/2, t+idt
    // the block's box of stage-1 cells; its three tiles when it fits
    const bool act = st == ACTIVE;
    int ci = 0, cj = 0, kind;
    Stencil s1;
    if (act) s1 = locate(a, cv, ax, x, y, ci, cj);
    const Box box = block_box(act, ci, cj, a.nx, a.ny, sp.points, red, i & 1,
                              kind);
    if (kind == BOX_STAGED) {
      stage_records(a, sp, box, l);
      __syncthreads();
    }
    blocks += kind == BOX_STAGED ? 1 : kind == BOX_GLOBAL ? 1 << 16 : 0;
    if (!act) continue;
    stage_in(s1, box, ci, cj, sp.ls, miss);
    pos_t u1, v1, w1, u2, v2, w2, u3, v3, w3, u4, v4, w4;
    find_currents_at(Records{a, sp, l, 0}, T, s1, z, cp, dp0, dp1, u1, v1,
                     w1);
    find_currents(a, sp, cv, ax, T, box, l, 1, x + u1 * half, y + v1 * half,
                  z + w1 * half, cp, dp0, dp1, miss, u2, v2, w2);
    find_currents(a, sp, cv, ax, T, box, l, 1, x + u2 * half, y + v2 * half,
                  z + w2 * half, cp, dp0, dp1, miss, u3, v3, w3);
    find_currents(a, sp, cv, ax, T, box, l, 2, x + u3 * idt, y + v3 * idt,
                  z + w3 * idt, cp, dp0, dp1, miss, u4, v4, w4);
    pos_t dx = sixth * (u1 + pos_t(2) * u2 + pos_t(2) * u3 + u4);
    pos_t dy = sixth * (v1 + pos_t(2) * v2 + pos_t(2) * v3 + v4);
    pos_t dz = sixth * (w1 + pos_t(2) * w2 + pos_t(2) * w3 + w4);

    // --- turbulence ------------------------------------------------------
    if constexpr (HT) {
      uint32_t b0, b1;
      particle_bits(a, STRIDE, i, HTURB, pid, b0, b1);
      pos_t r = m_sqrt(pos_t(-2) * m_log(bits_to_uniform(b0)));
      pos_t th = (pos_t)(2.0 * 3.14159265358979) * bits_to_uniform(b1);
      dx = dx + r * m_cos(th) * par[P_HSCALE];
      dy = dy + r * m_sin(th) * par[P_HSCALE];
    }
    if constexpr (VT != 0) {
      uint32_t b0, b1;
      particle_bits(a, STRIDE, i, VTURB, pid, b0, b1);
      pos_t R = pos_t(-1) + pos_t(2) * bits_to_uniform(b0);
      if constexpr (VT == 1) {
        dz = dz + R * par[P_VCONST];
      } else {
        // Aks blended at the stage-1 position and time
        Stencil sv = locate(a, sp, cv, ax, box, x, y, miss);
        pos_t zeta1 = (pos_t)lane(a, sp, sv, l, 0, a.nv - 2);
        pos_t h1 = (pos_t)lane(a, sp, sv, l, 0, a.nv - 1);
        dz = dz + visser_dz(a, sp, Ts.sigma, sv, l, zeta1, h1, z, R, idt, cq,
                            dq0, dq1);
      }
    }

    // --- behavior (free surface and depth at stage 1) -----------------------
    if constexpr (BEH != 0) {
      pos_t bx = pos_t(0), by = pos_t(0), bz = pos_t(0);
      Stencil sb = locate(a, sp, cv, ax, box, x, y, miss);
      pos_t zeta_b = (pos_t)lane(a, sp, sb, l, 0, a.nv - 2);
      pos_t h_b = (pos_t)lane(a, sp, sb, l, 0, a.nv - 1);
      // ontogenetic swim speed at the pre-step age
      pos_t frac = m_min(m_max((age_pre - par[P_SWIMSTART]) / par[P_SWIMDEN],
                               pos_t(0)), pos_t(1));
      pos_t wsw = par[P_SWIMSLOW] + par[P_SWIMDIFF] * frac;
      wsw = age_pre >= par[P_SWIMSTART] ? wsw : pos_t(0);
      if constexpr (SWIM) {
        uint32_t b0, b1;
        particle_bits(a, STRIDE, i, BEHAVE, pid, b0, b1);
        pos_t r_dir = bits_to_uniform(b0);
        particle_bits(a, STRIDE, i, MORTALITY, pid, b0, b1);
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
          fit_eval<true>(Records{a, sp, l, 0}, Ts, sb, par + P_HEAD,
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
    Stencil s4 = locate(a, sp, cv, ax, box, x1, y1, miss);
    pos_t zeta = (pos_t)lane(a, sp, s4, l, 2, a.nv - 2);
    pos_t h = (pos_t)lane(a, sp, s4, l, 2, a.nv - 1);
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
    // deterministic death at the pre-step age: overrides a same-step
    // ERROR, not an exit (step.internal_step's order)
    if constexpr (MORT) {
      if (age_pre >= par[P_DEADAGE] && !exited) st = DEAD;
    }
    // settlement at the reflected position: a particle still ACTIVE
    // after the exit, error and death updates, old enough at the
    // pre-step age + idt; the polygon id is kept from the first time
    if constexpr (SETTLE) {
      if (st == ACTIVE && sg.poly.n > 0
          && age_pre + idt >= par[P_PEDIAGE]) {
        int id = settle_id(sg, ax, a.nx, a.ny, x, y);
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
      fit_eval(Records{a, sp, l, 2}, Ts, s4, par + P_HEAD,
               par + P_HEAD + a.us, a.us, a.salt0, a.salt0 + a.us, zeta, h,
               z, cq, dq0, dq1, salt, temp, zf);
    }
  }
  count_staging(sp.cnt, blocks & 0xffff, blocks >> 16, miss);
  if (!live) return;
  x_out[p] = x;
  y_out[p] = y;
  z_out[p] = z;
  if constexpr (AGE) age_out[p] = age;
  if constexpr (SETTLE) spoly_out[p] = spoly;
  if constexpr (SALT) { salt_out[p] = salt; temp_out[p] = temp; }
  st_out[p] = st;
  hitl_out[p] = hitl;
  hitb_out[p] = hitb;
}

// the variant of this library, and its dynamic shared memory opt-in
// (above 48 KB a block needs it; set once per larger size)
static constexpr auto kernel_fn =
    &ext_step_kernel<LTX_HTURB, LTX_VTURB, LTX_BEHAVIOR, LTX_MORTALITY,
                     LTX_SETTLE, LTX_SALT>;

static cudaError_t allow_smem(size_t smem) {
  static size_t allowed = 48 * 1024;
  if (smem <= allowed) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel_fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) allowed = smem;
  return e;
}

// Blocks of this variant that one SM holds when each stages tile_points
// points of a table with nl lanes (the occupancy calculator), or minus a
// cudaError_t.
extern "C" int ltx_ext_step_blocks_per_sm(int nl, int tile_points) {
  const size_t smem = 3 * (size_t)tile_points * (nl | 1) * sizeof(float);
  int blocks = 0;
  cudaError_t e = allow_smem(smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel_fn,
                                                      LTX_BLOCK, smem);
  return e == cudaSuccess ? blocks : -(int)e;
}

// One external step of n particles, in the variant this library was
// compiled for (LTX_* macros).  The particle columns x, y, z, dob, age,
// salt, temp and their outputs and the boundary rows are pos_t (float64
// under LTX_POS64, which also takes dparams: params's layout in float64).
// rngk may be null when the variant draws
// nothing; age/age_out are read/written only where the variant carries
// the age, spoly/spoly_out with settlement, salt/temp and their outputs
// with SaltTempOn.  The record table's lanes are the nv value lanes, the
// ws Aks lanes from aks0 (nv, or -1 without them) and the us salt + us
// temp lanes from salt0 (after the Aks lanes, or -1 without them).
// settle_d holds the cell-edge lattice (x0, dx, y0, dy) and the f64
// vertices (x then y) of the polygons and then of the holes; settle_i
// their vertex counts, ids and per-cell candidate rows, polygons first.
// curv_xy (Ny*Nx, 2) and curv_seed (the seed_i then the seed_j raster,
// each curv_my x curv_mx) with the raster origin, inverse spacings and
// the squared residual tolerance are the curvilinear map, given exactly
// when the library is an LTX_CURV variant.  tile_points is the rho points
// a block may stage (the launch takes 3 * tile_points * (nl | 1) floats of
// dynamic shared memory; 0 runs every block from device memory); counters
// (3 u64, zeroed by the caller once) accumulate staged_block_steps,
// global_block_steps and staged_misses.  axis_x/axis_y (nx, ny) are the
// rho axes, edge_x/edge_y (nx + 1, ny + 1) the boundary cell edges (each
// pair null where uniform) and settle_ex/settle_ey the edges in f64 for
// settlement: given only to an LTX_AXES variant.  Returns the launch's
// cudaError_t.
extern "C" int ltx_ext_step(
    const float* rtab, const pos_t* brows, const float* params,
    const double* dparams, const uint32_t* rngk, const pos_t* x,
    const pos_t* y, const pos_t* z, const pos_t* dob, const pos_t* age,
    const int* pid, const int* status, const int* spoly, const pos_t* salt,
    const pos_t* temp, pos_t* x_out, pos_t* y_out, pos_t* z_out,
    pos_t* age_out, int* st_out, int* hitl_out, int* hitb_out,
    int* spoly_out, pos_t* salt_out, pos_t* temp_out,
    const double* settle_d, const int* settle_i, int n, int nx, int ny,
    int us, int ws, int nl, int aks0, int salt0, int vtransform, int n_int,
    int n_iter, int open_exits, int s_max, int n_poly, int vmax_poly,
    int cmax_poly, int n_hole, int vmax_hole, int cmax_hole,
    const pos_t* curv_xy, const int* curv_seed, int curv_mx, int curv_my,
    double curv_rx0, double curv_ry0, double curv_inv_rdx,
    double curv_inv_rdy, double curv_tol2, int tile_points,
    unsigned long long* counters, const pos_t* axis_x, const pos_t* axis_y,
    const pos_t* edge_x, const pos_t* edge_y, const double* settle_ex,
    const double* settle_ey, void* stream) {
  if (us > MAX_LEVELS || ws > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  const int nv = 2 * us + ws + 2;
  const int after_aks = aks0 >= 0 ? nv + ws : nv;
  if ((aks0 != -1 && aks0 != nv) || (salt0 != -1 && salt0 != after_aks)
      || nl != (salt0 >= 0 ? salt0 + 2 * us : after_aks)
      || (LTX_VTURB == 2 && aks0 < 0)
      || ((LTX_SALT || LTX_BEHAVIOR == 4 || LTX_BEHAVIOR == 5) && salt0 < 0)
      || (LTX_SETTLE && n_poly > 0 && (!settle_d || !settle_i))
      || (LTX_CURV != 0) != (curv_xy != nullptr)
      || (LTX_CURV && (!curv_seed || curv_mx < 1 || curv_my < 1))
      || (LTX_POS64 != 0) != (dparams != nullptr)
      || (!LTX_AXES && (axis_x || axis_y || edge_x || edge_y || settle_ex
                        || settle_ey))
      || (!axis_x) != (!axis_y) || (!edge_x) != (!edge_y)
      || (!settle_ex) != (!settle_ey)
      || tile_points < 0 || !counters)
    return (int)cudaErrorInvalidValue;      // lane offsets, tables
  if (n <= 0) return 0;
  Args a;
  a.rtab = rtab;
  a.brows = brows;
  a.par = params;
#if LTX_POS64
  a.dpar = dparams;
#endif
  a.rngk = rngk;
  a.nx = nx;
  a.ny = ny;
  a.us = us;
  a.ws = ws;
  a.nv = nv;
  a.nl = nl;
  a.salt0 = salt0;
  a.vt = vtransform;
  a.n_int = n_int;
  a.n_iter = n_iter;
  a.open_exits = open_exits;
  a.s_max = s_max;
  a.bl = 8 + 8 * s_max;
  a.C = (long long)nx * ny;
  // polygon tables: sub-arrays of settle_d / settle_i
  Settle sg;
  sg.edge = settle_d;
  const long long pv = (long long)n_poly * vmax_poly;
  const long long hv = (long long)n_hole * vmax_hole;
  sg.poly = {settle_d ? settle_d + 4 : nullptr,
            settle_d ? settle_d + 4 + pv : nullptr,
            settle_i, settle_i ? settle_i + n_poly : nullptr,
            settle_i ? settle_i + 2 * n_poly : nullptr,
            n_poly, vmax_poly, cmax_poly};
  const int* hi = settle_i ? settle_i + 2 * n_poly + a.C * cmax_poly
                           : nullptr;
  sg.hole = {settle_d ? settle_d + 4 + 2 * pv : nullptr,
            settle_d ? settle_d + 4 + 2 * pv + hv : nullptr,
            hi, hi ? hi + n_hole : nullptr, hi ? hi + 2 * n_hole : nullptr,
            n_hole, vmax_hole, cmax_hole};
  const long long ms = (long long)curv_mx * curv_my;
  Curv cv = {reinterpret_cast<const pos2_t*>(curv_xy), curv_seed,
             curv_seed ? curv_seed + ms : nullptr, curv_mx, curv_my,
             (pos_t)curv_rx0, (pos_t)curv_ry0, (pos_t)curv_inv_rdx,
             (pos_t)curv_inv_rdy, (pos_t)curv_tol2};
  Axes ax = {axis_x, axis_y, edge_x, edge_y, settle_ex, settle_ey};
  Stage sp = {counters, tile_points, nl | 1, tile_points * (nl | 1)};
  const size_t smem = 3 * (size_t)sp.ts * sizeof(float);
  cudaError_t e = allow_smem(smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + LTX_BLOCK - 1) / LTX_BLOCK;
  kernel_fn<<<blocks, LTX_BLOCK, smem, (cudaStream_t)stream>>>(
      a, sg, cv, sp, n, x, y, z, dob, age, pid, status, spoly, salt, temp,
      x_out, y_out, z_out, age_out, st_out, hitl_out, hitb_out, spoly_out,
      salt_out, temp_out, ax);
  return (int)cudaGetLastError();
}
