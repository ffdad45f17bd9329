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
// LTX_SALT, LTX_CURV; the wrapper builds one library per combination), so
// each
// configuration carries only its own lanes; with all of them 0 the
// kernel is the advection kernel alone.
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
// cost.  __launch_bounds__(128, 4): every variant at <= 128 registers
// with no spills, where ptxas alone chose 96 with spills in 6 variants;
// measured, the bound makes the advect and behavior cells 4-5% faster
// at 1M particles and 15-23% at 65,536, turb 1-5% slower.
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
// candidate's edges in double on its f32 position promoted, as
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
#include "find_currents.cuh"

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

// the curvilinear inverse map (ltjax_torch.grid.CurvMap, as f32), a
// kernel argument of its own like Settle; unused without LTX_CURV
struct Curv {
  const float2* xy;                 // (Ny*Nx) projected rho points
  const int* seed_i;                // (my, mx) seed raster: nearest cell
  const int* seed_j;
  int mx, my;
  float rx0, ry0, inv_rdx, inv_rdy; // raster origin and inverse spacing
  float tol2;                       // squared inside-mesh residual tol
};

struct Args {
  const float* __restrict__ rtab;   // (3, C, nl) raw record lanes
  const float* __restrict__ brows;  // (C, bl) boundary cell rows
  const float* __restrict__ par;    // head + ladders + weights
  const uint32_t* __restrict__ rngk;  // per-step derived key pairs
  int nx, ny, us, ws, nv, nl, vt, n_int, n_iter, open_exits, s_max, bl;
  int salt0;                        // first salt lane (temp follows)
  long long C;
};

// ltjax_torch.grid.curv_logical: logical coordinates (ti, tj) of (x, y)
// from the raster seed and 3 bounded Newton steps on the bilinear quad
// map, clamped to the lattice; RESID adds r2, the squared residual of
// the forward map at the clamped solution
template <bool RESID>
__device__ __forceinline__ void curv_logical(const Curv& c, int nx, int ny,
                                             float x, float y, float& ti,
                                             float& tj, float& r2) {
  const float ri = fminf(fmaxf(floorf((x - c.rx0) * c.inv_rdx), 0.0f),
                         (float)(c.mx - 1));
  const float rj = fminf(fmaxf(floorf((y - c.ry0) * c.inv_rdy), 0.0f),
                         (float)(c.my - 1));
  const int rflat = (int)rj * c.mx + (int)ri;
  ti = (float)c.seed_i[rflat] + 0.5f;
  tj = (float)c.seed_j[rflat] + 0.5f;
  for (int it = 0; it < 3; ++it) {
    const float i = fminf(fmaxf(floorf(ti), 0.0f), (float)(nx - 2));
    const float j = fminf(fmaxf(floorf(tj), 0.0f), (float)(ny - 2));
    const float fx = ti - i, fy = tj - j;
    const int base = (int)j * nx + (int)i;
    const float2 c00 = c.xy[base], c01 = c.xy[base + 1];
    const float2 c10 = c.xy[base + nx], c11 = c.xy[base + nx + 1];
    const float ax0 = c01.x - c00.x, ax1 = c01.y - c00.y;
    const float ay0 = c10.x - c00.x, ay1 = c10.y - c00.y;
    const float b0 = c11.x - c01.x - c10.x + c00.x;
    const float b1 = c11.y - c01.y - c10.y + c00.y;
    const float fxy = fx * fy;
    const float p0 = c00.x + fx * ax0 + fy * ay0 + fxy * b0;
    const float p1 = c00.y + fx * ax1 + fy * ay1 + fxy * b1;
    const float jx0 = ax0 + fy * b0, jx1 = ax1 + fy * b1;   // dP/dfx
    const float jy0 = ay0 + fx * b0, jy1 = ay1 + fx * b1;   // dP/dfy
    float det = jx0 * jy1 - jx1 * jy0;
    det = fabsf(det) < 1e-30f ? 1e-30f : det;
    const float rx = x - p0, ry = y - p1;
    const float dfx = (jy1 * rx - jy0 * ry) / det;
    const float dfy = (-jx1 * rx + jx0 * ry) / det;
    ti = i + fminf(fmaxf(fx + dfx, -1.5f), 2.5f);
    tj = j + fminf(fmaxf(fy + dfy, -1.5f), 2.5f);
  }
  ti = fminf(fmaxf(ti, 0.0f), (float)(nx - 1));
  tj = fminf(fmaxf(tj, 0.0f), (float)(ny - 1));
  if constexpr (RESID) {
    const float i = fminf(fmaxf(floorf(ti), 0.0f), (float)(nx - 2));
    const float j = fminf(fmaxf(floorf(tj), 0.0f), (float)(ny - 2));
    const float fx = ti - i, fy = tj - j;
    const int base = (int)j * nx + (int)i;
    const float2 c00 = c.xy[base], c01 = c.xy[base + 1];
    const float2 c10 = c.xy[base + nx], c11 = c.xy[base + nx + 1];
    const float fxy = fx * fy;
    const float p0 = c00.x + fx * (c01.x - c00.x) + fy * (c10.x - c00.x)
                     + fxy * (c11.x - c01.x - c10.x + c00.x);
    const float p1 = c00.y + fx * (c01.y - c00.y) + fy * (c10.y - c00.y)
                     + fxy * (c11.y - c01.y - c10.y + c00.y);
    r2 = (x - p0) * (x - p0) + (y - p1) * (y - p1);
  }
}

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

// the cell (i, j) and stencil of (x, y), not staged
__device__ __forceinline__ Stencil locate(const Args& a, const Curv& cv,
                                          float x, float y, int& i, int& j) {
#if LTX_CURV
  Stencil s;
  float ti, tj, r2;
  curv_logical<false>(cv, a.nx, a.ny, x, y, ti, tj, r2);
  const float fi = fminf(fmaxf(floorf(ti), 0.0f), (float)(a.nx - 2));
  const float fj = fminf(fmaxf(floorf(tj), 0.0f), (float)(a.ny - 2));
  i = (int)fi;
  j = (int)fj;
  s.fx = fminf(fmaxf(ti - fi, 0.0f), 1.0f);
  s.fy = fminf(fmaxf(tj - fj, 0.0f), 1.0f);
  s.r00 = ((long long)j * a.nx + i) * a.nl;
  s.t = -1;
  s.rs = 0;
  return s;
#else
  return locate_rect(a.par, a.nx, a.ny, a.nl, x, y, i, j);
#endif
}

// the stencil of (x, y) in the tiles of box b, or a (counted) miss
__device__ __forceinline__ Stencil locate(const Args& a, const Stage& sp,
                                          const Curv& cv, const Box& b,
                                          float x, float y, int& miss) {
  int i, j;
  Stencil s = locate(a, cv, x, y, i, j);
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
  __device__ __forceinline__ float knot(float s, float cs, float zeta,
                                        float h) const {
    return knot_depth(a.par[P_HC], a.vt, s, cs, zeta, h);
  }
  __device__ __forceinline__ const float* ladders() const {
    return a.par + P_HEAD;
  }
  __device__ __forceinline__ float z0m() const { return a.par[P_Z0M]; }
  __device__ __forceinline__ int us() const { return a.us; }
  __device__ __forceinline__ int ws() const { return a.ws; }
  __device__ __forceinline__ int nv() const { return a.nv; }
};

// find_currents at (x, y, z) on stage q of the internal step (weights l)
__device__ void find_currents(const Args& a, const Stage& sp, const Curv& cv,
                              const Tension& T, const Box& b, const float* l,
                              int q, float x, float y, float z, float* cp,
                              float* dp0, float* dp1, int& miss, float& u,
                              float& v, float& w) {
  find_currents_at(Records{a, sp, l, q}, T,
                   locate(a, sp, cv, b, x, y, miss), z, cp, dp0, dp1, u, v,
                   w);
}

// the boundary cell row of (x, y): on a curvilinear grid boundary cell
// (j, i) spans the rho logical range [i - 0.5, i + 0.5]
__device__ __forceinline__ const float* cell_row(const Args& a,
                                                 const Curv& cv, float x,
                                                 float y) {
#if LTX_CURV
  float ti, tj, r2;
  curv_logical<false>(cv, a.nx, a.ny, x, y, ti, tj, r2);
  const int i = (int)fminf(fmaxf(floorf(ti + 0.5f), 0.0f), (float)(a.nx - 1));
  const int j = (int)fminf(fmaxf(floorf(tj + 0.5f), 0.0f), (float)(a.ny - 1));
#else
  const float* par = a.par;
  int i = (int)floorf((x - par[P_BX0]) / par[P_BDX]);
  int j = (int)floorf((y - par[P_BY0]) / par[P_BDY]);
  i = min(max(i, 0), a.nx - 1);
  j = min(max(j, 0), a.ny - 1);
#endif
  return a.brows + ((long long)j * a.nx + i) * a.bl;
}

// inside the domain (the box; on a curvilinear grid the map's residual
// within tol) and in a water cell
__device__ __forceinline__ bool in_water(const Args& a, const Curv& cv,
                                         float x, float y) {
#if LTX_CURV
  float ti, tj, r2;
  curv_logical<true>(cv, a.nx, a.ny, x, y, ti, tj, r2);
  const int i = (int)fminf(fmaxf(floorf(ti + 0.5f), 0.0f), (float)(a.nx - 1));
  const int j = (int)fminf(fmaxf(floorf(tj + 0.5f), 0.0f), (float)(a.ny - 1));
  return r2 <= cv.tol2 && a.brows[((long long)j * a.nx + i) * a.bl] > 0.5f;
#else
  const float* par = a.par;
  bool inside = (x >= par[P_BX0]) && (x <= par[P_BX1])
                && (y >= par[P_BY0]) && (y <= par[P_BY1]);
  return inside && cell_row(a, cv, x, y)[0] > 0.5f;
#endif
}

// boundary.reflect for one particle: (x0, y0) -> (x1, y1) becomes the
// reflected endpoint; returns exited/stuck and the land-hit count.  On a
// curvilinear grid a pass skips the segment that the previous pass
// reflected from, as the plain version does: the f32 restart point lies
// on either side of a slanted wall, and re-crossing it at tp ~ 0 would
// reflect the particle into land.
__device__ void reflect(const Args& a, const Curv& cv, float x0, float y0,
                        float& x1, float& y1, bool& exited, bool& stuck,
                        int& hits) {
  const float eps = 1e-6f;
  float px0 = x0, py0 = y0, px1 = x1, py1 = y1;
  float ms2x = 0.0f, ms2y = 0.0f;
  exited = false;
  hits = 0;
#if LTX_CURV
  float lax = NAN, lay = NAN, lbx = NAN, lby = NAN;   // last reflected from
  float sax = 0.0f, say = 0.0f, sbx = 0.0f, sby = 0.0f;
#endif
  for (int it = 0; it < a.n_iter; ++it) {
    const float* row = cell_row(a, cv, px0, py0);
    if (it == 0) { ms2x = row[3]; ms2y = row[4]; }
    float dx = px1 - px0, dy = py1 - py0;
    float tpm = INFINITY, exf = 0.0f, eyf = 0.0f, kindf = 0.0f;
    bool any = false;
    for (int s = 0; s < a.s_max; ++s) {
      const float* sl = row + 8 + 8 * s;
      if (!(sl[5] > 0.5f)) continue;
#if LTX_CURV
      if (sl[0] == lax && sl[1] == lay && sl[2] == lbx && sl[3] == lby)
        continue;
#endif
      float ax = sl[0], ay = sl[1];
      float ex = sl[2] - ax, ey = sl[3] - ay;
      float apx = ax - px0, apy = ay - py0;
      float denom = dx * ey - dy * ex;
      float dsafe = fabsf(denom) < 1e-30f ? 1e-30f : denom;
      float tp = (apx * ey - apy * ex) / dsafe;
      float ts = (apx * dy - apy * dx) / dsafe;
      bool cross = fabsf(denom) > 1e-30f && tp > 0.0f && tp <= 1.0f
                   && ts >= 0.0f && ts <= 1.0f;
      if (cross && tp < tpm) {          // first minimum wins (argmin)
        tpm = tp; exf = ex; eyf = ey; kindf = sl[4]; any = true;
#if LTX_CURV
        sax = sl[0]; say = sl[1]; sbx = sl[2]; sby = sl[3];
#endif
      }
    }
    bool act = any && !exited;
    if (!act) continue;
    float ix = px0 + tpm * (px1 - px0);
    float iy = py0 + tpm * (py1 - py0);
    float rx = px1 - ix, ry = py1 - iy;
    float elen2 = fmaxf(exf * exf + eyf * eyf, 1e-30f);
    float proj = (rx * exf + ry * eyf) / elen2;
    float rrx = 2.0f * proj * exf - rx;
    float rry = 2.0f * proj * eyf - ry;
    int kind = (int)kindf;
    bool newly_exited = a.open_exits && kind == OPEN;
    bool do_reflect = a.open_exits ? kind == LAND : true;
    if (do_reflect) {
      float nrm = sqrtf(fmaxf(rrx * rrx + rry * rry, 1e-30f));
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
  stuck = !exited && !in_water(a, cv, px1, py1);
  // tunnel guard on the straight path of non-interacting particles
  if (hits == 0 && !exited && !stuck
      && !in_water(a, cv, 0.5f * (x0 + px1), 0.5f * (y0 + py1)))
    stuck = true;
  // displacement guard: per-axis reach of the pre-move cell's bucket
  float ddx = x1 - x0, ddy = y1 - y0;
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
// contains it, unless a candidate hole does; -1 otherwise
__device__ int settle_id(const Settle& sg, int nx, int ny, float x,
                         float y) {
  const double px = (double)x, py = (double)y;
  const int i = (int)fmin(fmax(floor((px - sg.edge[0]) / sg.edge[1]), 0.0),
                          (double)(nx - 1));
  const int j = (int)fmin(fmax(floor((py - sg.edge[2]) / sg.edge[3]), 0.0),
                          (double)(ny - 1));
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

// word -> (0, 1): the top 24 bits, offset half an ulp from 0
__device__ __forceinline__ float bits_to_uniform(uint32_t b) {
  return (float)(int)(b >> 8) * 5.9604644775390625e-08f
         + 2.98023223876953125e-08f;
}

// ---- Visser random displacement on the Aks profile ---------------------

// spline value (deriv = false) or derivative at zq of the fitted Aks
// column: knots zk, second derivatives z2, values re-read from the lanes
__device__ float aks_eval(const Args& a, const Stage& sp, const Tension& T,
                          const Stencil& st, const float* l, const float* zk,
                          const float* z2, int K, float zq, bool deriv) {
  zq = fminf(fmaxf(zq, zk[0]), zk[K - 1]);
  int j = 0;
  for (int k = 1; k < K; ++k) j += zq >= zk[k] ? 1 : 0;
  j = min(j, K - 2);
  float x0 = zk[j], x1 = zk[j + 1];
  float y0 = fmaxf(lane(a, sp, st, l, 0, a.nv + j), 0.0f);
  float y1 = fmaxf(lane(a, sp, st, l, 0, a.nv + j + 1), 0.0f);
  float h = x1 - x0;
  float B2 = (zq - x0) / h;
  float B1 = 1.0f - B2;
  if (deriv)
    return (y1 - y0) / h + h * (z2[j] * ds_fn(T, B1) - z2[j + 1] * ds_fn(T, B2));
  return y0 * B1 + y1 * B2 + h * h * (z2[j] * gs_fn(T, B1)
                                      + z2[j + 1] * gs_fn(T, B2));
}

// dz = K'(z) idt + R sqrt(2 K(z_mid) idt / (1/3)) on the Aks lanes (after
// the nv value lanes) blended at stencil st at stage 1 (weights l);
// physics.turb.vturb: Aks clipped at >= 0 before a natural tension fit
// on the w ladder, z_mid = clip(z + K' idt / 2) to the knot range.
__device__ float visser_dz(const Args& a, const Stage& sp, float sigma,
                           const Stencil& st, const float* l, float zeta,
                           float h, float z, float R, float idt, float* cp,
                           float* z2, float* zk) {
  Tension T;                 // tension.evaluate: series at sigma = 0
  T.sigma = sigma;
  T.small = 0.5f;
  T.cubic = false;
  const float* par = a.par;
  const float* s_w = par + P_HEAD + 2 * a.us;
  const float* cs_w = s_w + a.ws;
  const int K = a.ws;
  float zprev = knot_depth(a.par[P_HC], a.vt, s_w[0], cs_w[0], zeta, h);
  float yprev = fmaxf(lane(a, sp, st, l, 0, a.nv), 0.0f);
  zk[0] = zprev;
  cp[0] = 0.0f;
  z2[0] = 0.0f;
  float offp = 0.0f, diap = 0.0f, dyp = 0.0f;
  for (int k = 1; k < K; ++k) {           // Thomas forward sweep
    float zc = knot_depth(a.par[P_HC], a.vt, s_w[k], cs_w[k], zeta, h);
    float yk = fmaxf(lane(a, sp, st, l, 0, a.nv + k), 0.0f);
    float hk = zc - zprev;
    float dy = (yk - yprev) / hk;
    float offc, diac;
    coefs(T, hk, offc, diac);
    if (k >= 2) {
      int i = k - 1;
      float denom = (diap + diac) - offp * cp[i - 1];
      cp[i] = offc / denom;
      z2[i] = ((dy - dyp) - offp * z2[i - 1]) / denom;
    }
    zk[k] = zc;
    zprev = zc; yprev = yk;
    offp = offc; diap = diac; dyp = dy;
  }
  float x = 0.0f;                         // natural end: z2[K-1] = 0
  z2[K - 1] = 0.0f;
  for (int i = K - 2; i >= 0; --i) {
    x = z2[i] - cp[i] * x;
    z2[i] = x;
  }
  float kprime = aks_eval(a, sp, T, st, l, zk, z2, K, z, true);
  float zmid = fminf(fmaxf(z + 0.5f * kprime * idt, zk[0]), zk[K - 1]);
  float kmid = fmaxf(aks_eval(a, sp, T, st, l, zk, z2, K, zmid, false),
                     0.0f);
  return kprime * idt + R * sqrtf(2.0f * kmid * idt / (1.0f / 3.0f));
}

template <int HT, int VT, int BEH, int MORT, int SETTLE, int SALT>
__global__ void __launch_bounds__(LTX_BLOCK, 4)
ext_step_kernel(Args a, Settle sg, Curv cv, Stage sp, int n,
                const float* __restrict__ x_in,
                const float* __restrict__ y_in,
                const float* __restrict__ z_in,
                const float* __restrict__ dob_in,
                const float* __restrict__ age_in,
                const int* __restrict__ pid_in,
                const int* __restrict__ st_in,
                const int* __restrict__ spoly_in,
                const float* __restrict__ salt_in,
                const float* __restrict__ temp_in,
                float* __restrict__ x_out, float* __restrict__ y_out,
                float* __restrict__ z_out, float* __restrict__ age_out,
                int* __restrict__ st_out,
                int* __restrict__ hitl_out, int* __restrict__ hitb_out,
                int* __restrict__ spoly_out, float* __restrict__ salt_out,
                float* __restrict__ temp_out) {
  // behaviors that swim read the age and draw BEHAVE/MORTALITY words;
  // settlement reads the age too (eligible from pediage on)
  constexpr bool SWIM = BEH >= 1 && BEH <= 5;
  constexpr bool AGE = MORT || SWIM || BEH == 7 || SETTLE;
  constexpr bool RNG = HT || VT != 0 || SWIM;
  constexpr int STRIDE = SWIM ? 8 : 4;    // key words per internal step
  __shared__ int red[2 * 4 * (LTX_BLOCK / 32)];
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = p < n;   // every thread reaches the staging barriers
  const float* par = a.par;
  Tension T;
  T.sigma = par[P_SIGMA];
  T.small = 0.5f;
  T.cubic = T.sigma == 0.0f;
  Tension Ts = T;            // salt/temp splines: tension.evaluate's
  Ts.cubic = false;          // series at sigma = 0, as the plain version
  float cp[MAX_LEVELS], dp0[MAX_LEVELS], dp1[MAX_LEVELS];

  const int q = live ? p : 0;
  float x = x_in[q], y = y_in[q], z = z_in[q], dob = dob_in[q];
  float age = 0.0f;
  if constexpr (AGE) age = age_in[q];
  uint32_t pid = 0u;
  if constexpr (RNG) pid = (uint32_t)pid_in[q];
  int st = live ? st_in[q] : -1;   // past the batch: never active
  int spoly = 0;
  if constexpr (SETTLE) spoly = spoly_in[q];
  float salt = 0.0f, temp = 0.0f;
  if constexpr (SALT) { salt = salt_in[q]; temp = temp_in[q]; }
  int hitl = 0, hitb = 0;
  int miss = 0, blocks = 0;   // staged misses; block-steps staged + 2^16 x
                              // global (thread 0's count)
  const float idt = par[P_IDT];
  const float half = 0.5f * idt;
  const float sixth = idt / 6.0f;
  const float* coef = par + P_HEAD + 2 * (a.us + a.ws);

  for (int i = 0; i < a.n_int; ++i) {
    float t_i = par[P_T0] + (float)i * idt;
    if (st == NOT_RELEASED && t_i >= dob) st = ACTIVE;
    const float age_pre = age;  // behavior, mortality, settlement read it
    if constexpr (AGE) {
      if (st >= ACTIVE) age = (t_i + idt) - dob;
    }
    const float* l = coef + 9 * i;        // stage weights: t, t+idt/2, t+idt
    // the block's box of stage-1 cells; its three tiles when it fits
    const bool act = st == ACTIVE;
    int ci = 0, cj = 0, kind;
    Stencil s1;
    if (act) s1 = locate(a, cv, x, y, ci, cj);
    const Box box = block_box(act, ci, cj, a.nx, a.ny, sp.points, red, i & 1,
                              kind);
    if (kind == BOX_STAGED) {
      stage_records(a, sp, box, l);
      __syncthreads();
    }
    blocks += kind == BOX_STAGED ? 1 : kind == BOX_GLOBAL ? 1 << 16 : 0;
    if (!act) continue;
    stage_in(s1, box, ci, cj, sp.ls, miss);
    float u1, v1, w1, u2, v2, w2, u3, v3, w3, u4, v4, w4;
    find_currents_at(Records{a, sp, l, 0}, T, s1, z, cp, dp0, dp1, u1, v1,
                     w1);
    find_currents(a, sp, cv, T, box, l, 1, x + u1 * half, y + v1 * half,
                  z + w1 * half, cp, dp0, dp1, miss, u2, v2, w2);
    find_currents(a, sp, cv, T, box, l, 1, x + u2 * half, y + v2 * half,
                  z + w2 * half, cp, dp0, dp1, miss, u3, v3, w3);
    find_currents(a, sp, cv, T, box, l, 2, x + u3 * idt, y + v3 * idt,
                  z + w3 * idt, cp, dp0, dp1, miss, u4, v4, w4);
    float dx = sixth * (u1 + 2.0f * u2 + 2.0f * u3 + u4);
    float dy = sixth * (v1 + 2.0f * v2 + 2.0f * v3 + v4);
    float dz = sixth * (w1 + 2.0f * w2 + 2.0f * w3 + w4);

    // --- turbulence ------------------------------------------------------
    if constexpr (HT) {
      uint32_t b0, b1;
      particle_bits(a, STRIDE, i, HTURB, pid, b0, b1);
      float r = sqrtf(-2.0f * logf(bits_to_uniform(b0)));
      float th = (float)(2.0 * 3.14159265358979) * bits_to_uniform(b1);
      dx = dx + r * cosf(th) * par[P_HSCALE];
      dy = dy + r * sinf(th) * par[P_HSCALE];
    }
    if constexpr (VT != 0) {
      uint32_t b0, b1;
      particle_bits(a, STRIDE, i, VTURB, pid, b0, b1);
      float R = -1.0f + 2.0f * bits_to_uniform(b0);
      if constexpr (VT == 1) {
        dz = dz + R * par[P_VCONST];
      } else {
        // Aks blended at the stage-1 position and time
        Stencil sv = locate(a, sp, cv, box, x, y, miss);
        float zeta1 = lane(a, sp, sv, l, 0, a.nv - 2);
        float h1 = lane(a, sp, sv, l, 0, a.nv - 1);
        dz = dz + visser_dz(a, sp, T.sigma, sv, l, zeta1, h1, z, R, idt, cp,
                            dp0, dp1);
      }
    }

    // --- behavior (free surface and depth at stage 1) -----------------------
    if constexpr (BEH != 0) {
      float bx = 0.0f, by = 0.0f, bz = 0.0f;
      Stencil sb = locate(a, sp, cv, box, x, y, miss);
      float zeta_b = lane(a, sp, sb, l, 0, a.nv - 2);
      float h_b = lane(a, sp, sb, l, 0, a.nv - 1);
      // ontogenetic swim speed at the pre-step age
      float frac = fminf(fmaxf((age_pre - par[P_SWIMSTART]) / par[P_SWIMDEN],
                               0.0f), 1.0f);
      float wsw = par[P_SWIMSLOW] + par[P_SWIMDIFF] * frac;
      wsw = age_pre >= par[P_SWIMSTART] ? wsw : 0.0f;
      if constexpr (SWIM) {
        uint32_t b0, b1;
        particle_bits(a, STRIDE, i, BEHAVE, pid, b0, b1);
        float r_dir = bits_to_uniform(b0);
        particle_bits(a, STRIDE, i, MORTALITY, pid, b0, b1);
        float r_mix = -1.0f + 2.0f * bits_to_uniform(b0);
        float rnd = r_mix * wsw * idt;
        float toward = BEH == 2 ? -1.0f : 1.0f;       // biased walk
        float biased = (r_dir < 0.8f ? toward : -toward) * wsw * idt;
        if constexpr (BEH == 1) {
          bz = z < (zeta_b - 2.0f) ? biased : rnd;     // SURFACE_ZONE
        } else if constexpr (BEH == 2) {
          bz = z > (-h_b + 2.0f) ? biased : rnd;       // BOTTOM_ZONE
        } else if constexpr (BEH == 3) {
          float e0 = coef[9 * a.n_int + i];
          float light = e0 * expf(-par[P_KP] * fmaxf(zeta_b - z, 0.0f));
          bz = light > par[P_THRESH] ? -wsw * idt
               : (e0 > 0.0f ? wsw * idt : rnd);
        } else {
          // halocline cue: dS/dz of the salt spline at the pre-step
          // position and time (stage-1 stencil, weights and knots)
          float dsdz, unused, zf;
          fit_eval<true>(Records{a, sp, l, 0}, Ts, sb, par + P_HEAD,
                         par + P_HEAD + a.us, a.us, a.salt0, -1, zeta_b, h_b,
                         z, cp, dp0, dp1, dsdz, unused, zf);
          bool cue = fabsf(dsdz) >= par[P_SGRAD];
          bool young = age_pre < par[P_PEDIAGE];
          float down = -biased;                          // toward the bottom
          if constexpr (BEH == 4)
            bz = young ? (cue ? biased : rnd) : down;
          else
            bz = young ? (cue ? biased : biased * 0.5f + rnd * 0.5f) : down;
        }
      } else if constexpr (BEH == 6) {
        bz = -par[P_SINK] * idt * 1.0f;
      } else if constexpr (BEH == 7) {
        // tidal-stream transport on the stage-1 currents
        float speed = sqrtf(u1 * u1 + v1 * v1);
        bool riding = speed > 0.05f;                   // TST_MIN_SPEED
        float target = riding ? zeta_b - par[P_SWIMDEPTH] : -h_b + 0.5f;
        bz = fminf(fmaxf(target - z, -wsw * idt - 1.0f), wsw * idt + 1.0f);
        float spd = fmaxf(speed, 1e-12f);
        bx = riding ? par[P_HSWIM] * u1 / spd * idt : 0.0f;
        by = riding ? par[P_HSWIM] * v1 / spd * idt : 0.0f;
      }
      dx = dx + bx;
      dy = dy + by;
      dz = dz + bz;
    }
    float x1 = x + dx;
    float y1 = y + dy;
    float z1 = z + dz;

    bool exited, stuck;
    int hits;
    reflect(a, cv, x, y, x1, y1, exited, stuck, hits);

    // vertical reflection about zeta/h of the new column at t + idt
    Stencil s4 = locate(a, sp, cv, box, x1, y1, miss);
    float zeta = lane(a, sp, s4, l, 2, a.nv - 2);
    float h = lane(a, sp, s4, l, 2, a.nv - 1);
    bool above = z1 > zeta;
    float za = above ? 2.0f * zeta - z1 : z1;
    bool below = za < -h;
    float zb = below ? -2.0f * h - za : za;

    x = x1;
    y = y1;
    z = fminf(fmaxf(zb, -h), zeta);
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
        int id = settle_id(sg, a.nx, a.ny, x, y);
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
      float zf;
      fit_eval(Records{a, sp, l, 2}, Ts, s4, par + P_HEAD,
               par + P_HEAD + a.us, a.us, a.salt0, a.salt0 + a.us, zeta, h,
               z, cp, dp0, dp1, salt, temp, zf);
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
// compiled for (LTX_* macros).  rngk may be null when the variant draws
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
// global_block_steps and staged_misses.  Returns the launch's
// cudaError_t.
extern "C" int ltx_ext_step(
    const float* rtab, const float* brows, const float* params,
    const uint32_t* rngk, const float* x, const float* y, const float* z,
    const float* dob, const float* age, const int* pid, const int* status,
    const int* spoly, const float* salt, const float* temp,
    float* x_out, float* y_out, float* z_out, float* age_out, int* st_out,
    int* hitl_out, int* hitb_out, int* spoly_out, float* salt_out,
    float* temp_out, const double* settle_d, const int* settle_i, int n,
    int nx, int ny, int us, int ws, int nl, int aks0, int salt0,
    int vtransform, int n_int, int n_iter, int open_exits, int s_max,
    int n_poly, int vmax_poly, int cmax_poly, int n_hole, int vmax_hole,
    int cmax_hole, const float* curv_xy, const int* curv_seed, int curv_mx,
    int curv_my, float curv_rx0, float curv_ry0, float curv_inv_rdx,
    float curv_inv_rdy, float curv_tol2, int tile_points,
    unsigned long long* counters, void* stream) {
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
      || tile_points < 0 || !counters)
    return (int)cudaErrorInvalidValue;      // lane offsets, tables
  if (n <= 0) return 0;
  Args a;
  a.rtab = rtab;
  a.brows = brows;
  a.par = params;
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
  Curv cv = {reinterpret_cast<const float2*>(curv_xy), curv_seed,
             curv_seed ? curv_seed + ms : nullptr, curv_mx, curv_my,
             curv_rx0, curv_ry0, curv_inv_rdx, curv_inv_rdy, curv_tol2};
  Stage sp = {counters, tile_points, nl | 1, tile_points * (nl | 1)};
  const size_t smem = 3 * (size_t)sp.ts * sizeof(float);
  cudaError_t e = allow_smem(smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + LTX_BLOCK - 1) / LTX_BLOCK;
  kernel_fn<<<blocks, LTX_BLOCK, smem, (cudaStream_t)stream>>>(
      a, sg, cv, sp, n, x, y, z, dob, age, pid, status, spoly, salt, temp,
      x_out, y_out, z_out, age_out, st_out, hitl_out, hitb_out, spoly_out,
      salt_out, temp_out);
  return (int)cudaGetLastError();
}
