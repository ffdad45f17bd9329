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
// LTX_SALT, LTX_CURV, LTX_POS64, LTX_AXES, LTX_TILE; the wrapper builds
// one library per combination), so each configuration carries only its
// own lanes;
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
// (Axes, a kernel argument of its own).  LTX_TILE runs one tile of a
// sharded run (ltjax_torch.shard): the record table, boundary rows and
// polygon candidates are the strip's (ny rows), and every cell location
// (rho stencil, boundary cell, settlement cell) runs on the whole grid's
// axes, origins and rows (P_NYG; searched axes the whole grid's), then
// moves P_ROW0 rows into the strip (find_currents.cuh to_strip): the
// arithmetic of an unsharded run, so a tile steps its particles bit for
// bit as the whole grid does.
//
// Design.  One thread per particle, LTX_BLOCK = 128 threads a block, one
// launch per external step; the n_int internal steps run inside the
// thread with x, y, z, status (and the age, where behavior or mortality
// read it) in registers.  find_currents.cuh (shared with rk4_step.cu)
// fits and evaluates, and lanes.cuh's step_lanes (shared with
// step_lanes.cu) runs every lane after the RK4 displacement; every lane
// read of a step goes through the staged
// corner source below: at the top of each internal step the block
// reduces the box of its active particles' stage-1 cells, and when the
// box (grown by a cell on each side) holds at most tile_points rho
// points it collapses the three raw records into three shared-memory
// tiles (t, t + idt/2, t + idt) of every lane of the table, once per
// point (stage_records: each box row is bw * nl consecutive floats of a
// record, so the loads are coalesced; 4-byte loads, no 16-byte ones).
// A box of up to 3 x tile_points points (blocks whose particles drift
// apart between two sorts, under vertical shear) is split: the same
// shared memory holds one tile of it at a time (stage_tile), restaged
// between RK4 stages 1 and 2 (t + idt/2) and 3 and 4 (t + idt), each
// restage between two barriers that every thread of the block reaches.
// The fit scratch stays in local memory: its frame size measured no
// cost.  __launch_bounds__(128, 4): every float32 variant at <= 128
// registers with no spills, where ptxas alone chose 96 with spills in 6
// variants; measured, the bound makes the advect and behavior cells 4-5%
// faster at 1M particles and 15-23% at 65,536, turb 1-5% slower.  The
// float64 variants' bound is LTX_MIN_BLOCKS below (measured too).
// The four RK4 stages, the Visser Aks fit, the behavior column and the
// 4/5 salt cue (stage 1), the vertical reflection's column and SaltTempOn
// (t + idt) then blend 4 shared words per lane where the global path
// loads 12 scattered ones.  A lookup outside the box, a lookup of a
// split box at a stage time whose tile is not resident (Visser's Aks
// column, the behaviors' zeta/h and the 4/5 cue at t, read in step_lanes
// after the t + idt restage) and every lookup of a block whose box is
// too large read the raw records with the same arithmetic (collapse,
// blend), and are counted (staged_misses, global_block_steps, beside
// staged_block_steps and split_block_steps): the result does not depend
// on which path a lookup took.  The inverse curvilinear map, the
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
// A split box takes the same bytes as one tile of 3 x tile_points points
// (108 for advection, 96 for the oyster lanes), so it holds three times
// the points at the same occupancy; it pays two more collapse passes of
// its box (from L2) and four barriers a block-step.
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
#ifndef LTX_TILE
#define LTX_TILE 0
#endif

#include "find_currents.cuh"
#include "curv.cuh"
#include "lanes.cuh"

// ---- the staged corner source ------------------------------------------
//
// At the top of each internal step a block reduces the rho-cell bounding
// box of its active particles' stage-1 positions (block_box), grows it by
// one cell on each side (a stage moves a particle by less than a cell at
// the speeds of the bench cases: 4.2 m/s x 120 s = 0.5 km on 1 km cells)
// and sizes it against the launch's budget (Stage::points):
//
//   three tiles (points <= budget): one staging pass writes three tiles
//     into dynamic shared memory, one per stage time (t, t + idt/2,
//     t + idt), Stage::ts floats apart;
//   split (budget < points <= 3 x budget): the same shared memory holds
//     one tile of up to 3 x budget points at a time.  The block stages
//     the t tile before stage 1, restages the t + idt/2 tile after it
//     (stages 2 and 3 read it) and the t + idt tile after stage 3 (stage
//     4 and step_lanes' reads at q = 2: the vertical reflection's column,
//     SaltTempOn).  Each restage sits between two barriers (no thread
//     still reads the old tile; every thread sees the new one) that every
//     thread of the block reaches, those without an active particle and
//     those past the batch too; the kind is uniform across the block.  A
//     lookup at a stage time that is not resident (Visser's and the
//     behaviors' reads at q = 0 inside step_lanes) is a counted miss;
//   global (more points, or no budget): every lookup from device memory.
//
// Every point and lane of a tile is the three raw records collapsed once
// (collapse(), the arithmetic of the global path), so a lookup returns
// the same value whichever path served it.  A tile is [row][column][lane],
// ls = nl | 1 floats per point (odd, so the distinct points that a warp
// reads fall in distinct banks; threads of one point read one word, a
// broadcast), rows bw points wide.

// threads a block (the launch's); not an #ifndef option: build.tag reads
// those as the variant's macros
#define LTX_BLOCK 128

// the staged rho points [i0, i0 + bw) x [j0, j0 + bh) of a block's tiles;
// bw = 0: nothing staged.  q: the stage time of a split box's one
// resident tile, -1 where the three tiles are (or nothing is) staged
struct Box {
  int i0, j0, bw, bh, q;
};

// block-step kinds (also the index of the block's shared tally)
enum { BOX_EMPTY = 0, BOX_STAGED = 1, BOX_SPLIT = 2, BOX_GLOBAL = 3 };

// the box of the cells (i, j) of the block's active threads (act), grown
// by one cell on each side and clipped to the nx x ny points; staged
// (bw > 0) if it holds at most 3 x max_points points.  kind: BOX_EMPTY
// (no active thread), BOX_STAGED (three tiles: at most max_points),
// BOX_SPLIT (one tile at a time, q = 0 first) or BOX_GLOBAL.  Every
// thread of the block calls it (it holds a barrier); red is 2 x 4 x
// LTX_BLOCK/32 ints of shared memory, used by half per call (parity), so
// that the next call may write the other half while a slow warp still
// reads this one.
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
  Box b = {0, 0, 0, 0, -1};
  if (v0 == big) {
    kind = BOX_EMPTY;
    return b;
  }
  b.i0 = max(v0 - 1, 0);
  b.j0 = max(v2 - 1, 0);
  const int bw = min(2 - v1, nx - 1) - b.i0 + 1;
  const int bh = min(2 - v3, ny - 1) - b.j0 + 1;
  kind = bw * bh <= max_points       ? BOX_STAGED
         : bw * bh <= 3 * max_points ? BOX_SPLIT
                                     : BOX_GLOBAL;
  if (kind != BOX_GLOBAL) {
    b.bw = bw;
    b.bh = bh;
    if (kind == BOX_SPLIT) b.q = 0;
  }
  return b;
}

// the launch's staged corner source: a kernel argument of its own, like
// Settle
struct Stage {
  unsigned long long* cnt;   // staged_block_steps, global_block_steps,
                             // staged_misses, split_block_steps,
                             // active_steps
  int points;                // rho points a block may stage in three
                             // tiles (tile_points); 3x that split
  int ls, ts;                // tile_lanes (nl | 1); floats between tiles
};

// stencil s of cell (i, j), read at stage time q, into the tiles of box
// b (s.t: the offset of its point in the tile of q), or a miss, counted
// when the block staged: the cell outside the box, or q not resident in
// a split box
__device__ __forceinline__ void stage_in(Stencil& s, const Box& b,
                                         const Stage& sp, int i, int j,
                                         int q, int& miss) {
  const int di = i - b.i0, dj = j - b.j0;
  if (di >= 0 && di + 1 < b.bw && dj >= 0 && dj + 1 < b.bh
      && (b.q < 0 || b.q == q)) {
    s.t = (b.q < 0 ? q * sp.ts : 0) + (dj * b.bw + di) * sp.ls;
    s.rs = b.bw * sp.ls;
  } else if (b.bw > 0) {
    ++miss;
  }
}

// the launch's device counters: staged_block_steps (three tiles and
// split), global_block_steps, staged_misses, split_block_steps,
// active_steps (one atomic per block and warp at the kernel's end; every
// thread calls it).  kinds is the block's shared tally of block-steps by
// kind (thread 0's), active its shared total of active particle-steps,
// which the barrier completes
__device__ __forceinline__ void count_staging(unsigned long long* cnt,
                                              const unsigned* kinds,
                                              int miss,
                                              const unsigned& active) {
  const int m = __reduce_add_sync(0xffffffffu, miss);
  if ((threadIdx.x & 31) == 0 && m > 0)
    atomicAdd(cnt + 2, (unsigned long long)m);
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned staged = kinds[BOX_STAGED] + kinds[BOX_SPLIT];
    if (staged > 0) atomicAdd(cnt, (unsigned long long)staged);
    if (kinds[BOX_GLOBAL] > 0)
      atomicAdd(cnt + 1, (unsigned long long)kinds[BOX_GLOBAL]);
    if (kinds[BOX_SPLIT] > 0)
      atomicAdd(cnt + 3, (unsigned long long)kinds[BOX_SPLIT]);
    if (active > 0) atomicAdd(cnt + 4, (unsigned long long)active);
  }
}

// three tiles of Stage::ts floats, or one split tile of up to 3 x ts
extern __shared__ float ltx_tiles[];

// the stencil of (x, y), read at stage time q, in the tiles of box b, or
// a (counted) miss
__device__ __forceinline__ Stencil locate(const Args& a, const Stage& sp,
                                          const Curv& cv, const Axes& ax,
                                          const Box& b, pos_t x, pos_t y,
                                          int q, int& miss) {
  int i, j;
  Stencil s = locate(a, cv, ax, x, y, i, j);
  stage_in(s, b, sp, i, j, q, miss);
  return s;
}

// lane k of the table collapsed to stage time q (weights l + 3q: t,
// t + idt/2, t + idt), blended at stencil s: from the tile that
// stage_in put in s.t, which is q's only where s was located at this
// same q (lanes.cuh's Src contract), else from the raw records
__device__ __forceinline__ float lane(const Args& a, const Stage& sp,
                                      const Stencil& s, const float* l,
                                      int q, int k) {
  if (s.t >= 0) {
    const float* t = ltx_tiles + s.t + k;
    return blend(s, t[0], t[sp.ls], t[s.rs], t[s.rs + sp.ls]);
  }
  return record_lane(a, s, l + 3 * q, k);
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

// the one tile of split box b: at every point and lane the raw records
// collapsed with the weights w of one stage time.  Element e of the box is
// lane k of point p (row r, column c); each thread steps e by LTX_BLOCK
// and carries k, p, c and r along, with no integer divide in the loop
// (with a divide an element, as stage_records has, K1 took 25% longer on
// the advect-sheared-1m cell: H100, its float64 build).  Consecutive
// threads read consecutive floats of a box row: coalesced loads.
__device__ void stage_tile(const Args& a, const Stage& sp, const Box& b,
                           const float* w) {
  const long long R = a.C * a.nl;
  const int nl = a.nl, total = b.bw * b.bh * nl;
  const int dp = LTX_BLOCK / nl, dk = LTX_BLOCK - dp * nl;
  int e = threadIdx.x;
  int p = e / nl, k = e - p * nl;
  int r = p / b.bw, c = p - r * b.bw;
  for (; e < total; e += LTX_BLOCK) {
    const float* s =
        a.rtab + ((long long)(b.j0 + r) * a.nx + b.i0 + c) * nl + k;
    ltx_tiles[p * sp.ls + k] = collapse(s[0], s[R], s[2 * R], w);
    k += dk;
    c += dp;
    p += dp;
    if (k >= nl) {
      k -= nl;
      ++c;
      ++p;
    }
    while (c >= b.bw) {
      c -= b.bw;
      ++r;
    }
  }
}

// a split box's one tile moves on to stage time q (weights l + 3q);
// nothing for any other box.  Every thread of the block calls it: the
// barriers before (no thread still reads the old tile) and after (every
// thread sees the new one)
__device__ __forceinline__ void restage(const Args& a, const Stage& sp,
                                        Box& b, const float* l, int q) {
  if (b.q < 0) return;
  __syncthreads();
  stage_tile(a, sp, b, l + 3 * q);
  b.q = q;
  __syncthreads();
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
                   locate(a, sp, cv, ax, b, x, y, q, miss), z, cp, dp0, dp1,
                   u, v, w);
}

// the corner source of step_lanes (lanes.cuh): the stages of internal
// step l from the block's tiles of box b, else from the raw records
// (misses counted)
struct Staged {
  const Args& a;
  const Stage& sp;
  const Curv& cv;
  const Axes& ax;
  const Box& b;
  const float* l;
  int& miss;
  __device__ __forceinline__ Stencil at(pos_t x, pos_t y, int q) const {
    return locate(a, sp, cv, ax, b, x, y, q, miss);
  }
  __device__ __forceinline__ float lane(const Stencil& s, int q,
                                        int k) const {
    return ::lane(a, sp, s, l, q, k);
  }
  __device__ __forceinline__ Records rec(int q) const {
    return Records{a, sp, l, q};
  }
  // behavior 3's surface irradiance of internal step i (after the 9
  // polintd weights of every internal step)
  __device__ __forceinline__ pos_t e0(int i) const {
    const pos_t* pcoef = ppar(a) + P_HEAD + 2 * (a.us + a.ws);
    return pcoef[9 * a.n_int + i];
  }
};

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
  // the block's particle-steps whose lanes ran (active_steps) and its
  // block-steps by kind (BOX_*), kept in shared memory, off the register
  // file (kinds by thread 0 alone)
  __shared__ unsigned act_n, kinds[4];
  if (threadIdx.x == 0) {
    act_n = 0u;
    for (int k = 0; k < 4; ++k) kinds[k] = 0u;
  }
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
  int miss = 0;               // staged misses
  const pos_t idt = par[P_IDT];
  const pos_t half = pos_t(0.5) * idt;
  const pos_t sixth = idt / pos_t(6);
  const float* coef = a.par + P_HEAD + 2 * (a.us + a.ws);

  for (int i = 0; i < a.n_int; ++i) {
    pos_t t_i = par[P_T0] + (pos_t)i * idt;
    if (st == NOT_RELEASED && t_i >= dob) st = ACTIVE;
    const pos_t age_pre = age;  // behavior, mortality, settlement read it
    if constexpr (AGE) {
      if (st >= ACTIVE) age = (t_i + idt) - dob;
    }
    const float* l = coef + 9 * i;        // stage weights: t, t+idt/2, t+idt
    // the block's box of stage-1 cells; its three tiles when it fits, its
    // t tile when it fits split
    const bool act = st == ACTIVE;
    int ci = 0, cj = 0, kind;
    Stencil s1;
    if (act) s1 = locate(a, cv, ax, x, y, ci, cj);
    Box box = block_box(act, ci, cj, a.nx, a.ny, sp.points, red, i & 1,
                        kind);
    // counted here, not in block_box: its barrier as __syncthreads_count,
    // or a per-warp sum beside its lane-0 stores, made the advect build
    // 4.4-4.7% slower (H100, tools/cells_ab.py at 1M); this, 1.0%
    {
      const unsigned w = __ballot_sync(0xffffffffu, act);
      if ((threadIdx.x & 31) == 0) atomicAdd(&act_n, (unsigned)__popc(w));
    }
    if (kind == BOX_STAGED) {
      stage_records(a, sp, box, l);
      __syncthreads();
    } else if (kind == BOX_SPLIT) {
      stage_tile(a, sp, box, l);
      __syncthreads();
    }
    if (threadIdx.x == 0) ++kinds[kind];
    // a thread without an active particle still reaches a split box's
    // restage barriers
    pos_t u1, v1, w1, u2, v2, w2, u3, v3, w3, u4, v4, w4;
    if (act) {
      stage_in(s1, box, sp, ci, cj, 0, miss);
      find_currents_at(Records{a, sp, l, 0}, T, s1, z, cp, dp0, dp1, u1, v1,
                       w1);
    }
    restage(a, sp, box, l, 1);
    if (act) {
      find_currents(a, sp, cv, ax, T, box, l, 1, x + u1 * half,
                    y + v1 * half, z + w1 * half, cp, dp0, dp1, miss, u2, v2,
                    w2);
      find_currents(a, sp, cv, ax, T, box, l, 1, x + u2 * half,
                    y + v2 * half, z + w2 * half, cp, dp0, dp1, miss, u3, v3,
                    w3);
    }
    restage(a, sp, box, l, 2);
    if (!act) continue;
    find_currents(a, sp, cv, ax, T, box, l, 2, x + u3 * idt, y + v3 * idt,
                  z + w3 * idt, cp, dp0, dp1, miss, u4, v4, w4);
    pos_t dx = sixth * (u1 + pos_t(2) * u2 + pos_t(2) * u3 + u4);
    pos_t dy = sixth * (v1 + pos_t(2) * v2 + pos_t(2) * v3 + v4);
    pos_t dz = sixth * (w1 + pos_t(2) * w2 + pos_t(2) * w3 + w4);

    step_lanes<HT, VT, BEH, MORT, SETTLE, SALT>(
        Staged{a, sp, cv, ax, box, l, miss}, a, sg, cv, ax, Ts, cq, dq0, dq1,
        STRIDE, i, pid, age_pre, u1, v1, dx, dy, dz, x, y, z, st, spoly,
        salt, temp, hitl, hitb);
  }
  count_staging(sp.cnt, kinds, miss, act_n);
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
// a block may stage in three tiles, 3 * tile_points split (the launch
// takes 3 * tile_points * (nl | 1) floats of dynamic shared memory; 0
// runs every block from device memory); counters (5 u64, zeroed by the
// caller once) accumulate staged_block_steps, global_block_steps,
// staged_misses, split_block_steps and active_steps.  axis_x/axis_y
// (nx, ny) are the rho axes, edge_x/edge_y (nx + 1, ny + 1) the boundary
// cell edges (each pair null where uniform) and settle_ex/settle_ey the
// edges in f64 for settlement: given only to an LTX_AXES variant.
// Returns the launch's cudaError_t.
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
  if (bad_tables(us, ws, nl, aks0, salt0, n_poly, settle_d, settle_i,
                 curv_xy, curv_seed, curv_mx, curv_my, dparams, axis_x,
                 axis_y, edge_x, edge_y, settle_ex, settle_ey)
      || tile_points < 0 || !counters)
    return (int)cudaErrorInvalidValue;      // lane offsets, tables
  if (n <= 0) return 0;
  const Args a = make_args(rtab, brows, params, dparams, rngk, nx, ny, us,
                           ws, nl, salt0, vtransform, n_int, n_iter,
                           open_exits, s_max);
  const Settle sg = make_settle(settle_d, settle_i, n_poly, vmax_poly,
                                cmax_poly, n_hole, vmax_hole, cmax_hole, a.C);
  const Curv cv = make_curv(curv_xy, curv_seed, curv_mx, curv_my, curv_rx0,
                            curv_ry0, curv_inv_rdx, curv_inv_rdy, curv_tol2);
  const Axes ax = {axis_x, axis_y, edge_x, edge_y, settle_ex, settle_ey};
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
