// Particle migration between eta strips for Hopper (sm_90a): the slot
// block of one rank split into the particles that stay and the rows that
// leave, and the rows that arrive merged back into a new block.
//
// Replaces no TPU kernel: ltjax/shard.py::_migrate is XLA ops.  Added
// because its PyTorch form (the plain version, ltjax_torch/shard.py::
// plain_migrate) walks every slot of a rank's block some twenty times:
// four int64 cumsums, the 12 columns packed into rows twice (a stack,
// then a cat), the keepers' rows gathered, concatenated with the
// arrivals, gathered again and unpacked column by column (several GB of
// traffic at 7.5M slots), and it stops the host three times a call.
//
// What it computes, slot for slot and byte for byte as the plain version:
//   dest  = searchsorted(edges, double(y), right=True) - 1, clamped to
//           [0, nt - 1]; an EMPTY slot is nobody's (it is not kept);
//   the first mig_cap leavers of each destination (dest != my_t), in slot
//   order, are sent as rows (the 7 float columns in the positions' type,
//   then the 5 int32 columns, the layout of shard.pack_rows), grouped by
//   destination in tile order; leavers beyond mig_cap stay with status
//   ERROR;
//   the new block: the keepers (dest == my_t, and the overflowed leavers)
//   in slot order, then the arrivals whose status is not EMPTY in the
//   order received, cut at n, then the sentinel row up to n;
//   drops = the valid candidates beyond n plus the overflowed leavers;
//   sent  = the rows sent (int64 scalars on the device, as the counts for
//   the all_to_all).
//
// Design.  What bounds it: bytes.  y and status read twice (12 bytes a
// slot each time; 8 for float32 positions), a keeper's 12 columns read
// once and written once, every other slot of the new block written once
// (the arrivals and the sentinel), the leavers' rows written once: about
// 1.1 GB at 7.5M slots with 4.2M live (76-byte rows), 0.33 ms at 3.35
// TB/s.  No pass packs a slot that does not leave, and the host waits for
// nothing: two calls of four kernels in all, one slot a thread, 1,024
// slots a block.
//   split:  count   each block's slots per key (the destination; the
//                   keepers of this tile are key my_t) with __match_any
//                   and shared atomics; the last block to finish (a ticket,
//                   no spinning) turns the counts into prefixes over the
//                   blocks, the keepers' prefix (overflowed leavers
//                   included), the send counts and offsets;
//           scatter recounts its block the same way, ranks each slot
//                   among its key's slots in slot order, and writes a
//                   keeper's columns straight into the new block (a
//                   ballot compacts them) and a sent leaver's row into the
//                   send buffer.
//   (the caller exchanges the counts and the rows: one host read)
//   merge:  arrivals counts the valid arrivals a block; the last block
//                   sums them, the drops and where the sentinel starts;
//           fill    writes each valid arrival after the keepers (a
//                   ballot compacts them) and the sentinel into the rest.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 1024              // slots a block, one a thread
#define WARPS (THREADS / 32)
#define MAX_TILES 256
#define N_FLOATS 7                // x y z dob age salt temp
#define N_INTS 5                  // status pid settle_poly hit_land hit_bottom
#define FULL 0xffffffffu

struct Cols {                     // the 12 columns of a slot block
  void* f[N_FLOATS];              // in the positions' type
  int* i[N_INTS];                 // int32; i[0] the status
};

// the int32 scratch of one call (zeroed by the caller: the tickets)
struct Plan {
  int* ticket;                    // [2] blocks done: split, merge
  int* tot;                       // [4] keepers, overflowed, arrivals, fill start
  int* soff;                      // [nt] each destination's first send row
  int* bkeep;                     // [nb] keepers a block -> their prefix
  int* bcount;                    // [nb][nt] per block per key -> prefix
  __device__ Plan(int* s, int nt, int nb)
      : ticket(s), tot(s + 2), soff(s + 6), bkeep(s + 6 + nt),
        bcount(s + 6 + nt + nb) {}
};

template <typename T> struct Words { static const int n = sizeof(T) / 4; };

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

__device__ __forceinline__ int warp_inclusive(int v) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// exclusive prefix of v over the block; *total the block's sum
__device__ int block_exclusive(int v, int* sh, int* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int x = warp_inclusive(v);
  if (lane == 31) sh[wid] = x;
  __syncthreads();
  if (wid == 0) sh[lane] = warp_inclusive(sh[lane]);
  __syncthreads();
  const int base = wid ? sh[wid - 1] : 0;
  *total = sh[WARPS - 1];
  __syncthreads();                // sh is reused by the next call
  return base + x - v;
}

// searchsorted(edges, y, right=True) - 1, clamped: the number of edges
// not above y (an upper bound, as torch's search: NaN counts every edge)
__device__ __forceinline__ int dest_of(double y, const double* e, int nt) {
  int c = 0;
  for (int j = 0; j <= nt; ++j) c += !(e[j] > y);
  return min(max(c - 1, 0), nt - 1);
}

// a slot's key: its destination, -1 for EMPTY, -2 past the block's end
template <typename T>
__device__ __forceinline__ int slot_key(const Cols& in, int k, int n,
                                        const double* se, int nt,
                                        int empty) {
  if (k >= n) return -2;
  if (in.i[0][k] == empty) return -1;
  return dest_of((double)((const T*)in.f[1])[k], se, nt);
}

__device__ __forceinline__ void load_edges(double* se, const double* edges,
                                           int nt) {
  for (int j = threadIdx.x; j <= nt; j += THREADS) se[j] = edges[j];
}

// ---------------------------------------------------------------------------
// split
// ---------------------------------------------------------------------------

// the last block of the count kernel: prefixes over the nb blocks
__device__ void plan_split(Plan P, int nt, int nb, int my_t, int mc,
                           long long* out64) {
  __shared__ int sh[WARPS];
  const int t = threadIdx.x, per = (nb + THREADS - 1) / THREADS;
  const int b0 = min(nb, t * per), b1 = min(nb, b0 + per);
  for (int b = b0; b < b1; ++b) P.bkeep[b] = 0;
  int send_at = 0, overflowed = 0;
  for (int key = 0; key < nt; ++key) {
    int s = 0;
    for (int b = b0; b < b1; ++b) s += __ldcg(P.bcount + b * nt + key);
    int total;
    int run = block_exclusive(s, sh, &total);
    for (int b = b0; b < b1; ++b) {
      const int c = __ldcg(P.bcount + b * nt + key);
      P.bcount[b * nt + key] = run;
      // this key's keepers in block b: every stay, or the leavers whose
      // order in their destination lies at mig_cap or beyond
      P.bkeep[b] += key == my_t ? c : max(0, run + c - max(mc, run));
      run += c;
    }
    const int sends = key == my_t ? 0 : min(total, mc);
    if (t == 0) {
      out64[key] = sends;
      P.soff[key] = send_at;
    }
    send_at += sends;
    if (key != my_t) overflowed += max(0, total - mc);
  }
  int s = 0;
  for (int b = b0; b < b1; ++b) s += P.bkeep[b];
  int kept;
  int run = block_exclusive(s, sh, &kept);
  for (int b = b0; b < b1; ++b) {
    const int c = P.bkeep[b];
    P.bkeep[b] = run;
    run += c;
  }
  if (t == 0) {
    P.tot[0] = kept;
    P.tot[1] = overflowed;
    out64[nt + 1] = send_at;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
migrate_count_kernel(Cols in, int n, const double* __restrict__ edges,
                     int nt, int my_t, int mc, int empty, int* scratch,
                     long long* __restrict__ out64) {
  __shared__ double se[MAX_TILES + 1];
  __shared__ int cnt[MAX_TILES];
  __shared__ int last;
  const int t = threadIdx.x, nb = gridDim.x;
  load_edges(se, edges, nt);
  for (int j = t; j < nt; j += THREADS) cnt[j] = 0;
  __syncthreads();
  const int key = slot_key<T>(in, blockIdx.x * THREADS + t, n, se, nt,
                              empty);
  const unsigned grp = __match_any_sync(FULL, key);
  if (key >= 0 && (grp & lanes_below()) == 0)
    atomicAdd(&cnt[key], __popc(grp));
  __syncthreads();
  Plan P(scratch, nt, nb);
  for (int j = t; j < nt; j += THREADS) P.bcount[blockIdx.x * nt + j] = cnt[j];
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(P.ticket, 1) == nb - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  plan_split(P, nt, nb, my_t, mc, out64);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
migrate_scatter_kernel(Cols in, Cols out, int n,
                       const double* __restrict__ edges, int nt, int my_t,
                       int mc, int empty, int error, const int* scratch,
                       uint32_t* __restrict__ send) {
  __shared__ double se[MAX_TILES + 1];
  __shared__ int wcnt[WARPS * MAX_TILES];   // [warp][key]
  __shared__ int sh[WARPS];
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const int b = blockIdx.x, k = b * THREADS + t;
  const Plan P(const_cast<int*>(scratch), nt, gridDim.x);
  load_edges(se, edges, nt);
  for (int j = t; j < WARPS * nt; j += THREADS) wcnt[j] = 0;
  __syncthreads();
  const int key = slot_key<T>(in, k, n, se, nt, empty);
  const unsigned grp = __match_any_sync(FULL, key);
  const unsigned before = grp & lanes_below();
  if (key >= 0 && before == 0) wcnt[wid * nt + key] = __popc(grp);
  __syncthreads();
  // each key's slots in the warps before, over the block
  for (int j = wid; j < nt; j += WARPS) {
    const int v = wcnt[lane * nt + j];
    wcnt[lane * nt + j] = warp_inclusive(v) - v;
  }
  __syncthreads();
  bool keep = false, leave = false, overflow = false;
  int order = 0;
  if (key >= 0) {
    order = P.bcount[b * nt + key] + wcnt[wid * nt + key] + __popc(before);
    keep = key == my_t;
    leave = !keep && order < mc;
    overflow = !keep && !leave;
    keep = keep || overflow;
  }
  // the keepers in slot order
  const unsigned kb = __ballot_sync(FULL, keep);
  if (lane == 0) sh[wid] = __popc(kb);
  __syncthreads();
  if (wid == 0) {
    const int v = sh[lane];
    sh[lane] = warp_inclusive(v) - v;
  }
  __syncthreads();
  if (keep) {
    const int pos = P.bkeep[b] + sh[wid] + __popc(kb & lanes_below());
    for (int c = 0; c < N_FLOATS; ++c)
      ((T*)out.f[c])[pos] = ((const T*)in.f[c])[k];
    out.i[0][pos] = overflow ? error : in.i[0][k];
    for (int c = 1; c < N_INTS; ++c) out.i[c][pos] = in.i[c][k];
  }
  if (leave) {
    const int W = Words<T>::n;
    uint32_t* row = send + (size_t)(P.soff[key] + order) * (N_FLOATS * W
                                                            + N_INTS);
    for (int c = 0; c < N_FLOATS; ++c)
      for (int w = 0; w < W; ++w)
        row[c * W + w] = ((const uint32_t*)in.f[c])[(size_t)k * W + w];
    for (int c = 0; c < N_INTS; ++c)
      row[N_FLOATS * W + c] = (uint32_t)in.i[c][k];
  }
}

// ---------------------------------------------------------------------------
// merge
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
migrate_arrivals_kernel(const uint32_t* __restrict__ recv, int m, int words,
                        int status_at, int empty, int n, int nt,
                        int nb_split, int* scratch, int* acount,
                        long long* __restrict__ out64) {
  __shared__ int sh[WARPS];
  __shared__ int last;
  const int t = threadIdx.x, k = blockIdx.x * THREADS + t;
  const bool valid = k < m
      && (int)recv[(size_t)k * words + status_at] != empty;
  const int c = __syncthreads_count(valid);
  if (t == 0) acount[blockIdx.x] = c;
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(Plan(scratch, nt, nb_split).ticket + 1, 1)
                     == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int na = gridDim.x, per = (na + THREADS - 1) / THREADS;
  const int b0 = min(na, t * per), b1 = min(na, b0 + per);
  int s = 0;
  for (int b = b0; b < b1; ++b) s += __ldcg(acount + b);
  int arrived;
  int run = block_exclusive(s, sh, &arrived);
  for (int b = b0; b < b1; ++b) {
    const int v = __ldcg(acount + b);
    acount[b] = run;
    run += v;
  }
  if (t == 0) {
    Plan P(scratch, nt, nb_split);
    const long long all = (long long)P.tot[0] + arrived;
    const long long kept = all < n ? all : n;
    P.tot[2] = arrived;
    P.tot[3] = (int)kept;
    out64[nt] = all - kept + P.tot[1];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
migrate_fill_kernel(Cols out, int n, const uint32_t* __restrict__ recv,
                    int m, const uint32_t* __restrict__ sentinel, int empty,
                    int nt, int nb_split, const int* scratch,
                    const int* __restrict__ acount) {
  __shared__ int sh[WARPS];
  const int W = Words<T>::n, words = N_FLOATS * W + N_INTS;
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const int k = blockIdx.x * THREADS + t;
  const Plan P(const_cast<int*>(scratch), nt, nb_split);
  const uint32_t* row = recv + (size_t)k * words;
  const bool valid = k < m && (int)row[N_FLOATS * W] != empty;
  const unsigned vb = __ballot_sync(FULL, valid);
  if (lane == 0) sh[wid] = __popc(vb);
  __syncthreads();
  if (wid == 0) {
    const int v = sh[lane];
    sh[lane] = warp_inclusive(v) - v;
  }
  __syncthreads();
  int at = -1;                     // the new block's slot this thread fills
  if (valid) {
    const int pos = P.tot[0] + acount[blockIdx.x] + sh[wid]
                    + __popc(vb & lanes_below());
    if (pos < n) at = pos;
  }
  if (at >= 0) {
    for (int c = 0; c < N_FLOATS; ++c)
      for (int w = 0; w < W; ++w)
        ((uint32_t*)out.f[c])[(size_t)at * W + w] = row[c * W + w];
    for (int c = 0; c < N_INTS; ++c)
      out.i[c][at] = (int)row[N_FLOATS * W + c];
  }
  if (k < n && k >= P.tot[3]) {
    for (int c = 0; c < N_FLOATS; ++c)
      for (int w = 0; w < W; ++w)
        ((uint32_t*)out.f[c])[(size_t)k * W + w] = __ldg(sentinel + c * W
                                                          + w);
    for (int c = 0; c < N_INTS; ++c)
      out.i[c][k] = (int)__ldg(sentinel + N_FLOATS * W + c);
  }
}

// ---------------------------------------------------------------------------
// the C interface
// ---------------------------------------------------------------------------

static Cols cols_of(void* const* p) {
  Cols c;
  for (int j = 0; j < N_FLOATS; ++j) c.f[j] = p[j];
  for (int j = 0; j < N_INTS; ++j) c.i[j] = (int*)p[N_FLOATS + j];
  return c;
}

static int blocks_of(int n) { return n > 0 ? (n + THREADS - 1) / THREADS : 1; }

// in, out: the 12 columns' pointers (FLOATS then INTS, shard.py's order)
extern "C" int ltx_migrate_split(int pos64, void* const* in, void* const* out,
                                 int n, const double* edges, int nt,
                                 int my_t, int mc, int empty, int error,
                                 int* scratch, long long* out64, void* send,
                                 void* stream) {
  if (n < 0 || nt < 1 || nt > MAX_TILES || my_t < 0 || my_t >= nt
      || mc < 0)
    return (int)cudaErrorInvalidValue;
  const Cols ci = cols_of(in), co = cols_of(out);
  const int nb = blocks_of(n);
  cudaStream_t s = (cudaStream_t)stream;
  if (pos64) {
    migrate_count_kernel<double><<<nb, THREADS, 0, s>>>(
        ci, n, edges, nt, my_t, mc, empty, scratch, out64);
    migrate_scatter_kernel<double><<<nb, THREADS, 0, s>>>(
        ci, co, n, edges, nt, my_t, mc, empty, error, scratch,
        (uint32_t*)send);
  } else {
    migrate_count_kernel<float><<<nb, THREADS, 0, s>>>(
        ci, n, edges, nt, my_t, mc, empty, scratch, out64);
    migrate_scatter_kernel<float><<<nb, THREADS, 0, s>>>(
        ci, co, n, edges, nt, my_t, mc, empty, error, scratch,
        (uint32_t*)send);
  }
  return (int)cudaGetLastError();
}

extern "C" int ltx_migrate_merge(int pos64, void* const* out, int n, int nt,
                                 const void* recv, int m,
                                 const void* sentinel, int empty,
                                 int* scratch, int* acount, long long* out64,
                                 void* stream) {
  if (n < 0 || m < 0 || nt < 1 || nt > MAX_TILES)
    return (int)cudaErrorInvalidValue;
  const Cols co = cols_of(out);
  const int nb = blocks_of(n), na = blocks_of(m);
  const int W = pos64 ? 2 : 1, words = N_FLOATS * W + N_INTS;
  cudaStream_t s = (cudaStream_t)stream;
  migrate_arrivals_kernel<<<na, THREADS, 0, s>>>(
      (const uint32_t*)recv, m, words, N_FLOATS * W, empty, n, nt, nb,
      scratch, acount, out64);
  const int nf = blocks_of(n > m ? n : m);
  if (pos64)
    migrate_fill_kernel<double><<<nf, THREADS, 0, s>>>(
        co, n, (const uint32_t*)recv, m, (const uint32_t*)sentinel, empty,
        nt, nb, scratch, acount);
  else
    migrate_fill_kernel<float><<<nf, THREADS, 0, s>>>(
        co, n, (const uint32_t*)recv, m, (const uint32_t*)sentinel, empty,
        nt, nb, scratch, acount);
  return (int)cudaGetLastError();
}
