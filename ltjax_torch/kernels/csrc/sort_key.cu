// The Hilbert sort key of the particle batch for Hopper (sm_90a).
//
// Replaces no TPU kernel: ltjax/spatial.py::hilbert_key and
// sort_by_cell's key are XLA elementwise ops.  Added because their
// PyTorch form (the plain version, ltjax_torch/kernels/sort_key.py::
// plain_key) is some 20 elementwise launches over int64 tensors of every
// slot for each of the curve's 15 levels: about 300 launches and 35 GB
// of traffic a sort of 7.5M slots, for integer arithmetic that fits in
// registers.
//
// Per slot k, from its rho cell (ci, cj) (step._sort_cells), its status
// and, where the sort is banded, its depth band:
//   unbanded: hilbert_key(ci, cj, 15) + 2^30 if the slot is parked;
//   banded:   hilbert_key(ci, cj, 14) + (band << 28), band clamped to
//             [0, n_bands - 1], and 7 for a parked slot;
// parked = status >= SETTLED or status < 0 (a sharded run's EMPTY slots).
// Cells are clamped to [0, 2^bits - 1] as the plain version clamps them.
// Every key lies below 2^31, so the caller sorts int32 keys.
//
// The plain version walks the curve on int64 values where a flipped
// quadrant goes negative (s - 1 - x with x >= s); this kernel does it on
// unsigned 32-bit values, which wrap.  Each level reads bit s of x and
// y alone, and the low 32 bits of the two agree at every level, so the
// keys are equal bit for bit.
//
// Design.  One thread per slot, 256 threads a block, one launch a sort.
// What bounds it: bytes.  12 bytes read a slot (16 banded) and 4
// written, the 15 levels a few integer operations each in registers:
// at 7.5M slots 120 MB, about 0.04 ms at 3.35 TB/s.

#include <cuda_runtime.h>

__global__ void sort_key_kernel(const int* __restrict__ ci,
                                const int* __restrict__ cj,
                                const int* __restrict__ status,
                                const int* __restrict__ band,
                                int* __restrict__ key, int n, int bits,
                                int n_bands, int settled) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int top = (1 << bits) - 1;
  unsigned x = (unsigned)min(max(ci[k], 0), top);
  unsigned y = (unsigned)min(max(cj[k], 0), top);
  unsigned d = 0u;
  for (unsigned s = 1u << (bits - 1); s != 0u; s >>= 1) {
    const unsigned rx = (x & s) != 0u;
    const unsigned ry = (y & s) != 0u;
    d += s * s * ((3u * rx) ^ ry);
    if (ry == 0u) {                       // rotate the quadrant
      if (rx == 1u) {
        x = s - 1u - x;
        y = s - 1u - y;
      }
      const unsigned t = x;
      x = y;
      y = t;
    }
  }
  const int st = status[k];
  const bool parked = st >= settled || st < 0;
  unsigned hi;
  if (band == nullptr)
    hi = parked ? 1u << 30 : 0u;
  else
    hi = (unsigned)(parked ? 7 : min(max(band[k], 0), n_bands - 1)) << 28;
  key[k] = (int)(d + hi);
}

extern "C" int ltx_sort_key(const int* ci, const int* cj, const int* status,
                            const int* band, int* key, int n, int bits,
                            int n_bands, int settled, void* stream) {
  if (n < 0 || bits < 1 || bits > 15 || (band && bits > 14)
      || (band && (n_bands < 1 || n_bands > 6)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  sort_key_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      ci, cj, status, band, key, n, bits, n_bands, settled);
  return (int)cudaGetLastError();
}
