// Kernel D: segment expansion with per-segment fills.
//
// Replaces the TPU kernel harkdb_tpu/kernels/expand.py (_make_expand_kernel,
// launched by _run_expand through pl.pallas_call): for every output slot
// p < out_capacity,
//     seg[p]        = max{i < n_src : offsets[i] <= p}   (0 if none),
//     offsets_f[p]  = offsets[seg[p]],
//     extra_f[e][p] = extra[e][seg[p]]   for each extra plane e.
// Entries of offsets at index >= n_src are ignored (they read as INT32_MAX,
// exactly as the TPU wrapper's off_eff does). The join's pair
// materialisation calls it with the pre-compacted, strictly increasing
// segment starts and two extra planes (each segment's first matching right
// row and its match end).
//
// What bounds it on an H100: memory latency, not bandwidth. The outputs are
// a streaming write of (2 + E) words a slot; the search is log2(n_src)
// dependent reads per slot (23 at the star join's 8.4M segments). The
// offsets array is 4 B per segment, so at 8.4M segments it is 32 MiB and
// stays in the 50 MB L2: the searches hit L2, and their first levels are
// the same for every thread and hit L1.
//
// What the design does about it: one thread per output slot in a
// grid-stride loop; each thread runs an upper_bound binary search over
// offsets[0:n_src], then writes the seg id, the offset fill and every extra
// plane's fill in the same pass. Neighbouring threads own neighbouring slots,
// so the stores are coalesced and the gathers of the fills (seg is
// non-decreasing in p) mostly are too. The TPU kernel's log-shift dilation
// and max-scan existed because a binary search is a chain of dependent
// gathers on the TPU; on the card it is cheap. Binary search also needs no
// monotone-extras precondition (the TPU max-fill did). n_src is read from
// device memory, so the caller never synchronises with the host. A marker
// scatter with a decoupled max-scan, or a shared-memory window per tile, is
// later speed-up work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxExtras = 8;
constexpr int32_t kI32Max = 2147483647;

struct PlaneTable {
  const int32_t* in[kMaxExtras];
  int32_t* out[kMaxExtras];
};

__global__ void __launch_bounds__(kThreads)
expand_kernel(const int32_t* __restrict__ offsets,
              const int32_t* __restrict__ n_src_ptr, int64_t cap,
              int64_t out_capacity, int n_extra, PlaneTable planes,
              int32_t* __restrict__ seg_out, int32_t* __restrict__ off_out) {
  int64_t n = *n_src_ptr;
  if (n < 0) n = 0;
  if (n > cap) n = cap;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       p < out_capacity; p += stride) {
    // upper_bound: first index in [0, n) whose offset exceeds p.
    int64_t lo = 0, hi = n;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (static_cast<int64_t>(offsets[mid]) <= p) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int64_t seg = lo > 0 ? lo - 1 : 0;
    seg_out[p] = static_cast<int32_t>(seg);
    off_out[p] = seg < n ? offsets[seg] : kI32Max;
    for (int e = 0; e < n_extra; ++e) planes.out[e][p] = planes.in[e][seg];
  }
}

}  // namespace

extern "C" {

// extra_in / extra_out are host arrays of n_extra device pointers
// (n_extra <= kMaxExtras, checked by the wrapper). Requires cap >= 1.
int harkdb_expand_fills(const void* offsets, const void* n_src, int64_t cap,
                        int64_t out_capacity, int n_extra,
                        void* const* extra_in, void* const* extra_out,
                        void* seg_out, void* off_out, int sm_count,
                        void* stream) {
  if (n_extra < 0 || n_extra > kMaxExtras || cap < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (out_capacity <= 0) return static_cast<int>(cudaGetLastError());
  PlaneTable table;
  for (int e = 0; e < n_extra; ++e) {
    table.in[e] = static_cast<const int32_t*>(extra_in[e]);
    table.out[e] = static_cast<int32_t*>(extra_out[e]);
  }
  int64_t blocks = (out_capacity + kThreads - 1) / kThreads;
  const int64_t max_blocks = static_cast<int64_t>(sm_count) * 16;
  if (blocks > max_blocks) blocks = max_blocks;
  expand_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(offsets),
      static_cast<const int32_t*>(n_src), cap, out_capacity, n_extra, table,
      static_cast<int32_t*>(seg_out), static_cast<int32_t*>(off_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
