// Kernel D: segment expansion with per-segment fills.
//
// Replaces the TPU kernel harkdb_tpu/kernels/expand.py (_make_expand_kernel,
// launched by _run_expand through pl.pallas_call): for every output slot
// p < out_capacity,
//     seg[p]        = max{i < n_src : offsets[i] <= p}   (0 if none),
//     offsets_f[p]  = offsets[seg[p]],
//     extra_f[e][p] = extra[e][seg[p]]   for each extra plane e.
// Entries of offsets at index >= n_src are ignored (they read as INT32_MAX,
// exactly as the TPU wrapper's off_eff does). With n_src = 0 every slot gets
// seg 0, offset fill INT32_MAX and extra[e][0]. Equal offsets (empty
// segments, outside the TPU contract) give the last of the equal entries,
// as torch.searchsorted(..., right=True) does. The join's pair
// materialisation calls it with the pre-compacted, strictly increasing
// segment starts and two extra planes (each segment's first matching right
// row and its match end).
//
// What bounds it on an H100: device-memory bandwidth, once the latency of
// its dependent reads is hidden. The work must read 4 B per live segment
// and plane and write (2 + E) words a slot. A search per slot (the previous
// design: one upper_bound in global memory per slot, 23 dependent L2 reads
// at the star join's 8.4M segments) made every slot wait on a chain of
// reads, and the kernel ran at a quarter of the bandwidth.
//
// What the design does about it, after the TPU kernel's own structure:
// each block owns a tile of T consecutive output slots, independent of every
// other tile (no carry, no look-back).
//   1. Two warps find the tile's source window once: s_lo = seg(t0) and
//      s_hi = seg(t_last), each by a 32-ary search over offsets[0:n_src]
//      (32 probes a round, one ballot; 6 rounds at 8.4M segments).
//   2. The window's offsets, offsets[s_lo .. s_hi], are copied to shared
//      memory with cp.async in one round trip, while each extra plane's
//      window is prefetched into L2. Every segment after s_lo starts inside
//      the tile and scatters a marker (its index minus s_lo) to its start
//      slot in a T-word shared array with atomicMax, so the last of equal
//      offsets wins. A window wider than the tile (only equal offsets make
//      one) is not staged: its markers are read from global memory, in
//      batches, and still land inside the tile.
//   3. A block max-scan of the markers (serial over each thread's T/threads
//      slots, warp shuffles, then the warp totals) gives every slot its
//      seg - s_lo in shared memory: the TPU kernel's dilation + max-fill.
//   4. A warp writes 32 consecutive slots (128 B) an instruction: seg, the
//      offset fill from the staged window, and each plane's fill, gathered
//      inside the plane's prefetched window with all of a thread's loads in
//      flight together.
// The tile's dependent reads (n_src, the search rounds, the window) are a
// fixed latency per tile, about the same at 2048 and 4096 slots, so what
// sets the speed is how many slots an SM holds in flight: a block keeps only
// 8 B of shared memory a slot, and six blocks of 256 threads share an SM.
// Staging every plane's window in shared memory (16 B a slot) left room for
// fewer tiles and was slower. n_src is read from device memory, so the
// caller never synchronises with the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxExtras = 8;
constexpr int32_t kI32Max = 2147483647;
constexpr unsigned kFull = 0xffffffffu;

struct PlaneTable {
  const int32_t* in[kMaxExtras];
  int32_t* out[kMaxExtras];
};

// Number of entries of off[0:n] that are <= x (off non-decreasing): the
// warp probes 32 evenly spaced entries of the remaining range a round.
// Called by all 32 lanes of a warp; lo and hi stay warp-uniform.
__device__ __forceinline__ int64_t warp_upper_bound(
    const int32_t* __restrict__ off, int64_t n, int64_t x) {
  const int lane = threadIdx.x & 31;
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) >> 5;
    const int64_t idx = lo + lane * step;
    const bool le = idx < hi && static_cast<int64_t>(__ldg(off + idx)) <= x;
    const int k = __popc(__ballot_sync(kFull, le));
    if (k == 0) {
      hi = lo;
    } else {
      const int64_t top = lo + k * step;
      lo += (k - 1) * step + 1;
      hi = top < hi ? top : hi;
    }
  }
  return lo;
}

__device__ __forceinline__ void copy_async4(int32_t* smem,
                                            const int32_t* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void prefetch_l2(const int32_t* gmem) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(gmem));
}

constexpr int kTile = 2048;     // output slots a block owns
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads, 1536 / kThreads)
expand_kernel(const int32_t* __restrict__ offsets,
              const int32_t* __restrict__ n_src_ptr, int64_t cap,
              int64_t out_capacity, int n_extra, PlaneTable planes,
              int32_t* __restrict__ seg_out, int32_t* __restrict__ off_out) {
  constexpr int kPer = kTile / kThreads;        // slots a thread holds
  constexpr int kWarps = kThreads / 32;
  static_assert(kPer % 8 == 0, "a thread holds whole chunks of 8 slots");
  __shared__ __align__(16) int32_t mark[kTile];
  __shared__ int32_t win[kTile];                // offsets[s_lo + i]
  __shared__ int64_t window[2];
  __shared__ int32_t warp_max[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int64_t n = *n_src_ptr;
  if (n < 0) n = 0;
  if (n > cap) n = cap;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t t_end = t0 + kTile < out_capacity ? t0 + kTile : out_capacity;

  int4* mark4 = reinterpret_cast<int4*>(mark);
  for (int i = tid; i < kTile / 4; i += kThreads) {
    mark4[i] = make_int4(0, 0, 0, 0);
  }
  if (warp < 2) {
    const int64_t c =
        warp_upper_bound(offsets, n, warp == 0 ? t0 : t_end - 1);
    if (lane == 0) window[warp] = c > 0 ? c - 1 : 0;
  }
  __syncthreads();
  const int64_t s_lo = window[0], s_hi = window[1];
  const int64_t width = s_hi - s_lo + 1;
  const bool staged = width <= kTile;

  if (staged) {
    for (int i = tid; i < width; i += kThreads) {
      copy_async4(win + i, offsets + s_lo + i);
    }
  }
#pragma unroll
  for (int e = 0; e < kMaxExtras; ++e) {
    if (e >= n_extra) break;
    for (int64_t i = s_lo + 32 * tid; i <= s_hi; i += 32 * kThreads) {
      prefetch_l2(planes.in[e] + i);
    }
  }
  if (staged) {
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
    // Markers: segment s_lo + i starts at slot offsets[s_lo + i] - t0.
    for (int i = tid + 1; i < width; i += kThreads) {
      const int64_t slot = static_cast<int64_t>(win[i]) - t0;
      if (slot >= 0 && slot < kTile) atomicMax(&mark[slot], i);
    }
  } else {
    for (int64_t base = s_lo + 1; base <= s_hi; base += kTile) {
      int32_t o[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int64_t i = base + u * kThreads + tid;
        o[u] = i <= s_hi ? __ldg(offsets + i) : -1;
      }
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int64_t slot = static_cast<int64_t>(o[u]) - t0;
        if (o[u] >= 0 && slot >= 0 && slot < kTile) {
          atomicMax(&mark[slot],
                    static_cast<int32_t>(base + u * kThreads + tid - s_lo));
        }
      }
    }
  }
  __syncthreads();

  // Block inclusive max-scan of mark (all values >= 0).
  int32_t v[kPer];
  const int4* mine = reinterpret_cast<const int4*>(mark + tid * kPer);
#pragma unroll
  for (int q = 0; q < kPer / 4; ++q) {
    const int4 m = mine[q];
    v[4 * q] = m.x;
    v[4 * q + 1] = m.y;
    v[4 * q + 2] = m.z;
    v[4 * q + 3] = m.w;
  }
#pragma unroll
  for (int i = 1; i < kPer; ++i) v[i] = max(v[i], v[i - 1]);
  int32_t incl = v[kPer - 1];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t up = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl = max(incl, up);
  }
  int32_t before = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) before = 0;
  if (lane == 31) warp_max[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int32_t w = lane < kWarps ? warp_max[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t up = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w = max(w, up);
    }
    if (lane < kWarps) warp_max[lane] = w;
  }
  __syncthreads();
  if (warp > 0) before = max(before, warp_max[warp - 1]);
  int4* mine_w = reinterpret_cast<int4*>(mark + tid * kPer);
#pragma unroll
  for (int q = 0; q < kPer / 4; ++q) {
    mine_w[q] = make_int4(max(v[4 * q], before), max(v[4 * q + 1], before),
                          max(v[4 * q + 2], before),
                          max(v[4 * q + 3], before));
  }
  __syncthreads();

  // Outputs: slot tid + u * kThreads, so a warp stores 128 contiguous bytes
  // and reads the shared arrays at consecutive words; kChunk slots a thread
  // at a time, their loads all in flight together.
  constexpr int kChunk = 8;
  const int live = static_cast<int>(t_end - t0);
#pragma unroll
  for (int u0 = 0; u0 < kPer; u0 += kChunk) {
    int32_t loc[kChunk], val[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int i = tid + (u0 + u) * kThreads;
      loc[u] = i < live ? mark[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int64_t s = s_lo + loc[u];
      val[u] = s >= n ? kI32Max : staged ? win[loc[u]] : __ldg(offsets + s);
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int i = tid + (u0 + u) * kThreads;
      if (i < live) {
        seg_out[t0 + i] = static_cast<int32_t>(s_lo + loc[u]);
        off_out[t0 + i] = val[u];
      }
    }
#pragma unroll
    for (int e = 0; e < kMaxExtras; ++e) {
      if (e >= n_extra) break;
      const int32_t* in = planes.in[e];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) val[u] = __ldg(in + s_lo + loc[u]);
      int32_t* o = planes.out[e];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int i = tid + (u0 + u) * kThreads;
        if (i < live) o[t0 + i] = val[u];
      }
    }
  }
}

cudaError_t launch(const int32_t* offsets, const int32_t* n_src, int64_t cap,
                   int64_t out_capacity, int n_extra, const PlaneTable& table,
                   int32_t* seg_out, int32_t* off_out, cudaStream_t stream) {
  const int64_t blocks = (out_capacity + kTile - 1) / kTile;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  expand_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      offsets, n_src, cap, out_capacity, n_extra, table, seg_out, off_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// extra_in / extra_out are host arrays of n_extra device pointers
// (n_extra <= kMaxExtras, checked by the wrapper). Requires cap >= 1.
int harkdb_expand_fills(const void* offsets, const void* n_src, int64_t cap,
                        int64_t out_capacity, int n_extra,
                        void* const* extra_in, void* const* extra_out,
                        void* seg_out, void* off_out, void* stream) {
  if (n_extra < 0 || n_extra > kMaxExtras || cap < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (out_capacity <= 0) return static_cast<int>(cudaGetLastError());
  PlaneTable table;
  for (int e = 0; e < n_extra; ++e) {
    table.in[e] = static_cast<const int32_t*>(extra_in[e]);
    table.out[e] = static_cast<int32_t*>(extra_out[e]);
  }
  const auto* offs = static_cast<const int32_t*>(offsets);
  const auto* nsrc = static_cast<const int32_t*>(n_src);
  auto* seg = static_cast<int32_t*>(seg_out);
  auto* off = static_cast<int32_t*>(off_out);
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(launch(offs, nsrc, cap, out_capacity, n_extra, table,
                                 seg, off, s));
}

}  // extern "C"
