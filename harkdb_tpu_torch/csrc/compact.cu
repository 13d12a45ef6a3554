// Kernel A: stable stream compaction of several 32-bit columns.
//
// Replaces the TPU kernel harkdb_tpu/kernels/compact.py (_make_kernel,
// launched by _run through pl.pallas_call): pack the rows where
// mask[i] && i < n_valid holds to the front, in row order, across C
// columns; rows past the kept count are left unspecified.
//
// What bounds it on an H100: device-memory bandwidth. The work is one read
// of the mask (1 byte a row), one read of every 32-byte sector of each
// column that holds a kept row (8 rows a sector: at half the rows kept,
// practically every sector) and one write of each kept word. For 2^24 rows
// x 2 columns at 50 % kept that is 218 MB, 65 us at 3.35 TB/s. There is no
// arithmetic to speak of.
//
// What the design does about it: one pass and one launch, so the mask is
// read once and no tile counts travel through device memory.
//   * A tile is 256 threads x 16 rows (4096 rows) in a blocked arrangement:
//     thread t owns rows [16t, 16t + 16), so row order is thread order. It
//     loads its 16 mask bytes as one 16-byte vector and counts them; a warp
//     shuffle scan and a scan of the 8 warp totals give its rank in the
//     tile and the tile's kept count.
//   * Decoupled look-back gives the tile its output offset. Tiles take
//     their index from an atomic counter (so a tile only waits on tiles
//     that have started), publish their count as one 64-bit status word
//     (2-bit flag: aggregate or inclusive prefix, over the count) with
//     release semantics, and one warp sums its predecessors' words 32 at a
//     time until it meets an inclusive prefix, then publishes its own.
//     Tiles past n_valid count 0 and still publish, so the chain never
//     stalls. The tile holding the last rows writes the kept count.
//   * The kept rows' in-tile indices go to a shared list at their ranks;
//     then each column is moved list entry by list entry: the stores are
//     one contiguous, coalesced run per tile, the loads gathers inside the
//     tile's 16 KB of the column. Columns travel through a kernel-parameter
//     table, 32 to a launch; later groups of columns take each tile's offset
//     from the first launch and skip the look-back.
// n_valid is read from device memory, so the caller never synchronises.
// The TPU's log-shift routing and 128-row carry existed to avoid dynamic
// addressing on the TPU; a GPU scatters directly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 16;
constexpr int kTile = kThreads * kRowsPerThread;  // 4096 rows per tile
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 32;                      // columns per launch
constexpr int kUnroll = 8;                        // loads in flight a thread
constexpr unsigned kFull = 0xffffffffu;

// Tile status word: the flag in the top two bits, the kept count below.
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;
constexpr unsigned long long kCountBits = 0xffffffffull;

struct ColumnTable {
  const int32_t* in[kMaxCols];
  int32_t* out[kMaxCols];
};

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ int64_t live_limit(const int32_t* n_valid,
                                              int64_t n) {
  int64_t nv = *n_valid;
  if (nv < 0) nv = 0;
  if (nv > n) nv = n;
  return nv;
}

// Bit i set where byte i of x is not zero (i < 4).
__device__ __forceinline__ unsigned byte_bits(unsigned x) {
  const unsigned ne = __vcmpne4(x, 0u);  // 0xff in every non-zero byte
  return (ne & 1u) | (ne >> 7 & 2u) | (ne >> 14 & 4u) | (ne >> 21 & 8u);
}

// scratch: word 0 holds the tile counter (low 32 bits), words 1.. one
// status word per tile, all zero before the look-back launch.
// tile_offsets: each tile's output offset, written by the look-back launch
// (when not null) and read by the launches of later column groups.
template <bool kLookBack>
__global__ void __launch_bounds__(kThreads)
compact_kernel(const uint8_t* __restrict__ mask,
               const int32_t* __restrict__ n_valid, int64_t n, int64_t tiles,
               unsigned long long* __restrict__ scratch,
               int32_t* __restrict__ tile_offsets, int32_t* __restrict__ count,
               int n_cols, ColumnTable cols) {
  __shared__ int s_list[kTile];
  __shared__ int s_warp[kWarps];
  __shared__ int s_tile;
  __shared__ int s_offset;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (kLookBack) {
    if (tid == 0)
      s_tile = static_cast<int>(
          atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u));
    __syncthreads();
  }
  const int64_t tile = kLookBack ? s_tile : blockIdx.x;
  const int64_t base = tile * kTile;
  const int64_t limit = live_limit(n_valid, n);

  // This thread's 16 rows as a bit set (bit i: row 16 * tid + i is kept).
  const int64_t row0 = base + tid * kRowsPerThread;
  unsigned bits = 0;
  if (row0 + kRowsPerThread <= limit &&
      (reinterpret_cast<uintptr_t>(mask) & 15) == 0) {
    const uint4 m = *reinterpret_cast<const uint4*>(mask + row0);
    bits = byte_bits(m.x) | byte_bits(m.y) << 4 | byte_bits(m.z) << 8 |
           byte_bits(m.w) << 12;
  } else {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
      if (row0 + i < limit && mask[row0 + i]) bits |= 1u << i;
  }

  // Rank of the thread's first kept row in the tile, and the tile's count.
  const int kept = __popc(bits);
  int incl = kept;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int rank = incl - kept;
  int tile_count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_warp[w];
    rank += (w < warp) ? c : 0;
    tile_count += c;
  }
  for (int i = 0; i < kRowsPerThread; ++i)
    if (bits >> i & 1u) s_list[rank++] = tid * kRowsPerThread + i;

  if (kLookBack) {
    if (warp == 0) {
      unsigned long long* status = scratch + 1;
      unsigned exclusive = 0;
      if (tile == 0) {
        if (lane == 0) store_release(&status[0], kPrefix | tile_count);
      } else {
        if (lane == 0) store_release(&status[tile], kAggregate | tile_count);
        int64_t pred = tile - 1 - lane;  // lane 0 looks at the nearest
        while (true) {
          unsigned long long s = kPrefix;  // no tile before tile 0
          if (pred >= 0) {
            do {
              s = load_acquire(&status[pred]);
            } while ((s >> 62) == 0);
          }
          const unsigned prefixes = __ballot_sync(kFull, (s >> 62) == 2);
          const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
          unsigned v = lane <= stop ? static_cast<unsigned>(s & kCountBits)
                                    : 0u;
#pragma unroll
          for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(kFull, v, d);
          exclusive += __shfl_sync(kFull, v, 0);
          if (prefixes) break;
          pred -= 32;
        }
        if (lane == 0)
          store_release(&status[tile], kPrefix | (exclusive + tile_count));
      }
      if (lane == 0) {
        s_offset = static_cast<int>(exclusive);
        if (tile_offsets != nullptr)
          tile_offsets[tile] = static_cast<int>(exclusive);
        if (tile == tiles - 1)
          *count = static_cast<int32_t>(exclusive + tile_count);
      }
    }
  } else if (tid == 0) {
    s_offset = tile_offsets[tile];
  }
  __syncthreads();

  // Move every column: list entry j goes to out[offset + j].
  const int offset = s_offset;
  for (int c = 0; c < n_cols; ++c) {
    const int32_t* in = cols.in[c] + base;
    int32_t* out = cols.out[c] + offset;
    for (int j0 = tid; j0 < tile_count; j0 += kThreads * kUnroll) {
      int32_t v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * kThreads;
        if (j < tile_count) v[u] = in[s_list[j]];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * kThreads;
        if (j < tile_count) out[j] = v[u];
      }
    }
  }
}

}  // namespace

extern "C" {

const char* harkdb_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// Tiles the compaction uses for n rows. scratch holds 1 + tiles zeroed
// 64-bit words; tile_offsets holds tiles int32 words and is needed (may be
// null otherwise) only when n_cols > 32.
int64_t harkdb_compact_num_tiles(int64_t n) { return (n + kTile - 1) / kTile; }

// in_cols / out_cols are host arrays of n_cols device pointers; count is a
// device int32 that receives the kept count. The first launch moves the
// first 32 columns with the look-back; each further group of 32 columns is
// one more launch that reuses the first launch's tile offsets.
int harkdb_compact(const void* mask, const void* n_valid, int64_t n,
                   int n_cols, void* const* in_cols, void* const* out_cols,
                   void* count, void* scratch, void* tile_offsets,
                   void* stream) {
  const int64_t tiles = harkdb_compact_num_tiles(n);
  if (tiles == 0) return static_cast<int>(cudaGetLastError());
  if (n_cols > kMaxCols && tile_offsets == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const uint8_t*>(mask);
  const auto* nv = static_cast<const int32_t*>(n_valid);
  auto* words = static_cast<unsigned long long*>(scratch);
  auto* offsets = static_cast<int32_t*>(tile_offsets);
  auto* cnt = static_cast<int32_t*>(count);
  for (int c0 = 0; c0 == 0 || c0 < n_cols; c0 += kMaxCols) {
    const int group = (n_cols - c0 < kMaxCols) ? n_cols - c0 : kMaxCols;
    ColumnTable table;
    for (int c = 0; c < group; ++c) {
      table.in[c] = static_cast<const int32_t*>(in_cols[c0 + c]);
      table.out[c] = static_cast<int32_t*>(out_cols[c0 + c]);
    }
    if (c0 == 0) {
      compact_kernel<true><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
          m, nv, n, tiles, words, offsets, cnt, group, table);
    } else {
      compact_kernel<false><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
          m, nv, n, tiles, words, offsets, cnt, group, table);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
