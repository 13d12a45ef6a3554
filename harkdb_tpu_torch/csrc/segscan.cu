// Kernel B: inclusive segmented scan (add / max / min / mul) of 32-bit
// columns under one shared, contiguous, non-decreasing segment id.
//
// Replaces the TPU kernel harkdb_tpu/kernels/segscan.py
// (_make_segscan_kernel, launched by _run_segscan through pl.pallas_call).
// Contract kept from it: row i of a column gets op over every earlier row
// of its segment (rows of equal sid), combined with a carry that starts as
// (sid -1, neutral) before the first row, so rows of a leading sid -1 run
// get op(value, neutral). Integer add and mul wrap mod 2^32; float max and
// min propagate NaN like torch.maximum / jnp.maximum. Two forms serve the
// running max / min: no sid (one segment; no sid is read) and reverse
// (the scan runs from the last row to the first, so out[i] covers x[i:];
// sid must then be non-decreasing in that order).
//
// What bounds it on an H100: device-memory bandwidth. The work is one read
// of sid and of each column and one write of each result: 100.7 MB for
// 2^23 rows and one column, 30 us at 3.35 TB/s; 67.1 MB (20 us) without a
// sid. The arithmetic is one compare and one op per row and column.
//
// What the design does about it: one pass and one launch for up to 8
// columns, which share one read of sid and one look-back.
//   * A tile is 256 threads x 16 rows (4096 rows). sid and the first column
//     are loaded together (one memory latency, not two) with coalesced
//     16-byte loads (warp-striped) and staged in shared memory at padded
//     positions i + i / 32, so that reading them back in the blocked
//     arrangement (thread t: rows [16t, 16t + 16)) is free of bank
//     conflicts. Each thread scans its 16 rows serially; warp shuffles scan
//     the (sid, value) thread tails with the segmented operator
//     combine(a, b) = (b.s, a.s == b.s ? op(b.v, a.v) : b.v), which is
//     associative because ids are non-decreasing; shared memory joins the
//     8 warps.
//   * Decoupled look-back carries the tile prefix. Tiles take their index
//     from an atomic counter. A tile publishes, per column, a 64-bit status
//     word (a valid bit over the value's 32 bits) for its aggregate and,
//     once known, another for its inclusive prefix; a word carries its own
//     value, so it needs no fence and a reader one load, not a flag and
//     then a payload. A tile's tail sid is read from the input, so a
//     predecessor of another segment ends a look-back without being waited
//     for. A tile whose last row starts a new segment relative to the row
//     before the tile publishes its inclusive prefix at once (it is its
//     aggregate); only tiles whose first row continues the previous row's
//     segment look back, 32 predecessors a round, until an inclusive
//     prefix or another segment. Group-by segments of a few rows wait on
//     at most their neighbour; one segment over every tile sums aggregates
//     as a plain decoupled look-back does.
//   * Each thread folds its prefix into its leading rows of the same
//     segment while they are still staged, and the tile is written back
//     with coalesced 16-byte stores: no second pass.
//   * Registers are capped so that 4 blocks fit an SM (2 for the 8-column
//     kernel): the tile's phases (load, scan, look-back, store) serialise
//     inside a block, and only other blocks keep memory busy meanwhile.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // 4096 rows per tile
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 8;               // columns per launch
constexpr int kPadded = kTile + kTile / 32;  // staged words per array
constexpr unsigned kFull = 0xffffffffu;

enum OpCode { kAdd = 0, kMax = 1, kMin = 2, kMul = 3 };

template <int OP>
struct Op;

template <>
struct Op<kAdd> {
  __device__ static int32_t apply(int32_t a, int32_t b) {
    return static_cast<int32_t>(static_cast<uint32_t>(a) +
                                static_cast<uint32_t>(b));
  }
  __device__ static float apply(float a, float b) { return a + b; }
};

template <>
struct Op<kMul> {
  __device__ static int32_t apply(int32_t a, int32_t b) {
    return static_cast<int32_t>(static_cast<uint32_t>(a) *
                                static_cast<uint32_t>(b));
  }
  __device__ static float apply(float a, float b) { return a * b; }
};

template <>
struct Op<kMax> {
  __device__ static int32_t apply(int32_t a, int32_t b) { return a > b ? a : b; }
  __device__ static float apply(float a, float b) {
    if (isnan(a)) return a;
    if (isnan(b)) return b;
    return a > b ? a : b;
  }
};

template <>
struct Op<kMin> {
  __device__ static int32_t apply(int32_t a, int32_t b) { return a < b ? a : b; }
  __device__ static float apply(float a, float b) {
    if (isnan(a)) return a;
    if (isnan(b)) return b;
    return a < b ? a : b;
  }
};

struct ScanArgs {
  const int32_t* sid;             // null: one segment
  const int32_t* in[kMaxCols];    // 32-bit words of the columns
  int32_t* out[kMaxCols];
  int64_t n;
  int n_cols;
  bool reverse;                   // scan position g is row n - 1 - g
  bool vec;                       // 16-byte accesses line up in full tiles
};

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

__device__ __forceinline__ int64_t row_of(const ScanArgs& a, int64_t g) {
  return a.reverse ? a.n - 1 - g : g;
}

// Tile status: one 64-bit word per tile, column and kind (aggregate or
// inclusive prefix): kValid over the value's 32 bits, 0 until published.
// A word carries its own value, so a relaxed store publishes it and a
// relaxed load reads it, with no fence and no second load.
constexpr unsigned long long kValid = 1ull << 32;

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long status_of(int32_t v) {
  return kValid | static_cast<uint32_t>(v);
}
__device__ __forceinline__ unsigned long long status_of(float v) {
  return kValid | __float_as_uint(v);
}
__device__ __forceinline__ void value_of(unsigned long long w, int32_t& v) {
  v = static_cast<int32_t>(static_cast<uint32_t>(w));
}
__device__ __forceinline__ void value_of(unsigned long long w, float& v) {
  v = __uint_as_float(static_cast<uint32_t>(w));
}

// A thread's share of one array's tile: 16 words, from 4 16-byte vectors
// (warp-striped rows of a full tile) or 16 scalars (scan positions
// tid + 256k).
struct Staged {
  int32_t v[kItems];
};

__device__ __forceinline__ bool vector_tile(const ScanArgs& a, int64_t first) {
  return a.vec && first + kTile <= a.n;
}

// Load the tile starting at scan position `first` of a device array;
// positions past n get `fill`.
__device__ __forceinline__ Staged stage_load(const ScanArgs& a,
                                             const int32_t* __restrict__ src,
                                             int32_t fill, int64_t first) {
  const int tid = threadIdx.x;
  Staged t;
  if (vector_tile(a, first)) {
    const int64_t row0 = a.reverse ? a.n - first - kTile : first;
    const uint4* s4 = reinterpret_cast<const uint4*>(src + row0);
#pragma unroll
    for (int k = 0; k < kItems / 4; ++k) {
      const uint4 q = s4[tid + k * kThreads];
      t.v[4 * k] = static_cast<int32_t>(q.x);
      t.v[4 * k + 1] = static_cast<int32_t>(q.y);
      t.v[4 * k + 2] = static_cast<int32_t>(q.z);
      t.v[4 * k + 3] = static_cast<int32_t>(q.w);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t g = first + tid + k * kThreads;
      t.v[k] = g < a.n ? src[row_of(a, g)] : fill;
    }
  }
  return t;
}

// Store a loaded tile into shared memory, scan position p at pad(p).
__device__ __forceinline__ void stage_store(const ScanArgs& a,
                                            const Staged& t, int32_t* dst,
                                            int64_t first) {
  const int tid = threadIdx.x;
  if (vector_tile(a, first)) {
#pragma unroll
    for (int k = 0; k < kItems / 4; ++k) {
      const int w = 4 * (tid + k * kThreads);  // row offset in the tile
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dst[pad(a.reverse ? kTile - 1 - (w + i) : w + i)] = t.v[4 * k + i];
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) dst[pad(tid + k * kThreads)] = t.v[k];
  }
}

// The inverse of stage for the rows of the tile below n.
__device__ __forceinline__ void unstage(const ScanArgs& a, const int32_t* src,
                                        int32_t* __restrict__ dst,
                                        int64_t first) {
  const int tid = threadIdx.x;
  if (vector_tile(a, first)) {
    const int64_t row0 = a.reverse ? a.n - first - kTile : first;
    uint4* d4 = reinterpret_cast<uint4*>(dst + row0);
#pragma unroll
    for (int k = 0; k < kItems / 4; ++k) {
      const int w = 4 * (tid + k * kThreads);
      int32_t v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = src[pad(a.reverse ? kTile - 1 - (w + i) : w + i)];
      d4[tid + k * kThreads] =
          make_uint4(static_cast<unsigned>(v[0]), static_cast<unsigned>(v[1]),
                     static_cast<unsigned>(v[2]), static_cast<unsigned>(v[3]));
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int64_t g = first + tid + k * kThreads;
      if (g < a.n) dst[row_of(a, g)] = src[pad(tid + k * kThreads)];
    }
  }
}

// (has, s, v) = combine((has, s, v), (ns, nv)): the pair (ns, nv) follows.
template <int OP, typename T, int kCols>
__device__ __forceinline__ void combine_into(bool& has, int32_t& s, T* v,
                                             int32_t ns, const T* nv, int nc) {
  const bool join = has && s == ns;
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (c < nc) v[c] = join ? Op<OP>::apply(nv[c], v[c]) : nv[c];
  s = ns;
  has = true;
}

// Publish a tile's value of each column into one kind of status word.
template <typename T, int kCols>
__device__ __forceinline__ void publish(unsigned long long* words,
                                        int64_t tiles, int64_t tile,
                                        const T* v, int nc) {
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (c < nc) store_status(&words[c * tiles + tile], status_of(v[c]));
}

// scratch (64-bit words, zero before the launch): the tile counter (low
// 32 bits of word 0), then per column the aggregate status word of each
// tile, then per column the inclusive one.
//
// The register budget allows 4 blocks an SM (64 registers a thread) for one
// column, 2 for up to 8. Left free, the compiler took 58-74 and 92-115
// registers, and the scan ran 20-50 % slower on an H100.
template <int OP, typename T, int kCols>
__global__ void __launch_bounds__(kThreads, kCols == 1 ? 4 : 2)
segscan_kernel(ScanArgs a, T neutral, int64_t tiles,
               unsigned long long* __restrict__ scratch) {
  extern __shared__ int32_t smem[];
  __shared__ int s_tile;
  __shared__ int32_t s_prev;
  __shared__ int32_t w_sid[kWarps];
  __shared__ T w_val[kWarps][kCols];
  __shared__ bool x_has;
  __shared__ int32_t x_sid;
  __shared__ T x_val[kCols];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nc = a.n_cols;
  const bool has_sid = a.sid != nullptr;

  if (tid == 0)
    s_tile = static_cast<int>(
        atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u));
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t first = tile * kTile;  // scan position of the tile's row 0
  int32_t* s_sid = smem;
  int32_t* s_words = smem + (has_sid ? kPadded : 0);  // the columns

  int32_t neutral_bits;
  memcpy(&neutral_bits, &neutral, sizeof(neutral_bits));
  // sid and the first column are in flight together; further columns
  // follow one at a time (their registers would cut occupancy).
  {
    const Staged sid_tile =
        has_sid ? stage_load(a, a.sid, INT32_MAX, first) : Staged{};
    const Staged col_tile = stage_load(a, a.in[0], neutral_bits, first);
    if (has_sid) stage_store(a, sid_tile, s_sid, first);
    stage_store(a, col_tile, s_words, first);
  }
#pragma unroll
  for (int c = 1; c < kCols; ++c)
    if (c < nc)
      stage_store(a, stage_load(a, a.in[c], neutral_bits, first),
                  s_words + c * kPadded, first);
  if (tid == 0 && tile > 0) s_prev = has_sid ? a.sid[row_of(a, first - 1)] : 0;
  __syncthreads();

  // Serial inclusive scan of the thread's 16 consecutive rows, in place.
  const int p0 = tid * kItems;
  int32_t sid[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) sid[j] = has_sid ? s_sid[pad(p0 + j)] : 0;
  T wv[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    if (c >= nc) continue;
    T* v = reinterpret_cast<T*>(s_words + c * kPadded);
    T run = v[pad(p0)];
#pragma unroll
    for (int j = 1; j < kItems; ++j) {
      const T x = v[pad(p0 + j)];
      run = sid[j] == sid[j - 1] ? Op<OP>::apply(x, run) : x;
      v[pad(p0 + j)] = run;
    }
    wv[c] = run;
  }

  // Inclusive warp scan of the thread tails; a tail's sid is its own.
  const int32_t ts = sid[kItems - 1];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t ps = __shfl_up_sync(kFull, ts, d);  // every lane shuffles
    const bool join = lane >= d && ps == ts;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c >= nc) continue;
      const T pv = __shfl_up_sync(kFull, wv[c], d);
      if (join) wv[c] = Op<OP>::apply(wv[c], pv);
    }
  }
  if (lane == 31) {
    w_sid[warp] = ts;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (c < nc) w_val[warp][c] = wv[c];
  }
  // The thread's exclusive prefix inside its warp.
  const int32_t ls = __shfl_up_sync(kFull, ts, 1);
  T lv[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (c < nc) lv[c] = __shfl_up_sync(kFull, wv[c], 1);
  __syncthreads();

  // The thread's exclusive prefix inside the tile: earlier warps, then the
  // earlier lanes of its own.
  bool eh = false;
  int32_t es = 0;
  T ev[kCols];
  for (int w = 0; w < warp; ++w)
    combine_into<OP, T, kCols>(eh, es, ev, w_sid[w], w_val[w], nc);
  if (lane > 0) combine_into<OP, T, kCols>(eh, es, ev, ls, lv, nc);

  if (warp == 0) {
    unsigned long long* agg = scratch + 1;
    unsigned long long* inc = agg + nc * tiles;
    // The tile's aggregate.
    bool ah = false;
    int32_t as = 0;
    T av[kCols];
    for (int w = 0; w < kWarps; ++w)
      combine_into<OP, T, kCols>(ah, as, av, w_sid[w], w_val[w], nc);
    bool xh = false;
    int32_t xs = 0;
    T xv[kCols];
    if (tile == 0) {
      // The carry (-1, neutral) precedes the first row.
      xh = true;
      xs = -1;
      T iv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        xv[c] = neutral;
        if (c < nc) iv[c] = as == -1 ? Op<OP>::apply(av[c], neutral) : av[c];
      }
      if (lane == 0) publish<T, kCols>(inc, tiles, tile, iv, nc);
    } else {
      const int32_t sp = s_prev;
      const bool early = sp != as;  // the tail segment starts in this tile
      if (lane == 0) publish<T, kCols>(early ? inc : agg, tiles, tile, av, nc);
      const int32_t s0 = has_sid ? s_sid[pad(0)] : 0;
      if (sp == s0) {
        // Look back for the value of segment sp before this tile: lane l
        // reads tile base - l, nearer tiles first. A tile's tail sid comes
        // from the input, so a tile of another segment ends the look-back
        // without being waited for.
        for (int64_t base = tile - 1;; base -= 32) {
          const int64_t pred = base - lane;
          const bool match =
              pred >= 0 &&
              (!has_sid ||
               __ldg(&a.sid[row_of(a, (pred + 1) * kTile - 1)]) == sp);
          bool inclusive = !match;
          T pv[kCols];
          // Wait until the tile has published one kind for every column.
          while (match) {
            unsigned long long wi[kCols], wa[kCols];
            bool has_i = true, has_a = true;
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              if (c >= nc) continue;
              wi[c] = load_status(&inc[c * tiles + pred]);
              wa[c] = load_status(&agg[c * tiles + pred]);
            }
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              if (c >= nc) continue;
              has_i = has_i && wi[c] != 0;
              has_a = has_a && wa[c] != 0;
            }
            if (has_i || has_a) {
              inclusive = has_i;
#pragma unroll
              for (int c = 0; c < kCols; ++c)
                if (c < nc) value_of(has_i ? wi[c] : wa[c], pv[c]);
              break;
            }
          }
          // Fold the lanes up to the first stop: a tile that is inclusive
          // (it counts) or of another segment (it does not).
          const unsigned stops = __ballot_sync(kFull, inclusive);
          const int stop = stops ? __ffs(stops) - 1 : 32;
          bool h = lane < stop || (lane == stop && match);
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const bool oh =
                __shfl_down_sync(kFull, static_cast<int>(h), d) != 0 &&
                lane + d < 32;
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              if (c >= nc) continue;
              const T ov = __shfl_down_sync(kFull, pv[c], d);
              if (oh) pv[c] = h ? Op<OP>::apply(pv[c], ov) : ov;
            }
            h = h || oh;
          }
          if (__shfl_sync(kFull, static_cast<int>(h), 0) != 0) {
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              if (c >= nc) continue;
              const T v0 = __shfl_sync(kFull, pv[c], 0);
              xv[c] = xh ? Op<OP>::apply(xv[c], v0) : v0;
            }
            xh = true;
          }
          if (stops) break;
        }
        xs = sp;
        if (!early && lane == 0) {
          T iv[kCols];
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            if (c < nc) iv[c] = xh ? Op<OP>::apply(av[c], xv[c]) : av[c];
          publish<T, kCols>(inc, tiles, tile, iv, nc);
        }
      }
    }
    if (lane == 0) {
      x_has = xh;
      x_sid = xs;
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (c < nc) x_val[c] = xv[c];
    }
  }
  __syncthreads();

  // Fold the thread's whole exclusive prefix (the tile's, then the
  // tile-internal one) into its leading rows of the same segment.
  bool fh = x_has;
  int32_t fs = x_sid;
  T fv[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (c < nc) fv[c] = x_val[c];
  if (eh) combine_into<OP, T, kCols>(fh, fs, fv, es, ev, nc);
  if (fh) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      if (c >= nc) continue;
      T* v = reinterpret_cast<T*>(s_words + c * kPadded);
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        if (sid[j] != fs) break;
        v[pad(p0 + j)] = Op<OP>::apply(v[pad(p0 + j)], fv[c]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (c < nc) unstage(a, s_words + c * kPadded, a.out[c], first);
}

template <int OP, typename T, int kCols>
int launch(const ScanArgs& a, T neutral, int64_t tiles,
           unsigned long long* scratch, cudaStream_t stream) {
  const size_t smem =
      sizeof(int32_t) * kPadded * ((a.sid != nullptr ? 1 : 0) + a.n_cols);
  auto* kernel = segscan_kernel<OP, T, kCols>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(tiles), kThreads, smem, stream>>>(
      a, neutral, tiles, scratch);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kCols>
int dispatch_op(int op, const ScanArgs& a, T neutral, int64_t tiles,
                unsigned long long* scratch, cudaStream_t stream) {
  switch (op) {
    case kAdd:
      return launch<kAdd, T, kCols>(a, neutral, tiles, scratch, stream);
    case kMax:
      return launch<kMax, T, kCols>(a, neutral, tiles, scratch, stream);
    case kMin:
      return launch<kMin, T, kCols>(a, neutral, tiles, scratch, stream);
    case kMul:
      return launch<kMul, T, kCols>(a, neutral, tiles, scratch, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(int op, const ScanArgs& a, T neutral, int64_t tiles,
             unsigned long long* scratch, cudaStream_t stream) {
  // One column (every caller on the main path) gets a kernel whose
  // registers hold one column's state; more columns take the 8-wide one.
  if (a.n_cols == 1)
    return dispatch_op<T, 1>(op, a, neutral, tiles, scratch, stream);
  return dispatch_op<T, kMaxCols>(op, a, neutral, tiles, scratch, stream);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int64_t num_tiles(int64_t n) { return (n + kTile - 1) / kTile; }

}  // namespace

extern "C" {

// 64-bit words of zeroed scratch one launch over n rows and n_cols
// columns needs.
int64_t harkdb_segscan_scratch_words(int64_t n, int n_cols) {
  return 1 + num_tiles(n) * 2 * static_cast<int64_t>(n_cols);
}

// op: 0 add, 1 max, 2 min, 3 mul. dtype: 0 int32, 1 float32.
// neutral_bits: the op's neutral element as the 32 bits of the dtype.
// sid may be null (one segment). in_cols / out_cols are host arrays of
// n_cols (1..8) device pointers; scratch holds
// harkdb_segscan_scratch_words(n, n_cols) zeroed int32 words.
int harkdb_segscan(int op, int dtype, const void* sid, int64_t n, int n_cols,
                   const void* const* in_cols, void* const* out_cols,
                   int32_t neutral_bits, int reverse, void* scratch,
                   void* stream) {
  if (n_cols < 1 || n_cols > kMaxCols)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tiles = num_tiles(n);
  if (tiles == 0) return static_cast<int>(cudaGetLastError());
  ScanArgs a{};
  a.sid = static_cast<const int32_t*>(sid);
  a.n = n;
  a.n_cols = n_cols;
  a.reverse = reverse != 0;
  a.vec = aligned16(sid) && (!a.reverse || n % 4 == 0);
  for (int c = 0; c < n_cols; ++c) {
    a.in[c] = static_cast<const int32_t*>(in_cols[c]);
    a.out[c] = static_cast<int32_t*>(out_cols[c]);
    a.vec = a.vec && aligned16(a.in[c]) && aligned16(a.out[c]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* words = static_cast<unsigned long long*>(scratch);
  if (dtype == 0)
    return dispatch<int32_t>(op, a, neutral_bits, tiles, words, s);
  if (dtype == 1) {
    float neutral;
    memcpy(&neutral, &neutral_bits, sizeof(neutral));
    return dispatch<float>(op, a, neutral, tiles, words, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
