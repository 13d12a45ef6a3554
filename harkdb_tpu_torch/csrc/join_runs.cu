// Kernels E: the join's count phase on each side of the pair sort
// (kernels/join_runs.py, under ops/join.compute_join_ranges).
//
// Replaces no TPU kernel: the JAX package's count phase
// (harkdb_tpu/ops/join.py, compute_join_ranges) is a composition of XLA
// operations, and so was the port's on the card: about 40 launches (five
// aranges, three cats, a dozen where / compare / bitwise / cast passes, a
// cumsum, kernel B's running max, three reductions and two kernel-A
// compactions) that move about 300 bytes a row around the sort.
//
// join_words_kernel, before the sort: one pass over both sides writes the
// concatenated order word and the tagged int32 row index, rights first,
// then lefts. A row at or past its side's n_valid (read on the card) is a
// pad: its key reads as INT32_MAX and its tag carries bit 31; a left's tag
// carries bit 30. The word is the key with its sign bit flipped (32 bits),
// or, with NULL codes, code | (key + 2^31) << 8 (40 bits, code 1 on a NULL
// right, 2 on a NULL left), bit for bit ops/sort.order_words of the padded
// keys.
//
// join_runs_kernel, after the sort: one pass over the sorted word and tag.
// A key run starts where the word changes; the tag says live right, live
// left or pad. Each live left's match count is the live rights of its run
// (they precede it: the sort is stable and rights come first) and its first
// match ("lo") the live rights before its run. Lefts go to their exclusive
// left rank (orig, count, lo), rights to their exclusive right rank (orig);
// the count total, the LEFT-join total and the live lefts come out too.
//
// What bounds both on an H100: device-memory bandwidth. Per row the words
// kernel reads a key (and a NULL byte) and writes a word and a tag (12 or
// 17 bytes); the runs kernel reads the word and tag and writes 12 bytes a
// live left and 4 a live right (about 20 bytes). For SSB's 120M-row fact
// against a dimension that is about 3.8 GB, 1.15 ms at 3.35 TB/s, where the
// composition moved about 36 GB.
//
// What the design does about it:
//   * The words kernel is a flat map: each thread makes 4 rows, 256 apart,
//     so every load and store of a warp is one coalesced 128-byte run. A
//     pad's key is not read.
//   * The runs kernel is one decoupled look-back scan, as kernel A's
//     (csrc/compact.cu): a tile is 256 threads x 16 rows (4096 rows) in a
//     blocked arrangement, loaded with 16-byte vector loads; the scanned
//     value per span of rows is (live rights, live lefts, a run starts in
//     it, live rights before its last run start), whose combination is
//     associative. A warp scan and a scan of the 8 warp values give each
//     thread its place in the tile; tiles take their index from an atomic
//     counter, publish their aggregate and later their inclusive prefix
//     (a flag word released after the 16-byte value), and one warp combines
//     its predecessors 32 at a time until it meets an inclusive prefix.
//     The run start of a tile's first row reads the word before it.
//     Its cost is paid per tile (the tile counter, the loads' latency, the
//     look-back's round trips), not per row, so the tile is as large as
//     the registers allow 4 blocks an SM: 2048-row tiles reached 0.43 of
//     the bound at 120M rows, 4096-row ones 0.62 (H100, PERF.md §6); a
//     look-back of 4 tiles a lane, 512 threads or 24 rows a thread did
//     worse.
//   * Each tile stages its lefts' (orig, count, lo) and its rights' orig in
//     shared memory at their ranks in the tile (52 KB, padded against bank
//     conflicts), then stores them as contiguous runs: coalesced, whatever
//     the mix of sides.
//   * The totals are 64-bit per-tile sums added atomically, turned into the
//     wrapping int32 sums and the float32 total the planner's guard reads
//     by a one-thread kernel after it. Counts past the live lefts are
//     zeroed by the tile that covers them (n_l read on the card), so the
//     caller never synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kLeftBit = 1 << 30;
constexpr int32_t kPadBit = INT32_MIN;  // bit 31
constexpr int32_t kOrigMask = (1 << 30) - 1;
constexpr unsigned kFull = 0xffffffffu;

// -- join_words_kernel ------------------------------------------------------

constexpr int kWordsThreads = 256;
constexpr int kWordsItems = 4;
constexpr int kWordsTile = kWordsThreads * kWordsItems;

template <bool kWide>
__global__ void __launch_bounds__(kWordsThreads)
join_words_kernel(const int32_t* __restrict__ l_key,
                  const int32_t* __restrict__ r_key,
                  const uint8_t* __restrict__ l_null,
                  const uint8_t* __restrict__ r_null,
                  const int32_t* __restrict__ n_l,
                  const int32_t* __restrict__ n_r, int64_t nl, int64_t nr,
                  void* __restrict__ words, int32_t* __restrict__ tags) {
  const int64_t live_l = *n_l;
  const int64_t live_r = *n_r;
  const int64_t n = nl + nr;
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * kWordsTile + threadIdx.x;
  int32_t key[kWordsItems];
  int32_t tag[kWordsItems];
  uint32_t code[kWordsItems];
#pragma unroll
  for (int u = 0; u < kWordsItems; ++u) {
    const int64_t i = first + u * kWordsThreads;
    key[u] = INT32_MAX;
    tag[u] = 0;
    code[u] = 0;
    if (i < nr) {
      const bool live = i < live_r;
      if (live) key[u] = r_key[i];
      tag[u] = static_cast<int32_t>(i) | (live ? 0 : kPadBit);
      if (kWide && r_null != nullptr) code[u] = r_null[i] ? 1u : 0u;
    } else if (i < n) {
      const int64_t j = i - nr;
      const bool live = j < live_l;
      if (live) key[u] = l_key[j];
      tag[u] = static_cast<int32_t>(j) | kLeftBit | (live ? 0 : kPadBit);
      if (kWide && l_null != nullptr) code[u] = l_null[j] ? 2u : 0u;
    }
  }
#pragma unroll
  for (int u = 0; u < kWordsItems; ++u) {
    const int64_t i = first + u * kWordsThreads;
    if (i >= n) continue;
    const uint32_t flipped = static_cast<uint32_t>(key[u]) ^ 0x80000000u;
    tags[i] = tag[u];
    if (kWide) {
      static_cast<unsigned long long*>(words)[i] =
          code[u] | static_cast<unsigned long long>(flipped) << 8;
    } else {
      static_cast<uint32_t*>(words)[i] = flipped;
    }
  }
}

// -- join_runs_kernel -------------------------------------------------------

constexpr int kRunsThreads = 256;
constexpr int kRunsItems = 16;
constexpr int kRunsTile = kRunsThreads * kRunsItems;  // 4096 rows per tile
constexpr int kRunsWarps = kRunsThreads / 32;
constexpr uint32_t kAggregate = 1;
constexpr uint32_t kPrefix = 2;
// One padding word after every 16 staged entries: where every row is a
// left, one step of a warp's threads stages entries 16 apart, which would
// hit 2 of the 32 banks; padded, they hit 32.
constexpr int kPadShift = 4;
constexpr int kStageWords = kRunsTile + (kRunsTile >> kPadShift);
constexpr size_t kRunsSmem = 3 * kStageWords * sizeof(int32_t);

__device__ __forceinline__ int slot(int i) { return i + (i >> kPadShift); }

// A span of sorted rows: its live rights, its live lefts, whether a key run
// starts in it (0/1), and the live rights before its last run start,
// counted from the span's first row (0 where no run starts in it).
struct Span {
  int32_t r, l, s, b;
};

// The span of a followed by b.
__device__ __forceinline__ Span combine(const Span& a, const Span& b) {
  return {a.r + b.r, a.l + b.l, a.s | b.s, b.s ? a.r + b.b : a.b};
}

__device__ __forceinline__ Span shfl_up(const Span& v, int d) {
  return {__shfl_up_sync(kFull, v.r, d), __shfl_up_sync(kFull, v.l, d),
          __shfl_up_sync(kFull, v.s, d), __shfl_up_sync(kFull, v.b, d)};
}

__device__ __forceinline__ Span shfl_down(const Span& v, int d) {
  return {__shfl_down_sync(kFull, v.r, d), __shfl_down_sync(kFull, v.l, d),
          __shfl_down_sync(kFull, v.s, d), __shfl_down_sync(kFull, v.b, d)};
}

__device__ __forceinline__ Span shfl(const Span& v, int src) {
  return {__shfl_sync(kFull, v.r, src), __shfl_sync(kFull, v.l, src),
          __shfl_sync(kFull, v.s, src), __shfl_sync(kFull, v.b, src)};
}

__device__ __forceinline__ uint32_t load_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The value first, then its flag with release semantics: a reader that
// acquires the flag reads the value whole.
__device__ __forceinline__ void publish(int4* values, uint32_t* flags,
                                        int64_t tile, const Span& v,
                                        uint32_t flag) {
  __stcg(&values[tile], make_int4(v.r, v.l, v.s, v.b));
  store_release(&flags[tile], flag);
}

__device__ __forceinline__ Span read_span(const int4* p) {
  const int4 x = __ldcg(p);
  return {x.x, x.y, x.z, x.w};
}

template <typename Word>
__device__ __forceinline__ void load_words(const Word* p,
                                           Word (&w)[kRunsItems]) {
  if constexpr (sizeof(Word) == 4) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int k = 0; k < kRunsItems / 4; ++k) {
      const uint4 x = q[k];
      w[4 * k] = x.x;
      w[4 * k + 1] = x.y;
      w[4 * k + 2] = x.z;
      w[4 * k + 3] = x.w;
    }
  } else {
    const ulonglong2* q = reinterpret_cast<const ulonglong2*>(p);
#pragma unroll
    for (int k = 0; k < kRunsItems / 2; ++k) {
      const ulonglong2 x = q[k];
      w[2 * k] = x.x;
      w[2 * k + 1] = x.y;
    }
  }
}

// Scratch, 64-bit words zeroed before the launch: [0] the tile counter,
// [1] the count total, [2] the LEFT-join total, [3] unused (16-byte
// alignment); then one 32-bit flag a tile (padded to 16 bytes), one 16-byte
// aggregate a tile and one 16-byte inclusive prefix a tile.
template <typename Word>
__global__ void __launch_bounds__(kRunsThreads)
join_runs_kernel(const Word* __restrict__ words,
                 const int32_t* __restrict__ tags, int64_t n, int64_t nl,
                 const int32_t* __restrict__ n_l, int64_t tiles,
                 unsigned long long* __restrict__ scratch,
                 int32_t* __restrict__ l_orig, int32_t* __restrict__ counts,
                 int32_t* __restrict__ lo, int32_t* __restrict__ r_orig,
                 int32_t* __restrict__ totals) {
  extern __shared__ int32_t s_stage[];
  int32_t* const s_orig = s_stage;
  int32_t* const s_count = s_stage + kStageWords;
  int32_t* const s_lo = s_stage + 2 * kStageWords;
  __shared__ Span s_warp[kRunsWarps];
  __shared__ Span s_prefix;
  __shared__ unsigned long long s_sums[2][kRunsWarps];
  __shared__ int64_t s_tile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  unsigned long long* const header = scratch;
  uint32_t* const flags = reinterpret_cast<uint32_t*>(scratch + 4);
  int4* const aggregates =
      reinterpret_cast<int4*>(scratch + 4 + 2 * ((tiles + 3) / 4));
  int4* const inclusive = aggregates + tiles;

  if (tid == 0)
    s_tile = atomicAdd(reinterpret_cast<unsigned*>(header), 1u);
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t row0 = tile * kRunsTile + static_cast<int64_t>(tid) * kRunsItems;

  // This thread's 8 rows: run starts as a bit set, tags kept for later.
  Word w[kRunsItems];
  int32_t t[kRunsItems];
  if (row0 + kRunsItems <= n) {
    load_words(words + row0, w);
    const int4* q = reinterpret_cast<const int4*>(tags + row0);
#pragma unroll
    for (int k = 0; k < kRunsItems / 4; ++k) {
      const int4 x = q[k];
      t[4 * k] = x.x;
      t[4 * k + 1] = x.y;
      t[4 * k + 2] = x.z;
      t[4 * k + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kRunsItems; ++i) {
      const bool in = row0 + i < n;
      w[i] = in ? words[row0 + i] : Word(0);
      t[i] = in ? tags[row0 + i] : kPadBit;
    }
  }
  Word prev = w[0];
  if (row0 > 0 && row0 < n) prev = words[row0 - 1];
  Span mine = {0, 0, 0, 0};
  unsigned starts = 0;
#pragma unroll
  for (int i = 0; i < kRunsItems; ++i) {
    const int64_t row = row0 + i;
    if (row >= n) break;
    if (row == 0 || w[i] != (i ? w[i - 1] : prev)) {
      starts |= 1u << i;
      mine.s = 1;
      mine.b = mine.r;
    }
    const int side = (t[i] >> 30) & 3;
    mine.r += side == 0;
    mine.l += side == 1;
  }

  // The rows of the tile before this thread's, and the whole tile.
  Span incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Span o = shfl_up(incl, d);
    if (lane >= d) incl = combine(o, incl);
  }
  if (lane == 31) s_warp[warp] = incl;
  Span excl = shfl_up(incl, 1);
  if (lane == 0) excl = {0, 0, 0, 0};
  __syncthreads();
  Span before = {0, 0, 0, 0};
  Span tile_span = {0, 0, 0, 0};
#pragma unroll
  for (int k = 0; k < kRunsWarps; ++k) {
    const Span c = s_warp[k];
    if (k < warp) before = combine(before, c);
    tile_span = combine(tile_span, c);
  }
  excl = combine(before, excl);

  // Decoupled look-back: the rows of every tile before this one.
  if (warp == 0) {
    Span exclusive = {0, 0, 0, 0};
    if (tile == 0) {
      if (lane == 0) publish(inclusive, flags, 0, tile_span, kPrefix);
    } else {
      if (lane == 0) publish(aggregates, flags, tile, tile_span, kAggregate);
      int64_t pred = tile - 1 - lane;  // lane 0 looks at the nearest
      while (true) {
        uint32_t f = kPrefix;  // no tile before tile 0
        Span v = {0, 0, 0, 0};
        if (pred >= 0) {
          do {
            f = load_acquire(&flags[pred]);
          } while (f == 0);
          v = read_span(f == kPrefix ? &inclusive[pred] : &aggregates[pred]);
        }
        const unsigned prefixes = __ballot_sync(kFull, f == kPrefix);
        const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
        if (lane > stop) v = {0, 0, 0, 0};
        // Lane 0 combines lanes 31 .. 0: a higher lane is an earlier tile.
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const Span o = shfl_down(v, d);
          if (lane + d < 32) v = combine(o, v);
        }
        exclusive = combine(shfl(v, 0), exclusive);
        if (prefixes) break;
        pred -= 32;
      }
      if (lane == 0)
        publish(inclusive, flags, tile, combine(exclusive, tile_span),
                kPrefix);
    }
    if (lane == 0) s_prefix = exclusive;
  }
  __syncthreads();
  const Span prefix = s_prefix;

  // Each row against the rows before it: lefts to the front of the shared
  // lists at their rank in the tile, rights after the tile's lefts.
  const Span start = combine(prefix, excl);
  int32_t rights = start.r;    // live rights before the row
  int32_t run_base = start.b;  // live rights before the row's run
  int l_at = excl.l;
  int r_at = tile_span.l + excl.r;
  unsigned long long sum = 0, sum_left = 0;
#pragma unroll
  for (int i = 0; i < kRunsItems; ++i) {
    if (row0 + i >= n) break;
    if (starts >> i & 1u) run_base = rights;
    const int side = (t[i] >> 30) & 3;
    const int32_t orig = t[i] & kOrigMask;
    if (side == 0) {
      s_orig[slot(r_at++)] = orig;
      ++rights;
    } else if (side == 1) {
      const int32_t c = rights - run_base;
      s_orig[slot(l_at)] = orig;
      s_count[slot(l_at)] = c;
      s_lo[slot(l_at)] = run_base;
      ++l_at;
      sum += static_cast<unsigned long long>(c);
      sum_left += static_cast<unsigned long long>(c > 0 ? c : 1);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    sum += __shfl_down_sync(kFull, sum, d);
    sum_left += __shfl_down_sync(kFull, sum_left, d);
  }
  if (lane == 0) {
    s_sums[0][warp] = sum;
    s_sums[1][warp] = sum_left;
  }
  __syncthreads();

  // Contiguous stores of the tile's lefts and rights.
  const int64_t l_out = prefix.l;
  const int64_t r_out = prefix.r;
  for (int j = tid; j < tile_span.l; j += kRunsThreads) {
    l_orig[l_out + j] = s_orig[slot(j)];
    counts[l_out + j] = s_count[slot(j)];
    lo[l_out + j] = s_lo[slot(j)];
  }
  for (int j = tid; j < tile_span.r; j += kRunsThreads)
    r_orig[r_out + j] = s_orig[slot(tile_span.l + j)];
  // Counts past the live lefts are 0: the rows of [live, nl) this tile
  // covers.
  int64_t live = *n_l;
  live = live < 0 ? 0 : (live > nl ? nl : live);
  const int64_t tile_end = (tile + 1) * kRunsTile;
  const int64_t z1 = tile_end < nl ? tile_end : nl;
  const int64_t z0 = tile * kRunsTile > live ? tile * kRunsTile : live;
  for (int64_t p = z0 + tid; p < z1; p += kRunsThreads) counts[p] = 0;

  if (tid == 0) {
    if (tile == tiles - 1) totals[3] = prefix.l + tile_span.l;
    unsigned long long a = 0, b = 0;
#pragma unroll
    for (int k = 0; k < kRunsWarps; ++k) {
      a += s_sums[0][k];
      b += s_sums[1][k];
    }
    if (a) atomicAdd(&header[1], a);
    if (b) atomicAdd(&header[2], b);
  }
}

// After the runs kernel, in stream order: the count total and the LEFT-join
// total as wrapping int32 sums, and the count total as float32.
__global__ void join_totals_kernel(const unsigned long long* __restrict__ header,
                                   int32_t* __restrict__ totals) {
  const unsigned long long total = header[1];
  totals[0] = static_cast<int32_t>(static_cast<uint32_t>(total));
  totals[1] = static_cast<int32_t>(static_cast<uint32_t>(header[2]));
  totals[2] = __float_as_int(static_cast<float>(total));
}

// The staging lists take more than the 48 KB a block gets without asking:
// each instantiation opts in once, before its first launch.
template <typename Word>
cudaError_t launch_runs(const Word* words, const int32_t* tags, int64_t n,
                        int64_t nl, const int32_t* n_l, int64_t tiles,
                        unsigned long long* scratch, int32_t* l_orig,
                        int32_t* counts, int32_t* lo, int32_t* r_orig,
                        int32_t* totals, unsigned blocks, cudaStream_t s) {
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      join_runs_kernel<Word>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kRunsSmem));
  if (opt_in != cudaSuccess) return opt_in;
  join_runs_kernel<Word><<<blocks, kRunsThreads, kRunsSmem, s>>>(
      words, tags, n, nl, n_l, tiles, scratch, l_orig, counts, lo, r_orig,
      totals);
  join_totals_kernel<<<1, 1, 0, s>>>(scratch, totals);
  return cudaGetLastError();
}

int64_t runs_tiles(int64_t n) { return (n + kRunsTile - 1) / kRunsTile; }

}  // namespace

extern "C" {

// 64-bit words of zeroed scratch the runs kernel needs for n rows.
int64_t harkdb_join_runs_scratch_words(int64_t n) {
  const int64_t tiles = runs_tiles(n);
  return 4 + 2 * ((tiles + 3) / 4) + 4 * tiles;
}

// words: nl + nr 4-byte words (wide = 0) or 8-byte words (wide = 1); tags:
// nl + nr int32. l_null / r_null: bool bytes or null (no NULL codes on that
// side); n_l / n_r: device int32, each side's live rows.
int harkdb_join_words(const void* l_key, const void* r_key,
                      const void* l_null, const void* r_null,
                      const void* n_l, const void* n_r, int64_t nl,
                      int64_t nr, int wide, void* words, void* tags,
                      void* stream) {
  const int64_t n = nl + nr;
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((n + kWordsTile - 1) /
                                                kWordsTile);
  const auto* lk = static_cast<const int32_t*>(l_key);
  const auto* rk = static_cast<const int32_t*>(r_key);
  const auto* ln = static_cast<const uint8_t*>(l_null);
  const auto* rn = static_cast<const uint8_t*>(r_null);
  const auto* nlp = static_cast<const int32_t*>(n_l);
  const auto* nrp = static_cast<const int32_t*>(n_r);
  auto* tg = static_cast<int32_t*>(tags);
  if (wide) {
    join_words_kernel<true><<<blocks, kWordsThreads, 0, s>>>(
        lk, rk, ln, rn, nlp, nrp, nl, nr, words, tg);
  } else {
    join_words_kernel<false><<<blocks, kWordsThreads, 0, s>>>(
        lk, rk, ln, rn, nlp, nrp, nl, nr, words, tg);
  }
  return static_cast<int>(cudaGetLastError());
}

// words / tags: the n sorted words (word_bytes 4 or 8) and tags, 16-byte
// aligned, of nl left rows and n - nl right rows (live or pad by tag).
// n_l: device int32, the live lefts the tags were made with. scratch:
// harkdb_join_runs_scratch_words(n) zeroed 64-bit words. l_orig, counts, lo:
// nl int32 each; r_orig: n - nl int32; totals: 4 int32 words receiving the
// count total and the LEFT-join total (int32, wrapping), the count total as
// float32, and the live lefts.
int harkdb_join_runs(const void* words, int word_bytes, const void* tags,
                     int64_t n, int64_t nl, const void* n_l, void* scratch,
                     void* l_orig, void* counts, void* lo, void* r_orig,
                     void* totals, void* stream) {
  const int64_t tiles = runs_tiles(n);
  if (tiles == 0) return static_cast<int>(cudaGetLastError());
  if ((word_bytes != 4 && word_bytes != 8) ||
      (reinterpret_cast<uintptr_t>(words) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(tags) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* tg = static_cast<const int32_t*>(tags);
  const auto* nlp = static_cast<const int32_t*>(n_l);
  auto* sc = static_cast<unsigned long long*>(scratch);
  auto* lorig = static_cast<int32_t*>(l_orig);
  auto* cnt = static_cast<int32_t*>(counts);
  auto* low = static_cast<int32_t*>(lo);
  auto* rorig = static_cast<int32_t*>(r_orig);
  auto* tot = static_cast<int32_t*>(totals);
  const unsigned blocks = static_cast<unsigned>(tiles);
  const cudaError_t err =
      word_bytes == 4
          ? launch_runs(static_cast<const uint32_t*>(words), tg, n, nl, nlp,
                        tiles, sc, lorig, cnt, low, rorig, tot, blocks, s)
          : launch_runs(static_cast<const unsigned long long*>(words), tg, n,
                        nl, nlp, tiles, sc, lorig, cnt, low, rorig, tot,
                        blocks, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
