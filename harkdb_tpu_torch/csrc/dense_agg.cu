// Kernel C: dense-key GROUP BY sums and counts.
//
// Replaces the TPU kernel harkdb_tpu/kernels/matmul_agg.py (_agg_kernel,
// launched by _run_kernel through pl.pallas_call): for keys in
// [key_min, key_min + span), counts[k] and sums[c][k] aggregate the rows
// with key == key_min + k that are below n_valid and pass the mask. Sums
// are int32 and wrap mod 2^32, bit-identical to the sort path's int32
// telescope. On the TPU this is a one-hot matmul on the MXU with the values
// split into bf16 base-256 digits; on the card it is a histogram in shared
// memory, not a matmul.
//
// What bounds it on an H100: reading the rows from device memory (4 B of
// key, 1 B of mask and 4 B per value column a row), as long as three other
// costs stay hidden: the atomics of the merge into the global output, the
// shared atomics of the row pass, and their serialisation on a hot key. The
// previous design merged every block's whole histogram with global atomics
// (about 4.3M at span 4096 for 8.4M rows), and split the columns of a
// histogram over 227 KB into groups along blockIdx.y, each re-reading the
// key with half the resident blocks. Reading at the memory's rate also
// needs about 70 KB of loads in flight an SM, more than a thread's own
// registers can hold at 1024 threads an SM.
//
// What the design does about it (Hopper thread block clusters):
//   * Histogram cells are (column, key), the count being the last column of
//     ones. A cluster of CTAs holds one histogram in shared memory, in one
//     of three shapes the wrapper picks from the span and the column count
//     (kernels/matmul_agg.py, dense_agg_plan):
//       (a) replicated: every CTA keeps the whole histogram and updates it
//           with local shared atomics; at the end each CTA sums one key
//           slice of all the cluster's copies through distributed shared
//           memory (DSMEM). The star join's span 4096 takes it.
//       (c) columns split: when no CTA holds the whole histogram (16384
//           keys x 4 columns is 256 KB) but two columns fit, each CTA of a
//           pair keeps two columns for every key. Each CTA stages its own
//           rows' keys, the pair trades the rebased keys through DSMEM
//           (one cluster barrier a step), and each CTA reads its own
//           columns' words for both CTAs' rows: every update stays local
//           and every word is still read once from device memory.
//       (b) keys split: past four columns, the key range is cut into
//           power-of-two slices, one per CTA, and every update goes to the
//           owning CTA's shared memory (red.shared::cluster when it is
//           another CTA). Columns past what the cluster holds (32 sum
//           columns at span 16384) are added straight into the output.
//     Each cluster adds each non-zero cell once into the global output, so
//     the merge costs one global atomic per (cluster, cell), a cluster-size
//     fraction of one per (block, cell), and every row and column is read
//     once whatever the span and column count. An update that crosses to
//     another CTA costs several times a local one: (b) at span 16384 x 3
//     sums took 0.22 ms on an H100, (c) 0.09 ms.
//   * Rows are staged by cp.async: a thread's quad of 4 rows (16 B of keys,
//     16 B of the first value column, 4 B of mask) lands in shared memory
//     3 quads (2 CTAs of 512 threads an SM) or 1 quad (1 CTA of 1024
//     threads) ahead of the one being added, so the loads in flight do not
//     live in registers. Further value columns load with 16-byte loads one
//     column ahead. The last quad, or every quad when a pointer is not
//     aligned, takes scalar loads.
//   * Warp-aggregated updates: in each row slot the lanes holding the
//     warp's current hot key form a group when there are two or more; the
//     group's first lane adds its sum (__reduce_add_sync) and its size as
//     the count, and every other lane adds alone. When no slot of a quad
//     had a group, the hot key is re-drawn from the lanes. A key that holds
//     most rows (span 1, or 90% of the rows on one key) costs about one
//     atomic per warp and column, not 32, for two votes a row slot. Integer
//     adds wrap mod 2^32 in any order, so the result stays bit-exact.
//     (__match_any_sync, which groups every key, took 0.16 ms at span 4096
//     on an H100.)
// n_valid is read from device memory, so the caller never synchronises with
// the host. A row past n_valid, failing the mask, or whose key - key_min
// (computed mod 2^32, as the TPU wrapper's int32 subtraction) falls outside
// [0, span) holds a key of -1 and adds nothing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCols = 32;            // sum columns one launch carries
constexpr int kMaxCluster = 8;
constexpr int64_t kRowsPerCtaMin = 8192;  // do not start CTAs for fewer rows
constexpr unsigned kFull = 0xffffffffu;
// Row staging: a thread's quad of 4 rows (16 B of keys, 16 B of the first
// value column, 4 B of mask) in each of kStages stages, field by field so
// no padding is needed: 512 threads x 4 stages or 1024 x 2 take 72 KB.
constexpr int kSlotBytes = 36;
// A CTA takes 512 threads and 4 stages when two such CTAs, histogram and
// staging, fit one SM's 228 KB; else 1024 threads and 2 stages.
constexpr size_t kSmemTwoCtas = 113 * 1024;

struct ValueTable {
  const int32_t* col[kMaxCols];
};

__device__ __forceinline__ void copy_async(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(gmem));
  }
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// The shared::cluster address of `local` (this CTA's shared memory) in
// CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_address(const int32_t* local,
                                                    int rank) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(local));
  uint32_t d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(d) : "r"(a), "r"(rank));
  return d;
}

// Adds v to a histogram cell: at `addr` in shared memory (this CTA's when
// replicated, the owner's through DSMEM when split), or at `global_cell`
// for a column the histogram does not hold.
template <bool kSplit>
__device__ __forceinline__ void add_cell(uint32_t addr, bool in_shared,
                                         int32_t* global_cell, int32_t v) {
  if (!in_shared) {
    atomicAdd(global_cell, v);
  } else if constexpr (kSplit) {
    asm volatile("red.shared::cluster.add.u32 [%0], %1;\n"
                 ::"r"(addr), "r"(v) : "memory");
  } else {
    asm volatile("red.shared.add.u32 [%0], %1;\n"
                 ::"r"(addr), "r"(v) : "memory");
  }
}

// Rebased keys of a quad of rows: -1 for a row past limit, failing the
// mask or outside [0, span).
__device__ __forceinline__ void quad_keys(int4 k4, uint32_t m4, uint32_t kmin,
                                          uint32_t uspan, int32_t kk[4]) {
  const int32_t ks[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t k = static_cast<uint32_t>(ks[j]) - kmin;
    kk[j] = ((m4 >> (8 * j)) & 0xffu) != 0 && k < uspan
                ? static_cast<int32_t>(k) : -1;
  }
}

__device__ __forceinline__ void quad_keys_scalar(
    const int32_t* key, const uint8_t* mask, int64_t r, int64_t limit,
    uint32_t kmin, uint32_t uspan, int32_t kk[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    kk[j] = -1;
    if (r + j < limit && (mask == nullptr || mask[r + j])) {
      const uint32_t k = static_cast<uint32_t>(key[r + j]) - kmin;
      if (k < uspan) kk[j] = static_cast<int32_t>(k);
    }
  }
}

// One column's words of a quad: a 16-byte load when the quad is wide, else
// scalar loads of the rows that count.
__device__ __forceinline__ int4 quad_values(const int32_t* col, int64_t r,
                                            bool wide, const int32_t kk[4]) {
  if (wide) return __ldg(reinterpret_cast<const int4*>(col + r));
  return make_int4(kk[0] >= 0 ? col[r] : 0, kk[1] >= 0 ? col[r + 1] : 0,
                   kk[2] >= 0 ? col[r + 2] : 0, kk[3] >= 0 ? col[r + 3] : 0);
}

// Warp aggregation: in each row slot the lanes holding the warp's hot key
// form a group when there are two or more (grp[j], else 0); when no slot of
// the quad had a group, the first valid lane's key of the last slot becomes
// the hot key. Lanes in no group add alone.
__device__ __forceinline__ void group_quad(const int32_t kk[4], int32_t& hot,
                                           unsigned grp[4]) {
  bool grouped = false;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    unsigned g = hot >= 0 ? __ballot_sync(kFull, kk[j] == hot) : 0u;
    if (__popc(g) < 2) g = 0;                    // warp-uniform
    grouped = grouped || g != 0;
    grp[j] = g;
  }
  if (!grouped) {                                // warp-uniform
    const unsigned valid = __ballot_sync(kFull, kk[3] >= 0);
    hot = valid ? __shfl_sync(kFull, kk[3], __ffs(valid) - 1) : -1;
  }
}

// Adds one column's words of a quad (ones for the count) to the cells of
// its rows: cell[j] in shared memory, or global_col[kk[j]] when the column
// is not held there. A group's first lane adds the group's sum.
template <bool kSplit>
__device__ __forceinline__ void add_quad(const int32_t kk[4],
                                         const unsigned grp[4], int4 v4,
                                         bool count, const uint32_t cell[4],
                                         bool in_shared, int32_t* global_col) {
  const int lane = threadIdx.x & 31;
  const int32_t v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned g = grp[j];
    if (g != 0) {                                // warp-uniform
      const int32_t sum =
          count ? __popc(g)
                : static_cast<int32_t>(__reduce_add_sync(
                      kFull, ((g >> lane) & 1u)
                                 ? static_cast<unsigned>(v[j]) : 0u));
      if (lane == __ffs(g) - 1) {
        add_cell<kSplit>(cell[j], in_shared, global_col + kk[j], sum);
      }
    }
    if (kk[j] >= 0 && !((g >> lane) & 1u)) {
      add_cell<kSplit>(cell[j], in_shared, global_col + kk[j],
                       count ? 1 : v[j]);
    }
  }
}

// out is (n_cols + 1, span) row-major: rows 0..n_cols-1 the sums, row
// n_cols the counts. Shared memory: the histogram, cell (c, k) at
// hist[c * held_keys + k - key0], where the CTA holds keys [key0, key0 +
// held_keys) (every key when replicated, its slice of 1 << key_shift keys
// when split; when split, columns c >= shared_cols live only in the global
// output), then the row staging.
template <bool kSplit, int kThreads, int kStages>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
dense_agg_kernel(const int32_t* __restrict__ key,
                 const uint8_t* __restrict__ mask,
                 const int32_t* __restrict__ n_valid, int64_t n,
                 int32_t key_min, int span, int n_cols, int key_shift,
                 int shared_cols, int vec_ok, ValueTable values,
                 int32_t* __restrict__ out, int32_t* __restrict__ keys_out) {
  extern __shared__ __align__(16) int32_t hist[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x, lane = tid & 31;
  const int c1 = n_cols + 1;
  const int held_keys = kSplit ? (1 << key_shift) : span;
  const int held_cols = kSplit ? shared_cols : c1;
  const int cells = held_cols * held_keys;
  char* staging = reinterpret_cast<char*>(hist + ((cells + 3) & ~3));
  for (int i = tid; i < cells; i += kThreads) hist[i] = 0;
  if (blockIdx.x == 0) {          // the keys axis, key_min + k (mod 2^32)
    for (int k = tid; k < span; k += kThreads) {
      keys_out[k] = static_cast<int32_t>(static_cast<uint32_t>(key_min) +
                                         static_cast<uint32_t>(k));
    }
  }
  cluster.sync();                 // every copy is zero before any update

  int64_t limit = *n_valid;
  if (limit < 0) limit = 0;
  if (limit > n) limit = n;
  const uint32_t kmin = static_cast<uint32_t>(key_min);
  const uint32_t uspan = static_cast<uint32_t>(span);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  // Quads of 4 rows wholly below limit are staged by cp.async, kStages - 1
  // quads ahead of the one being added; the last quad, or every quad when a
  // pointer is not 16-byte aligned, takes scalar loads.
  const int64_t wide_quads = vec_ok ? limit / 4 : 0;
  const int64_t quads = (limit + 3) / 4;
  const int32_t* col0 = n_cols > 0 ? values.col[0] : nullptr;
  // Stage s, thread t: keys at [s][t] of int4, column 0 at [s][t] of int4
  // after all keys, the mask word at [s][t] of uint32 after both.
  int4* keys_st = reinterpret_cast<int4*>(staging);
  int4* col0_st = keys_st + kStages * kThreads;
  uint32_t* mask_st = reinterpret_cast<uint32_t*>(col0_st + kStages * kThreads);
  auto stage_quad = [&](int64_t q, int stage) {
    if (q < wide_quads) {
      const int at = stage * kThreads + tid;
      copy_async(keys_st + at, key + 4 * q, 16);
      if (col0) copy_async(col0_st + at, col0 + 4 * q, 16);
      if (mask) copy_async(mask_st + at, mask + 4 * q, 4);
    }
    commit_copies();              // an empty group keeps the count in step
  };
  int64_t quad = static_cast<int64_t>(blockIdx.x) * kThreads + tid;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) stage_quad(quad + i * stride, i);

  int32_t hot = -1;               // the warp's candidate hot key (uniform)
  int stage = 0;
  // The loop bound is the warp's first quad, so the warp stays converged
  // for its votes and reductions; lanes past the rows hold key -1.
  for (; quad - lane < quads; quad += stride) {
    stage_quad(quad + (kStages - 1) * stride,
               stage == 0 ? kStages - 1 : stage - 1);
    wait_copies<kStages - 1>();   // this thread's copies of `quad` landed
    const int64_t r = quad * 4;
    const bool wide = quad < wide_quads;
    int32_t kk[4];
    int4 v_cur = make_int4(1, 1, 1, 1);
    if (wide) {
      const int at = stage * kThreads + tid;
      quad_keys(keys_st[at], mask ? mask_st[at] : 0x01010101u, kmin, uspan,
                kk);
      if (col0) v_cur = col0_st[at];
    } else {
      quad_keys_scalar(key, mask, r, limit, kmin, uspan, kk);
      if (col0) v_cur = quad_values(col0, r, false, kk);
    }
    stage = stage + 1 == kStages ? 0 : stage + 1;
    unsigned grp[4];
    group_quad(kk, hot, grp);
    // Column 0's cell of each row: a shared::cta address when replicated,
    // the owning CTA's shared::cluster address when split.
    uint32_t cell0[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = kk[j] >= 0 ? kk[j] : 0;
      if constexpr (kSplit) {
        const int owner = k >> key_shift;
        cell0[j] = cluster_address(hist + (k - (owner << key_shift)), owner);
      } else {
        cell0[j] = static_cast<uint32_t>(__cvta_generic_to_shared(hist + k));
      }
    }
    for (int c = 0; c < c1; ++c) {
      // The next column's words load while this one is added.
      const int4 v_after = c + 1 < n_cols
                               ? quad_values(values.col[c + 1], r, wide, kk)
                               : make_int4(1, 1, 1, 1);
      const uint32_t col_bytes = static_cast<uint32_t>(c * held_keys) * 4;
      const uint32_t cell[4] = {cell0[0] + col_bytes, cell0[1] + col_bytes,
                                cell0[2] + col_bytes, cell0[3] + col_bytes};
      add_quad<kSplit>(kk, grp, v_cur, c == n_cols, cell, c < held_cols,
                       out + static_cast<int64_t>(c) * span);
      v_cur = v_after;
    }
  }
  wait_copies<0>();
  cluster.sync();                 // every update of the cluster has landed

  if (kSplit) {
    // This CTA's slice holds the cluster's sum: add its non-zero cells.
    const int key0 = rank << key_shift;
    for (int i = tid; i < cells; i += kThreads) {
      const int c = i >> key_shift;
      const int k = key0 + (i & (held_keys - 1));
      const int32_t v = hist[i];
      if (k < span && v != 0) {
        atomicAdd(out + static_cast<int64_t>(c) * span + k, v);
      }
    }
  } else {
    // Sum key slice `rank` of every copy in the cluster, then add it.
    const int per = (span + csize - 1) / csize;
    const int k0 = rank * per;
    const int k1 = k0 + per < span ? k0 + per : span;
    const int width = k1 > k0 ? k1 - k0 : 0;
    for (int i = tid; i < c1 * width; i += kThreads) {
      const int c = i / width;
      const int cell = c * span + k0 + (i - c * width);
      int32_t v = 0;
      for (int q = 0; q < csize; ++q) {
        v += cluster.map_shared_rank(hist, q)[cell];
      }
      if (v != 0) atomicAdd(out + cell, v);
    }
    cluster.sync();               // no copy is freed while another reads it
  }
}

// Shape (c), columns split: CTA r of a pair keeps columns [r * group,
// (r + 1) * group) of the histogram for every key, so every update is
// local. Each CTA stages its own quads' keys and mask; the pair trades the
// rebased keys of each step through DSMEM (one cluster barrier a step), and
// each CTA reads its own columns' words for both CTAs' quads. Every row and
// column is still read once from device memory.
constexpr int kColsThreads = 1024;
constexpr int kColsPair = 2;      // CTAs of the cluster in shape (c)
constexpr int kColsGroup = 2;     // columns a CTA keeps in shape (c)

__global__ void __launch_bounds__(kColsThreads, 1)
dense_agg_cols_kernel(const int32_t* __restrict__ key,
                      const uint8_t* __restrict__ mask,
                      const int32_t* __restrict__ n_valid, int64_t n,
                      int32_t key_min, int span, int n_cols, int vec_ok,
                      ValueTable values, int32_t* __restrict__ out,
                      int32_t* __restrict__ keys_out) {
  constexpr int kThreads = kColsThreads;
  extern __shared__ __align__(16) int32_t hist[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int c1 = n_cols + 1;
  const int col_lo = rank * kColsGroup;
  int held = c1 - col_lo;
  held = held < 0 ? 0 : (held > kColsGroup ? kColsGroup : held);
  const int cells = kColsGroup * span;
  // After the histogram: the traded keys [2][kThreads] of int4, then the
  // staged keys [2][kThreads] of int4 and mask words [2][kThreads].
  int4* traded = reinterpret_cast<int4*>(hist + ((cells + 3) & ~3));
  int4* keys_st = traded + 2 * kThreads;
  uint32_t* mask_st = reinterpret_cast<uint32_t*>(keys_st + 2 * kThreads);
  for (int i = tid; i < cells; i += kThreads) hist[i] = 0;
  if (blockIdx.x == 0) {          // the keys axis, key_min + k (mod 2^32)
    for (int k = tid; k < span; k += kThreads) {
      keys_out[k] = static_cast<int32_t>(static_cast<uint32_t>(key_min) +
                                         static_cast<uint32_t>(k));
    }
  }
  cluster.sync();

  int64_t limit = *n_valid;
  if (limit < 0) limit = 0;
  if (limit > n) limit = n;
  const uint32_t kmin = static_cast<uint32_t>(key_min);
  const uint32_t uspan = static_cast<uint32_t>(span);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t wide_quads = vec_ok ? limit / 4 : 0;
  const int64_t quads = (limit + 3) / 4;
  auto stage_quad = [&](int64_t q, int stage) {
    if (q < wide_quads) {
      const int at = stage * kThreads + tid;
      copy_async(keys_st + at, key + 4 * q, 16);
      if (mask) copy_async(mask_st + at, mask + 4 * q, 4);
    }
    commit_copies();
  };
  int64_t quad = static_cast<int64_t>(blockIdx.x) * kThreads + tid;
  stage_quad(quad, 0);
  int32_t hot = -1;
  int stage = 0;
  // The bound is the pair's first quad of the step, the same in both CTAs,
  // so both reach every cluster barrier; threads past the rows hold -1.
  for (int64_t first = static_cast<int64_t>(blockIdx.x - rank) * kThreads;
       first < quads; first += stride, quad += stride) {
    stage_quad(quad + stride, stage ^ 1);
    // This CTA's columns for both CTAs' quads load while the keys are
    // traded (source q's quad is this one's + (q - rank) * kThreads).
    int4 vals[kColsPair][kColsGroup];
#pragma unroll
    for (int q = 0; q < kColsPair; ++q) {
      const int64_t qq = quad + (q - rank) * kThreads;
#pragma unroll
      for (int g = 0; g < kColsGroup; ++g) {
        const int c = col_lo + g;
        vals[q][g] = make_int4(1, 1, 1, 1);
        if (c < n_cols && qq < wide_quads) {
          vals[q][g] = __ldg(reinterpret_cast<const int4*>(values.col[c]) + qq);
        }
      }
    }
    wait_copies<1>();
    int32_t kk[4];
    if (quad < wide_quads) {
      const int at = stage * kThreads + tid;
      quad_keys(keys_st[at], mask ? mask_st[at] : 0x01010101u, kmin, uspan,
                kk);
    } else {
      quad_keys_scalar(key, mask, quad * 4, limit, kmin, uspan, kk);
    }
    const int buf = stage;
    traded[buf * kThreads + tid] = make_int4(kk[0], kk[1], kk[2], kk[3]);
    stage ^= 1;
    cluster.sync();               // both CTAs' keys of this step are traded
#pragma unroll
    for (int q = 0; q < kColsPair; ++q) {
      const int64_t qq = quad + (q - rank) * kThreads;
      const int4 t = q == rank ? traded[buf * kThreads + tid]
                               : *cluster.map_shared_rank(
                                     traded + buf * kThreads + tid, q);
      const int32_t kq[4] = {t.x, t.y, t.z, t.w};
      unsigned grp[4];
      group_quad(kq, hot, grp);
#pragma unroll
      for (int g = 0; g < kColsGroup; ++g) {
        const int c = col_lo + g;
        if (g >= held) break;
        int4 v4 = vals[q][g];
        if (c < n_cols && qq >= wide_quads) {
          v4 = quad_values(values.col[c], qq * 4, false, kq);
        }
        uint32_t cell[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          cell[j] = static_cast<uint32_t>(__cvta_generic_to_shared(
              hist + g * span + (kq[j] >= 0 ? kq[j] : 0)));
        }
        add_quad<false>(kq, grp, v4, c == n_cols, cell, true, nullptr);
      }
    }
  }
  wait_copies<0>();
  cluster.sync();                 // no traded keys are read any more
  // This CTA's columns hold the cluster's sums: add the non-zero cells.
  for (int i = tid; i < held * span; i += kThreads) {
    const int32_t v = hist[i];
    if (v != 0) atomicAdd(out + static_cast<int64_t>(col_lo) * span + i, v);
  }
}

struct Residency {
  const void* kernel;
  int device;
  size_t smem;
  int cluster;
  int clusters;
};

// Clusters of `kernel` resident at once under cfg (its cluster size and
// dynamic shared memory). The answer never changes for a shape, so the
// runtime is asked once per (device, kernel, bytes, cluster size). A
// kernel's first use on a device raises its shared-memory cap to the card's
// opt-in maximum, which covers every shape.
template <typename Kernel>
cudaError_t resident_clusters(Kernel kernel, int cluster,
                              const cudaLaunchConfig_t& cfg, int* clusters) {
  static std::mutex mu;
  static std::vector<Residency> seen;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  bool raised = false;
  for (const Residency& r : seen) {
    if (r.kernel != fn || r.device != dev) continue;
    raised = true;
    if (r.smem == cfg.dynamicSmemBytes && r.cluster == cluster) {
      *clusters = r.clusters;
      return cudaSuccess;
    }
  }
  if (!raised) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
  }
  err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  seen.push_back({fn, dev, cfg.dynamicSmemBytes, cluster, *clusters});
  return cudaSuccess;
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

template <bool kSplit, int kThreads, int kStages>
cudaError_t launch_shape(const int32_t* key, const uint8_t* mask,
                         const int32_t* n_valid, int64_t n, int32_t key_min,
                         int span, int n_cols, int cluster, int key_shift,
                         int shared_cols, int vec_ok, const ValueTable& table,
                         int32_t* out, int32_t* keys_out, size_t hist_bytes,
                         cudaStream_t stream) {
  auto kernel = dense_agg_kernel<kSplit, kThreads, kStages>;
  const size_t smem = ((hist_bytes + 15) & ~static_cast<size_t>(15)) +
                      static_cast<size_t>(kThreads) * kSlotBytes * kStages;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // As many clusters as are resident at once, fewer for few rows.
  cfg.gridDim = dim3(cluster);
  int resident = 0;
  cudaError_t err = resident_clusters(kernel, cluster, cfg, &resident);
  if (err != cudaSuccess) return err;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  int64_t clusters = (n + kRowsPerCtaMin * cluster - 1) /
                     (kRowsPerCtaMin * cluster);
  if (clusters > resident) clusters = resident;
  if (clusters < 1) clusters = 1;
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * cluster));
  err = cudaLaunchKernelEx(&cfg, kernel, key, mask, n_valid, n, key_min, span,
                           n_cols, key_shift, shared_cols, vec_ok, table, out,
                           keys_out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool kSplit>
cudaError_t launch(const int32_t* key, const uint8_t* mask,
                   const int32_t* n_valid, int64_t n, int32_t key_min,
                   int span, int n_cols, int cluster, int key_shift,
                   int shared_cols, int vec_ok, const ValueTable& table,
                   int32_t* out, int32_t* keys_out, cudaStream_t stream) {
  const int cells = kSplit ? shared_cols << key_shift : (n_cols + 1) * span;
  const size_t hist = static_cast<size_t>(cells) * 4;
  return hist + 512 * kSlotBytes * 4 <= kSmemTwoCtas
             ? launch_shape<kSplit, 512, 4>(key, mask, n_valid, n, key_min,
                                            span, n_cols, cluster, key_shift,
                                            shared_cols, vec_ok, table, out,
                                            keys_out, hist, stream)
             : launch_shape<kSplit, 1024, 2>(key, mask, n_valid, n, key_min,
                                             span, n_cols, cluster, key_shift,
                                             shared_cols, vec_ok, table, out,
                                             keys_out, hist, stream);
}

cudaError_t launch_cols(const int32_t* key, const uint8_t* mask,
                        const int32_t* n_valid, int64_t n, int32_t key_min,
                        int span, int n_cols, int vec_ok,
                        const ValueTable& table, int32_t* out,
                        int32_t* keys_out, cudaStream_t stream) {
  const size_t hist = static_cast<size_t>(kColsGroup) * span * 4;
  const size_t smem = ((hist + 15) & ~static_cast<size_t>(15)) +
                      static_cast<size_t>(kColsThreads) * (2 * 16 + 2 * 16 +
                                                           2 * 4);
  auto kernel = dense_agg_cols_kernel;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kColsPair;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(kColsThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(kColsPair);
  int resident = 0;
  cudaError_t err = resident_clusters(kernel, kColsPair, cfg, &resident);
  if (err != cudaSuccess) return err;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  int64_t clusters = (n + kRowsPerCtaMin * kColsPair - 1) /
                     (kRowsPerCtaMin * kColsPair);
  if (clusters > resident) clusters = resident;
  if (clusters < 1) clusters = 1;
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * kColsPair));
  err = cudaLaunchKernelEx(&cfg, kernel, key, mask, n_valid, n, key_min, span,
                           n_cols, vec_ok, table, out, keys_out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block may opt in to (bytes).
int harkdb_smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return 0;
  }
  return bytes;
}

// values is a host array of n_cols device pointers; mask may be null. out
// must hold (n_cols + 1) * span zeroed int32; keys_out (span int32)
// receives the keys axis. shape is 0 for (a) replicated, 1 for (b) keys
// split, with 1 << key_shift keys and shared_cols columns a CTA (cluster <<
// key_shift must cover span), 2 for (c) columns split (a pair of CTAs, at
// most 4 columns with the count); (a) and (c) ignore key_shift and
// shared_cols. cluster is 1, 2, 4 or 8 CTAs.
int harkdb_dense_agg(const void* key, const void* mask, const void* n_valid,
                     int64_t n, int32_t key_min, int span, int n_cols,
                     void* const* values, int shape, int cluster,
                     int key_shift, int shared_cols, void* out,
                     void* keys_out, void* stream) {
  if (n_cols < 0 || n_cols > kMaxCols || span < 1 || cluster < 1 ||
      cluster > kMaxCluster || (cluster & (cluster - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (shape == 1 && (key_shift < 0 || key_shift > 16 || shared_cols < 0 ||
                     shared_cols > n_cols + 1 ||
                     (static_cast<int64_t>(cluster) << key_shift) < span)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (shape == 2 && (cluster != kColsPair ||
                     n_cols + 1 > kColsPair * kColsGroup)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (shape < 0 || shape > 2) return static_cast<int>(cudaErrorInvalidValue);
  ValueTable table;
  int vec_ok = aligned(key, 16) && (mask == nullptr || aligned(mask, 4));
  for (int c = 0; c < n_cols; ++c) {
    table.col[c] = static_cast<const int32_t*>(values[c]);
    vec_ok = vec_ok && aligned(values[c], 16);
  }
  const auto* k = static_cast<const int32_t*>(key);
  const auto* m = static_cast<const uint8_t*>(mask);
  const auto* nv = static_cast<const int32_t*>(n_valid);
  auto* o = static_cast<int32_t*>(out);
  auto* ko = static_cast<int32_t*>(keys_out);
  auto s = static_cast<cudaStream_t>(stream);
  if (shape == 2) {
    return static_cast<int>(launch_cols(k, m, nv, n, key_min, span, n_cols,
                                        vec_ok, table, o, ko, s));
  }
  cudaError_t err =
      shape == 1 ? launch<true>(k, m, nv, n, key_min, span, n_cols, cluster,
                           key_shift, shared_cols, vec_ok, table, o, ko, s)
            : launch<false>(k, m, nv, n, key_min, span, n_cols, cluster,
                            key_shift, shared_cols, vec_ok, table, o, ko, s);
  return static_cast<int>(err);
}

}  // extern "C"
