// Kernel C: dense-key GROUP BY sums and counts.
//
// Replaces the TPU kernel harkdb_tpu/kernels/matmul_agg.py (_agg_kernel,
// launched by _run_kernel through pl.pallas_call): for keys in
// [key_min, key_min + span), counts[k] and sums[c][k] aggregate the rows
// with key == key_min + k that are below n_valid and pass the mask. Sums
// are int32 and wrap mod 2^32, bit-identical to the sort path's int32
// telescope. On the TPU this is a one-hot matmul on the MXU with the values
// split into bf16 base-256 digits; on the card it is a shared-memory
// histogram, not a matmul.
//
// What bounds it on an H100: reading the rows (4 B of key, 1 B of mask and
// 4 B per value column a row) from device memory, and the shared-memory
// atomics, one per row and column. At span 4096 and one sum column a block
// keeps 32 KiB of counters, so several blocks share an SM; the global merge
// costs one atomic per (block, key, column) with a non-zero partial.
//
// What the design does about it: every block keeps one int32 counter per
// (key, column) in dynamic shared memory, the count being one more column
// of ones. It walks a grid-stride range of rows with coalesced loads; a row
// past n_valid (read from device memory, so no host sync), failing the
// mask, or whose key - key_min (computed mod 2^32, as the TPU wrapper's
// int32 subtraction) falls outside [0, span) is skipped, and every other
// row does one shared atomicAdd per column. At the end each block adds its
// non-zero partials into the global output with atomicAdd. int32 atomics
// wrap, so no digit decomposition is needed. span_p x (columns + 1) x 4 B
// reaches 128 KiB at span 16384 with one sum column: the launch opts in to
// up to 227 KiB of dynamic shared memory, and when the columns do not fit
// they are split into groups that do, one blockIdx.y per group. The grid is
// sized from the occupancy the shared-memory footprint allows, so every
// block is resident at once. Many rows on one key (span 1) serialise on one
// shared counter; warp-aggregated atomics are later speed-up work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxCols = 32;           // sum columns one launch carries
constexpr int kRowsPerBlockMin = 4096; // do not start blocks for fewer rows

struct ValueTable {
  const int32_t* col[kMaxCols];
};

// out is (n_cols + 1, span) row-major: rows 0..n_cols-1 the sums, row
// n_cols the counts. Block column group g covers output rows
// [g * group, min((g + 1) * group, n_cols + 1)).
__global__ void __launch_bounds__(kThreads)
dense_agg_kernel(const int32_t* __restrict__ key,
                 const uint8_t* __restrict__ mask,
                 const int32_t* __restrict__ n_valid, int64_t n,
                 int32_t key_min, int span, int n_cols, int group,
                 ValueTable values, int32_t* __restrict__ out) {
  extern __shared__ int32_t hist[];
  const int c0 = blockIdx.y * group;
  int c1 = c0 + group;
  if (c1 > n_cols + 1) c1 = n_cols + 1;
  const int width = c1 - c0;
  const int cells = width * span;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) hist[i] = 0;
  __syncthreads();

  int64_t limit = *n_valid;
  if (limit < 0) limit = 0;
  if (limit > n) limit = n;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       r < limit; r += stride) {
    if (mask != nullptr && !mask[r]) continue;
    const int32_t k = static_cast<int32_t>(static_cast<uint32_t>(key[r]) -
                                           static_cast<uint32_t>(key_min));
    if (k < 0 || k >= span) continue;
    for (int c = c0; c < c1; ++c) {
      const int32_t v = c < n_cols ? values.col[c][r] : 1;
      atomicAdd(&hist[(c - c0) * span + k], v);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int32_t v = hist[i];
    if (v != 0) atomicAdd(&out[static_cast<int64_t>(c0) * span + i], v);
  }
}

}  // namespace

extern "C" {

// Output rows (of span int32 each) one block can hold in shared memory.
int harkdb_dense_agg_max_group(int span) {
  int dev = 0, max_smem = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&max_smem,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess) {
    return 0;
  }
  if (span < 1) return 0;
  return static_cast<int>(max_smem / (static_cast<int64_t>(span) * 4));
}

// values is a host array of n_cols device pointers; mask may be null. out
// must hold (n_cols + 1) * span zeroed int32. group is the number of output
// rows a block keeps (at most harkdb_dense_agg_max_group(span)).
int harkdb_dense_agg(const void* key, const void* mask, const void* n_valid,
                     int64_t n, int32_t key_min, int span, int n_cols,
                     void* const* values, int group, void* out,
                     void* stream) {
  if (n_cols < 0 || n_cols > kMaxCols || span < 1 || group < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  ValueTable table;
  for (int c = 0; c < n_cols; ++c) {
    table.col[c] = static_cast<const int32_t*>(values[c]);
  }
  const int groups = (n_cols + 1 + group - 1) / group;
  int rows_in_group = group < n_cols + 1 ? group : n_cols + 1;
  const size_t smem = static_cast<size_t>(rows_in_group) * span * 4;
  cudaError_t err = cudaFuncSetAttribute(
      dense_agg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, dense_agg_kernel, kThreads, smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  int64_t bx = static_cast<int64_t>(sms) * per_sm;
  // Every group runs its own blocks; share the resident slots among them.
  bx = (bx + groups - 1) / groups;
  const int64_t by_rows = (n + kRowsPerBlockMin - 1) / kRowsPerBlockMin;
  if (bx > by_rows) bx = by_rows;
  if (bx < 1) bx = 1;
  dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(groups));
  dense_agg_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(key), static_cast<const uint8_t*>(mask),
      static_cast<const int32_t*>(n_valid), n, key_min, span, n_cols, group,
      table, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
