// Stable radix pair sort: unsigned words on their low end_bit bits, with an
// int32 value moving along (kernels/radix_sort.sort_pairs).
//
// Replaces no TPU kernel: the JAX package sorts with lax.sort, which XLA
// lowers itself. It replaces one library call of the port, torch.sort over
// an int64 word, which fills an int64 index of its own, runs CUB's onesweep
// over all 64 bits (8 digit passes of 8-byte keys with 8-byte values) and
// returns the index for the caller to gather through. Here the same
// onesweep runs over the word's own significant bits and widths: a 32-bit
// join key is 4 passes of 4-byte keys carrying the caller's 4-byte value.
//
// What bounds it on an H100: device-memory bandwidth. The work is one read
// of the keys for the digit histograms, then per 8-bit digit pass one read
// and one write of every key and value. For 120M rows of 4-byte keys and
// values over 32 bits that is 0.48 + 4 x 1.92 = 8.16 GB, 2.44 ms at
// 3.35 TB/s; torch.sort on the same keys widened to int64 moved about 36 GB.
//
// What the design does about it: nothing of its own beyond choosing the
// widths. cub::DeviceRadixSort::SortPairs over DoubleBuffers: the caller's
// buffers are one half, the wrapper's alternates (torch's caching
// allocator) the other, so no pass copies back; the selector, known on the
// host from the pass count, says which half holds the result, and is
// returned without a device synchronisation. Temp storage comes from the
// caller too: nothing here allocates. Only uint32 and uint64 keys with
// int32 values are instantiated, to keep nvcc's build of this file short.
//
// CUB_WRAPPED_NAMESPACE puts this file's CUB in a namespace of its own, so
// its host symbols cannot bind to the copy of CUB inside libtorch_cuda; the
// kernels keep their CUB names (DeviceRadixSort*), by which traces find the
// sort.

#define CUB_WRAPPED_NAMESPACE harkdb_cub

#include <cub/device/device_radix_sort.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename Key>
cudaError_t sort_pairs(void* temp, size_t& temp_bytes, void* keys,
                       void* keys_alt, void* vals, void* vals_alt, int n,
                       int end_bit, cudaStream_t stream, int* selector) {
  harkdb_cub::cub::DoubleBuffer<Key> k(static_cast<Key*>(keys),
                                       static_cast<Key*>(keys_alt));
  harkdb_cub::cub::DoubleBuffer<int32_t> v(static_cast<int32_t*>(vals),
                                           static_cast<int32_t*>(vals_alt));
  const cudaError_t err = harkdb_cub::cub::DeviceRadixSort::SortPairs(
      temp, temp_bytes, k, v, n, 0, end_bit, stream);
  if (selector != nullptr) {
    selector[0] = k.selector;
    selector[1] = v.selector;
  }
  return err;
}

cudaError_t dispatch(void* temp, size_t& temp_bytes, void* keys,
                     void* keys_alt, void* vals, void* vals_alt, int64_t n,
                     int key_bytes, int end_bit, cudaStream_t stream,
                     int* selector) {
  if (n < 0 || n > INT32_MAX || end_bit < 1 || end_bit > 8 * key_bytes)
    return cudaErrorInvalidValue;
  if (key_bytes == 4)
    return sort_pairs<uint32_t>(temp, temp_bytes, keys, keys_alt, vals,
                                vals_alt, static_cast<int>(n), end_bit,
                                stream, selector);
  if (key_bytes == 8)
    return sort_pairs<uint64_t>(temp, temp_bytes, keys, keys_alt, vals,
                                vals_alt, static_cast<int>(n), end_bit,
                                stream, selector);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Bytes of temp storage one sort of n keys of key_bytes (4 or 8) over
// end_bit bits needs; a negative value is a cudaError_t, negated.
int64_t harkdb_radix_sort_temp_bytes(int64_t n, int key_bytes, int end_bit) {
  size_t bytes = 0;
  const cudaError_t err =
      dispatch(nullptr, bytes, nullptr, nullptr, nullptr, nullptr, n,
               key_bytes, end_bit, nullptr, nullptr);
  return err == cudaSuccess ? static_cast<int64_t>(bytes)
                            : -static_cast<int64_t>(err);
}

// Sorts the n keys in keys (4- or 8-byte unsigned words, ascending on bits
// [0, end_bit), stable) and the int32 values in vals with them. keys_alt and
// vals_alt are buffers of the same sizes; either half may hold the result,
// and selector (a host array of 2 ints) receives which: 0 for keys / vals,
// 1 for keys_alt / vals_alt, for the keys and for the values.
int harkdb_radix_sort_pairs(void* keys, void* keys_alt, void* vals,
                            void* vals_alt, int64_t n, int key_bytes,
                            int end_bit, void* temp, int64_t temp_bytes,
                            int* selector, void* stream) {
  size_t bytes = static_cast<size_t>(temp_bytes);
  const cudaError_t err =
      dispatch(temp, bytes, keys, keys_alt, vals, vals_alt, n, key_bytes,
               end_bit, static_cast<cudaStream_t>(stream), selector);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
