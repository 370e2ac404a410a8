// Multi-table row gather (the multiget), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the_algorithm_tpu/ops/gather.py:
// _row_gather_pallas (pallas_call at :55, body _gather_kernel :27-31), which
// copies rows ids[i] of k aligned [R, M_j] tables in one launch through
// scalar-prefetched ids driving double-buffered row DMAs. In this package it
// carries the SANN cluster-row fetch (the_algorithm_tpu/ops/retrieval.py:140-142):
// 12,800 rows of three [145,408, 400] tables per batch of 256 queries.
//
// What bounds it on this card: memory bandwidth; it computes nothing. What
// the design does about that: one warp per output row copies that row of
// every table, so a launch serves all k tables, the id is read once and stays
// in a register, and consecutive lanes touch consecutive 16-byte words
// (a 1,600-byte SANN row is 100 such words). When a row's byte width or a
// base pointer is not 16-byte aligned the wrapper picks 4-byte words instead.
// Ids must lie in [0, R): an id outside traps, like PyTorch's own device-side
// index assert; nothing is clamped.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;

template <typename V>
__device__ __forceinline__ void copy_row(const char* __restrict__ table,
                                         char* __restrict__ out, long long id,
                                         long long row, long long row_bytes,
                                         int lane) {
  const V* src = reinterpret_cast<const V*>(table + id * row_bytes);
  V* dst = reinterpret_cast<V*>(out + row * row_bytes);
  const long long n = row_bytes / static_cast<long long>(sizeof(V));
  for (long long e = lane; e < n; e += 32) dst[e] = src[e];
}

template <typename V>
__global__ void __launch_bounds__(THREADS) row_gather_kernel(
    const int* __restrict__ ids, int B, int R, int k,
    const char* __restrict__ t0, const char* __restrict__ t1,
    const char* __restrict__ t2, char* __restrict__ o0, char* __restrict__ o1,
    char* __restrict__ o2, long long rb0, long long rb1, long long rb2) {
  const long long row =
      static_cast<long long>(blockIdx.x) * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= B) return;
  const int lane = threadIdx.x & 31;
  const int id = ids[row];
  if (id < 0 || id >= R) __trap();
  copy_row<V>(t0, o0, id, row, rb0, lane);
  if (k > 1) copy_row<V>(t1, o1, id, row, rb1, lane);
  if (k > 2) copy_row<V>(t2, o2, id, row, rb2, lane);
}

}  // namespace

// ids: [B] int32 on the device; tables t_j: [R, *] contiguous with rb_j bytes
// per row; outputs o_j: [B, *] contiguous. k in {1, 2, 3} (unused pointers may
// be null). vec is the access width in bytes, 16 or 4; every rb_j and every
// pointer must be a multiple of it. Returns the launch's cudaError_t.
extern "C" int row_gather(const void* ids, int B, int R, int k, const void* t0,
                          const void* t1, const void* t2, void* o0, void* o1,
                          void* o2, long long rb0, long long rb1, long long rb2,
                          int vec, void* stream) {
  if (B <= 0) return 0;
  if (k < 1 || k > 3) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int blocks = (B + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  auto i = static_cast<const int*>(ids);
  auto a = static_cast<const char*>(t0);
  auto b = static_cast<const char*>(t1);
  auto c = static_cast<const char*>(t2);
  auto x = static_cast<char*>(o0);
  auto y = static_cast<char*>(o1);
  auto z = static_cast<char*>(o2);
  if (vec == 16) {
    row_gather_kernel<int4><<<blocks, THREADS, 0, s>>>(i, B, R, k, a, b, c, x, y, z, rb0, rb1, rb2);
  } else if (vec == 4) {
    row_gather_kernel<int><<<blocks, THREADS, 0, s>>>(i, B, R, k, a, b, c, x, y, z, rb0, rb1, rb2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
