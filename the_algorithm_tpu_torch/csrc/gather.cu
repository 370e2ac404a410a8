// Multi-table row gather (the multiget), hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the_algorithm_tpu/ops/gather.py:
// _row_gather_pallas (pallas_call at :55, body _gather_kernel :27-31), which
// copies rows ids[i] of k aligned [R, M_j] tables in one launch through
// scalar-prefetched ids driving double-buffered row DMAs. In this package it
// carries the SANN cluster-row fetch (the_algorithm_tpu/ops/retrieval.py:140-142):
// 12,800 rows of three [145,408, 400] tables per batch of 256 queries.
//
// What bounds it on this card: memory bandwidth; it computes nothing. A copy
// reaches the bandwidth roofline only with enough bytes in flight per SM to
// cover the loaded DRAM latency, and only if no SM idles in a last partial
// wave. A register copy gets its bytes in flight from threads and registers,
// and a lane's store waits for its load.
//
// row_gather_ring, for rows and bases that are multiples of 16 bytes (the
// SANN rows): the Tensor Memory Accelerator moves the bytes and no byte
// passes through registers. The work is split into units: `rows` whole
// output rows of all k tables, or, for a row wider than a stage, one piece
// of at most `piece` bytes of one table's row. A persistent grid of a few
// CTAs per SM (the wrapper sizes it from the SM count, ops/gather.py:_plan)
// gives each CTA a contiguous share of the units that differs from every
// other share by at most one. Each CTA is one warp walking a ring of S
// stages in dynamic shared memory, one unit to a stage. To fill a stage,
// lane 0 arms its mbarrier with the unit's bytes, and the lanes check their
// rows' ids against [0, R) and each issue the cp.async.bulk global->shared
// copies of their rows, completed on that mbarrier. To drain the oldest
// stage, lane 0 waits on its mbarrier with the parity of its use and stores
// it with cp.async.bulk shared->global as one bulk group: a stage keeps each
// table's rows side by side, so whole-row units store one copy per table.
// The stage before it is refilled once cp.async.bulk.wait_group.read shows
// its stores have read it. S-1 stages of loads stay in flight while one
// drains: S * stage bytes per CTA, whatever the thread count.
//
// row_gather_words, for rows that are multiples of 4 bytes but not 16,
// which a bulk copy cannot take: a persistent grid-stride loop of register
// copies in 4-byte words. A row gets the smallest power of two of lanes that
// covers its words (at most a warp), and each lane issues every load it
// holds for all k tables before any store, so a warp keeps k * 32 * UNROLL
// words in flight. The entry sizes its own launch from the SM count.
//
// Ids must lie in [0, R): an id outside traps, like PyTorch's own device-side
// index assert; nothing is clamped.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int MAX_TABLES = 3;
constexpr int SMEM_PER_BLOCK = 232448;  // 227 KB: the most a block can opt in to

struct Tables {
  const char* src[MAX_TABLES];
  char* dst[MAX_TABLES];
  long long row_bytes[MAX_TABLES];
};

__device__ __forceinline__ int checked_id(const int* ids, long long row, int R) {
  const int id = ids[row];
  if (id < 0 || id >= R) __trap();
  return id;
}

// ---- the TMA ring ----------------------------------------------------------

using tma::bar_arm;
using tma::bar_init;
using tma::bar_wait;
using tma::bulk_load;
using tma::bulk_store;
using tma::smem_addr;

// One piece: `len` bytes at byte `off` of row `row` of table `table`.
struct Piece {
  long long row, off;
  int table;
  uint32_t len;
};

// Piece u of the work: row u / groups, then the tables' pieces in order.
__device__ __forceinline__ Piece piece_of(long long u, int groups, int k, const Tables& tb, long long piece) {
  Piece p{u / groups, 0, 0, 0};
  long long g = u % groups;
  for (int j = 0; j < k; ++j) {
    const long long n = (tb.row_bytes[j] + piece - 1) / piece;
    if (g < n) {
      p.table = j;
      p.off = g * piece;
      p.len = static_cast<uint32_t>(tb.row_bytes[j] - p.off < piece ? tb.row_bytes[j] - p.off : piece);
      return p;
    }
    g -= n;
  }
  return p;
}

// rows > 0: a unit is `rows` output rows of all tables, a stage holding
// table j's rows side by side at byte rows * (rb_0 + ... + rb_{j-1}).
// rows == 0: a unit is one piece, `groups` pieces to an output row.
__global__ void __launch_bounds__(32) row_gather_ring_kernel(const int* __restrict__ ids, int B, int R, int k,
                                                             Tables tb, int rows, long long piece, int groups,
                                                             int stages, long long stage_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + stages * stage_bytes);
  const uint32_t ring = smem_addr(smem);
  const int lane = threadIdx.x;

  // this CTA's units: [lo, lo + n); shares differ by at most one
  const long long total = rows > 0 ? (B + rows - 1) / rows : static_cast<long long>(B) * groups;
  const long long lo = total * blockIdx.x / gridDim.x;
  const long long n = total * (blockIdx.x + 1) / gridDim.x - lo;

  if (lane == 0) {
    for (int s = 0; s < stages; ++s) bar_init(smem_addr(bars + s));
    tma::bar_init_fence();
  }
  __syncwarp();

  auto load = [&](long long i) {  // every lane: fill the stage of the CTA's i-th unit
    const int slot = static_cast<int>(i % stages);
    const uint32_t bar = smem_addr(bars + slot);
    const uint32_t stage = ring + static_cast<uint32_t>(slot * stage_bytes);
    if (rows == 0) {
      if (lane == 0) {
        const Piece p = piece_of(lo + i, groups, k, tb, piece);
        const long long id = checked_id(ids, p.row, R);
        bar_arm(bar, p.len);
        bulk_load(stage, tb.src[p.table] + id * tb.row_bytes[p.table] + p.off, p.len, bar);
      }
      return;
    }
    const long long first = (lo + i) * rows;
    const int m = static_cast<int>(B - first < rows ? B - first : rows);
    long long row_bytes = 0;
    for (int j = 0; j < k; ++j) row_bytes += tb.row_bytes[j];
    if (lane == 0) bar_arm(bar, static_cast<uint32_t>(m * row_bytes));
    __syncwarp();  // armed before any copy completes on it
    for (int r = lane; r < m; r += 32) {
      const long long id = checked_id(ids, first + r, R);
      long long off = 0;
      for (int j = 0; j < k; ++j) {
        const long long rb = tb.row_bytes[j];
        bulk_load(stage + static_cast<uint32_t>(rows * off + r * rb), tb.src[j] + id * rb,
                  static_cast<uint32_t>(rb), bar);
        off += rb;
      }
    }
  };

  auto store = [&](long long i) {  // lane 0: write the stage of the CTA's i-th unit back out
    const int slot = static_cast<int>(i % stages);
    const uint32_t stage = ring + static_cast<uint32_t>(slot * stage_bytes);
    if (rows == 0) {
      const Piece p = piece_of(lo + i, groups, k, tb, piece);
      bulk_store(tb.dst[p.table] + p.row * tb.row_bytes[p.table] + p.off, stage, p.len);
    } else {
      const long long first = (lo + i) * rows;
      const long long m = B - first < rows ? B - first : rows;
      long long off = 0;
      for (int j = 0; j < k; ++j) {
        const long long rb = tb.row_bytes[j];
        bulk_store(tb.dst[j] + first * rb, stage + static_cast<uint32_t>(rows * off),
                   static_cast<uint32_t>(m * rb));
        off += rb;
      }
    }
    tma::bulk_commit();
  };

  for (long long i = 0; i < n && i < stages; ++i) load(i);
  for (long long i = 0; i < n; ++i) {
    if (lane == 0) {
      bar_wait(smem_addr(bars + i % stages), static_cast<uint32_t>((i / stages) & 1));
      store(i);
    }
    // refill the stage drained one step ago, once its stores have read it
    if (i >= 1 && i - 1 + stages < n) {
      if (lane == 0) tma::bulk_wait_read<1>();
      __syncwarp();
      load(i - 1 + stages);
    }
  }
  // the stores must have read the ring before the CTA exits; their writes
  // land before the grid completes
  if (lane == 0) tma::bulk_wait_read<0>();
}

// ---- the register path -----------------------------------------------------

constexpr int WORD_THREADS = 256;
constexpr int WORD_WARPS = WORD_THREADS / 32;
constexpr int WORD_BLOCKS_PER_SM = 4;
constexpr int UNROLL = 4;  // loads a lane holds for each table before it stores

// K tables of rows of 4-byte words, K fixed at compile time so a lane holds
// registers for those alone
template <int K>
__global__ void __launch_bounds__(WORD_THREADS, WORD_BLOCKS_PER_SM) row_gather_words_kernel(
    const int* __restrict__ ids, int B, int R, Tables tb, int lanes_log2) {
  const int lane = threadIdx.x & 31;
  const int lanes = 1 << lanes_log2;  // lanes that copy one row
  const int sub = lane & (lanes - 1);
  long long nw[K];
  long long max_nw = 0;
  const int* src[K];
  int* dst[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    nw[j] = tb.row_bytes[j] / 4;
    max_nw = nw[j] > max_nw ? nw[j] : max_nw;
    src[j] = reinterpret_cast<const int*>(tb.src[j]);
    dst[j] = reinterpret_cast<int*>(tb.dst[j]);
  }
  const long long warp = static_cast<long long>(blockIdx.x) * WORD_WARPS + (threadIdx.x >> 5);
  const long long warps = static_cast<long long>(gridDim.x) * WORD_WARPS;
  int v[K][UNROLL];

  if (max_nw <= lanes) {
    // narrow rows: a warp covers 32/lanes rows at once, UNROLL times over
    const int per_pass = 32 >> lanes_log2;
    const long long per_warp = static_cast<long long>(per_pass) * UNROLL;
    const long long step = warps * per_warp;
    const long long sub_row = lane >> lanes_log2;
    int id[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long row = warp * per_warp + u * per_pass + sub_row;
      id[u] = row < B ? checked_id(ids, row, R) : 0;
    }
    for (long long base = warp * per_warp; base < B; base += step) {
#pragma unroll
      for (int j = 0; j < K; ++j)
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          if (base + u * per_pass + sub_row < B && sub < nw[j]) v[j][u] = src[j][id[u] * nw[j] + sub];
      // the next pass's ids, fetched while this pass's loads are in flight
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long row = base + step + u * per_pass + sub_row;
        id[u] = row < B ? checked_id(ids, row, R) : 0;
      }
#pragma unroll
      for (int j = 0; j < K; ++j)
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const long long row = base + u * per_pass + sub_row;
          if (row < B && sub < nw[j]) dst[j][row * nw[j] + sub] = v[j][u];
        }
    }
    return;
  }
  // wide rows: a warp copies one row, 32·UNROLL words per table at a time
  long long id = warp < B ? checked_id(ids, warp, R) : 0;
  for (long long row = warp; row < B; row += warps) {
    const long long next = row + warps < B ? checked_id(ids, row + warps, R) : 0;
    for (long long w0 = 0; w0 < max_nw; w0 += 32 * UNROLL) {
#pragma unroll
      for (int j = 0; j < K; ++j)
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const long long w = w0 + u * 32 + lane;
          if (w < nw[j]) v[j][u] = src[j][id * nw[j] + w];
        }
#pragma unroll
      for (int j = 0; j < K; ++j)
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const long long w = w0 + u * 32 + lane;
          if (w < nw[j]) dst[j][row * nw[j] + w] = v[j][u];
        }
    }
    id = next;
  }
}

Tables make_tables(const void* t0, const void* t1, const void* t2, void* o0, void* o1, void* o2,
                   long long rb0, long long rb1, long long rb2) {
  return Tables{{static_cast<const char*>(t0), static_cast<const char*>(t1), static_cast<const char*>(t2)},
                {static_cast<char*>(o0), static_cast<char*>(o1), static_cast<char*>(o2)},
                {rb0, rb1, rb2}};
}

}  // namespace

// Both entry points: ids [B] int32 on the device; tables t_j [R, *] contiguous
// with rb_j bytes per row; outputs o_j [B, *] contiguous; k in {1, 2, 3}
// (unused pointers may be null). Each returns its launch's cudaError_t.

// rb_j and every pointer multiples of 16. The ring's shape comes from the
// caller: `rows` whole output rows to a stage, or, if rows is 0, pieces of
// `piece` bytes (a multiple of 16); `stages` stages (at least 2: a stage
// refills while the next drains) and then their mbarriers in `smem` bytes of
// dynamic shared memory; `grid` CTAs.
extern "C" int row_gather_ring(const void* ids, int B, int R, int k, const void* t0, const void* t1,
                               const void* t2, void* o0, void* o1, void* o2, long long rb0, long long rb1,
                               long long rb2, int rows, long long piece, int stages, int grid, int smem,
                               void* stream) {
  if (B <= 0) return 0;
  if (k < 1 || k > MAX_TABLES || rows < 0 || stages < 2 || grid < 1 || smem > SMEM_PER_BLOCK)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rb[MAX_TABLES] = {rb0, rb1, rb2};
  long long row_bytes = 0, groups = 0;  // groups: pieces in one output row, over all tables
  for (int j = 0; j < k; ++j) {
    if (rb[j] < 16 || rb[j] % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
    row_bytes += rb[j];
    if (rows == 0) {
      if (piece < 16 || piece % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
      groups += (rb[j] + piece - 1) / piece;
    }
  }
  const long long stage_bytes = rows > 0 ? rows * row_bytes : piece;
  // the kernel splits B * groups pieces over the grid in 64-bit products
  if (groups > INT32_MAX || B * groups > (1LL << 40) || smem < stages * (stage_bytes + 8))
    return static_cast<int>(cudaErrorInvalidValue);
  // a launch above 48 KB of dynamic shared memory is refused without this;
  // it is set once for each device and size
  static int opted_in[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || opted_in[dev] < smem) {
    err = cudaFuncSetAttribute(row_gather_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) opted_in[dev] = smem;
  }
  row_gather_ring_kernel<<<grid, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), B, R, k, make_tables(t0, t1, t2, o0, o1, o2, rb0, rb1, rb2), rows, piece,
      static_cast<int>(groups), stages, stage_bytes);
  return static_cast<int>(cudaGetLastError());
}

// rb_j and every pointer multiples of 4; num_sms the device's SM count. The
// launch is sized here: the fewest lanes, a power of two up to a warp, that
// cover a row's words, and a persistent grid no larger than the passes of
// rows there are.
extern "C" int row_gather_words(const void* ids, int B, int R, int k, const void* t0, const void* t1,
                                const void* t2, void* o0, void* o1, void* o2, long long rb0, long long rb1,
                                long long rb2, int num_sms, void* stream) {
  if (B <= 0) return 0;
  if (k < 1 || k > MAX_TABLES || num_sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long rb[MAX_TABLES] = {rb0, rb1, rb2};
  long long words = 0;
  for (int j = 0; j < k; ++j) {
    if (rb[j] < 4 || rb[j] % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
    words = rb[j] / 4 > words ? rb[j] / 4 : words;
  }
  int lanes_log2 = 0;
  while (lanes_log2 < 5 && (1LL << lanes_log2) < words) ++lanes_log2;
  const long long per_warp = words <= (1LL << lanes_log2) ? (32 >> lanes_log2) * UNROLL : 1;
  const long long passes = (B + per_warp * WORD_WARPS - 1) / (per_warp * WORD_WARPS);
  const int grid = static_cast<int>(passes < num_sms * WORD_BLOCKS_PER_SM ? passes : num_sms * WORD_BLOCKS_PER_SM);
  const Tables tb = make_tables(t0, t1, t2, o0, o1, o2, rb0, rb1, rb2);
  const int* id = static_cast<const int*>(ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 1) row_gather_words_kernel<1><<<grid, WORD_THREADS, 0, s>>>(id, B, R, tb, lanes_log2);
  if (k == 2) row_gather_words_kernel<2><<<grid, WORD_THREADS, 0, s>>>(id, B, R, tb, lanes_log2);
  if (k == 3) row_gather_words_kernel<3><<<grid, WORD_THREADS, 0, s>>>(id, B, R, tb, lanes_log2);
  return static_cast<int>(cudaGetLastError());
}
