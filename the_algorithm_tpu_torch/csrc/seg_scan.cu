// Run-collapse (dedup-sum) of sorted id rows, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the_algorithm_tpu/ops/seg_scan.py:
// _run_collapse_single (pallas_call at :101, on the SANN dedup path through
// retrieval._dedup_sum) and _run_collapse_call (:134), whose body
// _collapse_tile (:49-77) runs a log-step segmented scan over one whole
// padded row held in VMEM.
//
// Semantics, per row of ids sorted ascending: each maximal run of equal ids
// collapses; the run's LAST slot holds (id, sum of each value array over the
// run) and every other slot holds (PAD_ID, 0). A run of PAD_ID also reads
// (PAD_ID, 0): consumers mask by PAD_ID and never read a PAD slot's sums.
//
// What bounds it on this card: memory. Each slot is read once and written
// once, (1 + k) * 4 bytes each way: at SANN ([256, 20,000], k = 2) 122.88 MB,
// 0.0367 ms at 3.35 TB/s. A plain device copy of the same bytes takes about
// a quarter more than that bound on an H100 (PERF.md), so the aim is copy speed.
//
// What the design does about it. A row is cut into tiles of `tile` slots and
// taken by a thread-block cluster of `cluster` CTAs (1 to 8), each CTA one
// tile of each pass over the row. The caller gives a row as many CTAs as it
// takes to give every SM its CTAs (ops/seg_scan.py:_plan): one at SANN, up to
// 8 when few rows would leave SMs idle, since every pass of a cluster of more
// than one CTA costs a cluster barrier. The grid is persistent: as many
// clusters as the card holds at once, each walking its rows' (row, pass)
// units, so a CTA's ring of 1 to 3 stages in dynamic shared memory holds the
// next units' tiles, loaded by 1-D TMA bulk copies, while it scans one. Slots
// that a 16-byte bulk copy cannot take (a row start that is not 16-byte
// aligned, W % 4 != 0, or a pointer that is not) are loaded and stored one by
// one. Each thread scans 8 consecutive slots, which it reads and writes as
// two 16-byte vectors, lanes 4-7 of each quarter-warp taking their second
// vector first so that no two lanes of a quarter-warp hit one bank; warp
// shuffles scan the lanes and then the warps' totals. Outputs go back into
// the stage in place and leave by bulk stores.
//
// The carry across tiles. Each CTA scans its tile as if the tile started a
// run, so every output but one is final: the end of the tile's first run,
// if that run began in an earlier tile. The CTA writes its tile's aggregate
// (whether the tile holds a run head, and the sums of its trailing run) to
// its own shared memory and arrives on the cluster barrier; it writes its
// outputs while the others catch up, then waits. Warp 0 then reads the
// cluster's aggregates through distributed shared memory, one CTA to a lane,
// folds those of the tiles before its own into the carry, adds the carry to
// that one slot, and issues the stores. The fold of all the cluster's tiles
// is the carry into the row's next pass. Sums are taken in a fixed order,
// with no atomics, in one launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int ITEMS = 8;  // consecutive slots a thread scans
constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MAX_STAGES = 3;
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
constexpr int MAX_VALUES = 3;
constexpr int SMEM_PER_BLOCK = 232448;  // 227 KB: the most a block can opt in to
constexpr int PAD_ID = 0x7fffffff;      // int32 max: sorts after every real id
constexpr unsigned FULL = 0xffffffffu;

struct Arrays {
  const int* ids;
  const float* v[MAX_VALUES];
  int* out_ids;
  float* o[MAX_VALUES];
};

// One CTA's tile of one pass: slots [s, s + n) of its row, at element g of the
// flat [Q, W] arrays. Shared memory index `lead + i` holds slot s + i, where
// lead puts element g & ~3 at index 0, so that a 16-byte-aligned element sits
// at a 16-byte-aligned index. Slots [lo, hi) come by bulk copy, the rest one
// by one.
struct Tile {
  long long s, g;
  int n, lead, lo, hi;
};

__device__ __forceinline__ Tile tile_of(int pass, uint32_t cs, uint32_t rank, int tile, int W, long long row,
                                        bool bulk) {
  Tile t;
  t.s = (static_cast<long long>(pass) * cs + rank) * tile;
  t.n = static_cast<int>(W - t.s < 0 ? 0 : (W - t.s < tile ? W - t.s : tile));
  t.g = row + t.s;
  t.lead = bulk ? static_cast<int>(t.g & 3) : 0;
  const long long up = (t.g + 3) & ~3LL, down = (t.g + t.n) & ~3LL;
  if (bulk && down > up) {
    t.lo = static_cast<int>(up - t.g);
    t.hi = static_cast<int>(down - t.g);
  } else {
    t.lo = t.hi = t.n;
  }
  return t;
}

// A thread's 8 slots at index i0 (a multiple of 8) as two 16-byte vectors,
// the half `h` first: lanes 0-3 of a quarter-warp read 32-byte-strided
// vectors of banks 0-3, 8-11, ..., lanes 4-7 those of banks 4-7, 12-15, ...
template <typename T, typename V>
__device__ __forceinline__ void read8(const T* base, int i0, int h, T (&x)[ITEMS]) {
  const V a = *reinterpret_cast<const V*>(base + i0 + 4 * h);
  const V b = *reinterpret_cast<const V*>(base + i0 + 4 * (1 - h));
  const V lo = h ? b : a, hi = h ? a : b;
  x[0] = lo.x, x[1] = lo.y, x[2] = lo.z, x[3] = lo.w;
  x[4] = hi.x, x[5] = hi.y, x[6] = hi.z, x[7] = hi.w;
}

template <typename T, typename V>
__device__ __forceinline__ void write8(T* base, int i0, int h, const T (&x)[ITEMS]) {
  const V lo{x[0], x[1], x[2], x[3]}, hi{x[4], x[5], x[6], x[7]};
  *reinterpret_cast<V*>(base + i0 + 4 * h) = h ? hi : lo;
  *reinterpret_cast<V*>(base + i0 + 4 * (1 - h)) = h ? lo : hi;
}

// The segmented sum: (fa, a) then (fb, b) is (fa | fb, fb ? b : a + b).
// A persistent grid: cluster c of G takes rows c, c + G, ..., and its CTAs
// walk the units (row, pass) of those rows in step, each its own tile of each.
template <int K>
__global__ void __launch_bounds__(MAX_THREADS, 2) run_collapse_kernel(Arrays A, int Q, int W, int tile, int passes,
                                                                   int stages, int slots, int bulk_ok) {
  // stage s, array j (0: ids, 1 + j: value j) at smem + (s * (1 + K) + j) * slots * 4
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[MAX_STAGES];
  __shared__ int s_wflag[MAX_WARPS];
  __shared__ float s_wsum[K][MAX_WARPS];
  __shared__ int s_prev, s_next, s_fix;
  __shared__ int s_aflag[2];  // the tile aggregate, by unit parity, read by the cluster
  __shared__ float s_asum[2][K];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;
  const int h = (lane >> 2) & 1;
  const int i0 = tid * ITEMS;
  const uint32_t cs = tma::cluster_size(), rank = tma::cluster_rank();
  const int c = blockIdx.x / cs, clusters = gridDim.x / cs;
  const int units = c < Q ? ((Q - 1 - c) / clusters + 1) * passes : 0;
  const bool bulk = bulk_ok != 0;
  auto ids_at = [&](int s) { return reinterpret_cast<int*>(smem + static_cast<size_t>(s) * (1 + K) * slots * 4); };
  auto vals_at = [&](int s, int j) {
    return reinterpret_cast<float*>(smem + (static_cast<size_t>(s) * (1 + K) + 1 + j) * slots * 4);
  };
  auto tile_at = [&](int u) {
    const long long q = c + static_cast<long long>(u / passes) * clusters;
    return tile_of(u % passes, cs, rank, tile, W, q * W, bulk);
  };

  // thread 0: arm stage u % stages and issue unit u's bulk loads on it
  auto issue = [&](int u) {
    const int st = u % stages;
    const Tile t = tile_at(u);
    const uint32_t bar = tma::smem_addr(&bars[st]);
    const uint32_t bytes = static_cast<uint32_t>(t.hi - t.lo) * 4;
    tma::bar_arm(bar, bytes * (1 + K));
    if (bytes == 0) return;
    const uint32_t at = static_cast<uint32_t>(t.lead + t.lo) * 4;
    tma::bulk_load(tma::smem_addr(ids_at(st)) + at, A.ids + t.g + t.lo, bytes, bar);
#pragma unroll
    for (int j = 0; j < K; ++j) tma::bulk_load(tma::smem_addr(vals_at(st, j)) + at, A.v[j] + t.g + t.lo, bytes, bar);
  };

  // thread 0: the ids beside unit u's tile, loaded a unit ahead of their use
  int prev_id = PAD_ID, next_id = PAD_ID;
  auto neighbours = [&](int u) {
    if (u >= units) return;
    const Tile t = tile_at(u);
    prev_id = t.n > 0 && t.s > 0 ? A.ids[t.g - 1] : PAD_ID;
    next_id = t.n > 0 && t.s + t.n < W ? A.ids[t.g + t.n] : PAD_ID;
  };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) tma::bar_init(tma::smem_addr(&bars[s]));
    tma::bar_init_fence();
    for (int u = 0; u < stages && u < units; ++u) issue(u);
    neighbours(0);
  }
  __syncthreads();

  float carry[K];  // warp 0: the fold of the row's tiles of the passes before
  int last_edges = 0;  // slots the last unit loaded one by one

  for (int u = 0; u < units; ++u) {
    const int st = u % stages;
    const Tile t = tile_at(u);
    int* sid = ids_at(st);
    if (u % passes == 0) {
#pragma unroll
      for (int j = 0; j < K; ++j) carry[j] = 0.f;
    }
    if (u > 0) {
      if (last_edges > 0) __syncthreads();  // the last unit's scalar stores have read their stage
      if (tid == 0 && u - 1 + stages < units) {
        tma::bulk_wait_read<0>();  // and so have its bulk stores: refill that stage
        issue(u - 1 + stages);
      }
    }
    tma::bar_wait(tma::smem_addr(&bars[st]), static_cast<uint32_t>((u / stages) & 1));

    // the slots no bulk copy brought
    const int edges = t.lo + t.n - t.hi;  // slots [0, lo) and [hi, n)
    last_edges = edges;
    for (int e = tid; e < edges; e += blockDim.x) {
      const int i = e < t.lo ? e : t.hi + e - t.lo;
      sid[t.lead + i] = A.ids[t.g + i];
#pragma unroll
      for (int j = 0; j < K; ++j) vals_at(st, j)[t.lead + i] = A.v[j][t.g + i];
    }
    if (tid == 0) {
      s_prev = prev_id;
      s_next = next_id;
      s_fix = -1;
      neighbours(u + 1);
    }
    __syncthreads();

    // this thread's 8 slots; a slot outside the tile is the identity (no head, 0)
    int id[ITEMS];
    float v[K][ITEMS];
    read8<int, int4>(sid, i0, h, id);
#pragma unroll
    for (int j = 0; j < K; ++j) read8<float, float4>(vals_at(st, j), i0, h, v[j]);
    int before = __shfl_up_sync(FULL, id[ITEMS - 1], 1);
    int after = __shfl_down_sync(FULL, id[0], 1);
    if (lane == 0) before = i0 > 0 ? sid[i0 - 1] : PAD_ID;
    if (lane == 31) after = i0 + ITEMS < slots ? sid[i0 + ITEMS] : PAD_ID;

    unsigned head = 0, last = 0;  // bit x: slot x starts / ends a run
    const int p0 = i0 - t.lead;       // the tile position of this thread's first slot
    if (p0 >= 1 && p0 + ITEMS < t.n) {  // all 8 inside the tile, with both neighbours
#pragma unroll
      for (int x = 0; x < ITEMS; ++x) {
        head |= static_cast<unsigned>(id[x] != (x == 0 ? before : id[x - 1])) << x;
        last |= static_cast<unsigned>(id[x] != (x == ITEMS - 1 ? after : id[x + 1])) << x;
      }
    } else {
#pragma unroll
      for (int x = 0; x < ITEMS; ++x) {
        const int pos = p0 + x;  // slot s + pos of the row
        const bool in = pos >= 0 && pos < t.n;
        int prev = x == 0 ? before : id[x - 1];
        int next = x == ITEMS - 1 ? after : id[x + 1];
        if (pos == 0) prev = s_prev;
        if (pos == t.n - 1) next = s_next;
        head |= static_cast<unsigned>(in && (t.s + pos == 0 || id[x] != prev)) << x;
        last |= static_cast<unsigned>(in && (t.s + pos == W - 1 || id[x] != next)) << x;
#pragma unroll
        for (int j = 0; j < K; ++j) v[j][x] = in ? v[j][x] : 0.f;
      }
    }
    int flag = head != 0;
    float agg[K];
#pragma unroll
    for (int j = 0; j < K; ++j) agg[j] = 0.f;
#pragma unroll
    for (int x = 0; x < ITEMS; ++x) {
#pragma unroll
      for (int j = 0; j < K; ++j) agg[j] = (head >> x) & 1 ? v[j][x] : agg[j] + v[j][x];
    }

    // inclusive segmented scan across the warp, then exclusive
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int f_up = __shfl_up_sync(FULL, flag, off);
      float a_up[K];
#pragma unroll
      for (int j = 0; j < K; ++j) a_up[j] = __shfl_up_sync(FULL, agg[j], off);
      if (lane >= off) {
#pragma unroll
        for (int j = 0; j < K; ++j) agg[j] = flag ? agg[j] : a_up[j] + agg[j];
        flag |= f_up;
      }
    }
    if (lane == 31) {
      s_wflag[warp] = flag;
#pragma unroll
      for (int j = 0; j < K; ++j) s_wsum[j][warp] = agg[j];
    }
    int ex_flag = __shfl_up_sync(FULL, flag, 1);
    float run[K];
#pragma unroll
    for (int j = 0; j < K; ++j) run[j] = __shfl_up_sync(FULL, agg[j], 1);
    if (lane == 0) {
      ex_flag = 0;
#pragma unroll
      for (int j = 0; j < K; ++j) run[j] = 0.f;
    }
    __syncthreads();  // every read of the stage is done; warp totals are out

    // the warps' totals, scanned by every warp in its lanes: the prefix before
    // this thread's warp, and (at the last warp) the tile's aggregate
    int wf = 0;
    float ws[K];
#pragma unroll
    for (int j = 0; j < K; ++j) ws[j] = 0.f;
    if (lane < warps) {
      wf = s_wflag[lane];
#pragma unroll
      for (int j = 0; j < K; ++j) ws[j] = s_wsum[j][lane];
    }
#pragma unroll
    for (int off = 1; off < MAX_WARPS; off <<= 1) {
      const int f_up = __shfl_up_sync(FULL, wf, off);
      float a_up[K];
#pragma unroll
      for (int j = 0; j < K; ++j) a_up[j] = __shfl_up_sync(FULL, ws[j], off);
      if (lane >= off) {
#pragma unroll
        for (int j = 0; j < K; ++j) ws[j] = wf ? ws[j] : a_up[j] + ws[j];
        wf |= f_up;
      }
    }
    const int pre_flag = warp > 0 ? __shfl_sync(FULL, wf, warp - 1) : 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float pre = warp > 0 ? __shfl_sync(FULL, ws[j], warp - 1) : 0.f;
      run[j] = ex_flag ? run[j] : pre + run[j];
    }
    bool open = !(pre_flag | ex_flag);  // no run head in the tile before this slot
    const int tile_flag = __shfl_sync(FULL, wf, warps - 1);
    float tile_sum[K];
#pragma unroll
    for (int j = 0; j < K; ++j) tile_sum[j] = __shfl_sync(FULL, ws[j], warps - 1);
    if (tid == 0) {  // the tile's aggregate, for the cluster
      s_aflag[u & 1] = tile_flag;
#pragma unroll
      for (int j = 0; j < K; ++j) s_asum[u & 1][j] = tile_sum[j];
    }
    tma::cluster_arrive();  // the aggregate is out: make the outputs while the cluster catches up

    // outputs, in place: run ends hold (id, sums), the rest (PAD_ID, 0)
#pragma unroll
    for (int x = 0; x < ITEMS; ++x) {
      const bool hd = (head >> x) & 1;
      open = open && !hd;
      const bool keep = ((last >> x) & 1) && id[x] != PAD_ID;
      if (keep && open) s_fix = i0 + x;  // the end of a run begun in an earlier tile
#pragma unroll
      for (int j = 0; j < K; ++j) {
        run[j] = hd ? v[j][x] : run[j] + v[j][x];
        v[j][x] = keep ? run[j] : 0.f;
      }
      id[x] = keep ? id[x] : PAD_ID;
    }
    write8<int, int4>(sid, i0, h, id);
#pragma unroll
    for (int j = 0; j < K; ++j) write8<float, float4>(vals_at(st, j), i0, h, v[j]);
    tma::fence_async_shared();
    __syncthreads();  // the outputs and s_fix are in place
    tma::cluster_wait();

    if (warp == 0) {
      // the carry into this tile: the passes before, then the cluster's tiles
      // before this one, in order; their fold is the next pass's carry. Lane
      // r reads CTA r's aggregate; every lane folds them alike.
      int f = 0;
      float a[K];
#pragma unroll
      for (int j = 0; j < K; ++j) a[j] = 0.f;
      if (lane < static_cast<int>(cs)) {
        f = tma::ld_cluster_s32(tma::map_rank(tma::smem_addr(&s_aflag[u & 1]), lane));
#pragma unroll
        for (int j = 0; j < K; ++j) a[j] = tma::ld_cluster_f32(tma::map_rank(tma::smem_addr(&s_asum[u & 1][j]), lane));
      }
      float in[K];
#pragma unroll
      for (int j = 0; j < K; ++j) in[j] = carry[j];
      for (uint32_t r = 0; r < cs; ++r) {
        const int fr = __shfl_sync(FULL, f, r);
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const float ar = __shfl_sync(FULL, a[j], r);
          if (r < rank) in[j] = fr ? ar : in[j] + ar;
          carry[j] = fr ? ar : carry[j] + ar;
        }
      }
      if (lane == 0) {
        if (s_fix >= 0) {
#pragma unroll
          for (int j = 0; j < K; ++j) vals_at(st, j)[s_fix] = in[j] + vals_at(st, j)[s_fix];
          tma::fence_async_shared();
        }
        const uint32_t bytes = static_cast<uint32_t>(t.hi - t.lo) * 4;
        if (bytes > 0) {
          const uint32_t at = static_cast<uint32_t>(t.lead + t.lo) * 4;
          tma::bulk_store(A.out_ids + t.g + t.lo, tma::smem_addr(sid) + at, bytes);
#pragma unroll
          for (int j = 0; j < K; ++j)
            tma::bulk_store(A.o[j] + t.g + t.lo, tma::smem_addr(vals_at(st, j)) + at, bytes);
        }
        tma::bulk_commit();
      }
    }
    if (edges > 0) __syncthreads();  // the carried slot is in place for the scalar stores
    for (int e = tid; e < edges; e += blockDim.x) {
      const int i = e < t.lo ? e : t.hi + e - t.lo;
      A.out_ids[t.g + i] = sid[t.lead + i];
#pragma unroll
      for (int j = 0; j < K; ++j) A.o[j][t.g + i] = vals_at(st, j)[t.lead + i];
    }
  }
  // the bulk stores have read the ring before the CTA exits (their writes land
  // before the grid completes), and no CTA leaves while another of its cluster
  // may still read its aggregates
  if (tid == 0) tma::bulk_wait_read<0>();
  tma::cluster_arrive();
  tma::cluster_wait();
}

// opts a kernel in to `smem` bytes of dynamic shared memory, once for each
// device and size: a launch above 48 KB is refused without it
template <int K>
cudaError_t opt_in(int smem) {
  static int opted_in[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && opted_in[dev] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(run_collapse_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < 64) opted_in[dev] = smem;
  return err;
}

// The persistent grid: as many clusters as the card holds at once, no more
// than there are rows, each with ceil(Q / G) or one row fewer. Cached for the
// last device and shape asked; the kernel is right for any grid, so a value
// raced by another host thread only changes its speed.
template <int K>
cudaError_t launch(const Arrays& a, int Q, int W, int cluster, int tile, int passes, int stages, int threads,
                   int smem, bool bulk, cudaStream_t stream) {
  cudaError_t err = opt_in<K>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static int cached[4] = {-1, 0, 0, 0};  // device, cluster, threads, smem -> clusters resident
  static int resident = 0;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (cached[0] != dev || cached[1] != cluster || cached[2] != threads || cached[3] != smem) {
    cfg.gridDim = dim3(cluster);
    err = cudaOccupancyMaxActiveClusters(&resident, run_collapse_kernel<K>, &cfg);
    if (err != cudaSuccess) return err;
    if (resident < 1) return cudaErrorInvalidConfiguration;
    cached[0] = dev, cached[1] = cluster, cached[2] = threads, cached[3] = smem;
  }
  const int per = (Q + resident - 1) / resident;  // rows a cluster takes, at most
  const int clusters = (Q + per - 1) / per;
  cfg.gridDim = dim3(static_cast<unsigned>(clusters) * cluster);
  return cudaLaunchKernelEx(&cfg, run_collapse_kernel<K>, a, Q, W, tile, passes, stages, threads * ITEMS,
                            static_cast<int>(bulk));
}

}  // namespace

// ids/values/outputs: [Q, W] contiguous on the device; k in {1, 2, 3} value
// arrays (unused pointers may be null). The launch's shape comes from the
// caller (ops/seg_scan.py:_plan): a cluster of `cluster` CTAs to a row, tiles
// of `tile` slots (a multiple of 4), `passes` passes so that
// cluster * tile * passes >= W, a ring of `stages` stages (1 to 3),
// `threads` threads (a multiple of 32, 8 slots each, covering a tile and the
// up to 3 slots before it in its first 16 bytes), and `smem` bytes of dynamic
// shared memory, stages * (1 + k) * threads * 32. The grid is sized here.
// Returns the launch's cudaError_t.
extern "C" int run_collapse_sorted(const void* ids, const void* v0, const void* v1, const void* v2,
                                   void* out_ids, void* o0, void* o1, void* o2, int Q, int W, int k, int cluster,
                                   int tile, int passes, int stages, int threads, int smem, void* stream) {
  if (Q <= 0 || W <= 0) return 0;
  const bool ok = k >= 1 && k <= MAX_VALUES && cluster >= 1 && cluster <= MAX_CLUSTER && tile >= 4 &&
                  tile % 4 == 0 && passes >= 1 && static_cast<long long>(cluster) * tile * passes >= W &&
                  stages >= 1 && stages <= MAX_STAGES && threads >= 32 &&
                  threads <= MAX_THREADS && threads % 32 == 0 && threads * ITEMS >= tile + 3 &&
                  smem == stages * (1 + k) * threads * ITEMS * 4 && smem <= SMEM_PER_BLOCK - 1024 &&
                  static_cast<long long>(Q) * cluster <= INT32_MAX;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Arrays a{static_cast<const int*>(ids),
                 {static_cast<const float*>(v0), static_cast<const float*>(v1), static_cast<const float*>(v2)},
                 static_cast<int*>(out_ids),
                 {static_cast<float*>(o0), static_cast<float*>(o1), static_cast<float*>(o2)}};
  // bulk copies take 16-byte-aligned addresses: with every pointer aligned, a
  // slot's alignment is its element index's
  bool bulk = reinterpret_cast<uintptr_t>(ids) % 16 == 0 && reinterpret_cast<uintptr_t>(out_ids) % 16 == 0;
  for (int j = 0; j < k; ++j)
    bulk = bulk && reinterpret_cast<uintptr_t>(a.v[j]) % 16 == 0 && reinterpret_cast<uintptr_t>(a.o[j]) % 16 == 0;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (k == 1) err = launch<1>(a, Q, W, cluster, tile, passes, stages, threads, smem, bulk, s);
  if (k == 2) err = launch<2>(a, Q, W, cluster, tile, passes, stages, threads, smem, bulk, s);
  if (k == 3) err = launch<3>(a, Q, W, cluster, tile, passes, stages, threads, smem, bulk, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The D-wide collapse: an embedding table's gradient.
//
// Replaces the same Pallas kernel (the_algorithm_tpu/ops/seg_scan.py:134,
// _run_collapse_call) at k = D: the TPU kernel takes any number of value
// arrays, and the gradient of a [N, D] table read at ids [n] is that collapse
// over the D columns of the read's output gradient. The JAX package reaches it
// through XLA's scatter-add, the transpose of its gather; here a table read
// (ops/gather.py:table_read) sorts its ids (stable) and hands this kernel the
// sorted ids, the sort's permutation and the output gradient dy [n', D].
//
// Semantics: for each run of equal ids in [0, N), the sum of dy[perm[s], :]
// over the run's slots s, in slot order, in f32, written once into row id of
// the zero-filled [N, D] output. Ids outside [0, N) (PAD_ID among them) are
// dropped. No atomics: each row has one writer, and the order of its sums is
// fixed, so the result is the same bits run to run.
//
// What bounds it: memory. It reads the ids (4 B), the permutation (8 B) and
// one D-wide row of dy (4D B) per slot, and writes each distinct row once: at
// a two-tower batch of 4,096 rows of D = 128, about 2 x 4,096 x 512 B, a few
// microseconds at 3.35 TB/s, so a launch costs more than its bytes. (The
// zero fill of the dense output is the caller's, and at a 2M-row table it is
// the larger cost.)
//
// What the design does about it: nothing clever yet. A warp per slot; the
// warp of a run's first slot walks the run, 32 slots at a time (one id and
// one permutation entry a lane, a ballot for where the run ends), and adds the
// run's rows in slot order, ROWS_UNROLL rows' loads in flight before their
// adds so that a long run (TwHIN's relation table: ~680 slots a run) is not
// one load latency a row. Each lane holds 4 columns (a 16-byte vector) of
// each 128-column chunk, or 1 column of each 32 when D % 4 != 0 or a base is
// not 16-byte aligned. Other warps return at once.
namespace {

constexpr int ROWS_WARPS = 8;   // warps of a block, one slot each
constexpr int ROWS_UNROLL = 8;  // rows whose loads a warp issues before it adds them (divides 32)

template <bool VEC>
__global__ void __launch_bounds__(ROWS_WARPS * 32) run_collapse_rows_kernel(const int* __restrict__ ids,
                                                                          const long long* __restrict__ perm,
                                                                          const float* __restrict__ dy,
                                                                          float* __restrict__ out, long long n,
                                                                          int D, int N) {
  const int lane = threadIdx.x & 31;
  const long long slot = static_cast<long long>(blockIdx.x) * ROWS_WARPS + (threadIdx.x >> 5);
  if (slot >= n) return;
  const int id = ids[slot];
  if (id < 0 || id >= N) return;                // dropped: PAD_ID or out of range
  if (slot > 0 && ids[slot - 1] == id) return;  // not the run's first slot
  constexpr int WIDTH = VEC ? 4 : 1;            // columns a lane holds of a chunk
  constexpr int CHUNK = 32 * WIDTH;
  for (int c0 = 0; c0 < D; c0 += CHUNK) {
    const int col = c0 + lane * WIDTH;
    const bool mine = col < D;  // D % 4 == 0 on the vector path: a lane's 4 columns are all in or all out
    float acc[WIDTH];
#pragma unroll
    for (int w = 0; w < WIDTH; ++w) acc[w] = 0.0f;
    for (long long j = slot;; j += 32) {
      const long long s = j + lane;
      const bool in = s < n && ids[s] == id;  // sorted: the run is a prefix of the 32 slots
      const unsigned m = __ballot_sync(FULL, in);
      const int count = m == FULL ? 32 : __ffs(static_cast<int>(~m)) - 1;
      const long long row = in ? perm[s] : 0;
      for (int t = 0; t < count; t += ROWS_UNROLL) {
        float v[ROWS_UNROLL][WIDTH];
#pragma unroll
        for (int u = 0; u < ROWS_UNROLL; ++u) {
          const long long r = __shfl_sync(FULL, row, t + u);
          if (t + u < count && mine) {
            const float* src = dy + r * D + col;
            if constexpr (VEC) {
              const float4 x = __ldg(reinterpret_cast<const float4*>(src));
              v[u][0] = x.x, v[u][1] = x.y, v[u][2] = x.z, v[u][3] = x.w;
            } else {
              v[u][0] = __ldg(src);
            }
          } else {
#pragma unroll
            for (int w = 0; w < WIDTH; ++w) v[u][w] = 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < ROWS_UNROLL; ++u) {
          if (t + u < count) {
#pragma unroll
            for (int w = 0; w < WIDTH; ++w) acc[w] += v[u][w];
          }
        }
      }
      if (count < 32) break;
    }
    if (mine) {
      float* dst = out + static_cast<long long>(id) * D + col;
      if constexpr (VEC) {
        *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      } else {
        dst[0] = acc[0];
      }
    }
  }
}

}  // namespace

// ids: [n] int32 sorted ascending; perm: [n] int64, slot s's row of dy; dy:
// [n', D] f32 contiguous; out: [N, D] f32 contiguous and zero-filled. vec != 0
// takes 16-byte vectors (D % 4 == 0, dy and out 16-byte aligned). Returns the
// launch's cudaError_t.
extern "C" int run_collapse_rows(const void* ids, const void* perm, const void* dy, void* out, long long n, int D,
                                 int N, int vec, void* stream) {
  if (n <= 0 || D <= 0 || N <= 0) return 0;
  if (vec && (D % 4 != 0 || reinterpret_cast<uintptr_t>(dy) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + ROWS_WARPS - 1) / ROWS_WARPS;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* i = static_cast<const int*>(ids);
  const auto* p = static_cast<const long long*>(perm);
  const auto* d = static_cast<const float*>(dy);
  auto* o = static_cast<float*>(out);
  if (vec)
    run_collapse_rows_kernel<true><<<static_cast<unsigned>(blocks), ROWS_WARPS * 32, 0, s>>>(i, p, d, o, n, D, N);
  else
    run_collapse_rows_kernel<false><<<static_cast<unsigned>(blocks), ROWS_WARPS * 32, 0, s>>>(i, p, d, o, n, D, N);
  return static_cast<int>(cudaGetLastError());
}
