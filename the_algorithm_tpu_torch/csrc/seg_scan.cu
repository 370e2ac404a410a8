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
constexpr int MAX_VALUES = 4;
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

// ids/values/outputs: [Q, W] contiguous on the device; k in {1, 2, 3, 4} value
// arrays (unused pointers may be null). The launch's shape comes from the
// caller (ops/seg_scan.py:_plan): a cluster of `cluster` CTAs to a row, tiles
// of `tile` slots (a multiple of 4), `passes` passes so that
// cluster * tile * passes >= W, a ring of `stages` stages (1 to 3),
// `threads` threads (a multiple of 32, 8 slots each, covering a tile and the
// up to 3 slots before it in its first 16 bytes), and `smem` bytes of dynamic
// shared memory, stages * (1 + k) * threads * 32. The grid is sized here.
// Returns the launch's cudaError_t.
extern "C" int run_collapse_sorted(const void* ids, const void* v0, const void* v1, const void* v2, const void* v3,
                                   void* out_ids, void* o0, void* o1, void* o2, void* o3, int Q, int W, int k, int cluster,
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
                 {static_cast<const float*>(v0), static_cast<const float*>(v1), static_cast<const float*>(v2),
                  static_cast<const float*>(v3)},
                 static_cast<int*>(out_ids),
                 {static_cast<float*>(o0), static_cast<float*>(o1), static_cast<float*>(o2), static_cast<float*>(o3)}};
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
  if (k == 4) err = launch<4>(a, Q, W, cluster, tile, passes, stages, threads, smem, bulk, s);
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
// Semantics: row i of the dense [N, D] f32 output is the sum of dy[perm[s], :]
// over the slots s with ids[s] == i, and 0 where no slot names i. Ids outside
// [0, N) (PAD_ID among them) are dropped. One launch writes every row of the
// output exactly once (or, after the caller's zero fill, every touched row).
//
// What bounds it: memory. The dense output is written once (4ND bytes) and
// the ids, the permutation and each touched dy row are read once (n(12 + 4D)
// bytes): 0.306 ms at a [2,000,000, 128] item table (3.35 TB/s), 3 us at a
// [16,384, 128] user table, 0.6 us at TwHIN's [6, 128] relation table, where a
// launch costs more than its bytes.
//
// What the design does about it.
// (1) The work is the merge of the N output rows with the n sorted slots (a
//     slot sits before the row it names; a dropped slot's id is clamped to
//     [0, N], so negative ids sort before row 0 and ids >= N after row N - 1,
//     where a CTA reads them and skips them). CTA c of a grid of G, all
//     resident, takes merge items [cW/G, (c+1)W/G) of W = n + N, and its 8
//     warps split that evenly again, each finding where its slice starts by
//     a 64-way search of the sorted ids in half a warp (2 rounds of loads at
//     n = 4,096; the other half finds where it ends). So every CTA moves
//     about the same bytes whether its share is mostly rows to zero (a
//     16,384-row table) or slots to sum (6 rows).
// (2) A warp walks its slice in slot order, 32 slots at a time, one id and
//     one permutation entry a lane (the first 32 in the same round of loads
//     as the ids beside the slice), with ROWS_UNROLL dy rows in flight (a
//     16-byte vector a lane, or one column when D % 4 != 0 or a base is off
//     16 bytes), summing each run in slot order and writing a run whose row
//     lies in its slice. Last, it writes 16-byte zeros over the rows of its
//     slice that no slot names, so the dense output needs no fill. Above
//     FILL_BYTES (ops/seg_scan.py) the caller zero-fills instead and the
//     kernel writes the touched rows only: on an H100 the warps' own zeros
//     lose to a fill from some tens of MB (chip_smoke.py's sweep).
// (3) A run cut by a slice boundary is summed in parts, in a fixed order. The
//     run's slots at a warp's end (its tail) and, when its first row's run
//     began earlier, at its start (its head) go to scratch rows. After a CTA
//     barrier the CTA adds its warps' tails of the run that leaves the CTA,
//     in warp order, into the CTA's part, and raises its flag; a warp whose
//     first row's run began in an earlier warp of the CTA adds those tails,
//     then its head. When the run began in an earlier CTA, warp 0 finds that
//     CTA (a search for the run's first slot), the CTA waits for the flags of
//     the CTAs from there on (the grid is resident — a cooperative launch
//     guarantees it — and every CTA raises its flag before it waits on any,
//     so the wait ends), its 8 warps add their
//     parts in 8 fixed ranges, and the row is the ranges' sums in order plus
//     the CTA's own sum. The order of every sum depends only on (n, N, D, the
//     grid), not on timing. A reader sets a flag back to 0, so the flags need
//     no fill between launches, and the kernel uses no atomics.
namespace {

constexpr int ROWS_WARPS = 8;  // warps of a CTA, each a slice of the CTA's share
constexpr int ROWS_THREADS = ROWS_WARPS * 32;
constexpr int ROWS_CTAS_PER_SM = 4;  // the residency the grid is sized for: 64 registers a thread
constexpr int ROWS_UNROLL = 8;       // dy rows a warp has in flight (divides 32)
constexpr long long ROWS_SPIN_LIMIT = 1LL << 26;  // polls of a flag, ~64 ns apart, before the launch gives up

struct RowsArgs {
  const int* ids;
  const long long* perm;
  const float* dy;
  float* out;
  float* scratch;  // D floats each: a tail row per warp, a head row per warp, a part row per CTA
  int* flags;      // per CTA: 1 once its part is out, 0 between launches
  int n, D, N, G;
  int zero_rows;  // 0: the caller zero-filled out, and only the touched rows are written
};

// A warp's slice of the merge: slots [k0, k1) and rows [r0, r1).
struct Slice {
  int k0, k1, r0, r1;
};

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// returns once a CTA's flag is up. One that never rises is a fault of the
// grid: the launch ends with an error after seconds rather than hang the card.
__device__ __forceinline__ void wait_flag(const int* p) {
  for (long long spin = 0; load_acquire(p) == 0; ++spin) {
    if (spin == ROWS_SPIN_LIMIT) __trap();
    __nanosleep(64);
  }
}

// The first j of [lo, hi) where pred(j) is false, pred holding on a prefix (hi
// if it holds throughout). The P lanes of `mask` (lane index i = 0..P-1) probe
// Q places each a round, P * Q in all, cutting the range P * Q + 1 ways: a
// range of 4,096 slots takes 2 rounds at P * Q = 64.
template <int P, int Q, typename Pred>
__device__ __forceinline__ int warp_search(int lo, int hi, int i, unsigned mask, Pred pred) {
  while (hi > lo) {
    const int step = (hi - lo + P * Q) / (P * Q + 1);
    bool below[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {  // probe q * P + i: the Q loads of a lane are in flight together
      const long long j = lo + static_cast<long long>(q * P + i + 1) * step - 1;
      below[q] = j < hi && pred(static_cast<int>(j));
    }
    int c = 0;  // the probes below: a prefix of the P * Q
#pragma unroll
    for (int q = 0; q < Q; ++q) c += __popc(__ballot_sync(mask, below[q]));
    const long long jc = lo + static_cast<long long>(c + 1) * step - 1;  // the first probe that failed
    if (c < P * Q && jc < hi) hi = static_cast<int>(jc);
    lo += c * step;
  }
  return lo;
}

// The CTA whose share [cW/G, (c+1)W/G) holds merge item p.
__device__ __forceinline__ int cta_of(long long p, long long W, int G) {
  int c = static_cast<int>(p * G / W);
  while (c + 1 < G && (c + 1) * W / G <= p) ++c;
  return c;
}

template <bool VEC>
struct Cols {
  static constexpr int WIDTH = VEC ? 4 : 1;  // columns a lane holds of a chunk
  static constexpr int CHUNK = 32 * WIDTH;
  float x[WIDTH];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int w = 0; w < WIDTH; ++w) x[w] = 0.0f;
  }
  __device__ __forceinline__ void load(const float* p) {  // dy: read once, through the read-only path
    if constexpr (VEC) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p));
      x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
    } else {
      x[0] = __ldg(p);
    }
  }
  __device__ __forceinline__ void load_l2(const float* p) {  // scratch another warp wrote: past L1
    zero();
    add_l2(p);
  }
  __device__ __forceinline__ void add_shared(const float* p) {
    if constexpr (VEC) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      x[0] += v.x, x[1] += v.y, x[2] += v.z, x[3] += v.w;
    } else {
      x[0] += p[0];
    }
  }
  __device__ __forceinline__ void add_l2(const float* p) {
    if constexpr (VEC) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(p));
      x[0] += v.x, x[1] += v.y, x[2] += v.z, x[3] += v.w;
    } else {
      x[0] += __ldcg(p);
    }
  }
  __device__ __forceinline__ void add(const Cols& o) {
#pragma unroll
    for (int w = 0; w < WIDTH; ++w) x[w] += o.x[w];
  }
  __device__ __forceinline__ void store(float* p) const {
    if constexpr (VEC) {
      *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
    } else {
      p[0] = x[0];
    }
  }
};

// rows [from, to) of out set to 0 by one warp: 16-byte stores on the vector path
template <bool VEC>
__device__ __forceinline__ void zero_fill(float* out, long long from, long long to, int D, int lane) {
  if (from >= to) return;
  if constexpr (VEC) {
    float4* p = reinterpret_cast<float4*>(out + from * D);
    const long long count = (to - from) * D / 4;
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
    for (long long i = lane; i < count; i += 32) p[i] = z;
  } else {
    float* p = out + from * D;
    const long long count = (to - from) * D;
#pragma unroll 4
    for (long long i = lane; i < count; i += 32) p[i] = 0.0f;
  }
}

__device__ __forceinline__ float* tail_row(const RowsArgs& a, int cta, int warp) {
  return a.scratch + (static_cast<long long>(cta) * ROWS_WARPS + warp) * a.D;
}

__device__ __forceinline__ float* head_row(const RowsArgs& a, int cta, int warp) {
  return a.scratch + (static_cast<long long>(a.G + cta) * ROWS_WARPS + warp) * a.D;
}

__device__ __forceinline__ float* part_row(const RowsArgs& a, int cta) {
  return a.scratch + (static_cast<long long>(a.G) * 2 * ROWS_WARPS + cta) * a.D;
}

// One warp's slice, in slot order, one column chunk at a time: each run summed
// in slot order into its row or, cut by the slice's ends, into the warp's tail
// or head row. (id0, row0): the slice's first 32 slots, loaded by the caller.
template <bool VEC>
__device__ void walk_slice(const RowsArgs& a, const Slice& sl, bool carried, int id0, long long row0, float* tail,
                           float* head, int lane) {
  using C = Cols<VEC>;
  for (int c0 = 0; c0 < a.D; c0 += C::CHUNK) {
    const int col = c0 + lane * C::WIDTH;
    const bool mine = col < a.D;  // on the vector path a lane's 4 columns are all in or all out
    int run = 0;
    bool have = false;
    C acc;
    acc.zero();
    auto flush = [&]() {
      if (!mine) return;
      if (run == sl.r1 && sl.r1 < a.N) {
        acc.store(tail + col);
      } else if (carried && run == sl.r0) {
        acc.store(head + col);
      } else if (run >= sl.r0 && run < sl.r1) {
        acc.store(a.out + static_cast<long long>(run) * a.D + col);
      }  // else a dropped id
    };
    for (int base = sl.k0; base < sl.k1; base += 32) {
      const int s = base + lane;
      const int count = sl.k1 - base < 32 ? sl.k1 - base : 32;
      int my_id = id0;
      long long my_row = row0;
      if (base != sl.k0) {  // the id and the permutation entry in one round of loads
        my_id = s < sl.k1 ? __ldg(a.ids + s) : 0;
        my_row = s < sl.k1 ? __ldg(a.perm + s) : -1;
      }
      if (my_id < 0 || my_id >= a.N) my_row = -1;  // dropped: no dy row read
      for (int t = 0; t < count; t += ROWS_UNROLL) {
        C v[ROWS_UNROLL];
#pragma unroll
        for (int u = 0; u < ROWS_UNROLL; ++u) {
          const long long r = __shfl_sync(FULL, my_row, t + u);
          if (t + u < count && r >= 0 && mine) {
            v[u].load(a.dy + r * a.D + col);
          } else {
            v[u].zero();
          }
        }
#pragma unroll
        for (int u = 0; u < ROWS_UNROLL; ++u) {
          const int id = __shfl_sync(FULL, my_id, t + u);
          if (t + u < count) {
            if (!have || id != run) {
              if (have) flush();
              run = id;
              have = true;
              acc.zero();
            }
            acc.add(v[u]);
          }
        }
      }
    }
    if (have) flush();
  }
}

// The rows of a slice that no slot names, zeroed: those before each run's row
// and after the last (the carried row r0 is its run's owner's to write).
template <bool VEC>
__device__ void zero_gaps(const RowsArgs& a, const Slice& sl, bool carried, int lane) {
  long long next = carried ? sl.r0 + 1 : sl.r0;  // the lowest row not yet written
  for (int base = sl.k0; base < sl.k1; base += 32) {
    const int s = base + lane;
    const int count = sl.k1 - base < 32 ? sl.k1 - base : 32;
    const int my_id = s < sl.k1 ? __ldg(a.ids + s) : 0;  // read by the walk just before
    for (int t = 0; t < count; ++t) {
      const int id = __shfl_sync(FULL, my_id, t);
      if (id >= next && id < sl.r1) {
        zero_fill<VEC>(a.out, next, id, a.D, lane);
        next = id + 1;
      }
    }
  }
  zero_fill<VEC>(a.out, next, sl.r1, a.D, lane);
}

// The warps before `w` whose tails are slots of row R, as the first of them
// (w if none): a run goes back through a warp only if that warp holds no row.
__device__ __forceinline__ int first_tail(const Slice* sl, const bool* tail, int w, int R) {
  int first = w;
  for (int v = w - 1; v >= 0; --v) {
    if (sl[v].r1 != R) break;
    if (tail[v]) first = v;
    if (sl[v].r0 != sl[v].r1) break;
  }
  return first;
}

template <bool VEC>
__global__ void __launch_bounds__(ROWS_THREADS, ROWS_CTAS_PER_SM) run_collapse_rows_kernel(RowsArgs a) {
  using C = Cols<VEC>;
  __shared__ Slice s_slice[ROWS_WARPS];
  __shared__ bool s_tail[ROWS_WARPS];
  __shared__ bool s_intra;  // the owner's head row holds a sum: the tails of warps before it, its own head
  __shared__ int s_first;   // the CTA where the run of the CTA's first row began
  __shared__ __align__(16) float s_sum[ROWS_WARPS][C::CHUNK];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, cta = blockIdx.x;
  const long long W = static_cast<long long>(a.n) + a.N;

  // this warp's slice: half a warp finds where it starts, half where it ends,
  // the slots before a merge item d (those placed below d: a slot after the
  // slots before it and the rows below its id, clamped to [0, N])
  const long long d0 = cta * W / a.G, d1 = (cta + 1) * W / a.G;
  const long long dw = d0 + warp * (d1 - d0) / ROWS_WARPS, dw1 = d0 + (warp + 1) * (d1 - d0) / ROWS_WARPS;
  const int half = lane >> 4;
  const long long d = half ? dw1 : dw;
  const int k = warp_search<16, 4>(static_cast<int>(d - a.N > 0 ? d - a.N : 0), static_cast<int>(d < a.n ? d : a.n),
                                   lane & 15, half ? 0xffff0000u : 0x0000ffffu, [&](int j) {
                                     const int id = __ldg(a.ids + j);
                                     return static_cast<long long>(j) + (id < 0 ? 0 : (id > a.N ? a.N : id)) < d;
                                   });
  Slice sl;
  sl.k0 = __shfl_sync(FULL, k, 0);
  sl.k1 = __shfl_sync(FULL, k, 16);
  sl.r0 = static_cast<int>(dw - sl.k0);
  sl.r1 = static_cast<int>(dw1 - sl.k1);
  // one round of loads: the ids beside the slice's ends, its first 32 slots
  const int before = sl.k0 > 0 ? __ldg(a.ids + sl.k0 - 1) : -1, end = sl.k1 > sl.k0 ? __ldg(a.ids + sl.k1 - 1) : -1;
  const int s0 = sl.k0 + lane;
  const int id0 = s0 < sl.k1 ? __ldg(a.ids + s0) : 0;
  const long long row0 = s0 < sl.k1 ? __ldg(a.perm + s0) : -1;
  // the run of row r0 began before this slice; its slots at the slice's end are a tail
  const bool carried = sl.r0 < sl.r1 && sl.k0 > 0 && before == sl.r0;
  const bool tail = sl.r1 < a.N && sl.k1 > sl.k0 && end == sl.r1;
  walk_slice<VEC>(a, sl, carried, id0, row0, tail_row(a, cta, warp), head_row(a, cta, warp), lane);
  if (lane == 0) {
    s_slice[warp] = sl;
    s_tail[warp] = tail;
  }
  __syncthreads();  // the slices, tails and heads are out

  // the CTA's first row R0; cross: its run began in an earlier CTA, and `owner`
  // (the first warp holding a row) writes it
  const Slice first = s_slice[0], last = s_slice[ROWS_WARPS - 1];
  int owner = 0;
  while (owner < ROWS_WARPS - 1 && s_slice[owner].r0 == s_slice[owner].r1) ++owner;
  const bool cross = first.r0 < last.r1 && first.k0 > 0 && a.ids[first.k0 - 1] == first.r0;

  if (warp == ROWS_WARPS - 1) {
    // the CTA's part: its warps' tails of the run that leaves it, in warp
    // order, then its flag up (the barrier, then a release store: the lanes'
    // writes come first)
    const int w0 = first_tail(s_slice, s_tail, ROWS_WARPS, last.r1);
    if (w0 < ROWS_WARPS) {
      for (int c0 = 0; c0 < a.D; c0 += C::CHUNK) {
        const int col = c0 + lane * C::WIDTH;
        if (col >= a.D) continue;
        C acc;
        acc.zero();
        for (int v = w0; v < ROWS_WARPS; ++v)
          if (s_tail[v]) acc.add_l2(tail_row(a, cta, v) + col);
        acc.store(part_row(a, cta) + col);
      }
      __syncwarp();
      if (lane == 0) store_release(a.flags + cta, 1);
    }
  }
  if (carried) {
    // row r0: the tails of the warps before this one that hold its run, then
    // this warp's head; when the run began in an earlier CTA that sum waits
    // in the head row for the earlier CTAs' parts
    const int w0 = first_tail(s_slice, s_tail, warp, sl.r0);
    const bool own_head = sl.k0 < sl.k1 && a.ids[sl.k0] == sl.r0;
    const bool wait = cross && warp == owner;
    if (wait && lane == 0) s_intra = w0 < warp || own_head;
    if (!wait || w0 < warp) {  // (a lone head is in place already)
      float* head = head_row(a, cta, warp);
      for (int c0 = 0; c0 < a.D; c0 += C::CHUNK) {
        const int col = c0 + lane * C::WIDTH;
        if (col >= a.D) continue;
        C acc;
        acc.zero();
        for (int v = w0; v < warp; ++v)
          if (s_tail[v]) acc.add_l2(tail_row(a, cta, v) + col);
        if (own_head) acc.add_l2(head + col);
        acc.store(wait ? head + col : a.out + static_cast<long long>(sl.r0) * a.D + col);
      }
    }
  }
  if (cross) {
    // row R0's run began in an earlier CTA: warp 0 finds that CTA by a search
    // of the ids, the 8 warps add the CTAs' parts in 8 fixed ranges (the lanes
    // wait on a range's flags together), and the owner adds those sums in
    // order, then its own
    if (warp == 0) {
      const int start =
          warp_search<32, 2>(0, first.k0, lane, FULL, [&](int j) { return __ldg(a.ids + j) < first.r0; });
      if (lane == 0) s_first = cta_of(start + static_cast<long long>(first.r0), W, a.G);
    }
    __syncthreads();
    const int c_first = s_first, parts = cta - c_first;
    const int p0 = c_first + warp * parts / ROWS_WARPS, p1 = c_first + (warp + 1) * parts / ROWS_WARPS;
    for (int p = p0 + lane; p < p1; p += 32) {
      wait_flag(a.flags + p);
      a.flags[p] = 0;  // read once: 0 again for the next launch
    }
    __syncwarp();
    for (int c0 = 0; c0 < a.D; c0 += C::CHUNK) {
      const int col = c0 + lane * C::WIDTH;
      if (col < a.D && p1 > p0) {
        C acc;
        acc.zero();
        int p = p0;
        for (; p + ROWS_UNROLL <= p1; p += ROWS_UNROLL) {  // ROWS_UNROLL parts in flight, added in order
          C v[ROWS_UNROLL];
#pragma unroll
          for (int u = 0; u < ROWS_UNROLL; ++u) v[u].load_l2(part_row(a, p + u) + col);
#pragma unroll
          for (int u = 0; u < ROWS_UNROLL; ++u) acc.add(v[u]);
        }
        for (; p < p1; ++p) acc.add_l2(part_row(a, p) + col);
        acc.store(&s_sum[warp][lane * C::WIDTH]);
      }
      __syncthreads();
      if (warp == owner && col < a.D) {
        C acc;
        acc.zero();
        for (int v = 0; v < ROWS_WARPS; ++v)
          if ((v + 1) * parts / ROWS_WARPS > v * parts / ROWS_WARPS) acc.add_shared(&s_sum[v][lane * C::WIDTH]);
        if (s_intra) acc.add_l2(head_row(a, cta, owner) + col);
        acc.store(a.out + static_cast<long long>(first.r0) * a.D + col);
      }
      __syncthreads();
    }
  }
  // last, the rows no slot names: their stores hold up no other CTA
  if (a.zero_rows) zero_gaps<VEC>(a, sl, carried, lane);
}

// A cooperative launch: the card either makes every CTA of the grid resident
// at once, which a CTA waiting on an earlier one's flag relies on, or refuses
// the launch (cudaErrorCooperativeLaunchTooLarge) — never a grid that only
// progresses while its CTAs happen to be dispatched in order beside other
// streams' work. ops/seg_scan.py:_rows_plan sizes the grid to ROWS_CTAS_PER_SM
// CTAs an SM.
template <bool VEC>
cudaError_t launch_rows(const RowsArgs& a, cudaStream_t stream) {
  RowsArgs args = a;
  void* params[] = {&args};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(run_collapse_rows_kernel<VEC>), dim3(a.G),
                                     dim3(ROWS_THREADS), params, 0, stream);
}

}  // namespace

// ids: [n] int32 sorted ascending; perm: [n] int64, slot s's row of dy; dy:
// [n', D] f32 contiguous; out: [N, D] f32 contiguous (zero-filled by the caller
// when zero_rows == 0; otherwise every row is written here). scratch: (2 * 8 +
// 1) * grid * D floats; flags: grid ints, all 0 (and left 0). grid: CTAs, at
// most n + N and as many as the card holds at once (ops/seg_scan.py:_rows_plan;
// the cooperative launch refuses more).
// vec != 0 takes 16-byte vectors (D % 4 == 0; dy, out and scratch 16-byte
// aligned). Returns the launch's cudaError_t.
extern "C" int run_collapse_rows(const void* ids, const void* perm, const void* dy, void* out, void* scratch,
                                 void* flags, long long n, int D, int N, int grid, int vec, int zero_rows,
                                 void* stream) {
  if (n <= 0 || D <= 0 || N <= 0) return 0;
  if (n >= (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);  // slots are int32 indices, with room
  // every CTA's share holds an item, so every CTA a run crosses holds part of it
  if (grid < 1 || grid > n + N || scratch == nullptr || flags == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && (D % 4 != 0 || reinterpret_cast<uintptr_t>(dy) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(scratch) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const RowsArgs a{static_cast<const int*>(ids), static_cast<const long long*>(perm), static_cast<const float*>(dy),
                   static_cast<float*>(out), static_cast<float*>(scratch), static_cast<int*>(flags),
                   static_cast<int>(n), D, N, grid, zero_rows};
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(vec ? launch_rows<true>(a, s) : launch_rows<false>(a, s));
}
