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
// What bounds it on this card: memory. Each element is read once and written
// once, (1 + k) * 4 bytes each way, as in the Pallas kernel. What the design
// does about the card: a row does not fit in one block's shared memory (SANN:
// W = 20,000 slots, ids plus k = 2 value arrays = 240 KB against the block's
// 227 KB), so one CTA walks its row in CHUNK-slot chunks and carries the
// partial sums of the run still open at a chunk's end into the next chunk. A
// prefix sum followed by a difference at run ends would be simpler but loses
// ~2e-3 absolute in f32 once prefixes reach ~2e4, against run totals of ~1.
// Loads and stores go through shared memory so that global accesses coalesce;
// each thread scans ITEMS consecutive slots in registers, a warp-shuffle scan
// joins the threads of a warp, and a short serial pass joins the warps.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;
constexpr int CHUNK = THREADS * ITEMS;  // 2,048 slots per chunk
constexpr int WARPS = THREADS / 32;
constexpr int PAD_ID = 0x7fffffff;  // int32 max: sorts after every real id
constexpr unsigned FULL = 0xffffffffu;

template <int K>
__global__ void __launch_bounds__(THREADS) run_collapse_kernel(
    const int* __restrict__ ids, const float* __restrict__ v0,
    const float* __restrict__ v1, const float* __restrict__ v2,
    int* __restrict__ out_ids, float* __restrict__ o0, float* __restrict__ o1,
    float* __restrict__ o2, int W) {
  // s_ids[0] is the slot before the chunk, s_ids[1 + i] slot i of the chunk,
  // s_ids[CHUNK + 1] the slot after it (run-start and run-end tests read both)
  __shared__ int s_ids[CHUNK + 2];
  __shared__ float s_v[K][CHUNK];
  __shared__ int s_wflag[WARPS];
  __shared__ float s_wsum[K][WARPS];
  __shared__ float s_carry[K];

  const float* vin[3] = {v0, v1, v2};
  float* vout[3] = {o0, o1, o2};
  const long long row = static_cast<long long>(blockIdx.x) * W;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int i0 = tid * ITEMS;

  if (tid < K) s_carry[tid] = 0.f;

  for (int base = 0; base < W; base += CHUNK) {
    const int n = min(CHUNK, W - base);
    for (int i = tid; i < CHUNK; i += THREADS) {
      const bool in = i < n;
      s_ids[1 + i] = in ? ids[row + base + i] : PAD_ID;
#pragma unroll
      for (int j = 0; j < K; ++j) s_v[j][i] = in ? vin[j][row + base + i] : 0.f;
    }
    if (tid == 0) s_ids[0] = base > 0 ? ids[row + base - 1] : PAD_ID;
    if (tid == THREADS - 1)
      s_ids[CHUNK + 1] = base + CHUNK < W ? ids[row + base + CHUNK] : PAD_ID;
    __syncthreads();

    // this thread's ITEMS slots: run-start flags and the segmented aggregate
    int id[ITEMS];
    bool head[ITEMS];
    float v[K][ITEMS];
    int flag = 0;
    float agg[K];
#pragma unroll
    for (int j = 0; j < K; ++j) agg[j] = 0.f;
#pragma unroll
    for (int t = 0; t < ITEMS; ++t) {
      id[t] = s_ids[1 + i0 + t];
      head[t] = (base + i0 + t == 0) || id[t] != s_ids[i0 + t];
      flag |= head[t];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        v[j][t] = s_v[j][i0 + t];
        agg[j] = head[t] ? v[j][t] : agg[j] + v[j][t];
      }
    }

    // inclusive segmented scan across the warp: (fa, a) then (fb, b) is
    // (fa | fb, fb ? b : a + b)
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
    // exclusive within the warp
    int ex_flag = __shfl_up_sync(FULL, flag, 1);
    float ex[K];
#pragma unroll
    for (int j = 0; j < K; ++j) ex[j] = __shfl_up_sync(FULL, agg[j], 1);
    if (lane == 0) {
      ex_flag = 0;
#pragma unroll
      for (int j = 0; j < K; ++j) ex[j] = 0.f;
    }
    __syncthreads();

    // the prefix before this thread's first slot: the carried open run, then
    // the warps before this one, then the lanes before this one
    float run[K];
#pragma unroll
    for (int j = 0; j < K; ++j) run[j] = s_carry[j];
    for (int u = 0; u < warp; ++u) {
#pragma unroll
      for (int j = 0; j < K; ++j)
        run[j] = s_wflag[u] ? s_wsum[j][u] : run[j] + s_wsum[j][u];
    }
#pragma unroll
    for (int j = 0; j < K; ++j) run[j] = ex_flag ? ex[j] : run[j] + ex[j];

    int out_id[ITEMS];
    float out_v[K][ITEMS];
#pragma unroll
    for (int t = 0; t < ITEMS; ++t) {
      const bool last =
          (base + i0 + t == W - 1) || id[t] != s_ids[2 + i0 + t];
      const bool keep = last && id[t] != PAD_ID;
      out_id[t] = keep ? id[t] : PAD_ID;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        run[j] = head[t] ? v[j][t] : run[j] + v[j][t];
        out_v[j][t] = keep ? run[j] : 0.f;
      }
    }
    __syncthreads();  // every read of s_ids, s_v and s_carry is done

    if (tid == THREADS - 1) {  // owns the chunk's last slot: carry its run
#pragma unroll
      for (int j = 0; j < K; ++j) s_carry[j] = run[j];
    }
#pragma unroll
    for (int t = 0; t < ITEMS; ++t) {
      s_ids[1 + i0 + t] = out_id[t];
#pragma unroll
      for (int j = 0; j < K; ++j) s_v[j][i0 + t] = out_v[j][t];
    }
    __syncthreads();
    for (int i = tid; i < n; i += THREADS) {
      out_ids[row + base + i] = s_ids[1 + i];
#pragma unroll
      for (int j = 0; j < K; ++j) vout[j][row + base + i] = s_v[j][i];
    }
    __syncthreads();  // the next chunk's loads overwrite shared memory
  }
}

}  // namespace

// ids/values/outputs: [Q, W] contiguous on the device; k in {1, 2, 3} value
// arrays (unused pointers may be null). Returns the launch's cudaError_t.
extern "C" int run_collapse_sorted(const void* ids, const void* v0,
                                   const void* v1, const void* v2,
                                   void* out_ids, void* o0, void* o1, void* o2,
                                   int Q, int W, int k, void* stream) {
  if (Q <= 0 || W <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto i = static_cast<const int*>(ids);
  auto a = static_cast<const float*>(v0);
  auto b = static_cast<const float*>(v1);
  auto c = static_cast<const float*>(v2);
  auto oi = static_cast<int*>(out_ids);
  auto x = static_cast<float*>(o0);
  auto y = static_cast<float*>(o1);
  auto z = static_cast<float*>(o2);
  switch (k) {
    case 1: run_collapse_kernel<1><<<Q, THREADS, 0, s>>>(i, a, b, c, oi, x, y, z, W); break;
    case 2: run_collapse_kernel<2><<<Q, THREADS, 0, s>>>(i, a, b, c, oi, x, y, z, W); break;
    case 3: run_collapse_kernel<3><<<Q, THREADS, 0, s>>>(i, a, b, c, oi, x, y, z, W); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
