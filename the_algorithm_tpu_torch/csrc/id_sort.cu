// Stable sort of int32 id rows carrying float32 value arrays, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package sorts each row of the dedup with one
// multi-operand lax.sort (the_algorithm_tpu/ops/retrieval.py:89), which it
// leaves to XLA. The port first ran torch.sort(stable=True), a global
// segmented radix sort whose passes each stream the keys and an int64 order
// through device memory, then gathered every value array through that order
// (take_along_dim, with its own int64 index wrap): at SANN's [1,024, 20,000]
// with two value arrays, half the batch's device time (PERF.md §5). This
// kernel is the same function in one launch (ops/id_sort.py).
//
// Semantics, per row of W slots: the ids in ascending int32 order, equal ids
// in slot order (stable), and each value array's 32-bit words carried with
// their ids unchanged (-0.0 and NaN payloads included): bit for bit what
// torch.sort(stable=True) followed by take_along_dim gives.
//
// What bounds it on this card: memory. Each slot's id and values are read
// once and written once, (1 + k) * 4 bytes each way: at SANN 491.5 MB a
// batch, 0.147 ms at 3.35 TB/s. Everything between the read and the write
// stays on the SM, so the sort's own work on the SM is what the design cuts.
//
// What the design does about it. One CTA sorts one row in shared memory: up
// to W_MAX = 20,480 slots as (key, slot) pairs of 6 bytes, beside a second
// row-sized buffer for the values. The key is the id with its sign bit
// flipped, so that unsigned order is int32 order; the slot is the id's place
// in the row, 16 bits. A stable LSD radix sort takes the key 8 bits a pass.
// Each thread holds IPT pairs in registers: item i of warp w, lane l sits at
// place w * 32 * IPT + 32 * i + l, so a warp's items are consecutive places
// and, in (i, l) order, in the row's current order. A pass ranks each item
// among its warp's items of the same digit (the lanes that share it found
// with eight ballots, each testing one key bit; one 16-bit counter a digit
// and warp), scans the counters in (digit, warp) order, and scatters each
// pair to its digit's base for its warp plus its rank: stable by
// construction. Passes that cannot change the order are skipped: a digit
// that every id of the row shares, and the digits above the highest one in
// which the ids other than PAD_ID differ, when no such id ties PAD_ID (all
// ones) below them: SANN's ids below 2^21 take three passes.
//
// The values never wait on device memory in the sort's path: the first value
// row streams into the second buffer (cp.async) while the row sorts, the
// others into L2; then the sorted ids leave, and each value row leaves
// through the sorted slots while the next one streams into the buffer the
// last one freed. Loads and stores are coalesced, 16 bytes a thread where
// every row start is 16-byte aligned. The places beyond W hold padding keys
// 0xffffffff, which sort after every id, so the first W places hold the row.
// A row is one CTA of up to 1,024 threads. The grid is persistent, as many
// CTAs as the card holds at once, each walking its rows: the next row's ids
// go to L2 while a row sorts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_VALUES = 4;
constexpr int RADIX_BITS = 8;
constexpr int DIGITS = 1 << RADIX_BITS;
constexpr int PASSES = 32 / RADIX_BITS;
constexpr int TOTALS = 40;  // 32 warp totals, then the row's five reductions
constexpr int SMEM_PER_BLOCK = 232448;  // 227 KB: the most a block can opt in to
constexpr uint32_t SIGN = 0x80000000u;  // flipped, int32 order becomes uint32 order
constexpr uint32_t PAD_KEY = 0xffffffffu;  // PAD_ID's key, and that of every place beyond the row
constexpr unsigned FULL = 0xffffffffu;

struct Arrays {
  const int* ids;
  const uint32_t* v[MAX_VALUES];  // float32 words, carried unchanged
  int* out_ids;
  uint32_t* o[MAX_VALUES];
};

// bytes of dynamic shared memory for `threads` threads of `ipt` places: keys,
// a value row, 16-bit slots, the 16-bit counters of each digit by warp (one
// spare column), and TOTALS words
__host__ __device__ constexpr int smem_bytes(int threads, int ipt) {
  return 10 * threads * ipt + 2 * DIGITS * (threads / 32 + 1) + 4 * TOTALS;
}

__device__ __forceinline__ uint32_t digit(uint32_t key, int shift) { return (key >> shift) & (DIGITS - 1); }

// the lanes of the warp whose key has this lane's digit at `shift`: one
// ballot for each of its bits, tested in place
__device__ __forceinline__ uint32_t peers_of(uint32_t key, int shift) {
  uint32_t peers = FULL;
#pragma unroll
  for (int b = 0; b < RADIX_BITS; ++b) {
    uint32_t same;
    asm("{\n .reg .pred p;\n and.b32 %0, %1, %2;\n setp.ne.u32 p, %0, 0;\n"
        " vote.ballot.sync.b32 %0, p, 0xffffffff;\n @!p not.b32 %0, %0;\n}"
        : "=r"(same)
        : "r"(key), "r"(1u << (shift + b)));
    peers &= same;
  }
  return peers;
}

__device__ __forceinline__ uint32_t half(const uint32_t* packed, int i) {
  return (packed[i / 2] >> ((i & 1) * 16)) & 0xffffu;
}

// exclusive prefix sums of the 16-bit counters in place, by every thread of
// the CTA, two counters a word: `pairs` words, and `totals` a warp's total.
// Ends on a barrier.
__device__ void exclusive_scan(uint32_t* c, int pairs, uint32_t* totals) {
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (pairs + T - 1) / T;
  const int lo = min(pairs, tid * per), hi = min(pairs, lo + per);
  uint32_t sum = 0;
  for (int j = lo; j < hi; ++j) sum += (c[j] & 0xffffu) + (c[j] >> 16);
  uint32_t inc = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t t = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) totals[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const uint32_t t = lane < (T >> 5) ? totals[lane] : 0u;
    uint32_t x = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    if (lane < (T >> 5)) totals[lane] = x - t;
  }
  __syncthreads();
  uint32_t run = totals[warp] + inc - sum;  // below 2^16: at most the row's places
  for (int j = lo; j < hi; ++j) {
    const uint32_t x = c[j], first = x & 0xffffu;
    c[j] = run | ((run + first) << 16);
    run += first + (x >> 16);
  }
  __syncthreads();
}

// a value row into shared memory by the CTA's asynchronous copies, as one
// commit group of each thread
__device__ __forceinline__ void stage_row(uint32_t* dst, const uint32_t* src, int W, bool vec) {
  if (vec) {
    for (int q = threadIdx.x; q < W / 4; q += blockDim.x)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                       static_cast<uint32_t>(__cvta_generic_to_shared(dst + 4 * q))),
                   "l"(src + 4 * q)
                   : "memory");
  } else {
    for (int p = threadIdx.x; p < W; p += blockDim.x)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                       static_cast<uint32_t>(__cvta_generic_to_shared(dst + p))),
                   "l"(src + p)
                   : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int IPT>
__global__ void __launch_bounds__(MAX_THREADS) id_sort_kernel(const Arrays a, const int Q, const int W, const int k,
                                                              const bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cap = T * IPT;
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem);
  uint32_t* stage = keys + cap;  // a value row
  uint16_t* slots = reinterpret_cast<uint16_t*>(stage + cap);
  uint16_t* count = slots + cap;
  const int stride = (T >> 5) + 1;  // digit d of warp w: count[d * stride + w]; the spare column spreads banks
  const int ncount = DIGITS * stride;
  uint32_t* totals = reinterpret_cast<uint32_t*>(count + ncount);
  // item i of this thread: place `first + 32 * i`, its slot packed two to a word
  const int first = warp * 32 * IPT + lane;
  const uint32_t below = (1u << lane) - 1u;

  for (int r = blockIdx.x; r < Q; r += gridDim.x) {
    const long long row = static_cast<long long>(r) * W;
    uint32_t key[IPT], slot2[IPT / 2], rank2[IPT / 2];
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
      const int p = first + 32 * i;
      key[i] = p < W ? static_cast<uint32_t>(a.ids[row + p]) ^ SIGN : PAD_KEY;
    }

    // which passes can change the order: the AND and the OR of every key of
    // the row, and of every key but PAD_ID's; and whether such a key has its
    // low 8, 16 or 24 bits all ones (it would tie PAD_ID there)
    uint32_t all = FULL, any = 0, all_id = FULL, any_id = 0, ones = 0;
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
      if (first + 32 * i < W) {
        all &= key[i];
        any |= key[i];
        if (key[i] != PAD_KEY) {
          all_id &= key[i];
          any_id |= key[i];
          ones |= ((key[i] & 0xffu) == 0xffu) | (((key[i] & 0xffffu) == 0xffffu) << 1) |
                  (((key[i] & 0xffffffu) == 0xffffffu) << 2);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < IPT; i += 2)
      slot2[i / 2] = static_cast<uint32_t>(first + 32 * i) | (static_cast<uint32_t>(first + 32 * (i + 1)) << 16);
    all = __reduce_and_sync(FULL, all);
    any = __reduce_or_sync(FULL, any);
    all_id = __reduce_and_sync(FULL, all_id);
    any_id = __reduce_or_sync(FULL, any_id);
    ones = __reduce_or_sync(FULL, ones);
    if (tid == 0) {
      totals[32] = FULL;
      totals[33] = 0;
      totals[34] = FULL;
      totals[35] = 0;
      totals[36] = 0;
    }
    __syncthreads();
    if (lane == 0) {
      atomicAnd(&totals[32], all);
      atomicOr(&totals[33], any);
      atomicAnd(&totals[34], all_id);
      atomicOr(&totals[35], any_id);
      atomicOr(&totals[36], ones);
    }
    __syncthreads();
    // while the row sorts: the first value row into shared memory, the others
    // and the next row's ids into L2
    stage_row(stage, a.v[0] + row, W, vec);
    const int* next = r + gridDim.x < Q ? a.ids + row + static_cast<long long>(gridDim.x) * W : nullptr;
    for (int p = 32 * tid; p < W; p += 32 * T) {
      for (int j = 1; j < k; ++j) asm volatile("prefetch.global.L2 [%0];" ::"l"(a.v[j] + row + p));
      if (next) asm volatile("prefetch.global.L2 [%0];" ::"l"(next + p));
    }
    const uint32_t varying = totals[32] ^ totals[33];  // the bits in which two keys of the row differ
    int last = PASSES - 1;
    {
      const uint32_t varying_id = totals[34] ^ totals[35];
      int top = -1;  // the highest digit in which two ids other than PAD_ID differ
      for (int pass = 0; pass < PASSES; ++pass)
        if (digit(varying_id, pass * RADIX_BITS) != 0) top = pass;
      if (top >= 0 && top < PASSES - 1 && !((totals[36] >> top) & 1u)) last = top;
    }

    bool in_smem = false;  // the pairs sit in shared memory in row order (else in registers, in place)
    for (int pass = 0; pass <= last; ++pass) {
      const int shift = pass * RADIX_BITS;
      if (digit(varying, shift) == 0) continue;  // one digit for the whole row: the pass keeps the order
      if (in_smem) {
#pragma unroll
        for (int i = 0; i < IPT; i += 2) {
          const int p = first + 32 * i;
          key[i] = keys[p];
          key[i + 1] = keys[p + 32];
          slot2[i / 2] = static_cast<uint32_t>(slots[p]) | (static_cast<uint32_t>(slots[p + 32]) << 16);
        }
      }
      for (int j = tid; j < ncount; j += T) count[j] = 0;
      __syncthreads();  // also: every thread has read the pairs that the scatter below overwrites
      // each item's rank among the earlier items of its warp with its digit;
      // the last lane of a digit moves the warp's counter past them all
#pragma unroll
      for (int i = 0; i < IPT; ++i) {
        const uint32_t peers = peers_of(key[i], shift);
        uint16_t* c = &count[digit(key[i], shift) * stride + warp];
        const uint32_t rank = *c + __popc(peers & below);
        __syncwarp();
        if ((peers >> lane) == 1u) *c = static_cast<uint16_t>(rank + 1);  // the last lane of the digit
        __syncwarp();
        rank2[i / 2] = (i & 1) ? (rank2[i / 2] | (rank << 16)) : rank;
      }
      __syncthreads();
      exclusive_scan(reinterpret_cast<uint32_t*>(count), ncount / 2, totals);
#pragma unroll
      for (int i = 0; i < IPT; ++i) {
        const uint32_t dst = count[digit(key[i], shift) * stride + warp] + half(rank2, i);
        keys[dst] = key[i];
        slots[dst] = static_cast<uint16_t>(half(slot2, i));
      }
      __syncthreads();
      in_smem = true;
    }
    if (!in_smem) {  // every pass skipped: one id fills the row
#pragma unroll
      for (int i = 0; i < IPT; ++i) {
        const int p = first + 32 * i;
        keys[p] = key[i];
        slots[p] = static_cast<uint16_t>(half(slot2, i));
      }
      __syncthreads();
    }

    if (vec) {
      for (int q = tid; q < W / 4; q += T) {
        uint4 x = reinterpret_cast<const uint4*>(keys)[q];
        x.x ^= SIGN;
        x.y ^= SIGN;
        x.z ^= SIGN;
        x.w ^= SIGN;
        reinterpret_cast<uint4*>(a.out_ids + row)[q] = x;
      }
    } else {
      for (int p = tid; p < W; p += T) a.out_ids[row + p] = static_cast<int>(keys[p] ^ SIGN);
    }
    // value row j sits in `stage` (j even) or `keys` (j odd)
    for (int j = 0; j < k; ++j) {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      __syncthreads();  // row j is in, and every thread is done with the buffer row j + 1 goes to
      const uint32_t* in = (j & 1) ? keys : stage;
      if (j + 1 < k) stage_row((j & 1) ? stage : keys, a.v[j + 1] + row, W, vec);
      uint32_t* out = a.o[j] + row;
      if (vec) {
        for (int q = tid; q < W / 4; q += T) {
          const uint2 s = reinterpret_cast<const uint2*>(slots)[q];
          reinterpret_cast<uint4*>(out)[q] =
              make_uint4(in[s.x & 0xffffu], in[s.x >> 16], in[s.y & 0xffffu], in[s.y >> 16]);
        }
      } else {
        for (int p = tid; p < W; p += T) out[p] = in[slots[p]];
      }
    }
    __syncthreads();  // the next row takes every buffer
  }
}

// opts a kernel in to `smem` bytes of dynamic shared memory, once for each
// device and size: a launch above 48 KB is refused without it
template <int IPT>
cudaError_t opt_in(int smem) {
  static int opted_in[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && opted_in[dev] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(id_sort_kernel<IPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < 64) opted_in[dev] = smem;
  return err;
}

// The persistent grid: as many CTAs as the card holds at once, no more than
// there are rows, each with ceil(Q / G) or one row fewer. Cached for the last
// device and shape asked; the kernel is right for any grid, so a value raced
// by another host thread only changes its speed.
template <int IPT>
cudaError_t launch(const Arrays& a, int Q, int W, int k, int threads, int smem, bool vec, cudaStream_t s) {
  cudaError_t err = opt_in<IPT>(smem);
  if (err != cudaSuccess) return err;
  static int cached[3] = {-1, 0, 0};  // device, threads, smem -> CTAs resident
  static int resident = 0;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (cached[0] != dev || cached[1] != threads || cached[2] != smem) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, id_sort_kernel<IPT>, threads, smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident = per_sm * sms;
    cached[0] = dev, cached[1] = threads, cached[2] = smem;
  }
  const int per = (Q + resident - 1) / resident;  // rows a CTA takes, at most
  id_sort_kernel<IPT><<<(Q + per - 1) / per, threads, smem, s>>>(a, Q, W, k, vec);
  return cudaGetLastError();
}

}  // namespace

// ids [Q, W] int32 and k (1 to 4) float32 value arrays [Q, W], all contiguous;
// outputs of the same shapes. One CTA of `threads` threads (a multiple of 32,
// at most 1,024) holding `ipt` places each (4 to 20, a multiple of 4) a row;
// `smem` is smem_bytes(threads, ipt). ops/id_sort.py:_plan sizes it.
extern "C" int sort_by_id(const void* ids, const void* v0, const void* v1, const void* v2, const void* v3,
                          void* out_ids, void* o0, void* o1, void* o2, void* o3, int Q, int W, int k, int ipt,
                          int threads, int smem, void* stream) {
  if (Q <= 0 || W <= 0) return 0;
  const bool ok = k >= 1 && k <= MAX_VALUES && threads >= 32 && threads <= MAX_THREADS && threads % 32 == 0 &&
                  ipt >= 4 && ipt <= 20 && ipt % 4 == 0 && threads * ipt >= W && smem == smem_bytes(threads, ipt) &&
                  smem <= SMEM_PER_BLOCK;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Arrays a{static_cast<const int*>(ids),
                 {static_cast<const uint32_t*>(v0), static_cast<const uint32_t*>(v1),
                  static_cast<const uint32_t*>(v2), static_cast<const uint32_t*>(v3)},
                 static_cast<int*>(out_ids),
                 {static_cast<uint32_t*>(o0), static_cast<uint32_t*>(o1), static_cast<uint32_t*>(o2),
                  static_cast<uint32_t*>(o3)}};
  // 16-byte copies where every row start is 16-byte aligned
  bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(out_ids) % 16 == 0;
  for (int j = 0; j < k; ++j)
    vec = vec && reinterpret_cast<uintptr_t>(a.v[j]) % 16 == 0 && reinterpret_cast<uintptr_t>(a.o[j]) % 16 == 0;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (ipt == 4) err = launch<4>(a, Q, W, k, threads, smem, vec, s);
  if (ipt == 8) err = launch<8>(a, Q, W, k, threads, smem, vec, s);
  if (ipt == 12) err = launch<12>(a, Q, W, k, threads, smem, vec, s);
  if (ipt == 16) err = launch<16>(a, Q, W, k, threads, smem, vec, s);
  if (ipt == 20) err = launch<20>(a, Q, W, k, threads, smem, vec, s);
  return static_cast<int>(err);
}
