// The grouped expert GEMM of a mixture-of-experts layer, hand-written for
// Hopper (sm_90a): every expert's product over the token rows routed to it,
// in one launch for gate/up and one for down.
//
// Replaces no TPU kernel: the JAX package has no mixture of experts. Looped
// over its experts, a routed layer of Moonlight-16B-A3B would take 64 x 3
// library calls (3,328 launches a batch of 26 layers, paced by the host).
//
// Layout (ops/expert_gemm.dispatch): expert e owns the sorted slots
// offsets[e]:offsets[e + 1], cut into BM-row tiles; tiles[e] counts the
// tiles of the experts before e, tiles[E] all of them. A CTA's index gives
// its row tile m (expert-major: the CTAs in flight share one expert's weights
// in L2) and its column tile n; the grid is sized by the wrapper for the most
// tiles any routing can give, and CTAs past tiles[E] exit, so empty and
// uneven groups need no host knowledge.
//
// - expert_gemm_swiglu: h[r] = silu(x[src[r]] . Wg[e]^T) * (x[src[r]] . Wu[e]^T)
//   for the sorted slots r of expert e. The A rows are read straight from the
//   token rows through src (no gathered copy); the gate and up tiles of the
//   same 128 columns lie side by side as one 256-wide B operand, so one
//   accumulator holds both and SwiGLU runs on the f32 sums in registers.
// - expert_gemm_down: y[dst[r]] = h[r] . Wd[e]^T, written to the slot's
//   place in token order (token . k + j) for the weighted combine.
//
// What bounds it on this card: at Moonlight's widths (D 2,048, I 1,408) and
// ~1,536 slots an expert the products do ~600 FLOP a byte of device memory,
// above the H100's 295, so the tensor cores (989 TFLOP/s dense bf16). The
// only path to that rate is wgmma; its operands come from shared memory in
// the 128-byte swizzled K-major layout. TMA cannot gather the A rows through
// src, so every thread fills the stages with 16-byte cp.async copies into
// that swizzled layout (zero-filled past the expert's rows, the columns and
// K), a ring of STAGES stages of BK = 64, two k-steps of loads in flight
// while the tensor cores run. Each of the two warpgroups owns 64 rows of the
// 128-row tile and issues m64n256k16 wgmma over all 256 columns; a stage is
// refilled only after every warpgroup's wgmma that read it has retired (one
// group kept in flight, the barrier at the top of the next step). A k-step
// streams 48 KB of operands from L2 into each SM for 4.2 MFLOP, so L2's
// bandwidth, not the tensor cores, sets this tile's pace near 60% of the
// peak; larger tiles would need operands shared across a cluster. A
// persistent grid (one CTA an SM running its ring on across tiles) measured
// 3-10% slower on an H100 than this one-tile-a-CTA grid.
//
// bf16 operands, f32 accumulation, each result rounded once to bf16. Every
// row is a multiple of 16 bytes (K % 8 == 0) and every base 16-byte aligned:
// the entries refuse anything else.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;      // rows of a tile: two warpgroups of 64
constexpr int BN = 256;      // columns of the wgmma: 128 gate + 128 up, or 256 of y
constexpr int BK = 64;       // one 128-byte swizzle row of bf16
constexpr int STAGES = 4;    // the ring; STAGES - 2 tiles of loads ahead of the wgmma
constexpr int THREADS = 256;
constexpr int A_BYTES = BM * BK * 2;                   // 16 KB
constexpr int B_BYTES = BN * BK * 2;                   // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;         // multiples of the 1 KB swizzle atom
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + slack to align the ring to 1 KB
constexpr int SWIGLU_COLS = BN / 2;                    // columns of h a swiglu tile writes

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !ok (then src is only a valid address)
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// this thread's shared-memory writes are seen by the async proxy (wgmma)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// a K-major operand in the 128-byte swizzle: 8-row groups 1,024 bytes apart
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across a wgmma
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 256] += A[64 x 16] . B[256 x 16]^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),
        "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]),
        "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

struct Tile {
  bool live;
  int e, n, row0, row_end;
};

// row tile m = pid / n_tiles of expert e: the last expert whose first tile
// is at or before m (an empty expert shares its start with the next one,
// and the next one wins)
__device__ __forceinline__ Tile tile_of(int pid, int n_tiles, const int* tiles, const int* offs, int E) {
  const int m = pid / n_tiles;
  Tile t;
  t.n = pid % n_tiles;
  t.live = m < tiles[E];
  int lo = 0, hi = E - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tiles[mid] <= m) lo = mid;
    else hi = mid - 1;
  }
  t.e = lo;
  t.row0 = offs[lo] + (m - tiles[lo]) * BM;
  t.row_end = offs[lo + 1];
  return t;
}

// One tile: acc[64 x 256] of this thread's warpgroup over K. The A rows of
// the tile come from a_rows[j] (rows rb + 32 j), the B rows from b_rows[j]
// (rows rb + 32 j of the 256), each with its validity; thread tid copies
// 16-byte chunk tid % 8 of its rows, at its swizzled place.
__device__ __forceinline__ void mainloop(float* acc, const bf16* const* a_rows, const bool* a_ok,
                                         const bf16* const* b_rows, const bool* b_ok, int K, uint32_t ring) {
  const int tid = threadIdx.x, c = tid & 7, rb = tid >> 3, wg = tid >> 7;
  const uint32_t at = rb * 128 + ((c ^ (rb & 7)) << 4);  // rows rb + 32 j lie 4,096 bytes apart
  const int KT = (K + BK - 1) / BK;
  auto load = [&](int kt) {
    const int k0 = kt * BK + c * 8;
    const bool kok = k0 < K;
    const int koff = kok ? k0 : 0;
    const uint32_t s = ring + (kt % STAGES) * STAGE_BYTES + at;
#pragma unroll
    for (int j = 0; j < 4; ++j) cp16(s + j * 4096, a_rows[j] + koff, a_ok[j] && kok);
#pragma unroll
    for (int j = 0; j < 8; ++j) cp16(s + A_BYTES + j * 4096, b_rows[j] + koff, b_ok[j] && kok);
  };
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < KT) load(s);
    cp_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_wait<STAGES - 3>();  // this thread's copies of tile kt have landed
    fence_async_shared();
    __syncthreads();  // everyone's have; every wgmma of tile kt - 2 has retired
    const uint32_t a = ring + (kt % STAGES) * STAGE_BYTES + wg * (64 * 128);
    const uint32_t b = ring + (kt % STAGES) * STAGE_BYTES + A_BYTES;
    wgmma_fence();
    fence_acc(acc);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_m64n256k16(acc, desc(a + kk * 32), desc(b + kk * 32));
    wgmma_commit();
    fence_acc(acc);
    if (kt + STAGES - 2 < KT) load(kt + STAGES - 2);  // into the stage of tile kt - 2
    cp_commit();
    wgmma_wait<1>();
    fence_acc(acc);
  }
  wgmma_wait<0>();
  fence_acc(acc);
}

// accumulator element i of this thread: row (within the warpgroup's 64) and column
__device__ __forceinline__ int acc_row(int i) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  return warp * 16 + (lane >> 2) + ((i & 2) ? 8 : 0);
}

__device__ __forceinline__ int acc_col(int i) { return (i >> 2) * 8 + (threadIdx.x & 3) * 2 + (i & 1); }

__global__ void __launch_bounds__(THREADS, 1)
    expert_gemm_swiglu_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg, const bf16* __restrict__ wu,
                              bf16* __restrict__ h, const int* __restrict__ src, const int* __restrict__ offs,
                              const int* __restrict__ tiles, int E, int D, int I, int n_tiles) {
  const Tile t = tile_of(blockIdx.x, n_tiles, tiles, offs, E);
  if (!t.live) return;
  extern __shared__ uint8_t smem[];
  const uint32_t ring = (smem_addr(smem) + 1023) & ~1023u;
  const int rb = threadIdx.x >> 3;
  const bf16* a_rows[4];
  bool a_ok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = t.row0 + rb + 32 * j;
    a_ok[j] = row < t.row_end;
    a_rows[j] = x + (a_ok[j] ? static_cast<long long>(src[row]) : 0LL) * D;
  }
  const bf16* b_rows[8];
  bool b_ok[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int r = rb + 32 * j;  // 0-127 gate, 128-255 up
    const int col = t.n * SWIGLU_COLS + (r & (SWIGLU_COLS - 1));
    b_ok[j] = col < I;
    b_rows[j] = (j < 4 ? wg : wu) + (static_cast<long long>(t.e) * I + (b_ok[j] ? col : 0)) * D;
  }
  float acc[128];
  mainloop(acc, a_rows, a_ok, b_rows, b_ok, D, ring);
  const int base = t.row0 + (threadIdx.x >> 7) * 64;
#pragma unroll
  for (int i = 0; i < 64; i += 2) {  // the gate half; its up partner is 64 elements on
    const int row = base + acc_row(i), col = t.n * SWIGLU_COLS + acc_col(i);
    if (row < t.row_end && col < I) {
      const float g0 = acc[i], g1 = acc[i + 1], u0 = acc[i + 64], u1 = acc[i + 65];
      const float h0 = g0 / (1.0f + __expf(-g0)) * u0, h1 = g1 / (1.0f + __expf(-g1)) * u1;
      *reinterpret_cast<__nv_bfloat162*>(h + static_cast<long long>(row) * I + col) = __floats2bfloat162_rn(h0, h1);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    expert_gemm_down_kernel(const bf16* __restrict__ hrows, const bf16* __restrict__ wd, bf16* __restrict__ y,
                            const int* __restrict__ dst, const int* __restrict__ offs, const int* __restrict__ tiles,
                            int E, int I, int D, int n_tiles) {
  const Tile t = tile_of(blockIdx.x, n_tiles, tiles, offs, E);
  if (!t.live) return;
  extern __shared__ uint8_t smem[];
  const uint32_t ring = (smem_addr(smem) + 1023) & ~1023u;
  const int rb = threadIdx.x >> 3;
  const bf16* a_rows[4];
  bool a_ok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = t.row0 + rb + 32 * j;
    a_ok[j] = row < t.row_end;
    a_rows[j] = hrows + (a_ok[j] ? static_cast<long long>(row) : 0LL) * I;
  }
  const bf16* b_rows[8];
  bool b_ok[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = t.n * BN + rb + 32 * j;
    b_ok[j] = col < D;
    b_rows[j] = wd + (static_cast<long long>(t.e) * D + (b_ok[j] ? col : 0)) * I;
  }
  float acc[128];
  mainloop(acc, a_rows, a_ok, b_rows, b_ok, I, ring);
  const int base = t.row0 + (threadIdx.x >> 7) * 64;
#pragma unroll
  for (int i = 0; i < 128; i += 2) {
    const int row = base + acc_row(i), col = t.n * BN + acc_col(i);
    if (row < t.row_end && col < D) {
      *reinterpret_cast<__nv_bfloat162*>(y + static_cast<long long>(dst[row]) * D + col) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// h [S, I] of x [T, D], wg and wu [E, I, D] over the dispatch (src [S],
// offsets [E + 1], tiles [E + 1]); max_tiles: the most row tiles any routing
// of the S slots can give (the grid's rows)
extern "C" int expert_gemm_swiglu(const void* x, const void* wg, const void* wu, void* h, const void* src,
                                  const void* offs, const void* tiles, int E, int D, int I, int max_tiles,
                                  void* stream) {
  if (max_tiles <= 0) return 0;
  if (E <= 0 || D <= 0 || I <= 0 || D % 8 || I % 8 || !aligned16(x) || !aligned16(wg) || !aligned16(wu) ||
      !aligned16(h))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(expert_gemm_swiglu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (I + SWIGLU_COLS - 1) / SWIGLU_COLS;
  expert_gemm_swiglu_kernel<<<max_tiles * n_tiles, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wg), static_cast<const bf16*>(wu), static_cast<bf16*>(h),
      static_cast<const int*>(src), static_cast<const int*>(offs), static_cast<const int*>(tiles), E, D, I, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// y [S, D] in slot order of h [S, I] (sorted slots) and wd [E, D, I] over
// the dispatch (dst [S], offsets [E + 1], tiles [E + 1])
extern "C" int expert_gemm_down(const void* h, const void* wd, void* y, const void* dst, const void* offs,
                                const void* tiles, int E, int I, int D, int max_tiles, void* stream) {
  if (max_tiles <= 0) return 0;
  if (E <= 0 || D <= 0 || I <= 0 || D % 8 || I % 8 || !aligned16(h) || !aligned16(wd) || !aligned16(y))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(expert_gemm_down_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (D + BN - 1) / BN;
  expert_gemm_down_kernel<<<max_tiles * n_tiles, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(wd), static_cast<bf16*>(y), static_cast<const int*>(dst),
      static_cast<const int*>(offs), static_cast<const int*>(tiles), E, I, D, n_tiles);
  return static_cast<int>(cudaGetLastError());
}
