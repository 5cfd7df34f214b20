// householder_gemm: y = R(x) · W with R = blockwise I − 2ûûᵀ, for sm_90a.
//
// Replaces the TPU kernel householder_gemm_pallas
// (src/repro/kernels/householder_gemm.py:51, pallas_call at :73): the
// ETHER forward of every adapted linear in activation mode.
// x: (M, K) bf16 or f32, W: (K, N) same dtype, u: (n, db) f32 raw
// hyperplanes with n·db = K; y: (M, N) in x's dtype.
// û = u / (‖u‖ + 1e-8) with ε outside the square root.  Like the TPU
// kernel it never writes the reflected x or a reflected W to device
// memory, and it rounds y once, from f32.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense, the
// data sheet's rates at 700 W):
//  * decode (M = batch, 2 or 4) reads W once: qwen2.5-32b's gate/up,
//    5120×27648 bf16 = 283 MB, is 0.085 ms of memory time; smollm-360m's
//    gate, 960×2560 = 4.9 MB, 1.5 µs.  Bytes bound.
//  * prefill: qwen2.5-32b's gate/up at M = 4,096 (B 2 × P 2,048) is 1.16
//    TFLOP, 1.17 ms on the bf16 tensor cores.  Operations bound.
//
// Routes, chosen on the host (kernels/householder_gemm.py, `route`) from
// the dtype, M, the widths, n and the alignment.  Every call makes two
// launches: the projection prologue of reflect_common.cuh (P[t, i] =
// x_t,i · û_i into an (M, n) f32 scratch, and the block norms), then the
// GEMM.  Only the GEMM reads W, once.
//
// 1. wgmma (bf16, n ≤ kMaxBlocks, K and N multiples of 8, x, W and u
//    16-byte aligned): the rank-n form
//
//      R(x)·W = x·W − 2·P·U,  U[i, :] = û_iᵀ · W[i·db : (i+1)·db, :] (n × N).
//
//    It is exact algebra: R(x)_i = x_i − 2 (x_i·û_i) û_i block by block.
//    The tensor cores multiply the stored bf16 x and W, whose products are
//    exact in f32, and sum in f32; P and U are f32; the epilogue adds
//    −2·P·U (n FMAs an output) to the f32 sum and rounds y once.  So the
//    reflected x is never rounded to bf16: f32 math throughout, as on the
//    SIMT route and in the plain version, but y comes from two f32 sums of
//    comparable size, x·W and 2·P·U, rather than one over the reflected x,
//    so its f32 rounding is larger: at the train step's shapes 0.07-0.16%
//    of outputs land one bf16 step from the plain version's, against
//    0.02-0.07% on the SIMT route, both as far from the float64 product
//    (tools/train_gap.py).
//    U comes from the W tiles the GEMM has already brought into shared
//    memory: two U warpgroups beside the MMA warpgroups read each stage
//    of a block's first row tile once the TMA has filled it and sum
//    u[k]·W[k, col] on the CUDA cores while the tensor cores run the
//    products; a thread sums 16 rows (a quarter of a 64-deep K tile) of
//    TILE/64 columns in k order, keeping one partial a block i and a
//    quarter in shared memory (4·n·TILE f32).  After the last K tile the
//    quarters are added in order and divided by ‖u_i‖ + ε, and the MMA
//    warps take U at a named barrier.  Every order of summation (the
//    16-deep k chunks of the MMA, a quarter's rows, the quarters, the
//    blocks of the epilogue) is fixed by K alone, so a row's y does not
//    depend on M, on the route or on the rows beside it (a right-padded
//    prompt is held bitwise to the same prompt served alone), and two
//    calls agree bit for bit.
//    The GEMM: TILE-wide output tiles, a ring of stages in shared memory
//    under the 128-byte swizzle, each stage one or more 64-deep K tiles.
//    One producer warp issues the TMA loads (cp.async.bulk.tensor: one
//    box of x and TILE/64 boxes of W a K tile, since a swizzled box is at
//    most 64 bf16 wide, and a bulk copy of the stage's u) and arms each
//    stage's "full" mbarrier with its bytes; TILE/64 MMA warpgroups, 64
//    rows each, wait on it, issue four wgmma.mma_async m64nTILEk16 a K
//    tile (A K-major; B N-major, through the transpose bit bf16 allows)
//    and free the stage on its "empty" mbarrier once the next stage's
//    products are issued; the U warps free it once they have read it.
//    Ragged edges: TMA fills rows and columns past M, N and K with zeros,
//    the epilogue masks its stores.
//    a. `wgmma` (M > 16, prefill and training): 128×128 tiles, two MMA
//       warpgroups, 4 stages of one K tile (32 KB).  A block takes up to
//       kMaxRowTiles row tiles of one column tile (as many as keep
//       kWaves waves of blocks on the card) and forms U in the first
//       alone; the blocks that run at once share their x and W tiles in
//       the 50 MB L2.
//    b. `wgmma_decode` (M ≤ 16, decode): 64-column tiles, one MMA
//       warpgroup, 4 stages of four K tiles (16 rows of x and 64 of W
//       each, 40 KB).  A decode step is bound by reading W: the narrower
//       tile gives twice the blocks (80 for qwen2.5-32b's q, o and down,
//       which 128-column tiles cut into 40 for 132 SMs), and four K tiles
//       a stage spread each stage's fixed costs (its barriers, the wait
//       for the products, the U warps' pass) over 32 KB of W.  The wgmma
//       still reads 64 rows: those past the 16 of x fall on the W boxes
//       behind them and give rows of the product that are never stored.
//       It sums exactly as (a): no split of K, whose partial sums would
//       change the order.
// 2. SIMT (f32, n > kMaxBlocks, widths not multiples of 8, a misaligned
//    view of x, W or u): the prologue's projections turn each loaded x
//    element into x − 2·p[t, k/db]·û[k] while the register-tiled SIMT f32
//    FMA kernel of reflect_common.cuh stages its A tile, for any db and
//    any ragged edge.
//    TF32 tensor cores would miss float32's tolerance.
//
// Next steps: persistent blocks that overlap one tile's epilogue with the
// next tile's loads; 256-wide tiles; the same core for the shared GEMM's
// other users (rows 5, 6, 10 and 18-21 of PERF.md's kernel table).
//
// C interface, bound with ctypes: hh_gemm(...) launches the route it is
// given on the given stream, allocates nothing and returns a cudaError_t.

#include <cuda.h>
#include <stdint.h>

#include <mutex>

#include "reflect_common.cuh"

namespace {

using namespace reflect;
using bf16 = __nv_bfloat16;

template <typename T>
int run_simt(const void* x, const void* w, const void* u, void* p,
             void* unorm, void* y, int M, int K, int N, int n, int db,
             cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const Proj pr{static_cast<const float*>(u), nullptr, static_cast<float*>(p),
                static_cast<float*>(unorm), nullptr, nullptr, n, db};
  cudaError_t err = launch_proj<T, false>(xt, pr, M, K, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // y (M×N) = R(x) (M×K) · W (K×N): A(t, k) = x[t*K + k] reflected along k
  return static_cast<int>(launch_gemm<T, T, T, true, true, kReflectK>(
      xt, K, static_cast<const T*>(w), N, static_cast<T*>(y), M, N, K, pr, s));
}

// ---------------------------------------------------------------------------
// The wgmma routes
// ---------------------------------------------------------------------------

constexpr int kBK = 64;          // K step: one 128-byte swizzled bf16 row
constexpr int kBox = 64 * 128;   // one 64-row × 64-column bf16 box, 8 KB
constexpr int kQuarters = 4;     // U's partials: 16 of a K step's 64 rows
constexpr int kMaxRowTiles = 4;  // row tiles a block takes, at most
constexpr int kSMs = 132, kWaves = 4;
constexpr int kMaxBlocks = 32;   // the largest n it takes
constexpr int kMaxDevices = 64;

// TILE = 128: the `wgmma` route; TILE = 64: `wgmma_decode`.  Both keep
// a ring of kStages stages.
constexpr int kStages = 4;

// The 64-deep K tiles a stage holds: at decode a stage's fixed costs (its
// barriers, the MMA warps' wait for their products, the U warps' pass)
// are spread over more of W.
template <int TILE>
__host__ __device__ constexpr int k_sub() {
  return TILE == 128 ? 1 : 4;
}

// The rows of x a stage holds: a whole 128-row tile, or at decode the
// DECODE_ROWS at most that a call has (the wgmma reads 64 rows from the
// stage: those past them fall on the W box that follows and yield rows
// of the product that are never stored).
template <int TILE>
__host__ __device__ constexpr int a_rows() {
  return TILE == 128 ? 128 : 16;
}

// TILE/64 MMA warpgroups, two U warpgroups and the producer warp.
template <int TILE>
__host__ __device__ constexpr int kThreads() {
  return 2 * TILE + 256 + 32;
}

// Dynamic shared memory: the ring (an A tile and TILE/64 W boxes a
// stage, and the stage's 64 values of u), its 2·stages mbarriers, U's
// quarter partials (4·n·TILE f32) and room to align the ring to the
// swizzle's 1024 bytes.
template <int TILE>
__host__ __device__ constexpr int smem_bytes(int n) {
  return kStages *
             (k_sub<TILE>() * ((a_rows<TILE>() + TILE) * 128 + 4 * kBK) +
              16) +
         kQuarters * n * TILE * 4 + 1024;
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// A 2-D box of `map` at (c0 innermost, c1) into shared memory at `dst`,
// its bytes counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A wgmma shared-memory descriptor under the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// d (64×TILE f32, the warpgroup's fragment) += A (64×16, K-major) ·
// B (16×TILE, N-major: transpose bit set).
template <int TILE>
struct Wgmma;

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global `src` into shared memory at `dst`, counted on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// y = x·W − 2·P·U, rounded once to bf16.  x by tma_x (dims {K, M}, box
// 64 × TILE), W by tma_w (dims {N, K}, box 64 × 64), both 128-byte
// swizzled; u the raw (n, db) hyperplanes, p (M, n) and unorm (n) the
// prologue's f32 projections and norms.  Warps: TILE/64 MMA warpgroups
// (64 rows each), two U warpgroups, one producer warp.  Block b takes the
// column tile b / groups and the row tiles mt·(b % groups) .. + mt − 1,
// groups = ⌈tiles_m / mt⌉: it forms U once, in its first row tile, and
// the blocks that run at once share their tiles of x and W in L2.
template <int TILE>
__global__ void __launch_bounds__(kThreads<TILE>(), 1)
    wgmma_kernel(const __grid_constant__ CUtensorMap tma_x,
                 const __grid_constant__ CUtensorMap tma_w,
                 const float* __restrict__ u, const float* __restrict__ p,
                 const float* __restrict__ unorm, bf16* __restrict__ y,
                 int M, int N, int K, int n, int db, int mt, int x_bytes) {
  constexpr int kMmaWarps = TILE / 16;        // TILE/64 warpgroups
  constexpr int kMT = kMmaWarps * 32;         // MMA threads
  constexpr int kUT = 256;                    // U threads, two warpgroups
  constexpr int kCols = TILE / 64;            // columns a U thread sums
  constexpr int kSub = k_sub<TILE>();         // K tiles a stage
  constexpr int kATile = a_rows<TILE>() * 128;  // rows × 64 k × 2 bytes
  constexpr int kSubBytes = kATile + TILE * 128;  // and TILE/64 W boxes
  constexpr int kStageBytes = kSub * kSubBytes;
  constexpr int kStageK = kSub * kBK;         // K rows a stage
  constexpr int kAcc = TILE / 2;              // a thread's f32 accumulators

  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the swizzle repeats every 1024 bytes: tiles start on that boundary
  const uint32_t pad = ((smem_addr(smem_raw) + 1023u) & ~1023u) -
                       smem_addr(smem_raw);
  uint8_t* const ring = smem_raw + pad;
  const uint32_t base = smem_addr(ring);
  // each stage's kStageK values of u (the first row tile's steps only)
  float* const uring = reinterpret_cast<float*>(ring + kStages * kStageBytes);
  const uint32_t bars = smem_addr(uring + kStages * kStageK);
  // us[(q·n + i)·TILE + c]: quarter q's partial of U[i, n0 + c]
  float* const us = uring + kStages * kStageK + 4 * kStages;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };

  const int tiles_m = (M + TILE - 1) / TILE;
  const int groups = (tiles_m + mt - 1) / mt;
  const int first_m = static_cast<int>(blockIdx.x) % groups * mt;
  const int count_m = min(mt, tiles_m - first_m);
  const int n0 = static_cast<int>(blockIdx.x) / groups * TILE;
  const int k_tiles = (K + kBK - 1) / kBK;
  const int k_steps = (k_tiles + kSub - 1) / kSub;   // stages a row tile
  const int steps = count_m * k_steps;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      // lane 0 of each MMA and U warp
      mbar_init(empty(s), kMmaWarps + kUT / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == (kMT + kUT) / 32) {  // the producer warp: one lane issues
    if (lane == 0) {
      for (int it = 0; it < steps; ++it) {
        const int mi = it / k_steps, k0 = it % k_steps * kStageK;
        const int subs = min(kSub, k_tiles - it % k_steps * kSub);
        const int s = it % kStages;
        // the stage's previous round freed (the first round passes)
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        const int u_bytes = mi ? 0 : 4 * min(kStageK, K - k0);
        mbar_expect_tx(full(s), subs * (x_bytes + TILE * 128) + u_bytes);
        for (int j = 0; j < subs; ++j) {
          const uint32_t a = base + s * kStageBytes + j * kSubBytes;
          tma_load(a, &tma_x, full(s), k0 + j * kBK, (first_m + mi) * TILE);
#pragma unroll
          for (int c = 0; c < TILE / 64; ++c)
            tma_load(a + kATile + c * kBox, &tma_w, full(s), n0 + 64 * c,
                     k0 + j * kBK);
        }
        if (u_bytes)
          bulk_load(smem_addr(uring + s * kStageK), u + k0, u_bytes,
                    full(s));
      }
    }
    return;
  }

  if (warp >= kMmaWarps) {
    // The U warps, two warpgroups: warps 2q and 2q + 1 sum rows 16·q ..
    // 16·q + 15 of every K step of the first row tile, each thread kCols
    // adjacent columns, in k order into one partial a block (stored when
    // the rows cross into the next block); on later steps they only free
    // the stages.
    const int ut = threadIdx.x - kMT;
    const int q = ut / 64;
    const int col = kCols * (ut % 64);
    float* const mine = us + q * n * TILE + col;
    for (int i = 0; i < n; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) mine[i * TILE + c] = 0.f;
    // the columns' byte offset in a stage, less their row's swizzle
    const int wofs =
        kATile + (col >> 6) * kBox + (col & 7) * 2 + 16 * q * 128;
    const int chunk = (col & 63) >> 3;
    int blk = 0, next = db;   // the block being summed and where it ends
    float sum[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) sum[c] = 0.f;
    auto store = [&]() {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        mine[blk * TILE + c] = sum[c];
        sum[c] = 0.f;
      }
    };
    for (int it = 0; it < steps; ++it) {
      const int s = it % kStages;
      mbar_wait(full(s), (it / kStages) & 1);
      const int subs = it < k_steps ? min(kSub, k_tiles - it * kSub) : 0;
      for (int j = 0; j < subs; ++j) {
        const int k0 = (it * kSub + j) * kBK + 16 * q;
        const float* const u16 = uring + s * kStageK + j * kBK + 16 * q;
        const uint8_t* const st =
            ring + s * kStageBytes + j * kSubBytes + wofs;
        // row r's kCols W values, as f32
        auto w_at = [&](int r, float (&w)[kCols]) {
          const uint8_t* at = st + r * 128 + ((chunk ^ (r & 7)) << 4);
          if constexpr (kCols == 2) {
            const float2 v = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(at));
            w[0] = v.x;
            w[1] = v.y;
          } else {
            w[0] = __bfloat162float(*reinterpret_cast<const bf16*>(at));
          }
        };
        if (db >= 16 && k0 + 16 <= K) {
          // at most one block boundary among the 16 rows: the rows' W
          // values and u values loaded first, then summed in k order
          float uk[16], wv[16][kCols];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            *reinterpret_cast<float4*>(uk + 4 * i) =
                reinterpret_cast<const float4*>(u16)[i];
#pragma unroll
          for (int r = 0; r < 16; ++r) w_at(r, wv[r]);
          if (k0 >= next) {
            store();
            blk = k0 / db;
            next = (blk + 1) * db;
          }
          const int split = next - k0;  // rows below it are in block blk
          if (split >= 16) {
#pragma unroll
            for (int r = 0; r < 16; ++r)
#pragma unroll
              for (int c = 0; c < kCols; ++c)
                sum[c] = fmaf(uk[r], wv[r][c], sum[c]);
          } else {
            // without branches: a row adds u·w to its own block's sum
            // and an exact 0·w to the other's
            float t[kCols];
#pragma unroll
            for (int c = 0; c < kCols; ++c) t[c] = 0.f;
#pragma unroll
            for (int r = 0; r < 16; ++r) {
              const float here = r < split ? uk[r] : 0.f;
              const float there = r < split ? 0.f : uk[r];
#pragma unroll
              for (int c = 0; c < kCols; ++c) {
                sum[c] = fmaf(here, wv[r][c], sum[c]);
                t[c] = fmaf(there, wv[r][c], t[c]);
              }
            }
            store();
#pragma unroll
            for (int c = 0; c < kCols; ++c) sum[c] = t[c];
            ++blk;
            next += db;
          }
        } else {
          // blocks narrower than 16 rows, or the last K step's ragged
          // end: row by row, the same order
          for (int r = 0; r < 16 && k0 + r < K; ++r) {
            if (k0 + r >= next) {
              store();
              blk = (k0 + r) / db;
              next = (blk + 1) * db;
            }
            float wv[kCols];
            w_at(r, wv);
#pragma unroll
            for (int c = 0; c < kCols; ++c)
              sum[c] = fmaf(u16[r], wv[c], sum[c]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
      if (it == k_steps - 1) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) mine[blk * TILE + c] = sum[c];
        // U[i, c] = (((q0 + q1) + q2) + q3) / (‖u_i‖ + ε), into quarter
        // 0's slots, once every quarter is in (named barrier 2, the U
        // warps); then hand U to the MMA warps (barrier 1)
        asm volatile("bar.sync 2, %0;" ::"n"(kUT) : "memory");
        for (int e = ut; e < n * TILE; e += kUT) {
          float v = us[e];
#pragma unroll
          for (int qq = 1; qq < kQuarters; ++qq) v += us[qq * n * TILE + e];
          us[e] = v / __ldg(unorm + e / TILE);
        }
        __threadfence_block();
        asm volatile("bar.arrive 1, %0;" ::"n"(kMT + kUT) : "memory");
      }
    }
    return;
  }

  const int g = warp / 4;  // MMA warpgroup: rows 64g .. of the row tile
  // The fragment: register 4j + h (h < 2) at row r0, 4j + 2 + h at row
  // r0 + 8, column 8j + 2·(lane % 4) + h of the tile.
  const int c0 = 2 * (lane % 4);
  float acc[kAcc];
  for (int mi = 0; mi < count_m; ++mi) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    for (int ki = 0; ki < k_steps; ++ki) {
      const int it = mi * k_steps + ki;
      const int s = it % kStages;
      const int subs = min(kSub, k_tiles - ki * kSub);
      mbar_wait(full(s), (it / kStages) & 1);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        if (kSub > 1 && j >= subs) break;
        const uint32_t a = base + s * kStageBytes + j * kSubBytes +
                           g * 64 * 128;
        const uint32_t b = base + s * kStageBytes + j * kSubBytes + kATile;
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks) {
          // A: 16 k (32 bytes) further along each 128-byte row, 8-row
          // groups 1024 bytes apart.  B: 16 k rows (2048 bytes) further,
          // 8-row groups 1024 bytes apart, the next 64-column box kBox on.
          Wgmma<TILE>::mma(acc, sw128_desc(a + ks * 32, 16, 1024),
                           sw128_desc(b + ks * 2048, kBox, 1024));
        }
      }
      wgmma_commit();
      fence_acc(acc);
      // the products of step it − 1 are done: free its stage
      wgmma_wait<1>();
      if (ki > 0 && lane == 0) mbar_arrive(empty((it - 1) % kStages));
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(empty((mi * k_steps + k_steps - 1) % kStages));
    // U, from the U warpgroup
    if (mi == 0) asm volatile("bar.sync 1, %0;" ::"n"(kMT + kUT) : "memory");

    const int r0 = (first_m + mi) * TILE + g * 64 + (warp % 4) * 16 +
                   lane / 4;
    const int r1 = r0 + 8;
    const float* p0row = p + static_cast<long long>(r0) * n;
    const float* p1row = p + static_cast<long long>(r1) * n;
    for (int i = 0; i < n; ++i) {
      const float p0 = r0 < M ? -2.f * p0row[i] : 0.f;
      const float p1 = r1 < M ? -2.f * p1row[i] : 0.f;
      const float* ui = us + i * TILE + c0;
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
        const float2 cv = *reinterpret_cast<const float2*>(ui + 8 * j);
        acc[4 * j] = fmaf(p0, cv.x, acc[4 * j]);
        acc[4 * j + 1] = fmaf(p0, cv.y, acc[4 * j + 1]);
        acc[4 * j + 2] = fmaf(p1, cv.x, acc[4 * j + 2]);
        acc[4 * j + 3] = fmaf(p1, cv.y, acc[4 * j + 3]);
      }
    }
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      const int cc = n0 + c0 + 8 * j;
      if (cc >= N) continue;
      if (r0 < M)
        *reinterpret_cast<__nv_bfloat162*>(
            y + static_cast<long long>(r0) * N + cc) =
            __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      if (r1 < M)
        *reinterpret_cast<__nv_bfloat162*>(
            y + static_cast<long long>(r1) * N + cc) =
            __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// cuTensorMapEncodeTiled is a driver call: taken through the runtime's
// entry-point query, so the library links against the runtime alone.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(sym);
  }
  return fn;
}

// A row-major bf16 (outer × inner) matrix as a TMA map with box
// (box_inner × box_outer), 128-byte swizzle, zeros past its edges.
bool encode(EncodeTiled enc, CUtensorMap* map, const void* ptr,
            uint64_t inner, uint64_t outer, uint32_t box_inner,
            uint32_t box_outer) {
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * sizeof(bf16)};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t step[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// encode's map through a cache of the maps made last, keyed by address,
// shape and box: a map holds nothing else (no contents), so an entry never
// goes stale.  A decode step's weights (224 at smollm-360m), and from
// PyTorch's caching allocator most of its activations, come back at the
// same addresses, so it encodes few maps: kWays-way sets, so that keys
// that share a set do not evict each other every step (a direct-mapped
// table re-encoded maps on every decode step).
struct MapSlot {
  CUtensorMap map;
  const void* ptr;
  uint64_t inner, outer;
  uint32_t box_inner, box_outer;
};
constexpr int kMapSetsLog2 = 10, kWays = 4;
MapSlot map_slots[1 << kMapSetsLog2][kWays];
int map_next[1 << kMapSetsLog2];   // the way a miss in the set refills
std::mutex map_lock;
long long map_lookups = 0, map_encodes = 0;   // read by hh_map_counts

bool cached_map(EncodeTiled enc, CUtensorMap* map, const void* ptr,
                uint64_t inner, uint64_t outer, uint32_t box_inner,
                uint32_t box_outer) {
  const uint64_t h =
      ((reinterpret_cast<uintptr_t>(ptr) >> 8) * 0x9E3779B97F4A7C15ull) ^
      ((inner << 20 | outer) * 0xC2B2AE3D27D4EB4Full) ^ box_outer;
  const int set = static_cast<int>(h >> (64 - kMapSetsLog2));
  std::lock_guard<std::mutex> hold(map_lock);
  ++map_lookups;
  for (MapSlot& slot : map_slots[set]) {
    if (slot.ptr == ptr && slot.inner == inner && slot.outer == outer &&
        slot.box_inner == box_inner && slot.box_outer == box_outer) {
      *map = slot.map;
      return true;
    }
  }
  MapSlot& slot = map_slots[set][map_next[set]];
  map_next[set] = (map_next[set] + 1) % kWays;
  ++map_encodes;
  if (!encode(enc, &slot.map, ptr, inner, outer, box_inner, box_outer)) {
    slot.ptr = nullptr;
    return false;
  }
  slot.ptr = ptr;
  slot.inner = inner;
  slot.outer = outer;
  slot.box_inner = box_inner;
  slot.box_outer = box_outer;
  *map = slot.map;
  return true;
}

// The GEMM of one wgmma route, after the prologue.
template <int TILE>
cudaError_t launch_wgmma(EncodeTiled enc, const void* x, const void* w,
                         const Proj& pr, void* y, int M, int K, int N,
                         cudaStream_t s) {
  // x's box: a 128-row tile, or at decode its rows rounded up to 8
  const int x_rows = TILE == 128 ? 128 : (M + 7) / 8 * 8;
  if (x_rows > a_rows<TILE>()) return cudaErrorInvalidValue;
  CUtensorMap tma_x, tma_w;
  if (!cached_map(enc, &tma_x, x, K, M, kBK, x_rows) ||
      !cached_map(enc, &tma_w, w, N, K, 64, kBK))
    return cudaErrorNotSupported;
  // beyond 48 KB a block must ask for its shared memory, once for each
  // device: a runtime call a launch would add one to every linear of a
  // host-bound decode step
  static bool sized[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!sized[device]) {
    err = cudaFuncSetAttribute(wgmma_kernel<TILE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<TILE>(kMaxBlocks));
    if (err != cudaSuccess) return err;
    sized[device] = true;
  }
  // row tiles a block: as many as keep kWaves waves of blocks on the
  // card, up to kMaxRowTiles (each forms U once, in its first)
  const int tiles_m = (M + TILE - 1) / TILE, tiles_n = (N + TILE - 1) / TILE;
  int mt = kMaxRowTiles;
  while (mt > 1 && static_cast<long long>(tiles_n) * ((tiles_m + mt - 1) / mt)
                       < static_cast<long long>(kWaves) * kSMs)
    mt /= 2;
  const long long blocks =
      static_cast<long long>(tiles_n) * ((tiles_m + mt - 1) / mt);
  wgmma_kernel<TILE><<<static_cast<unsigned>(blocks), kThreads<TILE>(),
                       smem_bytes<TILE>(pr.n), s>>>(
      tma_x, tma_w, pr.u, pr.p, pr.unorm, static_cast<bf16*>(y), M, N, K,
      pr.n, pr.db, mt, x_rows * 128);
  return cudaGetLastError();
}

template <int TILE>
int run_wgmma(const void* x, const void* w, const void* u, void* p,
              void* unorm, void* y, int M, int K, int N, int n, int db,
              cudaStream_t s) {
  if (n > kMaxBlocks || K % 8 || N % 8 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(u)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const Proj pr{static_cast<const float*>(u), nullptr, static_cast<float*>(p),
                static_cast<float*>(unorm), nullptr, nullptr, n, db};
  cudaError_t err =
      launch_proj<bf16, false>(static_cast<const bf16*>(x), pr, M, K, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_wgmma<TILE>(enc, x, w, pr, y, M, K, N, s));
}

}  // namespace

// route: 0 = SIMT float32, 1 = SIMT bfloat16 (x, W and y alike), 2 =
// wgmma (bf16), 3 = wgmma_decode (bf16); the wgmma routes take n ≤ 32, K
// and N multiples of 8, x, W and u 16-byte aligned.  p is (M, n) f32
// scratch, unorm (n,) f32 scratch, both written before they are read.
extern "C" int hh_gemm(const void* x, const void* w, const void* u, void* p,
                       void* unorm, void* y, int M, int K, int N, int n,
                       int db, int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (route) {
    case 0:
      return run_simt<float>(x, w, u, p, unorm, y, M, K, N, n, db, s);
    case 1:
      return run_simt<bf16>(x, w, u, p, unorm, y, M, K, N, n, db, s);
    case 2:
      return run_wgmma<128>(x, w, u, p, unorm, y, M, K, N, n, db, s);
    case 3:
      return run_wgmma<64>(x, w, u, p, unorm, y, M, K, N, n, db, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The tensor-map cache's lookups and encodes (its misses) since the
// library was loaded, into counts[0] and counts[1].
extern "C" int hh_map_counts(long long* counts) {
  std::lock_guard<std::mutex> hold(map_lock);
  counts[0] = map_lookups;
  counts[1] = map_encodes;
  return 0;
}
