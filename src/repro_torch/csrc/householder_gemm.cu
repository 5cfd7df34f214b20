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

#include "hopper.cuh"
#include "reflect_common.cuh"

namespace {

using namespace hopper;
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
          WgmmaSS<TILE, 1>::mma(acc, sw128_desc(a + ks * 32, 16, 1024),
                                sw128_desc(b + ks * 2048, kBox, 1024), 1);
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

// the wgmma routes' tensor maps, read by hh_map_counts
MapCache map_cache;

// The GEMM of one wgmma route, after the prologue.
template <int TILE>
cudaError_t launch_wgmma(EncodeTiled enc, const void* x, const void* w,
                         const Proj& pr, void* y, int M, int K, int N,
                         cudaStream_t s) {
  // x's box: a 128-row tile, or at decode its rows rounded up to 8
  const int x_rows = TILE == 128 ? 128 : (M + 7) / 8 * 8;
  if (x_rows > a_rows<TILE>()) return cudaErrorInvalidValue;
  CUtensorMap tma_x, tma_w;
  const uint64_t x_dims[2] = {static_cast<uint64_t>(K),
                              static_cast<uint64_t>(M)};
  const uint64_t w_dims[2] = {static_cast<uint64_t>(N),
                              static_cast<uint64_t>(K)};
  const uint32_t x_box[2] = {kBK, static_cast<uint32_t>(x_rows)};
  const uint32_t w_box[2] = {64, kBK};
  if (!map_cache.get(enc, &tma_x, x, 2, x_dims, x_box) ||
      !map_cache.get(enc, &tma_w, w, 2, w_dims, w_box))
    return cudaErrorNotSupported;
  static bool sized[kMaxDevices] = {};
  const cudaError_t err = reserve_smem(wgmma_kernel<TILE>,
                                       smem_bytes<TILE>(kMaxBlocks), sized);
  if (err != cudaSuccess) return err;
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
  map_cache.counts(counts);
  return 0;
}
