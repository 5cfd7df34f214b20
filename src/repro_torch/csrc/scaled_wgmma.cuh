// The wgmma core of the scaled and low-rank forwards, for sm_90a:
// hyperadapt_gemm_batched.cu (HyperAdapt through a bank: y =
// ((x⊙r_t)·W)⊙c_t, t each row's tenant), hyperadapt_gemm.cu (the same with
// one tenant) and delora_gemm_batched.cu (DeLoRA through a bank: y = x·W +
// ((x·a_t)⊙s_t)·b_t).  The methods' extra arithmetic sits around the
// tensor-core product, never inside its k-loop:
//
//  * HyperAdapt, MODE kColScale, or kPlain for the backward's z and y0.  A
//    prologue (scale_rows_kernel) forms v = x⊙r_{t(row)} in f32, each
//    row's tenant read on the device, and writes it as two bf16 planes,
//    hi = bf16(v) and lo = bf16(v − hi); the GEMM adds hi·W and lo·W on
//    the tensor cores, k chunk by k chunk, and its epilogue multiplies the
//    f32 accumulator by c_{t(row)}[col] and rounds once.  The JAX kernel
//    feeds the f32 x⊙r to its product (hyperadapt_gemm.py:91-95): hi
//    alone, one bf16 operand, put 42.6% of a train step's outputs one bf16
//    step off the plain version's and moved phase 14's loss gap past
//    TRAIN_TOL (PERF.md §6); hi + lo holds v to 16 bits.  Under kOne (the
//    single-tenant hyperadapt_gemm) r and c are a bank of one: tenant 0 at
//    every row, no ids read.
//  * DeLoRA, MODE kLowRank.  x·W multiplies x as it is: one plane, the
//    caller's x TMA-loaded as row 1 loads it, one wgmma a k chunk.  A
//    prologue (lowrank_h_kernel) writes hs[m, j] = fl32(Σ_k x[m, k]·
//    p_t[k, j], summed in f64)·s_t[j] to an (M, r) f32 scratch; the
//    epilogue adds Σ_j hs[m, j]·q_t[j, col], summed in f32 in j order, to
//    the accumulator after its last K partial, and rounds once, as
//    _delora_batched_kernel's _done (delora_gemm.py:119-124) adds its
//    (Ts, r)·(r, Tf) dot to the f32 scratch.  p and q are the banks where
//    they lie, read by strides: the forward's p = a (A, K, r), q = b (A,
//    r, N); the backward's dx = G·Wᵀ + ((G·b_tᵀ)⊙s_t)·a_tᵀ takes p = b read
//    along its rows and q = a read down its columns, so no bank is copied
//    transposed.  Where every row of a tile names one tenant (at train
//    size each 128-row tile is one sequence) the epilogue stages q_t's
//    r × TN tile and the tile's hs in the freed ring; otherwise (the decode
//    tile at B = 4, S = 1, the bank prefill's 4 × 32) it reads q_t[j, col]
//    at each row's tenant with __ldg.  r ≤ kMaxRank.
//
// Both scales and the rank-r term are per row, so a row tile may hold
// rows of several tenants and W is read once a call, where the Pallas
// grid (B, S/Ts, F/Tf, K/Tk) reads it once a sequence.  The alternative
// for HyperAdapt, x from registers scaled before a register-A wgmma, saves
// the planes (4·M·K bytes written and read once, 21 MB at a train step's
// 1,024 × 2,560) but needs a tenant lookup of r per row and k chunk inside
// the k-loop; the planes cost a few µs there and keep the k-loop the
// plain one.
//
// Why a core of its own, beside hh_wgmma.cuh and dxr_wgmma.cuh: the loop
// of hh_wgmma.cuh is built around its U warpgroups, which sum U = ÛᵀW from
// the W tiles in shared memory while the MMA warps use them, and its bank
// tiles hold one sequence's rows; dxr_wgmma.cuh reads W K-major only, on
// column tiles of whole reflection blocks.  Here x comes as one or two
// planes a stage, W in either layout, any rows share a tile, and nothing
// runs beside the MMA warps.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s, the
// data sheet's rates at 700 W), reckoned over one smollm-360m layer's
// seven linears (Σ d·f = 9.83e6): at decode, reading W (19.7 MB, 5.9 µs;
// DeLoRA's gathered banks add 4·r·(d + f) bytes a tenant); at a train
// step's 2,048 rows, the product, 2·M·Σ d·f = 40.3 GFLOP (40.7 µs).  The
// core does that product once for DeLoRA (one plane) and twice for
// HyperAdapt (hi and lo: 81 µs of tensor-core work); DeLoRA's rank-r term
// adds 2·M·r·Σ(d + f) f64 and f32 operations (0.4 GFLOP at r = 8).
//
// The GEMM: one producer warp issues the TMA loads (PLANES boxes of x and
// TN columns of W a 64-deep K tile) into a ring of 4 stages under the
// 128-byte swizzle and arms each stage's "full" mbarrier with its bytes;
// the MMA warpgroups, 64 rows each, wait on it, issue the wgmma.mma_async
// m64nTNk16 of a K tile into f32 partials and free the stage on its "empty"
// mbarrier once the next stage's products are issued.  W comes in either
// layout (template WT): kWN, W (K, N) row-major, N-major to wgmma through
// the transpose bit (the forwards, as hh_wgmma.cuh reads it); kWK, the
// (N, K) row-major matrix read as its transpose, K-major (z = (g⊙c)·Wᵀ,
// DeLoRA's G·Wᵀ, as dxr_wgmma.cuh reads W).  TMA fills rows and columns
// past M, N and K with zeros; the epilogue masks its stores.  The tensor
// cores sum each 64-deep K tile into a partial from zero, 16-deep k chunks
// in order, and the partials are added in order into the f32 accumulator
// on the CUDA cores, rounding to nearest, as the JAX kernel adds each K
// tile's dot into its f32 scratch.  The tensor cores' own accumulation
// truncates: with one chain over all of K, or over the JAX kernels' K
// tiles of up to 512, 0.031-0.038% of a train step's x·W outputs came out
// one bf16 step off the plain version's, with 64-deep partials
// 0.016-0.024% (PERF.md §6).  A block takes one tile, so every order is
// set by K (and r) alone: a row's y does not depend on M, on the rows or
// tenants beside it, or on which way its tile read q, and two calls agree
// bit for bit (the trainer's bitwise restores).
//
// Tiles (template TN):
//  * 128: 128 rows × 128 columns, two MMA warpgroups, 4 stages of one K
//    tile (PLANES · 16 KB of x and 16 KB of W each).
//  * 64 (decode, M ≤ kDecodeRows): one MMA warpgroup, 4 stages of four K
//    tiles (16 rows of x and 64 of W each), as hh_wgmma.cuh's decode tile:
//    a decode call is bound by reading W, and the narrower tile gives
//    twice the blocks.  The wgmma still reads 64 rows: those past the 16
//    of x fall on the W tiles behind them and give rows of the product
//    that are never stored.
// Registers (reckoned; `-Xptxas -v` prints them at each build): a block
// has three warpgroups' worth of threads (the producer warp rounds up to
// one), so 224 a thread; a 128-wide tile's 64 accumulators and 64
// partials (after the K loop, the low-rank term's 64 sums) take 128, the
// descriptors, indices and the epilogue's row pointers the rest, with no
// spill.  Dynamic shared memory a block (the ring, its mbarriers, 1,024
// bytes of alignment): TN 128, two planes 197,696 B; one plane 132,160 B;
// TN 64, two planes 197,696 B; one plane 164,928 B.  The low-rank
// epilogue's staged tiles (q_t r × TN f32, hs rows × r f32: 32 KB and 32
// KB at r = 64, TN = 128; 16 KB and 4 KB on the decode tile) lie in the
// freed ring.
#pragma once

#include <cuda.h>
#include <stdint.h>

#include "hopper.cuh"
#include "reflect_common.cuh"

namespace sw {
// Internal linkage throughout, as in hh_wgmma.cuh and dxr_wgmma.cuh: a
// function-local static of a template with external linkage (reserve_smem's
// `sized`, the map cache) would be one object for every library of the
// process that included the header.
namespace {

using namespace hopper;
using reflect::Tenants;
using bf16 = __nv_bfloat16;

constexpr int kBK = 64;          // K step: one 128-byte swizzled bf16 row
constexpr int kBox = 64 * 128;   // one 64-row × 64-column bf16 box, 8 KB
constexpr int kDecodeRows = 16;  // the most rows the decode tile takes
constexpr int kStages = 4;
constexpr int kMaxRank = 64;     // the low-rank epilogue's largest r

enum WLayout { kWN = 0, kWK = 1 };
// The kernel's MODE, bits: its epilogue and whose rows it serves.  The
// bank's HyperAdapt instantiations are 0 and 1, the single tenant's 4 and
// 5, DeLoRA's bank 2 (the trace tables tell the ops apart by them).
enum Mode {
  kPlain = 0,      // y = x⊙r · W: x⊙r as hi and lo planes
  kColScale = 1,   // and ⊙c_t on the f32 sum
  kLowRank = 2,    // y = x·W + hs·q_t: x itself, one plane
  kOne = 4,        // one tenant: tenant 0 at every row, no ids read
};

// x's planes a stage under MODE: x itself for the low-rank product, else
// x⊙r's hi and lo.
template <int MODE>
constexpr int kPlanesOf = (MODE & kLowRank) ? 1 : 2;

// A tile of TN columns on PLANES planes of x.
template <int TN, int PLANES>
struct Tile {
  static_assert(TN == 64 || TN == 128, "tiles: 64 or 128 columns");
  static_assert(PLANES == 1 || PLANES == 2, "x: one or two planes");
  static constexpr bool kDecode = TN == 64;
  static constexpr int kSub = kDecode ? 4 : 1;        // K tiles a stage
  static constexpr int kARows = kDecode ? kDecodeRows : 128;  // x rows
  static constexpr int kRows = kARows;                // rows a tile stores
  static constexpr int kMmaWarps = kDecode ? 4 : 8;   // 64 rows a warpgroup
  static constexpr int kMT = 32 * kMmaWarps;          // MMA threads
  static constexpr int kThreads = kMT + 32;           // and the producer
  static constexpr int kATile = kARows * 128;         // rows × 64 k × 2 B
  static constexpr int kWTile = TN * 128;             // 64 k × TN × 2 B
  static constexpr int kSubBytes = PLANES * kATile + kWTile;
  static constexpr int kStageBytes = kSub * kSubBytes;
  static constexpr int kStageK = kSub * kBK;          // K rows a stage
  static constexpr int kAcc = TN / 2;                 // f32 accumulators
  // Dynamic shared memory: the ring, its 2·kStages mbarriers, and room to
  // align the ring to the swizzle's 1024 bytes.
  static constexpr int kSmemBytes = kStages * kStageBytes + 16 * kStages +
                                    1024;
  // the low-rank epilogue's staged q_t and hs fit in the freed ring
  static_assert(kMaxRank * (TN + kRows) * 4 <= kStages * kStageBytes,
                "the staged tiles outgrow the ring");
};

struct Args {
  bf16* y;             // (M, N)
  const float* c;      // kColScale: (A, N) a bank's column scales
  Tenants tn;          // each row's tenant (unread under kOne)
  int M, K, N;
  int x_bytes;         // bytes of one box of x
  // kLowRank: hs (M, r) f32 from lowrank_h_kernel, and q_t[j, col] =
  // q[t·q_ten + j·q_j + col·q_c] f32; stage: whether a tile of one
  // tenant stages q_t and hs in shared memory (else every tile reads them
  // with __ldg); staged, where set: the tiles counted on the device, [0]
  // the row tiles that staged and [1] every row tile (column tile 0's
  // blocks add one each)
  const float* hs;
  const float* q;
  long long q_ten;
  int q_j, q_c, r, stage;
  int* staged;
};

__device__ __forceinline__ int tenant_of(const Args& a, int MODE, int m) {
  return (MODE & kOne) ? 0 : reflect::row_tenant(a.tn, m);
}

// y = epilogue(x·W), one TN-wide tile a block: x by tma_x (dims {K, M,
// PLANES}: x itself, or x⊙r's hi and lo planes; box 64 × rows), W by
// tma_w (kWN: dims {N, K}, box 64 × 64; kWK: dims {K, N}, box 64 × TN),
// all 128-byte swizzled.  Block b takes row tile b % tiles_m and column
// tile b / tiles_m.
template <int TN, int WT, int MODE>
__global__ void __launch_bounds__(Tile<TN, kPlanesOf<MODE>>::kThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap tma_x,
                const __grid_constant__ CUtensorMap tma_w, const Args a) {
  constexpr int kPlanes = kPlanesOf<MODE>;
  using T = Tile<TN, kPlanes>;
  constexpr int kMmaWarps = T::kMmaWarps, kSub = T::kSub, kMT = T::kMT;
  constexpr int kStageBytes = T::kStageBytes, kStageK = T::kStageK;
  constexpr int kSubBytes = T::kSubBytes, kATile = T::kATile;
  constexpr int kAcc = T::kAcc, kRows = T::kRows;
  const int M = a.M, K = a.K, N = a.N;

  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ int mixed;  // kLowRank: the tile's rows name several tenants
  const uint32_t pad = ((smem_addr(smem_raw) + 1023u) & ~1023u) -
                       smem_addr(smem_raw);
  uint8_t* const ring = smem_raw + pad;
  const uint32_t base = smem_addr(ring);
  const uint32_t bars = base + kStages * kStageBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };

  const int tiles_m = (M + kRows - 1) / kRows;
  const int row0 = static_cast<int>(blockIdx.x) % tiles_m * kRows;
  const int n0 = static_cast<int>(blockIdx.x) / tiles_m * TN;
  const int k_tiles = (K + kBK - 1) / kBK;
  const int k_steps = (k_tiles + kSub - 1) / kSub;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kMmaWarps);  // lane 0 of each MMA warp
    }
    mixed = 0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kMmaWarps) {  // the producer warp: one lane issues
    if (lane == 0) {
      for (int it = 0; it < k_steps; ++it) {
        const int k0 = it * kStageK;
        const int subs = min(kSub, k_tiles - it * kSub);
        const int s = it % kStages;
        // the stage's previous round freed (the first round passes)
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), subs * (kPlanes * a.x_bytes + T::kWTile));
        for (int j = 0; j < subs; ++j) {
          const uint32_t at = base + s * kStageBytes + j * kSubBytes;
          const uint32_t wt = at + kPlanes * kATile;
#pragma unroll
          for (int p = 0; p < kPlanes; ++p)
            tma_load(at + p * kATile, &tma_x, full(s), k0 + j * kBK, row0, p);
          if constexpr (WT == kWN) {
#pragma unroll
            for (int c = 0; c < TN / 64; ++c)
              tma_load(wt + c * kBox, &tma_w, full(s), n0 + 64 * c,
                       k0 + j * kBK);
          } else {
            tma_load(wt, &tma_w, full(s), k0 + j * kBK, n0);
          }
        }
      }
    }
    return;
  }

  const int g = warp / 4;  // MMA warpgroup: rows 64g .. of the tile
  // acc sums the partials of the 64-deep K tiles, each summed on the
  // tensor cores into part from zero and added here in order, rounding
  // to nearest
  float acc[kAcc], part[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = part[i] = 0.f;
  for (int it = 0; it < k_steps; ++it) {
    const int s = it % kStages;
    const int subs = min(kSub, k_tiles - it * kSub);
    mbar_wait(full(s), (it / kStages) & 1);
    fence_acc(part);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      if (kSub > 1 && j >= subs) break;
      const uint32_t at = base + s * kStageBytes + j * kSubBytes + g * 64 * 128;
      const uint32_t b =
          base + s * kStageBytes + j * kSubBytes + kPlanes * kATile;
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        const bool opens = ks == 0;  // a K tile's first k chunk
        if (opens && (it > 0 || j > 0)) {
          // the previous K tile's partial is whole: every product issued
          // so far is done; add it
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(part);
#pragma unroll
          for (int i = 0; i < kAcc; ++i) acc[i] += part[i];
          fence_acc(part);
          wgmma_fence();
        }
        // A: 16 k (32 bytes) further along each 128-byte row, 8-row groups
        // 1024 bytes apart (the lo plane kATile on).  kWN: 16 k rows (2048
        // bytes) further, the next 64-column box kBox on; kWK: like A, TN
        // rows of 128 bytes.  A partial's first product starts from zero;
        // each k chunk adds each plane's product, hi then lo.
        const uint64_t bd = WT == kWN ? sw128_desc(b + ks * 2048, kBox, 1024)
                                      : sw128_desc(b + ks * 32, 16, 1024);
#pragma unroll
        for (int p = 0; p < kPlanes; ++p)
          WgmmaSS<TN, WT == kWN>::mma(
              part, sw128_desc(at + p * kATile + ks * 32, 16, 1024), bd,
              p > 0 || !opens);
      }
    }
    wgmma_commit();
    fence_acc(part);
    // the products of step it − 1 are done: free its stage
    wgmma_wait<1>();
    if (it > 0 && lane == 0) mbar_arrive(empty((it - 1) % kStages));
  }
  wgmma_wait<0>();
  fence_acc(part);
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] += part[i];

  // The fragment: register 4j + h (h < 2) at row rl0, 4j + 2 + h at row
  // rl0 + 8, column 8j + 2·(lane % 4) + h of the tile.
  const int c0 = 2 * (lane % 4);
  const int rl0 = g * 64 + (warp % 4) * 16 + lane / 4, rl1 = rl0 + 8;
  const int r0 = row0 + rl0, r1 = row0 + rl1;
  const bool ok0 = rl0 < kRows && r0 < M, ok1 = rl1 < kRows && r1 < M;

  if constexpr ((MODE & kLowRank) != 0) {
    // lr = Σ_j hs[row, j]·q_t[j, col], an FMA chain from zero in j order;
    // then acc + lr, rounded once below.  lr is an array of its own, not
    // the dead partials: the wgmma's registers written on a divergent
    // path serialize every wgmma of the kernel (ptxas C7520)
    const int r = a.r;
    const int last = min(row0 + kRows, M) - 1;
    const int t0 = tenant_of(a, MODE, row0);
    if (!(MODE & kOne) && a.stage) {
      for (int sq = row0 / a.tn.seq + static_cast<int>(threadIdx.x);
           sq <= last / a.tn.seq; sq += kMT)
        if (reflect::row_tenant(a.tn, sq * a.tn.seq) != t0) mixed = 1;
    }
    // every MMA warp is done with the ring, and `mixed` is whole
    asm volatile("bar.sync 1, %0;" ::"n"(kMT) : "memory");
    if (a.staged != nullptr && n0 == 0 && threadIdx.x == 0) {
      if (a.stage && !mixed) atomicAdd(a.staged, 1);
      atomicAdd(a.staged + 1, 1);
    }
    float lr[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) lr[i] = 0.f;
    if (a.stage && !mixed) {
      // the tile names tenant t0 alone: stage q_t0's r × TN tile (qs, j
      // rows of TN) and the tile's hs (hss, j rows of kRows) in the ring,
      // each read from global memory in its own order of addresses
      float* const qs = reinterpret_cast<float*>(ring);
      float* const hss = qs + r * TN;
      const float* const qt = a.q + t0 * a.q_ten;
      for (int e = threadIdx.x; e < r * TN; e += kMT) {
        const int j = a.q_c == 1 ? e / TN : e % r;
        const int c = a.q_c == 1 ? e % TN : e / r;
        const int col = n0 + c;
        qs[j * TN + c] =
            col < N ? __ldg(qt + static_cast<long long>(j) * a.q_j +
                            static_cast<long long>(col) * a.q_c)
                    : 0.f;
      }
      for (int e = threadIdx.x; e < kRows * r; e += kMT) {
        const int m = e / r, j = e % r;
        hss[j * kRows + m] =
            row0 + m < M
                ? __ldg(a.hs + static_cast<long long>(row0) * r + e)
                : 0.f;
      }
      asm volatile("bar.sync 1, %0;" ::"n"(kMT) : "memory");
      for (int j = 0; j < r; ++j) {
        const float h0 = ok0 ? hss[j * kRows + rl0] : 0.f;
        const float h1 = ok1 ? hss[j * kRows + rl1] : 0.f;
        const float* const qj = qs + j * TN + c0;
#pragma unroll
        for (int q = 0; q < TN / 8; ++q) {
          const float2 v = *reinterpret_cast<const float2*>(qj + 8 * q);
          lr[4 * q] = fmaf(h0, v.x, lr[4 * q]);
          lr[4 * q + 1] = fmaf(h0, v.y, lr[4 * q + 1]);
          lr[4 * q + 2] = fmaf(h1, v.x, lr[4 * q + 2]);
          lr[4 * q + 3] = fmaf(h1, v.y, lr[4 * q + 3]);
        }
      }
    } else {
      // rows of several tenants: each row's own q_t and hs from global
      // memory (the bank's rows stay in L2 across the tiles)
      const float* const q0 = a.q + (ok0 ? tenant_of(a, MODE, r0) : 0) *
                                        a.q_ten;
      const float* const q1 = a.q + (ok1 ? tenant_of(a, MODE, r1) : 0) *
                                        a.q_ten;
      const float* const hm0 = a.hs + static_cast<long long>(ok0 ? r0 : 0) * r;
      const float* const hm1 = a.hs + static_cast<long long>(ok1 ? r1 : 0) * r;
      for (int j = 0; j < r; ++j) {
        const float h0 = ok0 ? __ldg(hm0 + j) : 0.f;
        const float h1 = ok1 ? __ldg(hm1 + j) : 0.f;
        const long long qj = static_cast<long long>(j) * a.q_j;
#pragma unroll
        for (int q = 0; q < TN / 8; ++q) {
          const long long cc = n0 + c0 + 8 * q;
          if (cc >= N) continue;  // N is a multiple of 8: the pair is inside
          const long long o0 = qj + cc * a.q_c, o1 = o0 + a.q_c;
          if (ok0) {
            lr[4 * q] = fmaf(h0, __ldg(q0 + o0), lr[4 * q]);
            lr[4 * q + 1] = fmaf(h0, __ldg(q0 + o1), lr[4 * q + 1]);
          }
          if (ok1) {
            lr[4 * q + 2] = fmaf(h1, __ldg(q1 + o0), lr[4 * q + 2]);
            lr[4 * q + 3] = fmaf(h1, __ldg(q1 + o1), lr[4 * q + 3]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] += lr[i];
  }

  const float* c0row = nullptr;
  const float* c1row = nullptr;
  if constexpr ((MODE & kColScale) != 0) {
    // each row's own tenant's column scales
    c0row = a.c + static_cast<long long>(ok0 ? tenant_of(a, MODE, r0) : 0) * N;
    c1row = a.c + static_cast<long long>(ok1 ? tenant_of(a, MODE, r1) : 0) * N;
  }
#pragma unroll
  for (int q = 0; q < TN / 8; ++q) {
    const int cc = n0 + c0 + 8 * q;
    if (cc >= N) continue;  // N is a multiple of 8: the pair is inside
    float y00 = acc[4 * q], y01 = acc[4 * q + 1];
    float y10 = acc[4 * q + 2], y11 = acc[4 * q + 3];
    if constexpr ((MODE & kColScale) != 0) {
      const float2 s0 = __ldg(reinterpret_cast<const float2*>(c0row + cc));
      const float2 s1 = __ldg(reinterpret_cast<const float2*>(c1row + cc));
      y00 *= s0.x, y01 *= s0.y, y10 *= s1.x, y11 *= s1.y;
    }
    if (ok0)
      *reinterpret_cast<__nv_bfloat162*>(a.y + static_cast<long long>(r0) * N +
                                         cc) = __floats2bfloat162_rn(y00, y01);
    if (ok1)
      *reinterpret_cast<__nv_bfloat162*>(a.y + static_cast<long long>(r1) * N +
                                         cc) = __floats2bfloat162_rn(y10, y11);
  }
}

// HyperAdapt's prologue on the eight elements of x at e: v = x·r in f32,
// written as bf16 hi = bf16(v) and lo = bf16(v − hi) in a plane M·K
// further.  hi + lo holds v to 16 bits: the product of the two planes with
// W misses x⊙r·W by 2^-17 of a term, where hi alone (bf16) would by 2^-9.
__device__ __forceinline__ void scale_chunk(const bf16* __restrict__ x,
                                            const float* __restrict__ rt,
                                            bf16* __restrict__ xr,
                                            long long e, long long mk) {
  const float4 ra = __ldg(reinterpret_cast<const float4*>(rt));
  const float4 rc = __ldg(reinterpret_cast<const float4*>(rt + 4));
  const float rv[8] = {ra.x, ra.y, ra.z, ra.w, rc.x, rc.y, rc.z, rc.w};
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(x + e));
  const __nv_bfloat162* const xp =
      reinterpret_cast<const __nv_bfloat162*>(&raw);
  uint4 hi, lo;
  __nv_bfloat162* const hp = reinterpret_cast<__nv_bfloat162*>(&hi);
  __nv_bfloat162* const lp = reinterpret_cast<__nv_bfloat162*>(&lo);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 v = __bfloat1622float2(xp[q]);
    const float v0 = v.x * rv[2 * q], v1 = v.y * rv[2 * q + 1];
    hp[q] = __floats2bfloat162_rn(v0, v1);
    const float2 h = __bfloat1622float2(hp[q]);
    lp[q] = __floats2bfloat162_rn(v0 - h.x, v1 - h.y);
  }
  *reinterpret_cast<uint4*>(xr + e) = hi;
  *reinterpret_cast<uint4*>(xr + mk + e) = lo;
}

// The bank's prologue: v = x[m, k]·r_t[k], t = row m's tenant (read on
// the device), eight k a thread; K a multiple of 8, x and the bank
// 16-byte aligned (the route's rule).
__global__ void __launch_bounds__(256)
    scale_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ rb,
                      bf16* __restrict__ xr, Tenants tn, int M, int K) {
  const long long e = (static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x) * 8;
  if (e >= static_cast<long long>(M) * K) return;
  const int m = static_cast<int>(e / K), k = static_cast<int>(e % K);
  scale_chunk(x, rb + static_cast<long long>(reflect::row_tenant(tn, m)) * K +
                     k,
              xr, e, static_cast<long long>(M) * K);
}

// The single tenant's: r (K,), no ids.
__global__ void __launch_bounds__(256)
    scale_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ r,
                      bf16* __restrict__ xr, int M, int K) {
  const long long e = (static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x) * 8;
  if (e >= static_cast<long long>(M) * K) return;
  scale_chunk(x, r + e % K, xr, e, static_cast<long long>(M) * K);
}

// DeLoRA's prologue: hs[m, j] = fl32(Σ_k x[m, k]·p_t[k, j])·s_t[j], t = row
// m's tenant, p_t[k, j] = p[t·p_ten + k·p_k + j·p_j] f32, s (A, r) bf16.
// A block takes one row and eight ranks j0 .. j0 + 7 and sums in f64,
// where every product of a bf16 and an f32 is exact: each thread its own
// k in ascending order, then the threads of a rank in a fixed order (a
// butterfly over a warp's lanes, then the eight warps in turn), and the
// sum is rounded to f32 once, so h is the f32 nearest Σ_k x·p but where
// the f64 sum itself rounds (2^-53 of a term), whatever the rows beside
// it; then ·s in f32, as the JAX kernel's h_ref·s.  The kernel is bound by
// its load instructions, so each load moves 16 bytes of p where the layout
// lets it:
//  * !KMAJOR, the forward's p = a (A, K, r): two threads a k, each four
//    ranks (one float4 where r % 4 == 0, else four masked loads), 128 k a
//    block a step, kHUnroll steps of loads before their products.
//  * KMAJOR, dx's p = b (A, r, K), read along its rows: a thread four
//    consecutive k of all eight ranks (a uint2 of x, a float4 a rank; K %
//    8 == 0 by the route's rule).
// One scalar load of x and of p a product (a thread a k residue and a
// rank) took 1.6-3× as long at a train call (PERF.md §6).
constexpr int kHThreads = 256;
constexpr int kHUnroll = 4;

template <bool KMAJOR>
__global__ void __launch_bounds__(kHThreads)
    lowrank_h_kernel(const bf16* __restrict__ x, const float* __restrict__ p,
                     long long p_ten, int p_k, int p_j,
                     const bf16* __restrict__ s, float* __restrict__ hs,
                     Tenants tn, int M, int K, int r) {
  __shared__ double part[kHThreads / 32][8];
  const int groups = (r + 7) / 8;
  const int m = static_cast<int>(blockIdx.x) / groups;
  const int j0 = static_cast<int>(blockIdx.x) % groups * 8;
  const int js = min(8, r - j0);  // live ranks
  const int t = reflect::row_tenant(tn, m);
  const float* const pt = p + t * p_ten + static_cast<long long>(j0) * p_j;
  const bf16* const xm = x + static_cast<long long>(m) * K;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  double h[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if constexpr (KMAJOR) {
    for (int kb = 4 * threadIdx.x; kb < K; kb += 4 * kHThreads) {
      const uint2 raw = __ldg(reinterpret_cast<const uint2*>(xm + kb));
      const __nv_bfloat162* const x2 =
          reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 xa = __bfloat1622float2(x2[0]);
      const float2 xb = __bfloat1622float2(x2[1]);
      const float xv[4] = {xa.x, xa.y, xb.x, xb.y};
      float4 pv[8];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        pv[jj] = jj < js ? __ldg(reinterpret_cast<const float4*>(
                               pt + static_cast<long long>(jj) * p_j + kb))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float pk[4] = {pv[jj].x, pv[jj].y, pv[jj].z, pv[jj].w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
          h[jj] = fma(static_cast<double>(xv[u]), static_cast<double>(pk[u]),
                      h[jj]);
      }
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
        h[jj] += __shfl_xor_sync(0xffffffffu, h[jj], off);
    if (lane == 0)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) part[warp][jj] = h[jj];
  } else {
    const int half = threadIdx.x % 2, kr = threadIdx.x / 2;
    const int q0 = 4 * half;             // this thread's first rank
    const bool vec = r % 4 == 0;         // a float4 of p_t[k, j0 + q0 ..]
    const float* const ph = pt + q0;
    for (int kb = kr; kb < K; kb += kHThreads / 2 * kHUnroll) {
      float xv[kHUnroll], pv[kHUnroll][4];
#pragma unroll
      for (int u = 0; u < kHUnroll; ++u) {
        const int k = kb + kHThreads / 2 * u;
        const bool in = k < K;
        xv[u] = in ? __bfloat162float(xm[k]) : 0.f;
        const float* const pk = ph + static_cast<long long>(in ? k : 0) * p_k;
        if (vec && in && q0 < js) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(pk));
          pv[u][0] = v.x, pv[u][1] = v.y, pv[u][2] = v.z, pv[u][3] = v.w;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            pv[u][q] = in && q0 + q < js ? __ldg(pk + q) : 0.f;
        }
      }
      // k in ascending order (a k past K adds an exact zero)
#pragma unroll
      for (int u = 0; u < kHUnroll; ++u)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          h[q] = fma(static_cast<double>(xv[u]), static_cast<double>(pv[u][q]),
                     h[q]);
    }
    // the warp's sixteen k of each rank, then the warps in order
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int off = 2; off < 32; off <<= 1)
        h[q] += __shfl_xor_sync(0xffffffffu, h[q], off);
    if (lane < 2)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[warp][4 * lane + q] = h[q];
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < js) {
    double sum = part[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kHThreads / 32; ++w) sum += part[w][threadIdx.x];
    const int j = j0 + threadIdx.x;
    hs[static_cast<long long>(m) * r + j] =
        static_cast<float>(sum) *
        __bfloat162float(s[static_cast<long long>(t) * r + j]);
  }
}

// lowrank_h_kernel's grid on M rows at rank r.
inline unsigned lowrank_h_blocks(int M, int r) {
  return static_cast<unsigned>(M) * ((r + 7) / 8);
}

// The tensor-map cache of the including library.
inline MapCache& map_cache() {
  static MapCache cache;
  return cache;
}

template <int TN, int WT, int MODE>
cudaError_t launch_tiles(const void* x, const void* w, Args a,
                         cudaStream_t s) {
  constexpr int kPlanes = kPlanesOf<MODE>;
  using T = Tile<TN, kPlanes>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  // x's box: a 128-row tile, or at decode its rows rounded up to 8
  const int x_rows = T::kDecode ? (a.M + 7) / 8 * 8 : T::kARows;
  if (x_rows > T::kARows) return cudaErrorInvalidValue;
  CUtensorMap tma_x, tma_w;
  const uint64_t x_dims[3] = {static_cast<uint64_t>(a.K),
                              static_cast<uint64_t>(a.M), kPlanes};
  const uint32_t x_box[3] = {kBK, static_cast<uint32_t>(x_rows), 1};
  const uint64_t w_dims[2] = {
      static_cast<uint64_t>(WT == kWN ? a.N : a.K),
      static_cast<uint64_t>(WT == kWN ? a.K : a.N)};
  const uint32_t w_box[2] = {64, WT == kWN ? 64u : static_cast<uint32_t>(TN)};
  if (!map_cache().get(enc, &tma_x, x, 3, x_dims, x_box) ||
      !map_cache().get(enc, &tma_w, w, 2, w_dims, w_box))
    return cudaErrorNotSupported;
  static bool sized[kMaxDevices] = {};
  const cudaError_t err =
      reserve_smem(gemm_kernel<TN, WT, MODE>, T::kSmemBytes, sized);
  if (err != cudaSuccess) return err;
  a.x_bytes = x_rows * 128;
  const long long blocks = static_cast<long long>((a.M + T::kRows - 1) /
                                                  T::kRows) *
                           ((a.N + TN - 1) / TN);
  gemm_kernel<TN, WT, MODE>
      <<<static_cast<unsigned>(blocks), T::kThreads, T::kSmemBytes, s>>>(
          tma_x, tma_w, a);
  return cudaGetLastError();
}

// gemm_kernel's launch on W bf16 and x bf16, x itself (kLowRank) or x⊙r's
// (2, M, K) hi and lo planes after the prologue: the decode tile at M ≤
// kDecodeRows, else the 128-wide one.
template <int WT, int MODE>
cudaError_t launch(const void* x, const void* w, const Args& a,
                   cudaStream_t s) {
  if (a.M <= kDecodeRows) return launch_tiles<64, WT, MODE>(x, w, a, s);
  return launch_tiles<128, WT, MODE>(x, w, a, s);
}

// launch<MODE> in W's layout (w_t: kWK).
template <int MODE>
cudaError_t launch(const void* x, const void* w, int w_t, const Args& a,
                   cudaStream_t s) {
  return w_t ? launch<kWK, MODE>(x, w, a, s) : launch<kWN, MODE>(x, w, a, s);
}

// scale_rows_kernel's grid on M·K elements, eight a thread.
inline unsigned scale_blocks(int M, int K) {
  const long long chunks = static_cast<long long>(M) * K / 8;
  return static_cast<unsigned>((chunks + 255) / 256);
}

// What the core takes (the host's rule, householder_gemm.wgmma_takes at
// n = 0, checked again here): K and N multiples of 8 (TMA's 16-byte
// strides), the operands 16-byte aligned.
inline bool takes(int K, int N, const void* const* ptrs, int count) {
  uintptr_t bits = 0;
  for (int i = 0; i < count; ++i)
    bits |= reinterpret_cast<uintptr_t>(ptrs[i]);
  return K % 8 == 0 && N % 8 == 0 && bits % 16 == 0;
}

}  // namespace
}  // namespace sw
