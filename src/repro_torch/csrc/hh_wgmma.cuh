// The wgmma core of the reflected forwards, shared by householder_gemm.cu
// (rank 1, one set of hyperplanes), etherplus_gemm.cu (ETHER+'s rank 2,
// with its output-side H̃⁺ in the epilogue) and householder_gemm_batched.cu
// (rank 1, a bank: each sequence's tenant's hyperplanes), for sm_90a.
//
// The rank-n form.  With P[t, i] = x_t,i · û_i (and Q[t, i] = x_t,i · v̂_i)
// the block projections of x that the prologue of reflect_common.cuh
// writes (launch_proj), and U[i, :] = û_iᵀ W_i, V[i, :] = v̂_iᵀ W_i (n × N):
//
//   R(x)·W  = x·W − 2·P·U                  (rank 1: I − 2ûûᵀ)
//   H⁺(x)·W = x·W − P·U + Q·V              (rank 2: I − ûûᵀ + v̂v̂ᵀ, both
//                                           projections of the original x)
//
// It is exact algebra block by block.  The tensor cores multiply the
// stored bf16 x and W, whose products are exact in f32, and sum in f32; P,
// Q, U and V are f32; the epilogue adds the correction (n or 2n FMAs an
// output) to the f32 sum and rounds y once.  So the reflected x is never
// rounded to bf16, but y comes from two f32 sums of comparable size rather
// than one over the reflected x: at the train step's shapes 0.07-0.16% of
// outputs land one bf16 step from the plain version's (PERF.md §6).
//
// U (and V) come from the W tiles the GEMM has already brought into
// shared memory: two U warpgroups beside the MMA warpgroups read each
// stage of a block's first row tile once the TMA has filled it and sum
// u[k]·W[k, col] (and v[k]·W[k, col]: each W value they read feeds both)
// on the CUDA cores while the tensor cores run the products.  The 64 rows
// of a K step are cut into kParts parts: four quarters of 16 rows at rank
// 1, two halves of 32 rows (two 16-row chunks) at rank 2, so that the
// partials, kParts · rank · n · TN f32, stay 64 KB at n = 32 and TN = 128:
// four quarters of both directions would be 128 KB, past the 227 KB a
// block may have beside the 4-stage ring, which keeps its depth (halves
// are the budget's choice; a 3-stage ring the other).  A thread sums its
// part's rows of kCols adjacent columns in k order, one partial a block i
// and part in shared memory.
// After the last K tile the parts are added in order and divided by
// ‖u_i‖ + ε, and the MMA warps take U at a named barrier.  Every order of
// summation (the 16-deep k chunks of the MMA, a part's rows, the parts,
// the blocks of the epilogue) is fixed by K alone, so a row's y does not
// depend on M, on the route or on the rows beside it, and two calls agree
// bit for bit (the trainer's bitwise restore needs that).
//
// The GEMM: TN-wide output tiles, a ring of stages in shared memory under
// the 128-byte swizzle, each stage one or more 64-deep K tiles.  One
// producer warp issues the TMA loads (cp.async.bulk.tensor: one box of x
// and ⌈TN/64⌉ boxes of W a K tile, since a swizzled box is at most 64 bf16
// wide, and a bulk copy of the stage's u, and v) and arms each stage's
// "full" mbarrier with its bytes; the MMA warpgroups, 64 rows each, wait
// on it, issue four wgmma.mma_async m64nTNk16 a K tile (A K-major; B
// N-major, through the transpose bit bf16 allows) and free the stage on
// its "empty" mbarrier once the next stage's products are issued; the U
// warps free it once they have read it.  TMA fills rows and columns past M, N
// and K with zeros; the epilogue masks its stores.
//
// Tiles (template TN):
//  * 128: 128 rows × 128 columns, two MMA warpgroups, 4 stages of one K
//    tile.  A block takes up to kMaxRowTiles row tiles of one column tile
//    (as many as keep kWaves waves of blocks on the card) and forms U in
//    the first alone; the blocks that run at once share their x and W
//    tiles in the 50 MB L2.
//  * 64 (rank 1 at decode, M ≤ 16): one MMA warpgroup, 4 stages of four K
//    tiles (16 rows of x and 64 of W each).  A decode step is bound by
//    reading W: the narrower tile gives twice the blocks and four K tiles a
//    stage spread each stage's fixed costs over 32 KB of W.  The wgmma
//    still reads 64 rows: those past the 16 of x fall on the W boxes
//    behind them and give rows of the product that are never stored.
// A block has 96 registers a thread (five warpgroups' worth: the producer
// warp counts as one), too few for the 80 accumulators of a 160-column
// tile: ptxas spilled and serialized its wgmma, and such tiles ran
// ETHER+'s two-sided gate/up slower than 128-wide ones with the scratch
// epilogue (PERF.md §6).
//
// Epilogues (template EPI):
//  * kNone: y from the corrected accumulators, rounded once.
//  * kFused (ETHER+'s two-sided H̃⁺ where the 128-column tile's whole
//    output blocks fill most of it): column tiles start on block
//    boundaries and hold nb whole output blocks (kernels/etherplus_gemm.py,
//    column_tiles): W's boxes start at the tile's first column, which must
//    lie on 16 bytes (a multiple of 8 columns), and the columns past the
//    last whole block are computed and dropped.  The MMA
//    warps form the tile's unit hyperplanes û2, v̂2 while the first boxes
//    are in flight.  Once the
//    products and the correction are done the ring is free (a fused block
//    takes one row tile): the f32 accumulators go there, each row padded
//    by a word; a thread a (row, block) forms the dots a = y0·û2 and b =
//    y0·v̂2 over the block's columns in order (an order set by db_out
//    alone); then y = y0 − a·û2 + b·v̂2 is rounded once and stored, a warp
//    along a row.
//  * kScratch (the other two-sided calls): the corrected f32 y0 into an
//    (M, N) scratch; etherplus_gemm.cu's rank2_rows_kernel applies H̃⁺ and
//    rounds.
//
// A bank (template BANK) takes the grid of the JAX kernel, whose row
// tiles never straddle sequences: each sequence of S rows has ⌈S/128⌉ row
// tiles of its own, the last one ragged; the rows of a box past its
// sequence are computed and never stored.  A tile's tenant is row_tenant
// of its first row, read on the device (the wrapper never synchronises to
// read the ids); the producer bulk-loads that tenant's u and the U warps
// divide by that tenant's norms, which the bank prologue writes per row.
// A bank block takes one row tile, so it forms U for its own tenant (row
// 1's rule takes one row tile a block too at every bank shape the paths
// run, B·S ≤ 2,048).  With every id naming one tenant the bank's sums are
// the single-tenant kernel's, in the same order, so y is bitwise the
// same: the two prologues sum each norm and projection in one order.
#pragma once

#include <cuda.h>
#include <stdint.h>

#include "hopper.cuh"
#include "reflect_common.cuh"

namespace hhw {
// Internal linkage throughout: three libraries include this header, and a
// function-local static of a template with external linkage (reserve_smem's
// `sized`, the map cache) would be one object for the whole process, so a
// second library would skip its own kernel's shared-memory attribute.
namespace {

using namespace hopper;
using reflect::Tenants;
using bf16 = __nv_bfloat16;

constexpr int kBK = 64;           // K step: one 128-byte swizzled bf16 row
constexpr int kBox = 64 * 128;    // one 64-row × 64-column bf16 box, 8 KB
constexpr int kMaxRowTiles = 4;   // row tiles a block takes, at most
constexpr int kSMs = 132, kWaves = 4;
constexpr int kMaxBlocks = 32;    // the largest n it takes
constexpr int kMaxOut = 16;       // output blocks a fused tile holds
constexpr int kUT = 256;          // U threads: two warpgroups

enum Epi { kNone = 0, kFused = 1, kScratch = 2 };

// The shape of a tile of TN columns at `RANK`.
template <int TN, int RANK>
struct Tile {
  static_assert(TN == 64 || TN == 128, "tiles: 64 or 128 columns");
  static constexpr bool kDecode = TN == 64;
  static constexpr int kSub = kDecode ? 4 : 1;       // K tiles a stage
  static constexpr int kARows = kDecode ? 16 : 128;  // rows of x a stage
  static constexpr int kRows = kDecode ? 64 : 128;   // rows of a row tile
  static constexpr int kMmaWarps = kDecode ? 4 : 8;  // 64 rows a warpgroup
  static constexpr int kMT = 32 * kMmaWarps;         // MMA threads
  static constexpr int kThreads = kMT + kUT + 32;    // and U, producer
  static constexpr int kBoxes = TN / 64;             // W boxes a K tile
  static constexpr int kStages = 4;
  static constexpr int kParts = RANK == 1 ? 4 : 2;   // U's partial sums
  static constexpr int kChunks = 4 / kParts;         // 16-row chunks a part
  static constexpr int kTP = kUT / kParts;           // U threads a part
  static constexpr int kCols = TN / kTP;              // columns a U thread
  static constexpr int kATile = kARows * 128;        // rows × 64 k × 2 B
  static constexpr int kSubBytes = kATile + kBoxes * kBox;
  static constexpr int kStageBytes = kSub * kSubBytes;
  static constexpr int kStageK = kSub * kBK;         // K rows a stage
  static constexpr int kAcc = TN / 2;                // f32 accumulators
  static constexpr int kPitch = TN + 1;              // fused: a row's words
  static_assert(kTP * kCols == TN, "U threads cover TN");
  // Dynamic shared memory: the ring (an A tile and the W boxes a K tile),
  // each stage's kStageK values of u (and v), its 2·stages mbarriers, U's
  // partials (kParts · RANK · n · TN f32), under kFused the tile's û2, v̂2
  // and block norms, and room to align the ring to the swizzle's 1024
  // bytes.
  static __host__ __device__ constexpr int smem_bytes(int n, bool fused) {
    return kStages * (kStageBytes + RANK * 4 * kStageK + 16) +
           kParts * RANK * n * TN * 4 +
           (fused ? 4 * (2 * TN + 2 * kMaxOut) : 0) + 1024;
  }
};

struct Args {
  const float* u;       // (n, db) raw hyperplanes, or an (A, n, db) bank
  const float* v;       // ETHER+'s second hyperplanes (rank 2)
  const float* p;       // (M, n): the prologue's P, Q
  const float* q;
  const float* unorm;   // (n) block norms, or (M, n) a row under BANK
  const float* vnorm;
  const float* u2;      // (n_out, db_out) raw output-side hyperplanes
  const float* v2;      // (kFused)
  bf16* y;              // (M, N)
  float* yacc;          // (M, N) f32: kScratch's y0
  int M, K, N, n, db;
  int nb, db_out, n_out;  // kFused: whole output blocks a column tile
  int seq, seq_tiles;     // BANK: rows a sequence, row tiles a sequence
  int mt;                 // row tiles a block
  int x_bytes;            // bytes of one box of x
  Tenants tn;
};

// The first row of row tile rt and its rows that are stored: one of each
// sequence's own row tiles under BANK (seq = M, one sequence, otherwise).
template <int TN, int RANK, bool BANK>
__device__ __forceinline__ void tile_rows(const Args& a, int rt, int& row0,
                                          int& lim) {
  constexpr int kRows = Tile<TN, RANK>::kRows;
  if constexpr (BANK) {
    const int in_seq = rt % a.seq_tiles * kRows;
    row0 = rt / a.seq_tiles * a.seq + in_seq;
    lim = min(kRows, a.seq - in_seq);
  } else {
    row0 = rt * kRows;
    lim = a.M - row0;
  }
}

// y (or y0) = x·W − 2·P·U (rank 1) or x·W − P·U + Q·V (rank 2), tile by
// tile; x by tma_x (dims {K, M}, box 64 × rows), W by tma_w (dims {N, K},
// box 64 × 64), both 128-byte swizzled.  Warps: the MMA warpgroups (64
// rows each), two U warpgroups, one producer warp.  Block b takes the
// column tile b / groups and the row tiles mt·(b % groups) .. + mt − 1,
// groups = ⌈tiles_m / mt⌉: it forms U once, in its first row tile.
template <int TN, int RANK, bool BANK, int EPI>
__global__ void __launch_bounds__(Tile<TN, RANK>::kThreads, 1)
    wgmma_kernel(const __grid_constant__ CUtensorMap tma_x,
                 const __grid_constant__ CUtensorMap tma_w, const Args a) {
  using T = Tile<TN, RANK>;
  static_assert(RANK == 1 || RANK == 2, "rank 1 or 2");
  static_assert(!(BANK && RANK == 2), "the bank is rank 1");
  static_assert(EPI == kNone || RANK == 2, "H̃⁺ is ETHER+'s");
  static_assert(!T::kDecode || (RANK == 1 && !BANK), "decode: row 1's");
  constexpr int kMmaWarps = T::kMmaWarps, kMT = T::kMT;
  constexpr int kCols = T::kCols, kSub = T::kSub, kStages = T::kStages;
  constexpr int kStageBytes = T::kStageBytes, kStageK = T::kStageK;
  constexpr int kSubBytes = T::kSubBytes, kATile = T::kATile;
  constexpr int kAcc = T::kAcc;
  const int n = a.n, M = a.M, K = a.K, N = a.N, db = a.db;

  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the swizzle repeats every 1024 bytes: tiles start on that boundary
  const uint32_t pad = ((smem_addr(smem_raw) + 1023u) & ~1023u) -
                       smem_addr(smem_raw);
  uint8_t* const ring = smem_raw + pad;
  const uint32_t base = smem_addr(ring);
  // each stage's kStageK values of u, then of v (the first row tile's
  // steps only)
  float* const uring = reinterpret_cast<float*>(ring + kStages * kStageBytes);
  float* const vring = uring + kStages * kStageK;
  const uint32_t bars = smem_addr(uring + RANK * kStages * kStageK);
  // us[((part·RANK + dir)·n + i)·TN + c]: a part's partial of U[i, n0 + c]
  // (dir 0) or V (dir 1)
  float* const us = uring + RANK * kStages * kStageK + 4 * kStages;
  // kFused: the tile's û2 and v̂2 at each column, the blocks' norms
  float* const uh2 = us + T::kParts * RANK * n * TN;
  float* const vh2 = uh2 + TN;
  float* const nrm2 = vh2 + TN;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };

  const int tiles_m = BANK ? M / a.seq * a.seq_tiles
                           : (M + T::kRows - 1) / T::kRows;
  const int groups = (tiles_m + a.mt - 1) / a.mt;
  const int first_m = static_cast<int>(blockIdx.x) % groups * a.mt;
  const int count_m = min(a.mt, tiles_m - first_m);
  const int ct = static_cast<int>(blockIdx.x) / groups;
  int n0 = ct * TN, cols = TN, nbc = 0;
  if constexpr (EPI == kFused) {
    nbc = min(a.nb, a.n_out - ct * a.nb);
    n0 = ct * a.nb * a.db_out;
    cols = nbc * a.db_out;
  }
  const int k_tiles = (K + kBK - 1) / kBK;
  const int k_steps = (k_tiles + kSub - 1) / kSub;   // stages a row tile
  const int steps = count_m * k_steps;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int first_row, first_rows;
  tile_rows<TN, RANK, BANK>(a, first_m, first_row, first_rows);
  // the hyperplanes and norms of the block's tenant
  const long long bank =
      BANK ? static_cast<long long>(reflect::row_tenant(a.tn, first_row)) * K
           : 0;
  const float* const unorm =
      a.unorm + (BANK ? static_cast<long long>(first_row) * n : 0);

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
        int row0, lim;
        tile_rows<TN, RANK, BANK>(a, first_m + mi, row0, lim);
        // the stage's previous round freed (the first round passes)
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        const int u_bytes = mi ? 0 : 4 * min(kStageK, K - k0);
        mbar_expect_tx(full(s),
                       subs * (a.x_bytes + T::kBoxes * kBox) + RANK * u_bytes);
        for (int j = 0; j < subs; ++j) {
          const uint32_t at = base + s * kStageBytes + j * kSubBytes;
          tma_load(at, &tma_x, full(s), k0 + j * kBK, row0);
#pragma unroll
          for (int c = 0; c < T::kBoxes; ++c)
            tma_load(at + kATile + c * kBox, &tma_w, full(s), n0 + 64 * c,
                     k0 + j * kBK);
        }
        if (u_bytes) {
          bulk_load(smem_addr(uring + s * kStageK), a.u + bank + k0, u_bytes,
                    full(s));
          if constexpr (RANK == 2)
            bulk_load(smem_addr(vring + s * kStageK), a.v + k0, u_bytes,
                      full(s));
        }
      }
    }
    return;
  }

  if (warp >= kMmaWarps) {
    // The U warps, two warpgroups: part q's threads sum rows
    // 16·kChunks·q .. + 16·kChunks − 1 of every K step of the first row
    // tile, each thread kCols adjacent columns, in k order into one partial
    // a block (stored when the rows cross into the next block), u and v
    // from the same W values; on later steps they only free the stages.
    const int ut = threadIdx.x - kMT;
    const int q = ut / T::kTP;
    const int col = kCols * (ut % T::kTP);
    float* const mine = us + q * RANK * n * TN + col;
    for (int i = 0; i < RANK * n; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) mine[i * TN + c] = 0.f;
    // the columns' byte offset in a stage, less their row's swizzle
    const int wofs = kATile + (col >> 6) * kBox + (col & 7) * 2;
    const int chunk = (col & 63) >> 3;
    int blk = 0, next = db;   // the block being summed and where it ends
    float sum[kCols], sv[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) sum[c] = sv[c] = 0.f;
    auto store = [&]() {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        mine[blk * TN + c] = sum[c];
        sum[c] = 0.f;
        if constexpr (RANK == 2) {
          mine[(n + blk) * TN + c] = sv[c];
          sv[c] = 0.f;
        }
      }
    };
    for (int it = 0; it < steps; ++it) {
      const int s = it % kStages;
      mbar_wait(full(s), (it / kStages) & 1);
      const int subs = it < k_steps ? min(kSub, k_tiles - it * kSub) : 0;
      for (int j = 0; j < subs; ++j) {
#pragma unroll
        for (int h = 0; h < T::kChunks; ++h) {
          const int roff = 16 * (q * T::kChunks + h);
          const int k0 = (it * kSub + j) * kBK + roff;
          const float* const u16 = uring + s * kStageK + j * kBK + roff;
          const float* const v16 = vring + s * kStageK + j * kBK + roff;
          const uint8_t* const st =
              ring + s * kStageBytes + j * kSubBytes + wofs + roff * 128;
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
            // values and u (v) values loaded first, then summed in k order
            float uk[16], vk[RANK == 2 ? 16 : 1], wv[16][kCols];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              *reinterpret_cast<float4*>(uk + 4 * i) =
                  reinterpret_cast<const float4*>(u16)[i];
              if constexpr (RANK == 2)
                *reinterpret_cast<float4*>(vk + 4 * i) =
                    reinterpret_cast<const float4*>(v16)[i];
            }
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
                for (int c = 0; c < kCols; ++c) {
                  sum[c] = fmaf(uk[r], wv[r][c], sum[c]);
                  if constexpr (RANK == 2)
                    sv[c] = fmaf(vk[r], wv[r][c], sv[c]);
                }
            } else {
              // without branches: a row adds u·w to its own block's sum
              // and an exact 0·w to the other's
              float t[kCols], tv[kCols];
#pragma unroll
              for (int c = 0; c < kCols; ++c) t[c] = tv[c] = 0.f;
#pragma unroll
              for (int r = 0; r < 16; ++r) {
                const float here = r < split ? uk[r] : 0.f;
                const float there = r < split ? 0.f : uk[r];
#pragma unroll
                for (int c = 0; c < kCols; ++c) {
                  sum[c] = fmaf(here, wv[r][c], sum[c]);
                  t[c] = fmaf(there, wv[r][c], t[c]);
                }
                if constexpr (RANK == 2) {
                  const float vhere = r < split ? vk[r] : 0.f;
                  const float vthere = r < split ? 0.f : vk[r];
#pragma unroll
                  for (int c = 0; c < kCols; ++c) {
                    sv[c] = fmaf(vhere, wv[r][c], sv[c]);
                    tv[c] = fmaf(vthere, wv[r][c], tv[c]);
                  }
                }
              }
              store();
#pragma unroll
              for (int c = 0; c < kCols; ++c) {
                sum[c] = t[c];
                sv[c] = tv[c];
              }
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
              for (int c = 0; c < kCols; ++c) {
                sum[c] = fmaf(u16[r], wv[c], sum[c]);
                if constexpr (RANK == 2) sv[c] = fmaf(v16[r], wv[c], sv[c]);
              }
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
      if (it == k_steps - 1) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          mine[blk * TN + c] = sum[c];
          if constexpr (RANK == 2) mine[(n + blk) * TN + c] = sv[c];
        }
        // U[i, c] = (((q0 + q1) + q2) + q3) / (‖u_i‖ + ε) (V likewise over
        // the halves), into part 0's slots, once every part is in (named
        // barrier 2, the U warps); then hand U to the MMA warps (barrier 1)
        asm volatile("bar.sync 2, %0;" ::"n"(kUT) : "memory");
        for (int e = threadIdx.x - kMT; e < RANK * n * TN; e += kUT) {
          float v = us[e];
#pragma unroll
          for (int qq = 1; qq < T::kParts; ++qq) v += us[qq * RANK * n * TN + e];
          if constexpr (RANK == 1) {
            us[e] = v / __ldg(unorm + e / TN);
          } else {
            const int i = e / TN;  // dir·n + block
            us[e] = v / __ldg(i < n ? unorm + i : a.vnorm + i - n);
          }
        }
        __threadfence_block();
        asm volatile("bar.arrive 1, %0;" ::"n"(kMT + kUT) : "memory");
      }
    }
    return;
  }

  const int g = warp / 4;  // MMA warpgroup: rows 64g .. of the row tile
  if constexpr (EPI == kFused) {
    // The tile's unit output hyperplanes while the first boxes are in
    // flight: each block's norms by a warp (as rank2_rows_kernel forms
    // them), then û2 and v̂2 at each of the tile's columns, 0 past its last
    // whole block.  The MMA warps alone: named barrier 3.
    const float* const u2 = a.u2 + n0;
    const float* const v2 = a.v2 + n0;
    for (int b = warp; b < nbc; b += kMmaWarps) {
      float su = 0.f, sw = 0.f;
      for (int j = lane; j < a.db_out; j += 32) {
        su = fmaf(u2[b * a.db_out + j], u2[b * a.db_out + j], su);
        sw = fmaf(v2[b * a.db_out + j], v2[b * a.db_out + j], sw);
      }
      su = reflect::warp_sum(su);
      sw = reflect::warp_sum(sw);
      if (lane == 0) {
        nrm2[b] = sqrtf(su) + reflect::kEps;
        nrm2[kMaxOut + b] = sqrtf(sw) + reflect::kEps;
      }
    }
    asm volatile("bar.sync 3, %0;" ::"n"(kMT) : "memory");
    for (int c = threadIdx.x; c < TN; c += kMT) {
      uh2[c] = c < cols ? u2[c] / nrm2[c / a.db_out] : 0.f;
      vh2[c] = c < cols ? v2[c] / nrm2[kMaxOut + c / a.db_out] : 0.f;
    }
  }
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
        const uint32_t at = base + s * kStageBytes + j * kSubBytes +
                            g * 64 * 128;
        const uint32_t b = base + s * kStageBytes + j * kSubBytes + kATile;
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks) {
          // A: 16 k (32 bytes) further along each 128-byte row, 8-row
          // groups 1024 bytes apart.  B: 16 k rows (2048 bytes) further,
          // 8-row groups 1024 bytes apart, the next 64-column box kBox on.
          WgmmaSS<TN, 1>::mma(acc, sw128_desc(at + ks * 32, 16, 1024),
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
    // U, from the U warpgroups
    if (mi == 0) asm volatile("bar.sync 1, %0;" ::"n"(kMT + kUT) : "memory");

    int row0, lim;
    tile_rows<TN, RANK, BANK>(a, first_m + mi, row0, lim);
    const int rl0 = g * 64 + (warp % 4) * 16 + lane / 4, rl1 = rl0 + 8;
    const bool ok0 = rl0 < lim, ok1 = rl1 < lim;
    const int r0 = row0 + rl0, r1 = row0 + rl1;
    const float* p0row = a.p + static_cast<long long>(r0) * n;
    const float* p1row = a.p + static_cast<long long>(r1) * n;
    for (int i = 0; i < n; ++i) {
      const float* ui = us + i * TN + c0;
      if constexpr (RANK == 1) {
        const float p0 = ok0 ? -2.f * p0row[i] : 0.f;
        const float p1 = ok1 ? -2.f * p1row[i] : 0.f;
#pragma unroll
        for (int j = 0; j < TN / 8; ++j) {
          const float2 cv = *reinterpret_cast<const float2*>(ui + 8 * j);
          acc[4 * j] = fmaf(p0, cv.x, acc[4 * j]);
          acc[4 * j + 1] = fmaf(p0, cv.y, acc[4 * j + 1]);
          acc[4 * j + 2] = fmaf(p1, cv.x, acc[4 * j + 2]);
          acc[4 * j + 3] = fmaf(p1, cv.y, acc[4 * j + 3]);
        }
      } else {
        const float* q0row = a.q + static_cast<long long>(r0) * n;
        const float* q1row = a.q + static_cast<long long>(r1) * n;
        const float p0 = ok0 ? -p0row[i] : 0.f, p1 = ok1 ? -p1row[i] : 0.f;
        const float q0 = ok0 ? q0row[i] : 0.f, q1 = ok1 ? q1row[i] : 0.f;
        const float* vi = ui + n * TN;
#pragma unroll
        for (int j = 0; j < TN / 8; ++j) {
          const float2 cu = *reinterpret_cast<const float2*>(ui + 8 * j);
          const float2 cv = *reinterpret_cast<const float2*>(vi + 8 * j);
          acc[4 * j] = fmaf(q0, cv.x, fmaf(p0, cu.x, acc[4 * j]));
          acc[4 * j + 1] = fmaf(q0, cv.y, fmaf(p0, cu.y, acc[4 * j + 1]));
          acc[4 * j + 2] = fmaf(q1, cv.x, fmaf(p1, cu.x, acc[4 * j + 2]));
          acc[4 * j + 3] = fmaf(q1, cv.y, fmaf(p1, cu.y, acc[4 * j + 3]));
        }
      }
    }
    if constexpr (EPI == kNone) {
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
        const int cc = n0 + c0 + 8 * j;
        if (cc >= N) continue;
        if (ok0)
          *reinterpret_cast<__nv_bfloat162*>(
              a.y + static_cast<long long>(r0) * N + cc) =
              __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
        if (ok1)
          *reinterpret_cast<__nv_bfloat162*>(
              a.y + static_cast<long long>(r1) * N + cc) =
              __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
      }
    } else if constexpr (EPI == kScratch) {
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
        const int cc = n0 + c0 + 8 * j;
        if (cc >= N) continue;
        if (ok0)
          *reinterpret_cast<float2*>(a.yacc + static_cast<long long>(r0) * N +
                                     cc) = make_float2(acc[4 * j],
                                                       acc[4 * j + 1]);
        if (ok1)
          *reinterpret_cast<float2*>(a.yacc + static_cast<long long>(r1) * N +
                                     cc) = make_float2(acc[4 * j + 2],
                                                       acc[4 * j + 3]);
      }
    } else {
      // H̃⁺ on the tile's whole output blocks.  Every product of both
      // warpgroups is done and the U warps have read every stage (they
      // handed U over after their last), so the ring is free: y0 goes
      // there in f32, rows past the tile's as zeros.
      constexpr int kPitch = T::kPitch;
      const int tid = threadIdx.x;
      asm volatile("bar.sync 3, %0;" ::"n"(kMT) : "memory");
      float* const sacc = reinterpret_cast<float*>(ring);  // [row][kPitch]
      float* const sdot = sacc + T::kRows * kPitch;        // [2][block][row]
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 8 * j + c0 + h;
          sacc[rl0 * kPitch + c] = ok0 ? acc[4 * j + h] : 0.f;
          sacc[rl1 * kPitch + c] = ok1 ? acc[4 * j + 2 + h] : 0.f;
        }
      }
      asm volatile("bar.sync 3, %0;" ::"n"(kMT) : "memory");
      // the block dots of each row: a thread a (row, block), consecutive
      // threads on consecutive rows, each dot over its block's columns in
      // order (an order set by db_out alone)
      for (int unit = tid; unit < nbc * T::kRows; unit += kMT) {
        const int r = unit % T::kRows, b = unit / T::kRows;
        float du = 0.f, dv = 0.f;
        for (int c = b * a.db_out; c < (b + 1) * a.db_out; ++c) {
          const float yv = sacc[r * kPitch + c];
          du = fmaf(yv, uh2[c], du);
          dv = fmaf(yv, vh2[c], dv);
        }
        sdot[b * T::kRows + r] = du;
        sdot[(kMaxOut + b) * T::kRows + r] = dv;
      }
      asm volatile("bar.sync 3, %0;" ::"n"(kMT) : "memory");
      // y = y0 − (y0·û2) û2 + (y0·v̂2) v̂2, rounded once: a warp along a row
      const int rows = min(lim, T::kRows);
      for (int e = tid; e < rows * TN; e += kMT) {
        const int r = e / TN, c = e % TN;
        if (c >= cols) continue;
        const int b = c / a.db_out;
        const float yv = fmaf(sdot[(kMaxOut + b) * T::kRows + r], vh2[c],
                              fmaf(-sdot[b * T::kRows + r], uh2[c],
                                   sacc[r * kPitch + c]));
        a.y[static_cast<long long>(row0 + r) * N + n0 + c] =
            __float2bfloat16(yv);
      }
    }
  }
}

// The tensor-map cache of the including library.
inline MapCache& map_cache() {
  static MapCache cache;
  return cache;
}

// wgmma_kernel's launch on x (M, K) and W (K, N) bf16, after the prologue
// has written a.p (a.q) and the norms.  a.mt is set here: one row tile a
// block under BANK and kFused (whose epilogue takes the ring), else as
// many as keep kWaves waves of blocks on the card, up to kMaxRowTiles.
template <int TN, int RANK, bool BANK, int EPI>
cudaError_t launch(const void* x, const void* w, Args a, cudaStream_t s) {
  using T = Tile<TN, RANK>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  // x's box: a 128-row tile, or at decode its rows rounded up to 8
  const int x_rows = T::kDecode ? (a.M + 7) / 8 * 8 : T::kARows;
  if (x_rows > T::kARows) return cudaErrorInvalidValue;
  CUtensorMap tma_x, tma_w;
  const uint64_t x_dims[2] = {static_cast<uint64_t>(a.K),
                              static_cast<uint64_t>(a.M)};
  const uint64_t w_dims[2] = {static_cast<uint64_t>(a.N),
                              static_cast<uint64_t>(a.K)};
  const uint32_t x_box[2] = {kBK, static_cast<uint32_t>(x_rows)};
  const uint32_t w_box[2] = {64, kBK};
  if (!map_cache().get(enc, &tma_x, x, 2, x_dims, x_box) ||
      !map_cache().get(enc, &tma_w, w, 2, w_dims, w_box))
    return cudaErrorNotSupported;
  static bool sized[kMaxDevices] = {};
  const cudaError_t err =
      reserve_smem(wgmma_kernel<TN, RANK, BANK, EPI>,
                   T::smem_bytes(kMaxBlocks, EPI == kFused), sized);
  if (err != cudaSuccess) return err;
  const int tiles_m = BANK ? a.M / a.seq * a.seq_tiles
                           : (a.M + T::kRows - 1) / T::kRows;
  const int tiles_n = EPI == kFused ? (a.n_out + a.nb - 1) / a.nb
                                    : (a.N + TN - 1) / TN;
  int mt = BANK || EPI == kFused ? 1 : kMaxRowTiles;
  while (mt > 1 && static_cast<long long>(tiles_n) * ((tiles_m + mt - 1) / mt)
                       < static_cast<long long>(kWaves) * kSMs)
    mt /= 2;
  a.mt = mt;
  a.x_bytes = x_rows * 128;
  const long long blocks =
      static_cast<long long>(tiles_n) * ((tiles_m + mt - 1) / mt);
  wgmma_kernel<TN, RANK, BANK, EPI>
      <<<static_cast<unsigned>(blocks), T::kThreads,
         T::smem_bytes(a.n, EPI == kFused), s>>>(tma_x, tma_w, a);
  return cudaGetLastError();
}

// What the wgmma core takes: n ≤ kMaxBlocks, K and N multiples of 8, and
// the operands 16-byte aligned.
inline bool takes(int K, int N, int n, const void* const* ptrs, int count) {
  uintptr_t bits = 0;
  for (int i = 0; i < count; ++i)
    bits |= reinterpret_cast<uintptr_t>(ptrs[i]);
  return n <= kMaxBlocks && K % 8 == 0 && N % 8 == 0 && bits % 16 == 0;
}

}  // namespace
}  // namespace hhw
