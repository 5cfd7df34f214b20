// The wgmma route of the dXr backward, shared by reflect_gemm_dx.cu (one
// set of hyperplanes, rank 1 or ETHER+'s rank 2) and
// householder_gemm_batched_bwd.cu (a bank: each sequence's tenant's), for
// sm_90a.  Under the cotangent G (M, N) of y = R(x)·W, W (K, N):
//
//   dXr = G · Wᵀ                                     (M, K) f32, never rounded
//   dx  = dXr + c_u (ûᵀdXr_t) û [+ c_v (v̂ᵀdXr_t) v̂]  per block, rounded once
//   ĝ_u = c_u Σ_t [(ûᵀx_t) dXr_t + (ûᵀdXr_t) x_t]    per block, f32
//
// c_u = −2 for the reflection I − 2ûûᵀ; ETHER+'s H⁺ = I − ûûᵀ + v̂v̂ᵀ takes
// c_u = −1, c_v = +1 (src/repro/kernels/gemm_bwd.py:60, _gemm_dx_kernel).
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s, the
// data sheet's rates at 700 W): the product, 2·M·N·K operations.  At
// smollm-360m's train step (M = 1024) down_proj's 1024×960×2560 is 5.0
// GFLOP, 5 µs on the tensor cores; its bytes (x, W, G, dx) 11 MB, 3 µs.
//
// The GEMM is the "TN" case that wgmma takes without a transpose: G is
// row-major along the reduction N (K-major in wgmma's terms) and W (K, N)
// keeps each output column k contiguous along N (K-major too).  A block
// computes one tile of dXr, 128 rows by TN = 128 or 160 columns: one
// producer warp issues the TMA boxes under the 128-byte swizzle (128 rows
// × 64 N of G, TN rows × 64 N of W) into a ring of kStages stages and arms
// each stage's "full" mbarrier; two consumer warpgroups (64 rows each)
// wait on it, issue an m64n128k16 wgmma (and at TN = 160 an m64n32k16 one
// on W's last 32 rows) four times a stage with f32 accumulators and free
// the stage on its "empty" mbarrier.  TMA fills past M, N and K with
// zeros.  One block sums all of N, in an order set by N alone, so two
// calls give the same bits (the trainer's bitwise restore needs that) and
// no split of N changes the sum.
//
// Two epilogues, chosen on the host by the reflection's block width db
// (kernels/reflect_gemm_dx.py, tile_width and blocks_per_tile):
//
// * fused (db ≤ 160): column tiles start on block boundaries and hold
//   nb = min(n, ⌊TN/db⌋, 16) whole blocks (TMA boxes may start at any row
//   k of W); TN is the width whose whole blocks fill more of it, 128 on a
//   tie, and its columns past the last whole block are computed and
//   dropped: db 30 keeps 120 of 128, db 80 160 of 160 (80 of 128 would
//   drop 37.5% of the products of smollm-360m's down_proj, and give twice
//   the blocks), db 120 120 of 128, db 128 128 of 128; a 240- or 256-wide
//   tile would hold more blocks but leave T = 1,024's grids of 32-64
//   blocks still emptier on 132 SMs.  The consumers load the tile's x
//   into registers (16 bytes a load) before the products, so it arrives
//   behind them.  Once both warpgroups' products are done the ring is
//   free: the f32 accumulators go there (rows past the tile's as zeros)
//   beside x, each row padded by a word so that a warp walking a column
//   hits 32 banks.  Then a thread a (row, block) forms the dots ûᵀx_t and
//   ûᵀdXr_t (a block wider than 64 splits each dot in two halves, added
//   in order); then a thread a (column, half of the rows) forms dx in
//   f32, rounds it once and stores it (a warp along a row, coalesced),
//   and sums ĝ over its rows in order; the halves are added in order into
//   one partial a (row tile, column) -- summed in order afterwards by
//   du_kernel (or, for a bank, seq_ghat_kernel and bank_chain_kernel).
//   Every one of these orders is set by db alone, not by the tile's
//   width, so a block's dx and ĝ have the same bits on either width (a
//   160-column tile that also split ĝ eight ways and db 80's dots not at
//   all moved the 8-step training of phase 14 past TRAIN_TOL: PERF.md,
//   PR 24).  dXr never goes to device memory.  No float atomics.
// * scratch (db > 160: 320 at n = 8 on d = 2560, 344 on Llama-2-7B's
//   down_proj): 128-column tiles store dXr in f32 to an (M, K) scratch
//   and reflect_common.cuh's reflect_bwd_kernel runs the reflection
//   backward, as the SIMT route does.  The same GEMM, on the tensor cores.
//
// A bank's row tiles never straddle two sequences: each sequence of S rows
// has ⌈S/128⌉ tiles of its own, the last one ragged; the rows of a box
// past its sequence are computed, zeroed before the epilogue and never
// stored, so they reach neither dx nor ĝ.  A tile's tenant is row_tenant
// of its first row, read on the device.
#pragma once

#include <cuda.h>
#include <stdint.h>

#include "hopper.cuh"
#include "reflect_common.cuh"

namespace dxr {
// Internal linkage throughout: two libraries include this header, and a
// function-local static of a template with external linkage (reserve_smem's
// `sized`, the map cache) would be one object for the whole process, so
// the second library would skip its own kernel's shared-memory attribute.
namespace {

using namespace hopper;
using reflect::Tenants;
using bf16 = __nv_bfloat16;

constexpr int kRows = 128;                 // rows of a tile
constexpr int kWide = 160;                 // the widest tile's columns
constexpr int kBK = 64;                    // N step: a 128-byte bf16 row
constexpr int kStages = 4;
constexpr int kGBox = kRows * 128;         // 128 rows × 64 bf16 of G, 16 KB
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kWarps = kConsumers / 32;
constexpr int kMaxBlocks = 16;             // blocks a fused tile holds
// ĝ's partial sums a column: over the two halves of the tile's rows
// (alternate rows), added in order
constexpr int kParts = 2;

// A tile of TN columns (128, or 160 where it drops fewer of its columns:
// db 80) and its shared memory: the ring (a G box and TN rows of W a
// stage), then the fused epilogue's rows of dXr (f32) and of x (bf16) in
// the freed ring, one word past each row so that a warp walking down a
// column hits 32 banks.
template <int TN>
struct Tile {
  static_assert(TN == 128 || TN == kWide, "tiles are 128 or 160 wide");
  static constexpr int kWBytes = TN * 128;
  static constexpr int kStageBytes = kGBox + kWBytes;
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kPitch = TN + 1;
  static constexpr int kPitchX = TN + 2;
  static constexpr int kXLoads = kRows * TN / 8 / kConsumers;  // 16 B each
  static_assert(kRows * (4 * kPitch + 2 * kPitchX) <= kRing,
                "dXr and x fit the ring");
  // the ring aligned to the swizzle's 1024 bytes, its 2·kStages
  // mbarriers, the unit hyperplanes and block norms (u and v), the rows'
  // block dots, ĝ's parts (u and v)
  static constexpr int smem_bytes() {
    return 1024 + kRing + 16 * kStages + 4 * 4 * kWide +
           4 * 4 * kMaxBlocks * kRows + 4 * 2 * kParts * TN;
  }
};

// Partial rows of ĝ a direction: one a (row tile, column) of the fused
// epilogue, or reflect_bwd_kernel's kRowsPerTile-row tiles; each of the
// M / seq sequences has its own.
inline int part_rows(int M, int seq, bool fused) {
  const int tiles = fused ? (seq + kRows - 1) / kRows : reflect::row_tiles(seq);
  return M / seq * tiles;
}

struct Args {
  const bf16* x;
  const float* u;     // (n, db) raw hyperplanes, or an (A, n, db) bank
  const float* v;     // ETHER+'s second hyperplanes, or null
  bf16* dx;
  float* dxr;         // (M, K) f32: the scratch epilogue's output
  float* part_u;      // (part_rows, K) f32: the fused epilogue's ĝ
  float* part_v;
  int M, K, N, n, db;
  int nb;             // whole blocks a column tile (fused), else 0
  int seq, seq_tiles;  // rows a sequence, row tiles a sequence
  Tenants tn;
};

// d (64×TN, the warpgroup's accumulators) += A · B over one k16 step: an
// m64n128k16 product, and at TN = 160 an m64n32k16 one on W's last 32
// rows (their accumulators d[64 ..] continue the fragment's columns).
template <int TN>
__device__ __forceinline__ void mma_step(float (&d)[TN / 2], uint64_t a,
                                         uint32_t b) {
  WgmmaSS<128, 0>::mma(*reinterpret_cast<float(*)[64]>(d), a,
                       sw128_desc(b, 16, 1024), 1);
  if constexpr (TN == kWide)
    WgmmaSS<32, 0>::mma(*reinterpret_cast<float(*)[16]>(d + 64), a,
                        sw128_desc(b + 128 * 128, 16, 1024), 1);
}

// One 128×TN tile of dXr = G·Wᵀ a block: tma_g over G (dims {N, M}, box
// 64 × 128), tma_w over W (dims {N, K}, box 64 × TN); then the fused
// epilogue (FUSED) or dXr into a.dxr.  Block b takes row tile b % tiles
// and column tile b / tiles, tiles = (M / seq)·seq_tiles.
template <bool FUSED, bool RANK2, bool BANK, int TN>
__global__ void __launch_bounds__(kThreads, 1)
    wgmma_kernel(const __grid_constant__ CUtensorMap tma_g,
                 const __grid_constant__ CUtensorMap tma_w, const Args a) {
  static_assert(FUSED || (!RANK2 && !BANK && TN == 128),
                "scratch tiles are plain and 128 wide");
  using T = Tile<TN>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t pad = ((smem_addr(smem_raw) + 1023u) & ~1023u) -
                       smem_addr(smem_raw);
  uint8_t* const ring = smem_raw + pad;
  const uint32_t base = smem_addr(ring);
  const uint32_t bars = base + T::kRing;
  float* const uh = reinterpret_cast<float*>(ring + T::kRing + 16 * kStages);
  float* const vh = uh + kWide;
  float* const nrm_u = vh + kWide;   // a block's ‖u‖ + ε, ‖v‖ + ε
  float* const nrm_v = nrm_u + kWide;
  // the block dots px, pg (qx, qg) of each row: [k][slot][row]
  float* const sdot = nrm_v + kWide;
  float* const sred = sdot + 4 * kMaxBlocks * kRows;  // ĝ's parts
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };

  const int row_tiles = a.M / a.seq * a.seq_tiles;
  const int rt = static_cast<int>(blockIdx.x) % row_tiles;
  const int ct = static_cast<int>(blockIdx.x) / row_tiles;
  const int in_seq = rt % a.seq_tiles * kRows;
  const int row0 = rt / a.seq_tiles * a.seq + in_seq;
  const int rows = min(kRows, a.seq - in_seq);
  int k0, cols, nbc = 0;
  if constexpr (FUSED) {
    nbc = min(a.nb, a.n - ct * a.nb);
    k0 = ct * a.nb * a.db;
    cols = nbc * a.db;
  } else {
    k0 = ct * TN;
    cols = min(TN, a.K - k0);
  }
  const int k_steps = (a.N + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kWarps);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kWarps) {  // the producer warp: one lane issues
    if (lane == 0) {
      for (int it = 0; it < k_steps; ++it) {
        const int s = it % kStages;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), T::kStageBytes);
        const uint32_t st = base + s * T::kStageBytes;
        tma_load(st, &tma_g, full(s), it * kBK, row0);
        tma_load(st + kGBox, &tma_w, full(s), it * kBK, k0);
      }
    }
    return;
  }

  const float* ub = nullptr;
  const float* vb = nullptr;
  if constexpr (FUSED) {
    // The tile's unit hyperplanes while the first boxes are in flight:
    // each block's norm by a warp (as reflect_bwd_kernel forms it), then
    // û at each of the tile's columns, 0 past its last whole block.
    const long long bank =
        BANK ? static_cast<long long>(reflect::row_tenant(a.tn, row0)) * a.K
             : 0;
    ub = a.u + bank + k0;
    if constexpr (RANK2) vb = a.v + bank + k0;
    for (int b = warp; b < nbc; b += kWarps) {
      float ss = 0.f, sv = 0.f;
      for (int j = lane; j < a.db; j += 32) {
        const float uu = ub[b * a.db + j];
        ss = fmaf(uu, uu, ss);
        if constexpr (RANK2) {
          const float vv = vb[b * a.db + j];
          sv = fmaf(vv, vv, sv);
        }
      }
      ss = reflect::warp_sum(ss);
      if constexpr (RANK2) sv = reflect::warp_sum(sv);
      if (lane == 0) {
        nrm_u[b] = sqrtf(ss) + reflect::kEps;
        if constexpr (RANK2) nrm_v[b] = sqrtf(sv) + reflect::kEps;
      }
    }
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
    if (threadIdx.x < TN) {
      const int c = threadIdx.x;
      uh[c] = c < cols ? ub[c] / nrm_u[c / a.db] : 0.f;
      if constexpr (RANK2) vh[c] = c < cols ? vb[c] / nrm_v[c / a.db] : 0.f;
    }
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
  }

  // The fused epilogue's x: the tile's rows and whole blocks' columns, 16
  // bytes a load (chunk e = thread + kConsumers·i of 128 rows × TN/8),
  // zeros past them, issued before the products so that they arrive
  // behind them.
  uint4 xq[FUSED ? T::kXLoads : 1];
  if constexpr (FUSED) {
    const bool vec = (k0 & 7) == 0;    // 16-byte aligned (K % 8 == 0)
#pragma unroll
    for (int i = 0; i < T::kXLoads; ++i) {
      const int e = threadIdx.x + kConsumers * i;
      const int r = e / (TN / 8), c = 8 * (e % (TN / 8));
      xq[i] = make_uint4(0, 0, 0, 0);
      if (r >= rows || c >= cols) continue;
      const bf16* at = a.x + static_cast<long long>(row0 + r) * a.K + k0 + c;
      if (vec && c + 8 <= cols) {
        xq[i] = __ldg(reinterpret_cast<const uint4*>(at));
      } else {
        uint32_t h[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          h[k] = c + k < cols ? __bfloat16_as_ushort(at[k]) : 0u;
        xq[i] = make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16,
                           h[4] | h[5] << 16, h[6] | h[7] << 16);
      }
    }
  }

  // The products: warpgroup g takes rows 64g .. 64g + 63 of the tile.
  const int g = warp / 4;
  float acc[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
  for (int it = 0; it < k_steps; ++it) {
    const int s = it % kStages;
    mbar_wait(full(s), (it / kStages) & 1);
    fence_acc(acc);
    wgmma_fence();
    const uint32_t ga = base + s * T::kStageBytes + g * 64 * 128;
    const uint32_t wb = base + s * T::kStageBytes + kGBox;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      // both K-major: 16 N (32 bytes) further along each 128-byte row,
      // 8-row groups 1024 bytes apart
      mma_step<TN>(acc, sw128_desc(ga + ks * 32, 16, 1024), wb + ks * 32);
    }
    wgmma_commit();
    fence_acc(acc);
    // the products of step it − 1 are done: free its stage
    wgmma_wait<1>();
    if (it > 0 && lane == 0) mbar_arrive(empty((it - 1) % kStages));
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (lane == 0) mbar_arrive(empty((k_steps - 1) % kStages));

  // The fragment: register 4j + h (h < 2) at row rl0, 4j + 2 + h at row
  // rl0 + 8, column 8j + 2q + h of the tile.
  const int q = lane & 3;
  const int rl0 = g * 64 + (warp & 3) * 16 + lane / 4, rl1 = rl0 + 8;
  const bool ok0 = rl0 < rows, ok1 = rl1 < rows;

  if constexpr (!FUSED) {
    const long long at0 = static_cast<long long>(row0 + rl0) * a.K + k0;
    const long long at1 = static_cast<long long>(row0 + rl1) * a.K + k0;
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int c = 8 * j + 2 * q;
      if (c >= cols) continue;  // cols is a multiple of 8 (K % 8 == 0)
      if (ok0)
        *reinterpret_cast<float2*>(a.dxr + at0 + c) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
      if (ok1)
        *reinterpret_cast<float2*>(a.dxr + at1 + c) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    return;
  } else {
    constexpr float cu = RANK2 ? -1.f : -2.f;
    constexpr float cv = 1.f;
    constexpr int kPitch = T::kPitch, kPitchX = T::kPitchX;
    const int tid = threadIdx.x;
    // Every product of both warpgroups is done (and every TMA load was
    // consumed), so the ring is free: dXr goes there in f32, rows past
    // the tile's as zeros, beside the tile's x from xq.
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
    float* const sacc = reinterpret_cast<float*>(ring);       // [row][kPitch]
    bf16* const sx = reinterpret_cast<bf16*>(sacc + kRows * kPitch);
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 8 * j + 2 * q + h;
        sacc[rl0 * kPitch + c] = ok0 ? acc[4 * j + h] : 0.f;
        sacc[rl1 * kPitch + c] = ok1 ? acc[4 * j + 2 + h] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < T::kXLoads; ++i) {
      const int e = tid + kConsumers * i;
      const int r = e / (TN / 8), c = 8 * (e % (TN / 8));
      uint32_t* const to = reinterpret_cast<uint32_t*>(sx + r * kPitchX + c);
      to[0] = xq[i].x;
      to[1] = xq[i].y;
      to[2] = xq[i].z;
      to[3] = xq[i].w;
    }
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");

    // The block dots of each row: a thread a (row, block), consecutive
    // threads on consecutive rows; a block wider than 64 splits each dot
    // into its two halves (slots 2b and 2b + 1), added in that order.
    // Every order of summation here is set by db alone, so both tile
    // widths give a block the same bits.
    const int splits = a.db > 64 ? 2 : 1;
    for (int unit = tid; unit < nbc * splits * kRows; unit += kConsumers) {
      const int r = unit % kRows, slot = unit / kRows;
      const int b = slot / splits, half = slot % splits;
      const int j0 = b * a.db + half * (a.db / 2);
      const int j1 = splits == 1 || half ? (b + 1) * a.db : j0 + a.db / 2;
      float px = 0.f, pg = 0.f, qx = 0.f, qg = 0.f;
#pragma unroll 4
      for (int c = j0; c < j1; ++c) {
        const float xv = __bfloat162float(sx[r * kPitchX + c]);
        const float dv = sacc[r * kPitch + c];
        const float uc = uh[c];
        px = fmaf(xv, uc, px);
        pg = fmaf(dv, uc, pg);
        if constexpr (RANK2) {
          const float vc = vh[c];
          qx = fmaf(xv, vc, qx);
          qg = fmaf(dv, vc, qg);
        }
      }
      sdot[(0 * kMaxBlocks + slot) * kRows + r] = px;
      sdot[(1 * kMaxBlocks + slot) * kRows + r] = pg;
      if constexpr (RANK2) {
        sdot[(2 * kMaxBlocks + slot) * kRows + r] = qx;
        sdot[(3 * kMaxBlocks + slot) * kRows + r] = qg;
      }
    }
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");

    // dx and ĝ: a thread a (column, part), the part's rows part, part +
    // kParts, ..., a warp along a row; dx formed in f32 and rounded once,
    // ĝ summed over the part's rows in order into sred[part][column].
    for (int unit = tid; unit < kParts * TN; unit += kConsumers) {
      const int c = unit % TN, part = unit / TN;
      float hu = 0.f, hv = 0.f;
      if (c < cols) {
        const int slot = c / a.db * splits;
        const float uc = uh[c];
        const float vc = RANK2 ? vh[c] : 0.f;
        auto dot = [&](int k, int r) {
          const float* at = sdot + (k * kMaxBlocks + slot) * kRows + r;
          return splits == 1 ? at[0] : at[0] + at[kRows];
        };
        bf16* const out = a.dx + static_cast<long long>(row0) * a.K + k0 + c;
#pragma unroll 4
        for (int r = part; r < rows; r += kParts) {
          const float dv = sacc[r * kPitch + c];
          const float xv = __bfloat162float(sx[r * kPitchX + c]);
          const float px = dot(0, r), pg = dot(1, r);
          hu = fmaf(pg, xv, fmaf(px, dv, hu));
          float d = fmaf(cu * pg, uc, dv);
          if constexpr (RANK2) {
            const float qx = dot(2, r), qg = dot(3, r);
            hv = fmaf(qg, xv, fmaf(qx, dv, hv));
            d = fmaf(cv * qg, vc, d);
          }
          out[static_cast<long long>(r) * a.K] = __float2bfloat16(d);
        }
      }
      sred[part * TN + c] = hu;
      if constexpr (RANK2) sred[(kParts + part) * TN + c] = hv;
    }
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
    // ĝ a column: its parts added in order, one thread a (direction,
    // column)
    for (int unit = tid; unit < (RANK2 ? 2 : 1) * TN; unit += kConsumers) {
      const int c = unit % TN, dir = unit / TN;
      if (c >= cols) continue;
      const float* at = sred + dir * kParts * TN + c;
      float s = at[0];
#pragma unroll
      for (int p = 1; p < kParts; ++p) s += at[p * TN];
      float* part = dir ? a.part_v : a.part_u;
      part[static_cast<long long>(rt) * a.K + k0 + c] = (dir ? cv : cu) * s;
    }
  }
}

// The tensor-map cache of the including library.
inline MapCache& map_cache() {
  static MapCache cache;
  return cache;
}

// wgmma_kernel's launch on G (M, N) and W (K, N) bf16.
template <bool FUSED, bool RANK2, bool BANK, int TN>
cudaError_t launch_tiles(const void* g, const void* w, const Args& a,
                         cudaStream_t s) {
  using T = Tile<TN>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap tma_g, tma_w;
  const uint64_t g_dims[2] = {static_cast<uint64_t>(a.N),
                              static_cast<uint64_t>(a.M)};
  const uint64_t w_dims[2] = {static_cast<uint64_t>(a.N),
                              static_cast<uint64_t>(a.K)};
  const uint32_t g_box[2] = {kBK, kRows};
  const uint32_t w_box[2] = {kBK, TN};
  if (!map_cache().get(enc, &tma_g, g, 2, g_dims, g_box) ||
      !map_cache().get(enc, &tma_w, w, 2, w_dims, w_box))
    return cudaErrorNotSupported;
  static bool sized[kMaxDevices] = {};
  const cudaError_t err = reserve_smem(wgmma_kernel<FUSED, RANK2, BANK, TN>,
                                       T::smem_bytes(), sized);
  if (err != cudaSuccess) return err;
  const long long col_tiles =
      FUSED ? (a.n + a.nb - 1) / a.nb : (a.K + TN - 1) / TN;
  const long long blocks =
      static_cast<long long>(a.M / a.seq) * a.seq_tiles * col_tiles;
  wgmma_kernel<FUSED, RANK2, BANK, TN>
      <<<static_cast<unsigned>(blocks), kThreads, T::smem_bytes(), s>>>(
          tma_g, tma_w, a);
  return cudaGetLastError();
}

// The launch for a.nb: the scratch tiles when 0, else the fused tiles of
// 128 columns, or 160 where the blocks take more than 128.
template <bool RANK2, bool BANK>
cudaError_t launch(const void* g, const void* w, const Args& a,
                   cudaStream_t s) {
  if (a.nb == 0) return launch_tiles<false, false, false, 128>(g, w, a, s);
  if (a.nb * a.db <= 128)
    return launch_tiles<true, RANK2, BANK, 128>(g, w, a, s);
  return launch_tiles<true, RANK2, BANK, kWide>(g, w, a, s);
}

// What the wgmma route takes: bf16 (the caller's dtype code 1), K and N
// multiples of 8, the operands 16-byte aligned, and a fused tile of whole
// blocks no wider than the widest tile.
inline bool takes(int dtype, int K, int N, int n, int db, int nb,
                  const void* const* ptrs, int count) {
  uintptr_t bits = 0;
  for (int i = 0; i < count; ++i)
    bits |= reinterpret_cast<uintptr_t>(ptrs[i]);
  return dtype == 1 && K % 8 == 0 && N % 8 == 0 && bits % 16 == 0 &&
         nb >= 0 && nb <= n && nb <= kMaxBlocks &&
         static_cast<long long>(nb) * db <= kWide;
}

}  // namespace
}  // namespace dxr
