// The wgmma core of the scaled forwards: hyperadapt_gemm_batched.cu
// (HyperAdapt through a bank: y = ((x⊙r_t)·W)⊙c_t, t each row's tenant),
// for sm_90a.  The method's extra arithmetic sits around the tensor-core
// product, never inside its k-loop:
//
//  * EPI kColScale, or kPlain for the backward's z and y0.  A prologue
//    (scale_rows_kernel) forms v = x⊙r_{t(row)} in f32, each row's tenant
//    read on the device, and writes it as two bf16 planes, hi = bf16(v)
//    and lo = bf16(v − hi); the GEMM adds hi·W and lo·W on the tensor
//    cores, k chunk by k chunk, and its epilogue
//    multiplies the f32 accumulator by c_{t(row)}[col] and rounds once.
//    The JAX kernel feeds the f32 x⊙r to its product
//    (hyperadapt_gemm.py:91-95): hi alone, one bf16 operand, put 42.6% of
//    a train step's outputs one bf16 step off the plain version's and
//    moved phase 14's loss gap past TRAIN_TOL (PERF.md §6); hi + lo holds
//    v to 16 bits.  Both scales are per row, so a row tile may hold rows of
//    several tenants and W is read once a call, not once a sequence as
//    rows 5 and 20 must.  The alternative, x from registers scaled before
//    a register-A wgmma, saves the planes (4·M·K bytes written and read
//    once, 21 MB at a train step's 1,024 × 2,560) but needs a tenant
//    lookup of r per row and k chunk inside the k-loop, between the TMA
//    and the tensor cores; the planes cost a few µs there and keep the
//    k-loop the plain one.
//
// Why a core of its own, beside hh_wgmma.cuh and dxr_wgmma.cuh: the
// loop of hh_wgmma.cuh is built around its U warpgroups, which sum
// U = ÛᵀW from the W tiles in shared memory while the MMA warps use them
// (five warpgroups' registers and a stage's release waiting on both), and
// its bank tiles hold one sequence's rows; dxr_wgmma.cuh reads W K-major
// only, on column tiles of whole reflection blocks (128 or 160 wide).
// Here x comes as two planes a stage, W in either layout, any rows share
// a tile, and nothing runs beside the MMA warps.  dxr_wgmma.cuh's G·Wᵀ
// loop is this one's kWK loop with another epilogue: folding it onto
// this core is ROADMAP Queue 2's item on the wgmma cores.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s, the
// data sheet's rates at 700 W): reading W at decode (one smollm-360m
// layer's seven weights, 19.7 MB, 5.9 µs); the product, 2·M·K·N
// operations, at a train step's 1,024 rows (one layer 41.7 µs).
//
// The GEMM: one producer warp issues the TMA loads (a box of x and TN
// columns of W a 64-deep K tile) into a ring of 4 stages under the
// 128-byte swizzle and arms each stage's "full" mbarrier with its bytes;
// the MMA warpgroups, 64 rows each, wait on it, issue four wgmma.mma_async
// m64nTNk16 a K tile into f32 partials and free the stage on its "empty"
// mbarrier once the next stage's products are issued.  W comes in
// either layout (template WT): kWN, W (K, N) row-major, N-major to wgmma
// through the transpose bit (the forwards, as hh_wgmma.cuh reads it); kWK,
// the (N, K) row-major matrix read as its transpose, K-major
// (HyperAdapt's z = (g⊙c_t)·Wᵀ, as dxr_wgmma.cuh reads W for G·Wᵀ).  TMA
// fills rows and columns past M, N and K with zeros; the epilogue masks
// its stores.  The tensor cores sum
// each 64-deep K tile into a partial from zero, 16-deep k chunks in order,
// and the partials are added in order into the f32 accumulator on the
// CUDA cores, rounding to nearest, as the JAX kernel adds each K tile's
// dot into its f32 scratch.  The tensor cores' own accumulation
// truncates: with one chain over all of K, or over the JAX kernels' K
// tiles of up to 512, 0.031-0.038% of a train step's x·W outputs came out
// one bf16 step off the plain version's, with 64-deep partials
// 0.016-0.024%, below the SIMT route's 0.020-0.026% but where that one is
// cuBLAS's own order at 960 × 960 (PERF.md §6).  A block takes one
// tile, so every order is set by K alone: a
// row's y does not depend on M, on the rows or tenants beside it, and two
// calls agree bit for bit (the trainer's bitwise restores).
//
// Tiles (template TN):
//  * 128: 128 rows × 128 columns, two MMA warpgroups, 4 stages of one K
//    tile (32 KB each).
//  * 64 (decode, M ≤ kDecodeRows): one MMA warpgroup, 4 stages of four K
//    tiles (16 rows of x and 64 of W each), as hh_wgmma.cuh's decode tile:
//    a decode call is bound by reading W, and the narrower tile gives
//    twice the blocks.  The wgmma still reads 64 rows: those past the 16
//    of x fall on the W tiles behind them and give rows of the product
//    that are never stored.
// A block has three warpgroups' worth of threads (the producer warp
// rounds up to one), so 224 registers a thread: a 128-wide tile's 64
// accumulators and 64 partials fit without spilling.
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
constexpr int kPlanes = 2;       // x⊙r's hi and lo planes, a box each

enum WLayout { kWN = 0, kWK = 1 };
enum Epi { kPlain = 0, kColScale = 1 };

// A tile of TN columns.
template <int TN>
struct Tile {
  static_assert(TN == 64 || TN == 128, "tiles: 64 or 128 columns");
  static constexpr bool kDecode = TN == 64;
  static constexpr int kSub = kDecode ? 4 : 1;        // K tiles a stage
  static constexpr int kARows = kDecode ? kDecodeRows : 128;  // x rows
  static constexpr int kMmaWarps = kDecode ? 4 : 8;   // 64 rows a warpgroup
  static constexpr int kMT = 32 * kMmaWarps;          // MMA threads
  static constexpr int kThreads = kMT + 32;           // and the producer
  static constexpr int kATile = kARows * 128;         // rows × 64 k × 2 B
  static constexpr int kWTile = TN * 128;             // 64 k × TN × 2 B
  static constexpr int kSubBytes = kPlanes * kATile + kWTile;
  static constexpr int kStageBytes = kSub * kSubBytes;
  static constexpr int kStageK = kSub * kBK;          // K rows a stage
  static constexpr int kAcc = TN / 2;                 // f32 accumulators
  // Dynamic shared memory: the ring, its 2·kStages mbarriers, and room to
  // align the ring to the swizzle's 1024 bytes.
  static constexpr int kSmemBytes = kStages * kStageBytes + 16 * kStages +
                                    1024;
};

struct Args {
  bf16* y;             // (M, N)
  const float* c;      // kColScale: (A, N) a bank's column scales
  Tenants tn;          // kColScale: each row's tenant
  int M, K, N;
  int x_bytes;         // bytes of one box of x
};

// y = epilogue(x·W), one TN-wide tile a block: x by tma_x (dims {K, M, 2},
// the hi and lo planes; box 64 × rows), W by
// tma_w (kWN: dims {N, K}, box 64 × 64; kWK: dims {K, N}, box 64 × TN),
// all 128-byte swizzled.  Block b takes row tile b % tiles_m and column
// tile b / tiles_m.
template <int TN, int WT, int EPI>
__global__ void __launch_bounds__(Tile<TN>::kThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap tma_x,
                const __grid_constant__ CUtensorMap tma_w, const Args a) {
  using T = Tile<TN>;
  constexpr int kMmaWarps = T::kMmaWarps, kSub = T::kSub;
  constexpr int kStageBytes = T::kStageBytes, kStageK = T::kStageK;
  constexpr int kSubBytes = T::kSubBytes, kATile = T::kATile;
  constexpr int kAcc = T::kAcc;
  constexpr int kRows = T::kDecode ? T::kARows : 128;  // rows a tile stores
  const int M = a.M, K = a.K, N = a.N;

  extern __shared__ __align__(1024) uint8_t smem_raw[];
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
        mbar_expect_tx(full(s),
                       subs * (kPlanes * a.x_bytes + T::kWTile));
        for (int j = 0; j < subs; ++j) {
          const uint32_t at = base + s * kStageBytes + j * kSubBytes;
          const uint32_t wt = at + kPlanes * kATile;
          tma_load(at, &tma_x, full(s), k0 + j * kBK, row0, 0);
          tma_load(at + kATile, &tma_x, full(s), k0 + j * kBK, row0, 1);
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
        // each k chunk adds hi·W, then lo·W.
        const uint64_t bd = WT == kWN ? sw128_desc(b + ks * 2048, kBox, 1024)
                                      : sw128_desc(b + ks * 32, 16, 1024);
        WgmmaSS<TN, WT == kWN>::mma(
            part, sw128_desc(at + ks * 32, 16, 1024), bd, !opens);
        WgmmaSS<TN, WT == kWN>::mma(
            part, sw128_desc(at + kATile + ks * 32, 16, 1024), bd, 1);
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
  const float* c0row = nullptr;
  const float* c1row = nullptr;
  if constexpr (EPI == kColScale) {
    // each row's own tenant's column scales
    c0row = a.c + static_cast<long long>(
                      ok0 ? reflect::row_tenant(a.tn, r0) : 0) * N;
    c1row = a.c + static_cast<long long>(
                      ok1 ? reflect::row_tenant(a.tn, r1) : 0) * N;
  }
#pragma unroll
  for (int q = 0; q < TN / 8; ++q) {
    const int cc = n0 + c0 + 8 * q;
    if (cc >= N) continue;  // N is a multiple of 8: the pair is inside
    float y00 = acc[4 * q], y01 = acc[4 * q + 1];
    float y10 = acc[4 * q + 2], y11 = acc[4 * q + 3];
    if constexpr (EPI == kColScale) {
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

// HyperAdapt's prologue: v = x[m, k]·r_t[k] in f32, t = row m's tenant
// (read on the device), written as bf16 hi = bf16(v) and lo = bf16(v − hi)
// in a plane M·K further, eight k a thread; K a multiple of 8, x and the
// bank 16-byte aligned (the route's rule).  hi + lo holds v to 16 bits:
// the product of the two planes with W misses x⊙r·W by 2^-17 of a term,
// where hi alone (bf16) would by 2^-9.
__global__ void __launch_bounds__(256)
    scale_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ rb,
                      bf16* __restrict__ xr, Tenants tn, int M, int K) {
  const long long e = (static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x) * 8;
  if (e >= static_cast<long long>(M) * K) return;
  const int m = static_cast<int>(e / K), k = static_cast<int>(e % K);
  const float* const rt =
      rb + static_cast<long long>(reflect::row_tenant(tn, m)) * K + k;
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
  *reinterpret_cast<uint4*>(xr + static_cast<long long>(M) * K + e) = lo;
}

// The tensor-map cache of the including library.
inline MapCache& map_cache() {
  static MapCache cache;
  return cache;
}

template <int TN, int WT, int EPI>
cudaError_t launch_tiles(const void* x, const void* w, Args a,
                         cudaStream_t s) {
  using T = Tile<TN>;
  constexpr int kRows = T::kDecode ? T::kARows : 128;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  // x's box: a 128-row tile, or at decode its rows rounded up to 8
  const int x_rows = T::kDecode ? (a.M + 7) / 8 * 8 : T::kARows;
  if (x_rows > T::kARows) return cudaErrorInvalidValue;
  CUtensorMap tma_x, tma_w;
  const uint64_t x_dims[3] = {static_cast<uint64_t>(a.K),
                              static_cast<uint64_t>(a.M), 2};
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
      reserve_smem(gemm_kernel<TN, WT, EPI>, T::kSmemBytes, sized);
  if (err != cudaSuccess) return err;
  a.x_bytes = x_rows * 128;
  const long long blocks =
      static_cast<long long>((a.M + kRows - 1) / kRows) * ((a.N + TN - 1) / TN);
  gemm_kernel<TN, WT, EPI>
      <<<static_cast<unsigned>(blocks), T::kThreads, T::kSmemBytes, s>>>(
          tma_x, tma_w, a);
  return cudaGetLastError();
}

// gemm_kernel's launch on x⊙r's (2, M, K) bf16 hi and lo planes and W
// bf16, after the prologue: the decode tile at M ≤ kDecodeRows, else the
// 128-wide one.
template <int WT, int EPI>
cudaError_t launch(const void* x, const void* w, const Args& a,
                   cudaStream_t s) {
  if (a.M <= kDecodeRows) return launch_tiles<64, WT, EPI>(x, w, a, s);
  return launch_tiles<128, WT, EPI>(x, w, a, s);
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
