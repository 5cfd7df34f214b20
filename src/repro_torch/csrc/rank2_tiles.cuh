// The ETHER+ bank reflection and its backward as sequence-tile kernels,
// for sm_90a: included by etherplus_reflect_batched.cu (row 7) and
// etherplus_reflect_batched_bwd.cu (row 25).
//
// For x (B·S, d) in bf16 or f32 and an ETHER+ bank u_bank, v_bank
// (A, n, db) f32 raw with n·db = d, sequence b is served by tenant
// t = ids[b] (mapped into [0, A) by reflect::row_tenant), and per block i
//   out = H⁺_t x = x − (ûᵀx) û + (v̂ᵀx) v̂,   û = u / (‖u‖ + ε)
// (src/repro/kernels/etherplus_reflect_batched.py:32).  The backward under
// a cotangent G (src/repro/kernels/reflect_bwd_batched.py:54):
//   dx = G − (ûᵀG) û + (v̂ᵀG) v̂
//   ĝu_seq[b] = −Σ_{rows of b} [(ûᵀx) G + (ûᵀG) x],  ĝv_seq likewise, +
//   du_bank[a] = norm_chain(u_bank[a], Σ_{b: ids[b] = a} ĝu_seq[b])
// and an exact zero for a tenant that no id names.
//
// What bounds it on an H100 SXM (3.35 TB/s at 700 W): bytes.  The forward
// reads x and writes out once, ~10 flops an element; the backward reads x
// and G and writes dx, ~20.  That is far below the 295 flops a byte at
// which the tensor cores would set the pace, so there are none here.
//
// The design (the Pallas kernels' grid is (sequence, block_s rows), the
// tenant's (n, db) hyperplanes staged once a step):
//  * One CTA of kThreads per (tile of `rows` rows of one sequence, column
//    chunk of `bpc` whole blocks); a tile never straddles two sequences,
//    and a sequence's last tile may be ragged.  The host picks the
//    geometry (kernels/batched.py, rank2_geometry): the forward's rows and
//    chunks so that the call fills the card; the backward's tiles are 32
//    rows (reflect_common.cuh's kRowsPerTile, whose ĝ order the training
//    checks were set on) and its chunks fill the card.
//  * Prologue: the tenant's u and v for the chunk's blocks are read once
//    into shared memory and normalised there, each block's norm by one
//    warp, while the tile of x (and G) streams into shared memory with
//    16-byte cp.async where every row of the chunk starts on 16 bytes
//    (element by element otherwise).
//  * Each (row, block) pair is taken by one warp, which forms its
//    projections from shared memory; a warp takes kPairs pairs at once,
//    so that their loads and shuffles overlap.  The forward writes out in
//    place over its x tile; the backward keeps its four projections in
//    shared memory and then one thread a column walks the tile's rows in
//    order, writing dx in place over G and summing the column's ĝ
//    partial.  The tiles go out with 16-byte stores.
//  * Where even one block's tile does not fit in shared memory (`staged`
//    0), the CTA reads x and G from device memory and writes out and dx
//    there directly, with the hyperplanes still normalised once in shared
//    memory.
//  * The backward writes each tile's ĝu and ĝv partials once (a (2, B,
//    tiles, d) f32 scratch), and bank_ghat_kernel, one warp a (direction,
//    tenant, block), sums its tenant's sequences' partials into ĝ_seq and
//    over the sequences, then applies the norm chain: one launch.  No
//    float atomics: every run gives the same bits.
//
// Every sum is taken in the order of the per-row kernels that ran these
// rows before (reflect_common.cuh's rank2_rows_kernel and the RANK2 bank
// reflect_bwd_kernel, seq_ghat_kernel and bank_chain_kernel), so the
// results are theirs bit for bit: phase 14's ETHER+ training check sits
// at the size of a last-bit difference grown by 8 AdamW steps, and an
// order of its own crossed it at seed 0.  The CPU tests
// (tests/test_torch_rank2_tiles.py) repeat these orders:
//  * a block's norm ‖u_i‖ and a pair's projection x·û: lane l of one warp
//    sums the products for c = l, l + 32, ... with fmaf from 0, then the
//    32 lanes' sums by the xor butterfly (offsets 16, 8, 4, 2, 1);
//    nrm = sqrtf(·) + ε and û_c = u_c / nrm;
//  * out_c = fmaf(pv, v̂_c, fmaf(−pu, û_c, x_c)); dx_c = fmaf(qg, v̂_c,
//    fmaf(−pg, û_c, G_c)), rounded once to the activations' dtype;
//  * a tile's ĝ partial of column c: a = a + fmaf(px_r, G_rc, pg_r·x_rc)
//    over the tile's rows r in order from 0 (nvcc's contraction of the
//    per-row kernel's a += px·G + pg·x; the forms fmaf(px, G, fmaf(pg, x,
//    a)), a + fmaf(pg, x, px·G) and that very source line here gave other
//    bits), stored as −a (ĝu) and, with qx, qg, as +a (ĝv);
//  * ĝ_seq[b]: the tiles of sequence b added in order from 0;
//  * du_bank[a]: ĝ_seq[b] added over b = 0, 1, ... with ids[b] mapped to a,
//    from 0; then, per block, ss = Σ u_c² and dot = Σ u_c·g_c (lane chains
//    and the butterfly, as the norm), rn = sqrtf(ss), s = rn + ε and
//    du_c = g_c / s − (dot·u_c) / ((rn·s)·s).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "reflect_common.cuh"

namespace r2t {
// Internal linkage: two libraries include this header (see dxr_wgmma.cuh).
namespace {

using reflect::from_f32;
using reflect::kEps;
using reflect::Tenants;
using reflect::to_f32;
using reflect::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPairs = 4;                 // pairs a warp takes at once
constexpr int kMaxSmem = 232448;          // what a block may ask for

// The launch geometry, picked on the host (kernels/batched.py,
// rank2_geometry) and checked by check_geometry.
struct Geometry {
  int M, n, db, seq;  // rows, blocks, block width, rows a sequence
  int rows;           // rows a tile
  int tiles;          // tiles a sequence: ⌈seq / rows⌉
  int bpc;            // blocks a column chunk
  int chunks;         // ⌈n / bpc⌉
  int vec;            // 1: every chunk row starts on 16 bytes
  int staged;         // 1: the tiles live in shared memory
};

__host__ __device__ inline int align16(int bytes) { return (bytes + 15) & ~15; }

// Shared memory of one CTA: the x tile [and the G tile] (when staged), û
// and v̂ of the chunk, and (backward) the tile's four projections a pair.
__host__ __device__ inline int smem_bytes(const Geometry& g, int es, bool bwd) {
  const int w = g.bpc * g.db;
  const int tile = g.staged ? align16(g.rows * w * es) * (bwd ? 2 : 1) : 0;
  return tile + 2 * align16(4 * w) + (bwd ? 16 * g.rows * g.bpc : 0);
}

inline bool check_geometry(const Geometry& g, int es, bool bwd) {
  return g.seq >= 1 && g.M % g.seq == 0 && g.n >= 1 && g.db >= 1 &&
         g.rows >= 1 && g.rows <= g.seq &&
         g.tiles == (g.seq + g.rows - 1) / g.rows && g.bpc >= 1 &&
         g.bpc <= g.n && g.chunks == (g.n + g.bpc - 1) / g.bpc &&
         (!g.vec || (g.staged && (g.n * g.db) % (16 / es) == 0 &&
                     (g.bpc * g.db) % (16 / es) == 0)) &&
         smem_bytes(g, es, bwd) <= kMaxSmem;
}

// Copies from device to shared memory that bypass the registers: 16
// bytes, or 4 (cp.async.ca takes either); a commit closes a group, and
// wait<N> returns once at most the N groups committed last are pending.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where a CTA works: sequence b's tile j (rows row0 .. row0 + live − 1)
// and the chunk's blocks blk0 .. blk0 + nb − 1, columns c0 .. c0 + w − 1.
struct Place {
  long long row0;
  int b, j, live, blk0, nb, c0, w;
};

__device__ __forceinline__ Place place(const Geometry& g) {
  Place p;
  const int tile = static_cast<int>(blockIdx.x);
  p.b = tile / g.tiles;
  p.j = tile % g.tiles;
  p.row0 = static_cast<long long>(p.b) * g.seq +
           static_cast<long long>(p.j) * g.rows;
  p.live = min(g.rows, g.seq - p.j * g.rows);
  p.blk0 = static_cast<int>(blockIdx.y) * g.bpc;
  p.nb = min(g.bpc, g.n - p.blk0);
  p.c0 = p.blk0 * g.db;
  p.w = p.nb * g.db;
  return p;
}

// Bring `tile`'s live rows of the chunk into shared memory (staged only):
// 16-byte cp.async under vec (the caller commits them), else element by
// element.
template <typename T>
__device__ void load_tile(const T* __restrict__ src, T* tile,
                          const Geometry& g, const Place& p) {
  const int d = g.n * g.db;
  if (g.vec) {
    constexpr int kV = 16 / sizeof(T);
    const int per_row = p.w / kV;
    for (int k = threadIdx.x; k < p.live * per_row; k += kThreads) {
      const int r = k / per_row, c = (k % per_row) * kV;
      cp_async16(tile + r * p.w + c, src + (p.row0 + r) * d + p.c0 + c);
    }
  } else {
    for (int k = threadIdx.x; k < p.live * p.w; k += kThreads) {
      const int r = k / p.w, c = k % p.w;
      tile[k] = src[(p.row0 + r) * d + p.c0 + c];
    }
  }
}

// Write the tile back to dst (staged only), with 16-byte stores under vec.
template <typename T>
__device__ void store_tile(const T* tile, T* __restrict__ dst,
                           const Geometry& g, const Place& p) {
  const int d = g.n * g.db;
  if (g.vec) {
    constexpr int kV = 16 / sizeof(T);
    const int per_row = p.w / kV;
    for (int k = threadIdx.x; k < p.live * per_row; k += kThreads) {
      const int r = k / per_row, c = (k % per_row) * kV;
      *reinterpret_cast<uint4*>(dst + (p.row0 + r) * d + p.c0 + c) =
          *reinterpret_cast<const uint4*>(tile + r * p.w + c);
    }
  } else {
    for (int k = threadIdx.x; k < p.live * p.w; k += kThreads) {
      const int r = k / p.w, c = k % p.w;
      dst[(p.row0 + r) * d + p.c0 + c] = tile[k];
    }
  }
}

// The tenant's u and v over the chunk into hu and hv, with cp.async (16
// bytes where both rows start on 16 bytes), as one committed group.
__device__ void stage_planes(const float* __restrict__ u,
                             const float* __restrict__ v, float* hu, float* hv,
                             const Geometry& g, const Place& p,
                             const Tenants& tn) {
  const int t = reflect::row_tenant(tn, static_cast<int>(p.row0));
  const long long base = static_cast<long long>(t) * g.n * g.db + p.c0;
  const float* us = u + base;
  const float* vs = v + base;
  if (p.w % 4 == 0 && ((reinterpret_cast<uintptr_t>(us) |
                        reinterpret_cast<uintptr_t>(vs)) & 15) == 0) {
    for (int c = 4 * threadIdx.x; c < p.w; c += 4 * kThreads) {
      cp_async16(hu + c, us + c);
      cp_async16(hv + c, vs + c);
    }
  } else {
    for (int c = threadIdx.x; c < p.w; c += kThreads) {
      cp_async4(hu + c, us + c);
      cp_async4(hv + c, vs + c);
    }
  }
  cp_async_commit();
}

// The prologue's second half, once stage_planes' copies have landed:
// each block of hu and hv normalised in place by one warp (its norm in
// the fixed order above).  Ends with a barrier.
__device__ void normalise(float* hu, float* hv, const Geometry& g,
                          const Place& p) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int first = warp * kPairs; first < 2 * p.nb;
       first += kWarps * kPairs) {
    float ss[kPairs];
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int unit = first + k;
      ss[k] = 0.f;
      if (unit < 2 * p.nb) {
        const float* h = (unit < p.nb ? hu : hv) + (unit % p.nb) * g.db;
        for (int c = lane; c < g.db; c += 32) ss[k] = fmaf(h[c], h[c], ss[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int unit = first + k;
      const float nrm = sqrtf(warp_sum(ss[k])) + kEps;
      if (unit < 2 * p.nb) {
        float* h = (unit < p.nb ? hu : hv) + (unit % p.nb) * g.db;
        for (int c = lane; c < g.db; c += 32) h[c] = h[c] / nrm;
      }
    }
  }
  __syncthreads();
}

// out = H⁺_t x for one (tile, chunk).  Dynamic shared memory: the x tile
// (staged), then û, v̂.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rank2_tile_kernel(const T* __restrict__ x, const float* __restrict__ u,
                      const float* __restrict__ v, T* __restrict__ out,
                      Geometry g, Tenants tn) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Place p = place(g);
  const int d = g.n * g.db;
  T* xs = reinterpret_cast<T*>(smem);
  const int tile_bytes =
      g.staged ? align16(g.rows * g.bpc * g.db * sizeof(T)) : 0;
  float* hu = reinterpret_cast<float*>(smem + tile_bytes);
  float* hv = hu + align16(4 * g.bpc * g.db) / 4;
  stage_planes(u, v, hu, hv, g, p, tn);
  if (g.staged) load_tile(x, xs, g, p);
  cp_async_commit();
  cp_async_wait<1>();  // the planes
  __syncthreads();
  normalise(hu, hv, g, p);
  cp_async_wait<0>();  // the tile
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pairs = p.live * p.nb;
  for (int first = warp * kPairs; first < pairs; first += kWarps * kPairs) {
    float pu[kPairs], pv[kPairs];
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int pair = first + k, r = pair / p.nb, col = (pair % p.nb) * g.db;
      const T* xr = g.staged ? xs + r * p.w + col
                             : x + (p.row0 + r) * d + p.c0 + col;
      pu[k] = pv[k] = 0.f;
      if (pair < pairs)
        for (int c = lane; c < g.db; c += 32) {
          const float xv = to_f32(xr[c]);
          pu[k] = fmaf(xv, hu[col + c], pu[k]);
          pv[k] = fmaf(xv, hv[col + c], pv[k]);
        }
    }
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      pu[k] = warp_sum(pu[k]);
      pv[k] = warp_sum(pv[k]);
    }
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int pair = first + k, r = pair / p.nb, col = (pair % p.nb) * g.db;
      if (pair >= pairs) break;
      const long long at = (p.row0 + r) * d + p.c0 + col;  // unstaged
      const T* xr = g.staged ? xs + r * p.w + col : x + at;
      T* orow = g.staged ? xs + r * p.w + col : out + at;
      for (int c = lane; c < g.db; c += 32)
        orow[c] = from_f32<T>(fmaf(pv[k], hv[col + c],
                                   fmaf(-pu[k], hu[col + c], to_f32(xr[c]))));
    }
  }
  if (g.staged) {
    __syncthreads();
    store_tile(xs, out, g, p);
  }
}

// dx and the tile's ĝ partials for one (tile, chunk).  part: (2, B·tiles,
// d) f32, ĝu's then ĝv's.  Dynamic shared memory: the x and G tiles
// (staged), û, v̂, then px, pg, qx, qg for each of the tile's pairs.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rank2_tile_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gr,
                          const float* __restrict__ u,
                          const float* __restrict__ v, T* __restrict__ dx,
                          float* __restrict__ part, Geometry g, Tenants tn) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Place p = place(g);
  const int d = g.n * g.db;
  const int tile_bytes =
      g.staged ? align16(g.rows * g.bpc * g.db * sizeof(T)) : 0;
  T* xs = reinterpret_cast<T*>(smem);
  T* gs = reinterpret_cast<T*>(smem + tile_bytes);
  float* hu = reinterpret_cast<float*>(smem + 2 * tile_bytes);
  float* hv = hu + align16(4 * g.bpc * g.db) / 4;
  float* proj = hv + align16(4 * g.bpc * g.db) / 4;  // 4 × rows·bpc
  const int most = g.rows * g.bpc;
  stage_planes(u, v, hu, hv, g, p, tn);
  if (g.staged) {
    load_tile(x, xs, g, p);
    load_tile(gr, gs, g, p);
  }
  cp_async_commit();
  cp_async_wait<1>();  // the planes
  __syncthreads();
  normalise(hu, hv, g, p);
  cp_async_wait<0>();  // the tiles
  __syncthreads();
  // row r of the chunk: in shared memory, or where it lies
  auto xrow = [&](int r) -> const T* {
    return g.staged ? xs + r * p.w : x + (p.row0 + r) * d + p.c0;
  };
  auto grow = [&](int r) -> const T* {
    return g.staged ? gs + r * p.w : gr + (p.row0 + r) * d + p.c0;
  };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pairs = p.live * p.nb;
  for (int first = warp * kPairs; first < pairs; first += kWarps * kPairs) {
    float px[kPairs], pg[kPairs], qx[kPairs], qg[kPairs];
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int pair = first + k, r = pair / p.nb, col = (pair % p.nb) * g.db;
      px[k] = pg[k] = qx[k] = qg[k] = 0.f;
      if (pair < pairs) {
        const T* xr = xrow(r) + col;
        const T* gp = grow(r) + col;
        for (int c = lane; c < g.db; c += 32) {
          const float xv = to_f32(xr[c]), gv = to_f32(gp[c]);
          const float uh = hu[col + c], vh = hv[col + c];
          px[k] = fmaf(xv, uh, px[k]);
          pg[k] = fmaf(gv, uh, pg[k]);
          qx[k] = fmaf(xv, vh, qx[k]);
          qg[k] = fmaf(gv, vh, qg[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      px[k] = warp_sum(px[k]);
      pg[k] = warp_sum(pg[k]);
      qx[k] = warp_sum(qx[k]);
      qg[k] = warp_sum(qg[k]);
    }
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int pair = first + k;
      if (lane == 0 && pair < pairs) {
        proj[pair] = px[k];
        proj[most + pair] = pg[k];
        proj[2 * most + pair] = qx[k];
        proj[3 * most + pair] = qg[k];
      }
    }
  }
  __syncthreads();
  const long long n_part = static_cast<long long>(g.M / g.seq) * g.tiles * d;
  float* pu_out =
      part + (static_cast<long long>(p.b) * g.tiles + p.j) * d + p.c0;
  float* pv_out = pu_out + n_part;
  for (int c = threadIdx.x; c < p.w; c += kThreads) {
    const int i = c / g.db;
    const float uh = hu[c], vh = hv[c];
    float au = 0.f, av = 0.f;
    for (int r = 0; r < p.live; ++r) {
      const int q = r * p.nb + i;
      const float px = proj[q], pg = proj[most + q];
      const float qx = proj[2 * most + q], qg = proj[3 * most + q];
      const float xv = to_f32(xrow(r)[c]), gv = to_f32(grow(r)[c]);
      au = au + fmaf(px, gv, pg * xv);
      av = av + fmaf(qx, gv, qg * xv);
      const T dv = from_f32<T>(fmaf(qg, vh, fmaf(-pg, uh, gv)));
      if (g.staged)
        gs[r * p.w + c] = dv;  // this thread's own element of G, now read
      else
        dx[(p.row0 + r) * d + p.c0 + c] = dv;
    }
    pu_out[c] = -au;
    pv_out[c] = av;
  }
  if (g.staged) {
    __syncthreads();
    store_tile(gs, dx, g, p);
  }
}

// One warp per (direction, tenant a, block i): for each sequence b whose id
// maps to a, in order, ĝ_seq[b, i] = Σ_j part[b, j, i] in tile order j =
// 0, 1, ... (written to ghat, (2, B, d)) and g = Σ_b ĝ_seq[b, i] from 0;
// then the norm chain with bank[a, i] (u for direction 0, v for 1) into du
// (dv).  A tenant that no id names gets an exact zero.  Each sequence's
// ĝ_seq is written by its own tenant's warps alone.
__global__ void __launch_bounds__(128)
    bank_ghat_kernel(const float* __restrict__ part,
                     const float* __restrict__ u, const float* __restrict__ v,
                     float* __restrict__ ghat, float* __restrict__ du,
                     float* __restrict__ dv, int B, int n, int db, int tiles,
                     Tenants tn) {
  const long long unit =
      static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long per_dir = static_cast<long long>(tn.count) * n;
  if (unit >= 2 * per_dir) return;  // whole warps exit
  const int dir = static_cast<int>(unit / per_dir);
  const int a = static_cast<int>(unit % per_dir / n);
  const int i = static_cast<int>(unit % n);
  const long long d = static_cast<long long>(n) * db;
  const float* pd = part + dir * B * tiles * d + static_cast<long long>(i) * db;
  float* gd = ghat + dir * B * d + static_cast<long long>(i) * db;
  const float* ua = (dir ? v : u) + a * d + static_cast<long long>(i) * db;
  float* oa = (dir ? dv : du) + a * d + static_cast<long long>(i) * db;
  int hits = 0;
  for (int b = 0; b < B; ++b) hits += reflect::row_tenant(tn, b * tn.seq) == a;
  if (hits == 0) {
    for (int c = lane; c < db; c += 32) oa[c] = 0.f;
    return;
  }
  float ss = 0.f, dot = 0.f;
  for (int c = lane; c < db; c += 32) {
    float s = 0.f;
    for (int b = 0; b < B; ++b) {
      if (reflect::row_tenant(tn, b * tn.seq) != a) continue;
      float sq = 0.f;
      for (int j = 0; j < tiles; ++j)
        sq += pd[(static_cast<long long>(b) * tiles + j) * d + c];
      gd[b * d + c] = sq;
      s += sq;
    }
    oa[c] = s;
    ss = fmaf(ua[c], ua[c], ss);
    dot = fmaf(ua[c], s, dot);
  }
  const float rn = sqrtf(warp_sum(ss));
  dot = warp_sum(dot);
  const float sn = rn + kEps;
  for (int c = lane; c < db; c += 32)
    oa[c] = oa[c] / sn - (dot * ua[c]) / ((rn * sn) * sn);
}

// Lift the kernel's dynamic shared-memory limit to the most a block may
// ask for, once per kernel in this library.
template <typename K>
cudaError_t reserve(K kernel, int bytes, bool& done) {
  if (bytes <= 48 * 1024 || done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  done = err == cudaSuccess;
  return err;
}

template <typename T>
cudaError_t launch_forward(const T* x, const float* u, const float* v,
                           T* out, const Geometry& g, const Tenants& tn,
                           cudaStream_t s) {
  static bool reserved = false;
  const int bytes = smem_bytes(g, sizeof(T), false);
  const cudaError_t err = reserve(rank2_tile_kernel<T>, bytes, reserved);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(g.M / g.seq * g.tiles), g.chunks);
  rank2_tile_kernel<T><<<grid, kThreads, bytes, s>>>(x, u, v, out, g, tn);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_backward(const T* x, const T* gr, const float* u,
                            const float* v, T* dx, float* part, float* ghat,
                            float* du, float* dv, const Geometry& g,
                            const Tenants& tn, cudaStream_t s) {
  static bool reserved = false;
  const int bytes = smem_bytes(g, sizeof(T), true);
  cudaError_t err = reserve(rank2_tile_bwd_kernel<T>, bytes, reserved);
  if (err != cudaSuccess) return err;
  const int B = g.M / g.seq;
  const dim3 grid(static_cast<unsigned>(B * g.tiles), g.chunks);
  rank2_tile_bwd_kernel<T><<<grid, kThreads, bytes, s>>>(x, gr, u, v, dx,
                                                          part, g, tn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long units = 2LL * tn.count * g.n;
  bank_ghat_kernel<<<static_cast<unsigned>((units + 3) / 4), 128, 0, s>>>(
      part, u, v, ghat, du, dv, B, g.n, g.db, g.tiles, tn);
  return cudaGetLastError();
}

}  // namespace
}  // namespace r2t
