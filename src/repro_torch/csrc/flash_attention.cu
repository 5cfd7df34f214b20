// flash_attention: exact causal (and sliding-window) softmax attention with
// an online softmax, for sm_90a.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py:76, body _flash_kernel at :25): every
// dense decoder's prefill and decode attention in the port.  q (B, H, S, D)
// against k, v (B, Hkv, T, D), H % Hkv == 0, all of one dtype (f32 or bf16);
// out (B, H, S, D) in q's dtype.  Query head h reads KV head h / (H / Hkv),
// never a repeated copy.  Query row i sits at absolute position
// q_offset + i against keys 0..T−1; a key is valid when kpos ≤ qpos (causal)
// and kpos > qpos − window (when a window is given).  Scale 1/√D; scores,
// running max, denominator and accumulator are f32; the output is rounded
// once.  A masked score's probability is an exact zero and the denominator
// is clamped to 1e-30 before the division, as in _flash_kernel, so a row
// with no valid key returns exact zeros.  Any S and T, with no fallback.
//
// What bounds it on an H100 SXM (the data sheet's rates at 700 W: 989
// TFLOP/s dense bf16 on the tensor cores, 67 TFLOP/s f32 without them, 3.35
// TB/s): at qwen2.5-32b's prefill layer (B = 2, H = 40, Hkv = 8,
// S = T = 2048, D = 128, causal) the causal half of QKᵀ and PV is 85.9
// GFLOP on 100.7 MB of q, k, v and out: 850 FLOP a byte, above the bf16
// ridge (~295), so operations bound it (0.087 ms on the tensor cores).  A
// decode step (S = 1) reads the whole KV cache for 4·D FLOP a key and
// query head: about 5 FLOP a byte at qwen2.5-32b's 5 query heads a KV
// head, so bytes bound it (17 MB, 0.005 ms), and the host's launch cost
// more.
//
// Three routes, chosen on the host (kernels/flash_attention.py, `route`)
// from the dtype, D and the rows S·(H/Hkv) a KV group's query heads
// bring:
//
// 1. `wgmma` (bf16, D ∈ {64, 128}, more than kMaxRows rows a group):
//    prefill on the tensor cores.  One block per 128 query rows of one
//    (b, h): two consumer warpgroups of 64 rows and one producer warp.
//    The producer issues TMA loads of the q tile once, then of K and V
//    tiles of 128 keys into a ring of two stages under the 128-byte
//    swizzle (a 128-wide row is two 64-column boxes), with full and empty
//    mbarriers.  Its maps are 3-D, (D, S, B·H) for q and (D, T, B·Hkv) for
//    k and v, so a box zero-fills at its own head's S or T edge and never
//    reads the next head's rows (a masked 0 times a neighbour's inf would
//    be NaN).  Each warpgroup computes S = Q·Kᵀ with wgmma m64n128k16 (A
//    = q, B = K, both K-major from shared memory, f32 sums of the exact
//    bf16 products), runs the online softmax on the accumulator fragment
//    (scores in base 2, row max shuffled across the quad of a row; each
//    thread keeps its own partial row sum, added across the quad once at
//    the end), rounds P to bf16 in registers and feeds it as the register
//    A operand of the P·V wgmma m64nDk16 (the S fragment's layout is the A
//    fragment's, so P never touches shared memory; B = the V tile,
//    N-major through the transpose bit).  O stays in f32 registers and is
//    divided once and rounded once.  Tiles wholly outside the causal or
//    window band are never loaded; only the diagonal, window-edge and
//    T-edge tiles are masked; the last query tiles, which see the most
//    keys under causality, are handed out first.
//    Where it rounds: q and k are the stored bf16 (their products are
//    exact in f32); P is rounded to bf16 for P·V while the denominator
//    sums the f32 P; O is rounded once to bf16.  Held to 1e-2 relative
//    Frobenius against the plain version (f32 throughout).
// 2. `decode` (both dtypes, every D, at most kMaxRows = 64 rows a
//    group: every decode step): one block's tile holds a KV group's
//    H/Hkv query heads × S rows, so K and V are read once a group, not
//    once a head.  T is split over blocks (grid splits × Hkv × B) so that
//    the groups fill the 132 SMs; the split count comes from B, Hkv and
//    T, the cache length, never from q_offset, so one grid serves every
//    cursor (a split past it writes m = −1e30, l = 0 and exits).  Each
//    split walks its keys in tiles of 64, staged by cp.async (16 bytes a
//    thread, zero-filled outside the split's valid keys) into two
//    buffers, in f32 on the CUDA cores (the tensor cores buy nothing at
//    these rows, and float32 keeps its 1e-5).  With one split the block
//    writes the output; with more, each writes its (m, l, acc) partials in
//    f32 to the caller's scratch and a second launch combines them in
//    split order, with no atomics, so two calls agree bit for bit.
// 3. `simt` (f32 prefill, where TF32 would miss 1e-5; D = 32): the
//    first port, one block per (64 query rows, head, batch row), 256
//    threads as 16 × 16; SIMT f32 FMAs, P through shared memory.
//
// C interface, bound with ctypes: flash_attention(...) launches the route
// it is given on the given stream, allocates nothing and returns
// cudaGetLastError(); flash_map_counts reads the wgmma route's tensor-map
// cache.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// Route `simt`: the first port, unchanged
// ---------------------------------------------------------------------------
//
// One block per (64 query rows, head, batch row), 256 threads as 16 × 16;
// thread (ty, tx) owns rows ty + 16i (i < 4), score columns tx + 16j
// (j < 4) and output columns tx + 16c (c < D/16), so the f32 accumulator
// of a 64 × D tile never leaves registers.  The q tile and K and V tiles
// of 64 keys are staged in shared memory in their own dtype and widened
// on read; the rows of q and k are padded by one 32-bit word.  Ragged q
// rows are zero-filled and never written, ragged key tiles zero-filled
// and masked; tiles outside the causal and window band are never
// visited.  Row max and row sum are shuffles across the 16 threads of a
// row; P goes through shared memory between the two products.

constexpr int kBQ = 64;          // query rows a block
constexpr int kBK = 64;          // keys a tile
constexpr int kThreads = 256;    // 16 × 16
constexpr int kLdP = kBK + 16;   // P rows: ty and ty + 1 sixteen banks apart
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, Hkv, S, T;
  int q_offset, causal, use_window, window;
  float scale;
};

// Row stride (elements) of q and k in shared memory: D plus one 32-bit word.
template <typename T, int D>
__host__ __device__ constexpr int ld_qk() {
  return D + 4 / static_cast<int>(sizeof(T));
}

template <typename T, int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return static_cast<size_t>(kBQ + kBK) * ld_qk<T, D>() * sizeof(T) +
         static_cast<size_t>(kBK) * D * sizeof(T) +
         static_cast<size_t>(kBQ) * kLdP * sizeof(float);
}

// The elements of one 16-byte load, in order, into dst.
__device__ __forceinline__ void unpack(float* dst, const uint4& raw) {
  dst[0] = __uint_as_float(raw.x);
  dst[1] = __uint_as_float(raw.y);
  dst[2] = __uint_as_float(raw.z);
  dst[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(__nv_bfloat16* dst, const uint4& raw) {
  const unsigned int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dst[2 * i] = __ushort_as_bfloat16(static_cast<unsigned short>(w[i]));
    dst[2 * i + 1] =
        __ushort_as_bfloat16(static_cast<unsigned short>(w[i] >> 16));
  }
}

// `rows` rows of D contiguous elements from src into dst (row stride LD),
// 64 rows in all, the rest zero.  16-byte global loads; src is 16-byte
// aligned (the wrapper checks the base pointers, and D·sizeof(T) is a
// multiple of 16).
template <typename T, int D, int LD>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      int rows, int tid) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kPerRow = D / kVec;
  for (int idx = tid; idx < 64 * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const int c = (idx % kPerRow) * kVec;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) {
      raw = __ldg(reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(r) * D + c));
    }
    unpack(dst + r * LD + c, raw);
  }
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) flash_kernel(Args a) {
  constexpr int kLd = ld_qk<T, D>();
  constexpr int kCols = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);          // kBQ × kLd
  T* sk = sq + kBQ * kLd;                      // kBK × kLd
  T* sv = sk + kBK * kLd;                      // kBK × D
  float* sp = reinterpret_cast<float*>(sv + kBK * D);  // kBQ × kLdP

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int rows = min(kBQ, a.S - q0);
  const size_t q_base = ((static_cast<size_t>(b) * a.H + h) * a.S + q0) * D;
  const size_t kv_base = (static_cast<size_t>(b) * a.Hkv + hk) * a.T * D;
  const T* k = static_cast<const T*>(a.k) + kv_base;
  const T* v = static_cast<const T*>(a.v) + kv_base;

  // the keys any of this block's rows can see: [kbeg, kend)
  const int qlo = a.q_offset + q0, qhi = a.q_offset + q0 + rows - 1;
  const int kend = a.causal ? min(a.T, qhi + 1) : a.T;
  const int kbeg = a.use_window ? max(0, qlo - a.window + 1) : 0;

  stage<T, D, kLd>(sq, static_cast<const T*>(a.q) + q_base, rows, tid);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = (kbeg / kBK) * kBK; k0 < kend; k0 += kBK) {
    const int krows = min(kBK, a.T - k0);
    __syncthreads();  // the last tile's K, V and P are consumed
    stage<T, D, kLd>(sk, k + static_cast<size_t>(k0) * D, krows, tid);
    stage<T, D, D>(sv, v + static_cast<size_t>(k0) * D, krows, tid);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = widen(sq[(ty + 16 * i) * kLd + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = widen(sk[(tx + 16 * j) * kLd + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = a.q_offset + q0 + ty + 16 * i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < a.T && (!a.causal || kpos <= qpos) &&
                (!a.use_window || kpos > qpos - a.window);
        s[i][j] = ok[j] ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sp[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = sp[(ty + 16 * i) * kLdP + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vb = widen(sv[kk * D + tx + 16 * c]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pa[i], vb, acc[i][c]);
      }
    }
  }

  T* o = static_cast<T*>(a.o) + q_base;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      put(o + static_cast<size_t>(r) * D + tx + 16 * c, acc[i][c] / den);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Args& a, int B, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<T, D>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((a.S + kBQ - 1) / kBQ),
                  static_cast<unsigned>(a.H), static_cast<unsigned>(B));
  flash_kernel<T, D><<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Args& a, int B, int D, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, 32>(a, B, s);
    case 64:
      return launch<T, 64>(a, B, s);
    case 128:
      return launch<T, 128>(a, B, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Route `wgmma`: bf16 prefill on TMA and the tensor cores
// ---------------------------------------------------------------------------

namespace wg {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kBQ = 128;                // query rows a block, 64 a warpgroup
constexpr int kBK = 128;                // keys a tile
constexpr int kStages = 2;              // K and V tiles in flight
constexpr int kThreads = 2 * 128 + 32;  // two consumer warpgroups, a producer
constexpr int kConsumerWarps = 8;

// Shared memory: the q tile (D/64 boxes of kBQ rows × 128 bytes), the ring
// (each stage a K and a V tile of D/64 boxes of kBK rows), 1 + 2·kStages
// mbarriers and room to align the tiles to the swizzle's 1024 bytes.
template <int D>
__host__ __device__ constexpr int q_bytes() {
  return D / 64 * kBQ * 128;
}
template <int D>
__host__ __device__ constexpr int kv_bytes() {
  return D / 64 * kBK * 128;
}
template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return q_bytes<D>() + kStages * 2 * kv_bytes<D>() + 8 * (1 + 2 * kStages) +
         1024;
}

struct Args {
  bf16* o;
  int BH, H, Hkv, S, T;
  int q_offset, causal, use_window, window, q_tiles;
  float scale_log2;  // 1/√D · log2(e): the scores in base 2
};

__device__ __forceinline__ bool valid(int kpos, int qpos, const Args& a) {
  return kpos < a.T && (!a.causal || kpos <= qpos) &&
         (!a.use_window || kpos > qpos - a.window);
}

// Two f32 values as a bf16 pair, `lo` in the low half (round to nearest
// even, as torch's .to()).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const Args a) {
  constexpr int kQ = q_bytes<D>(), kKV = kv_bytes<D>();
  constexpr int kBoxes = D / 64;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the swizzle repeats every 1024 bytes: tiles start on that boundary
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;  // q tile
  const uint32_t bars = base + kQ + kStages * 2 * kKV;
  const uint32_t qbar = bars;
  auto k_tile = [&](int s) { return base + kQ + s * 2 * kKV; };  // V: + kKV
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + kStages + s); };

  // blocks are handed out in index order: under causality the last query
  // tiles, which see the most keys, go first
  const int bh = static_cast<int>(blockIdx.x) % a.BH;
  int qt = static_cast<int>(blockIdx.x) / a.BH;
  if (a.causal) qt = a.q_tiles - 1 - qt;
  const int h = bh % a.H;
  const int hk = bh / a.H * a.Hkv + h / (a.H / a.Hkv);  // (b, KV head)
  const int q0 = qt * kBQ;
  const int rows = min(kBQ, a.S - q0);
  // the keys any of this block's rows can see: [kbeg, kend)
  const int qlo = a.q_offset + q0, qhi = qlo + rows - 1;
  const int kend = a.causal ? min(a.T, qhi + 1) : a.T;
  const int kbeg = a.use_window ? max(0, qlo - a.window + 1) : 0;
  const int t_first = kbeg / kBK;
  const int n_tiles = kbeg < kend ? (kend - 1) / kBK - t_first + 1 : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer warp: one lane issues
    if (lane == 0) {
      mbar_expect_tx(qbar, kQ);
      for (int c = 0; c < kBoxes; ++c)
        tma_load(base + c * kBQ * 128, &tq, qbar, 64 * c, q0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        // the stage's previous round freed (the first round passes)
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * kKV);
        const int k0 = (t_first + it) * kBK;
        for (int c = 0; c < kBoxes; ++c) {
          tma_load(k_tile(s) + c * kBK * 128, &tk, full(s), 64 * c, k0, hk);
          tma_load(k_tile(s) + kKV + c * kBK * 128, &tv, full(s), 64 * c, k0,
                   hk);
        }
      }
    }
    return;
  }

  // consumer warpgroup g: rows 64g .. 64g + 63 of the block; this thread's
  // rows of the fragment r0 and r0 + 8, its columns 8j + c0 + {0, 1}
  const int g = warp / 4;
  const int r0 = 64 * g + 16 * (warp % 4) + lane / 4;
  const int qpos0 = a.q_offset + q0 + r0, qpos1 = qpos0 + 8;
  const int wlo = a.q_offset + q0 + 64 * g, whi = wlo + 63;
  const bool live = q0 + 64 * g < a.S;
  const int c0 = 2 * (lane % 4);
  const uint32_t q_rows = base + g * 64 * 128;

  float o[D / 2], sc[kBK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // running max (base 2; −inf until a valid key) and this thread's share
  // of the row sums
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  mbar_wait(qbar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int k0 = (t_first + it) * kBK;
    mbar_wait(full(s), (it / kStages) & 1);
    // a tile no row of this warpgroup can see (its rows past S, or the
    // whole tile after them or below their window) is only freed
    const bool skip = !live || (a.causal && k0 > whi) ||
                      (a.use_window && k0 + kBK - 1 <= wlo - a.window);
    if (!skip) {
      // S = Q·Kᵀ: 16 of D a product; A's next 16 are 32 bytes along its
      // 128-byte rows, its next 64 the next box.  (The first product
      // ignores sc; zeroing it lets its registers go between tiles.)
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        WgmmaSS<kBK, 0>::mma(
            sc,
            sw128_desc(q_rows + (ks / 4) * kBQ * 128 + (ks % 4) * 32, 16,
                       1024),
            sw128_desc(k_tile(s) + (ks / 4) * kBK * 128 + (ks % 4) * 32, 16,
                       1024),
            ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);

      // masked only where some key of the tile may be invalid for some row
      const bool edge = (a.causal && k0 + kBK - 1 > wlo) || k0 + kBK > a.T ||
                        (a.use_window && k0 <= whi - a.window);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v0 = sc[4 * j + e] * a.scale_log2;
          float v1 = sc[4 * j + 2 + e] * a.scale_log2;
          if (edge) {
            const int kpos = k0 + 8 * j + c0 + e;
            if (!valid(kpos, qpos0, a)) v0 = -INFINITY;
            if (!valid(kpos, qpos1, a)) v1 = -INFINITY;
          }
          sc[4 * j + e] = v0;
          sc[4 * j + 2 + e] = v1;
          mx0 = fmaxf(mx0, v0);
          mx1 = fmaxf(mx1, v1);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      // a row that has seen no valid key yet subtracts 0: its p are then
      // exp2(−inf) = exact zeros, and so stay its sums
      const float u0 = n0 == -INFINITY ? 0.f : n0;
      const float u1 = n1 == -INFINITY ? 0.f : n1;
      const float al0 = exp2f(m0 - u0), al1 = exp2f(m1 - u1);
      m0 = n0;
      m1 = n1;
      // P in bf16, in the register A fragment of the P·V product: keys
      // 16kk .. 16kk + 15 are the fragment's columns 8j.., j = 2kk, 2kk + 1
      uint32_t pa[kBK / 16][4];
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const float p00 = exp2f(sc[4 * j] - u0);
        const float p01 = exp2f(sc[4 * j + 1] - u0);
        const float p10 = exp2f(sc[4 * j + 2] - u1);
        const float p11 = exp2f(sc[4 * j + 3] - u1);
        ls0 += p00 + p01;
        ls1 += p10 + p11;
        pa[j / 2][2 * (j % 2)] = pack_bf16(p00, p01);
        pa[j / 2][2 * (j % 2) + 1] = pack_bf16(p10, p11);
      }
      l0 = l0 * al0 + ls0;
      l1 = l1 * al1 + ls1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= al0;
        o[4 * j + 1] *= al0;
        o[4 * j + 2] *= al1;
        o[4 * j + 3] *= al1;
      }
      // O += P·V: 16 keys a product, the V tile's next 16 rows 2048 bytes
      // on, its next 64 columns the next box (kBK·128 bytes on)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        WgmmaRS<D, 1>::mma(
            o, pa[kk],
            sw128_desc(k_tile(s) + kKV + kk * 2048, kBK * 128, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

  // the row sums across the quad, in one order; one division, one rounding
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  bf16* const out = a.o + (static_cast<size_t>(bh) * a.S + q0) * D + c0;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (r0 < rows)
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(r0) * D +
                                         8 * j) =
          __floats2bfloat162_rn(o[4 * j] / d0, o[4 * j + 1] / d0);
    if (r0 + 8 < rows)
      *reinterpret_cast<__nv_bfloat162*>(
          out + static_cast<size_t>(r0 + 8) * D + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
  }
}

// the route's tensor maps, read by flash_map_counts
MapCache map_cache;

template <int D>
cudaError_t launch(EncodeTiled enc, const void* q, const void* k,
                   const void* v, const Args& a, int B, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  const uint64_t q_dims[3] = {D, static_cast<uint64_t>(a.S),
                              static_cast<uint64_t>(a.BH)};
  const uint64_t kv_dims[3] = {D, static_cast<uint64_t>(a.T),
                               static_cast<uint64_t>(B) * a.Hkv};
  const uint32_t q_box[3] = {64, kBQ, 1}, kv_box[3] = {64, kBK, 1};
  if (!map_cache.get(enc, &tq, q, 3, q_dims, q_box) ||
      !map_cache.get(enc, &tk, k, 3, kv_dims, kv_box) ||
      !map_cache.get(enc, &tv, v, 3, kv_dims, kv_box))
    return cudaErrorNotSupported;
  static bool sized[kMaxDevices] = {};
  const cudaError_t err =
      reserve_smem(wgmma_kernel<D>, smem_bytes<D>(), sized);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(a.q_tiles) * a.BH;
  wgmma_kernel<D><<<static_cast<unsigned>(blocks), kThreads, smem_bytes<D>(),
                    st>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

int run(const void* q, const void* k, const void* v, void* o, int B, int H,
        int Hkv, int S, int T, int D, int q_offset, int causal,
        int use_window, int window, cudaStream_t st) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const Args a{static_cast<bf16*>(o), B * H, H, Hkv, S, T, q_offset,
               causal ? 1 : 0, use_window ? 1 : 0, window, (S + kBQ - 1) / kBQ,
               static_cast<float>(1.4426950408889634 /
                                  std::sqrt(static_cast<double>(D)))};
  switch (D) {
    case 64:
      return static_cast<int>(launch<64>(enc, q, k, v, a, B, st));
    case 128:
      return static_cast<int>(launch<128>(enc, q, k, v, a, B, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace wg

// ---------------------------------------------------------------------------
// Route `decode`: a KV group's query rows a block, T split over blocks
// ---------------------------------------------------------------------------

namespace dec {

constexpr int kKeys = 64;      // keys a tile
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 64;   // query rows a group, at most

// K and V rows in shared memory: D plus 16 bytes, so the 8 rows that a
// quarter-warp's 16-byte loads read at one column fall in 8 bank groups
template <typename T, int D>
__host__ __device__ constexpr int ld() {
  return D + 16 / static_cast<int>(sizeof(T));
}

// two buffers of a K and a V tile, then q (rows × D f32), the scores and
// probabilities (rows × kKeys f32), each row's rescale factor and sum
template <typename T, int D>
__host__ __device__ constexpr int smem_bytes(int rows) {
  return 4 * kKeys * ld<T, D>() * static_cast<int>(sizeof(T)) +
         rows * (D + kKeys) * 4 + 2 * kMaxRows * 4;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* part;  // splits > 1: acc (G·splits·rows·D), then (m, l) pairs
  int H, Hkv, S, T, rep, rows, groups;
  int q_offset, causal, use_window, window, splits, split_keys;
  float scale;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  // src-size 0 writes 16 zero bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Block (split, KV head, b): the group's rows r = (h % rep)·S + s, which
// are contiguous in q and out, against the split's keys.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const Args a) {
  constexpr int kLd = ld<T, D>();
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kChunks = D / kVec;          // 16-byte pieces of a row
  constexpr int kGroups = kThreads / D;      // threads on one column
  constexpr int kPer = kMaxRows / kGroups;   // rows a thread sums, at most
  extern __shared__ __align__(16) unsigned char smem[];
  T* const kv = reinterpret_cast<T*>(smem);  // [buffer][K, V][kKeys][kLd]
  float* const qs = reinterpret_cast<float*>(kv + 4 * kKeys * kLd);
  float* const ss = qs + a.rows * D;
  float* const alpha_s = ss + a.rows * kKeys;
  float* const l_s = alpha_s + kMaxRows;

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int R = a.rows;
  const int group = b * a.Hkv + hk;
  const size_t row0 = (static_cast<size_t>(b) * a.H + hk * a.rep) * a.S;
  const T* const kg = static_cast<const T*>(a.k) +
                      static_cast<size_t>(group) * a.T * D;
  const T* const vg = static_cast<const T*>(a.v) +
                      static_cast<size_t>(group) * a.T * D;
  // the keys of this split that some row can see: [lo, hi)
  const int qhi = a.q_offset + a.S - 1;
  const int kend = a.causal ? min(a.T, qhi + 1) : a.T;
  const int kbeg = a.use_window ? max(0, a.q_offset - a.window + 1) : 0;
  const int lo = max(split * a.split_keys, kbeg);
  const int hi = min(min(split * a.split_keys + a.split_keys, a.T), kend);
  const size_t slot = static_cast<size_t>(group) * a.splits + split;
  float* const ml = a.part + static_cast<size_t>(a.groups) * a.splits * R * D;

  if (lo >= hi) {  // no key of the split is visible to any row
    if (a.splits > 1) {
      for (int r = tid; r < R; r += kThreads) {
        ml[2 * (slot * R + r)] = -1e30f;
        ml[2 * (slot * R + r) + 1] = 0.f;
      }
    } else {
      T* const o = static_cast<T*>(a.o) + row0 * D;
      for (int i = tid; i < R * D; i += kThreads) put(o + i, 0.f);
    }
    return;
  }

  auto load = [&](int buf, int k0) {
    T* const ks = kv + buf * 2 * kKeys * kLd;
    T* const vs = ks + kKeys * kLd;
    for (int i = tid; i < kKeys * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * kVec;
      const int key = k0 + r;
      const bool ok = key >= lo && key < hi;
      const size_t at = ok ? static_cast<size_t>(key) * D + c : 0;
      cp_async16(ks + r * kLd + c, kg + at, ok);
      cp_async16(vs + r * kLd + c, vg + at, ok);
    }
    cp_async_commit();
  };

  const int t0 = lo / kKeys * kKeys;
  const int n_tiles = (hi - 1) / kKeys - lo / kKeys + 1;
  load(0, t0);
  {
    const T* const q = static_cast<const T*>(a.q) + row0 * D;
    for (int i = tid; i < R * D; i += kThreads) qs[i] = widen(q[i]);
  }

  // the softmax's rows: warp w owns rows w, w + 8, ..
  float m[kMaxRows / kWarps], l[kMaxRows / kWarps];
#pragma unroll
  for (int i = 0; i < kMaxRows / kWarps; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  // P·V: thread (gi, d) sums column d of rows gi, gi + kGroups, ..
  const int gi = tid / D, d = tid % D;
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1, k0 = t0 + t * kKeys;
    if (t + 1 < n_tiles) {
      load(buf ^ 1, k0 + kKeys);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* const ks = kv + buf * 2 * kKeys * kLd;
    const T* const vs = ks + kKeys * kLd;

    // scores: thread pairs (row, key), 32 keys of one row a warp
    for (int p = tid; p < R * kKeys; p += kThreads) {
      const int r = p / kKeys, key = p % kKeys, kpos = k0 + key;
      const int qpos = a.q_offset + r % a.S;
      const bool ok = kpos >= lo && kpos < hi &&
                      (!a.causal || kpos <= qpos) &&
                      (!a.use_window || kpos > qpos - a.window);
      float dot = 0.f;
      if (ok) {
        const float* const qr = qs + r * D;
        const T* const kr = ks + key * kLd;
#pragma unroll 4
        for (int c = 0; c < kChunks; ++c) {
          T kx[kVec];
          unpack(kx, *reinterpret_cast<const uint4*>(kr + c * kVec));
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            dot = fmaf(qr[c * kVec + e], widen(kx[e]), dot);
        }
      }
      ss[r * kKeys + key] = ok ? dot * a.scale : -INFINITY;
    }
    __syncthreads();

    // online softmax, a warp a row, two keys a lane
#pragma unroll
    for (int i = 0; i < kMaxRows / kWarps; ++i) {
      const int r = warp + kWarps * i;
      if (r >= R) break;
      float* const sr = ss + r * kKeys;
      const float s0 = sr[lane], s1 = sr[lane + 32];
      const float n = fmaxf(m[i], warp_max(fmaxf(s0, s1)));
      // a row with no valid key yet subtracts 0: exact zeros
      const float u = n == -INFINITY ? 0.f : n;
      const float alpha = expf(m[i] - u);
      const float p0 = expf(s0 - u), p1 = expf(s1 - u);
      l[i] = l[i] * alpha + warp_sum(p0 + p1);
      m[i] = n;
      sr[lane] = p0;
      sr[lane + 32] = p1;
      if (lane == 0) alpha_s[r] = alpha;
    }
    __syncthreads();

    // acc = acc·alpha + P·V, keys in order
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = gi + kGroups * i;
      if (r >= R) break;
      acc[i] *= alpha_s[r];
    }
#pragma unroll 4
    for (int key = 0; key < kKeys; ++key) {
      const float vv = widen(vs[key * kLd + d]);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int r = gi + kGroups * i;
        if (r >= R) break;
        acc[i] = fmaf(ss[r * kKeys + key], vv, acc[i]);
      }
    }
    __syncthreads();  // the buffer and the scores are free again
  }

  if (a.splits == 1) {
#pragma unroll
    for (int i = 0; i < kMaxRows / kWarps; ++i) {
      const int r = warp + kWarps * i;
      if (r >= R) break;
      if (lane == 0) l_s[r] = l[i];
    }
    __syncthreads();
    T* const o = static_cast<T*>(a.o) + row0 * D;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = gi + kGroups * i;
      if (r >= R) break;
      put(o + static_cast<size_t>(r) * D + d,
          acc[i] / fmaxf(l_s[r], 1e-30f));
    }
  } else {
#pragma unroll
    for (int i = 0; i < kMaxRows / kWarps; ++i) {
      const int r = warp + kWarps * i;
      if (r >= R) break;
      if (lane == 0) {
        ml[2 * (slot * R + r)] = l[i] > 0.f ? m[i] : -1e30f;
        ml[2 * (slot * R + r) + 1] = l[i];
      }
    }
    float* const pa = a.part + slot * R * D;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = gi + kGroups * i;
      if (r >= R) break;
      pa[static_cast<size_t>(r) * D + d] = acc[i];
    }
  }
}

// out row r of group (b, KV head) from the splits' partials, in split
// order: M the largest m of the splits that saw a key, then
// Σ acc·e^(m − M) / max(Σ l·e^(m − M), 1e-30).
template <typename T, int D>
__global__ void __launch_bounds__(D) combine_kernel(const Args a) {
  const int r = blockIdx.x, hk = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int R = a.rows;
  const size_t first = static_cast<size_t>(b * a.Hkv + hk) * a.splits;
  const float* const ml =
      a.part + static_cast<size_t>(a.groups) * a.splits * R * D;
  float top = -INFINITY;
  for (int i = 0; i < a.splits; ++i) {
    const size_t at = 2 * ((first + i) * R + r);
    if (ml[at + 1] > 0.f) top = fmaxf(top, ml[at]);
  }
  float den = 0.f, num = 0.f;
  for (int i = 0; i < a.splits; ++i) {
    const size_t at = 2 * ((first + i) * R + r);
    const float li = ml[at + 1];
    if (li > 0.f) {
      const float w = expf(ml[at] - top);
      den = fmaf(li, w, den);
      num = fmaf(a.part[((first + i) * R + r) * D + d], w, num);
    }
  }
  T* const o = static_cast<T*>(a.o) +
               ((static_cast<size_t>(b) * a.H + hk * a.rep) * a.S + r) * D;
  put(o + d, num / fmaxf(den, 1e-30f));
}

template <typename T, int D>
cudaError_t launch(const Args& a, int B, cudaStream_t st) {
  static bool sized[hopper::kMaxDevices] = {};
  cudaError_t err = hopper::reserve_smem(decode_kernel<T, D>,
                                         smem_bytes<T, D>(kMaxRows), sized);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(a.splits),
                  static_cast<unsigned>(a.Hkv), static_cast<unsigned>(B));
  decode_kernel<T, D><<<grid, kThreads, smem_bytes<T, D>(a.rows), st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  const dim3 rows(static_cast<unsigned>(a.rows), static_cast<unsigned>(a.Hkv),
                  static_cast<unsigned>(B));
  combine_kernel<T, D><<<rows, D, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
int run(const Args& a, int B, int D, cudaStream_t st) {
  switch (D) {
    case 32:
      return static_cast<int>(launch<T, 32>(a, B, st));
    case 64:
      return static_cast<int>(launch<T, 64>(a, B, st));
    case 128:
      return static_cast<int>(launch<T, 128>(a, B, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace dec

}  // namespace

// q (B, H, S, D), k and v (B, Hkv, T, D), out (B, H, S, D), contiguous, of
// one dtype (0 float32, 1 bfloat16), D ∈ {32, 64, 128}, H % Hkv == 0,
// S, T ≥ 1; window is read only when use_window is nonzero.  route: 0 =
// simt, 1 = wgmma (bf16, D ∈ {64, 128}, 16-byte aligned), 2 = decode
// (S·(H/Hkv) ≤ 64, 16-byte aligned) over `splits` splits of `split_keys`
// keys (a multiple of 64; splits · split_keys ≥ T); with splits > 1,
// scratch holds B·Hkv·splits·S·(H/Hkv)·(D + 2) f32, written before it is
// read.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, void* scratch, int B, int H,
                               int Hkv, int S, int T, int D, int q_offset,
                               int causal, int use_window, int window,
                               int dtype, int route, int splits,
                               int split_keys, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    return wg::run(q, k, v, out, B, H, Hkv, S, T, D, q_offset, causal,
                   use_window, window, s);
  }
  if (route == 2) {
    const int rep = H / Hkv, rows = S * rep;
    if (rows > dec::kMaxRows || splits < 1 || split_keys % dec::kKeys ||
        static_cast<long long>(splits) * split_keys < T ||
        (splits > 1 && scratch == nullptr) ||
        (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v)) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    const dec::Args a{q, k, v, out, static_cast<float*>(scratch), H, Hkv, S,
                      T, rep, rows, B * Hkv, q_offset, causal ? 1 : 0,
                      use_window ? 1 : 0, window, splits, split_keys,
                      static_cast<float>(
                          1.0 / std::sqrt(static_cast<double>(D)))};
    return dtype == 1 ? dec::run<__nv_bfloat16>(a, B, D, s)
                      : dec::run<float>(a, B, D, s);
  }
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, out, H, Hkv, S, T, q_offset, causal ? 1 : 0,
               use_window ? 1 : 0, window,
               static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)))};
  const cudaError_t err = dtype == 1 ? launch_d<__nv_bfloat16>(a, B, D, s)
                                     : launch_d<float>(a, B, D, s);
  return static_cast<int>(err);
}

// The wgmma route's tensor-map cache: lookups and encodes (its misses)
// since the library was loaded, into counts[0] and counts[1].
extern "C" int flash_map_counts(long long* counts) {
  wg::map_cache.counts(counts);
  return 0;
}
