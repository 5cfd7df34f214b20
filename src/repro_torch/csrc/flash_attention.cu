// flash_attention: exact causal (and sliding-window) softmax attention with
// an online softmax, for sm_90a.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py:76, body _flash_kernel at :25): every
// dense decoder's prefill and decode attention in the port.  q (B, H, S, D)
// against k, v (B, Hkv, T, D), H % Hkv == 0, all of one dtype (f32 or bf16);
// out (B, H, S, D) in q's dtype.  Query row i sits at absolute position
// q_offset + i against keys 0..T−1; a key is valid when kpos ≤ qpos (causal)
// and kpos > qpos − window (when a window is given).  Scores, running max,
// denominator and accumulator are f32; the output is rounded once.  Masked
// scores are −1e30 and their exp is zeroed explicitly, and the denominator
// is clamped to 1e-30 before the division, as in _flash_kernel, so a row
// with no valid key returns exact zeros.
//
// What bounds it on an H100 SXM (the data sheet's rates at 700 W: 989
// TFLOP/s dense bf16 on the tensor cores, 67 TFLOP/s f32 without them, 3.35
// TB/s): at qwen2.5-32b's prefill layer (B = 2, H = 40, Hkv = 8,
// S = T = 2048, D = 128, causal) the causal half of QKᵀ and PV is 85.9
// GFLOP on 100.7 MB of q, k, v and out: 850 FLOP a byte, far above either
// ridge, so operations bound it (0.087 ms at the bf16 tensor-core rate).
// A decode step (S = 1) reads the whole KV cache for 4·T·D FLOP a head:
// bytes bound it, and the host's launch cost more.
//
// What the design does about that — a simple kernel that is right first:
//  * One block per (64 query rows, head, batch row), 256 threads as 16 × 16;
//    thread (ty, tx) owns rows ty + 16i (i < 4), score columns tx + 16j
//    (j < 4) and output columns tx + 16c (c < D/16), so the f32 accumulator
//    of a 64 × D tile is spread over the block (32 registers a thread at
//    D = 128) and never leaves registers.
//  * The q tile and K and V tiles of 64 keys are staged in shared memory in
//    their own dtype and widened on read (at D = 128: 49 KB in bf16, 98 KB
//    in f32, beside the 20 KB f32 P tile that goes through shared memory
//    between the two products); the rows of q and k are padded by one
//    32-bit word, so the 16 rows a half-warp reads at one depth fall in 16
//    banks.  Above 48 KB of dynamic shared memory is asked for with
//    cudaFuncSetAttribute.
//  * GQA without repeating KV: the block reads KV head h / (H / Hkv) itself,
//    as the Pallas index map folds heads (hi // rep).
//  * Any S and T: ragged q rows are zero-filled and never written, ragged
//    key tiles zero-filled and masked, so nothing falls back (the JAX
//    wrapper's fallback for shapes not tileable by 128, which drops
//    q_offset, has no counterpart).
//  * Tiles wholly outside the causal and window band are never visited: in
//    decode that is every cache slot past the cursor.  Inside a visited
//    tile the masked p are zeroed, so a tile that is wholly masked for a
//    row while its max is still −1e30 adds nothing (exp(0) would add 1).
//  * Row max and row sum are shuffles across the 16 threads of a row.
//    SIMT f32 FMAs, no tensor cores: a wgmma design (bf16 QKᵀ, P rounded
//    to bf16 for PV) changes the numerics and is later work.  Decode runs
//    one query row in a 64-row tile; packing a KV group's query heads into
//    one tile is later work too.
//
// C interface, bound with ctypes: flash_attention(...) launches the kernel
// on the given stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

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

}  // namespace

// q (B, H, S, D), k and v (B, Hkv, T, D), out (B, H, S, D), contiguous, of
// one dtype (0 float32, 1 bfloat16), D ∈ {32, 64, 128}, H % Hkv == 0,
// S, T ≥ 1.  window is read only when use_window is nonzero.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int H, int Hkv, int S, int T,
                               int D, int q_offset, int causal,
                               int use_window, int window, int dtype,
                               void* stream) {
  const Args a{q, k, v, out, H, Hkv, S, T, q_offset, causal ? 1 : 0,
               use_window ? 1 : 0, window,
               static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)))};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 1
                              ? launch_d<__nv_bfloat16>(a, B, D, s)
                              : launch_d<float>(a, B, D, s);
  return static_cast<int>(err);
}
