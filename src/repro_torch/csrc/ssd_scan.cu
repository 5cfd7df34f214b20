// ssd_chunk: the Mamba-2 SSD intra-chunk dual form, for sm_90a.
//
// Replaces the TPU kernel ssd_chunk_pallas (src/repro/kernels/ssd_scan.py:52,
// body _ssd_chunk_kernel at :22): the chunked scan of every Mamba-2
// prefill.  For each (batch b, head h, chunk k) of L ≤ 256 steps:
//   cum      = cumsum(a) within the chunk,
//   y[i]     = Σ_{j≤i} exp(cum_i − cum_j)·(c_i·b_j)·x_j     (L, P)
//   state    = Σ_j exp(cum_{L−1} − cum_j)·b_j ⊗ x_j         (N, P)
//   decay    = exp(cum_{L−1}).
// Operands in the model's layout, not head-expanded: xv (B, S, H, P) f32,
// a (B, S, H) f32, b and c (B, S, G, N) f32 or bf16, head h reading group
// h / (H/G) (the Pallas route first copies b and c to every head in f32,
// 64× their bytes at mamba2-1.3b's 64 heads and one group); outputs
// y (B, S, H, P), states (B, H, nc, N, P), decays (B, H, nc), all f32.
// Everything inside is f32 (b, c converted on load, f32 accumulation), as
// in the Pallas kernel.  exp is always taken of a difference of cumulative
// sums (≤ 0 on and below the diagonal), never as exp(cum_i)·exp(−cum_j),
// so no factor overflows under strong decay; entries above the diagonal
// are never formed.
//
// What bounds it on an H100 SXM (3.35 TB/s; 67 TFLOP/s f32 without tensor
// cores, the data sheet's rates at 700 W): at mamba2-1.3b's widths
// (H = 64, P = 64, N = 128, L = 256) a (head, chunk) needs
// L(L+1)/2·2(N+P) + 2LNP ≈ 17 MFLOP on 64 KB of xv read and 64 + 32 KB of
// y and state written: about 170 FLOP a byte, above the f32 ridge
// (20 FLOP/B), so operations bound.  At S = 32 (one short chunk) the
// score triangle is small and the bytes take over.
//
// What the design does about that — a simple kernel that is right first:
//  * The Pallas kernel holds a whole chunk's L×L score tile in VMEM; at
//    L = 256 that is 256 KB of f32, above the 227 KB a block may use.  So
//    ssd_intra_kernel takes 64 query rows (and 64 output columns) a block
//    and walks the key rows in tiles of 64, only up to the diagonal: a
//    64×64 score tile (c_i·b_j on 64×N staged rows of c and b, times the
//    decay, masked on the diagonal tile) is built in shared memory and
//    multiplied into the 64×64 output at once; ~100 KB of dynamic shared
//    memory at N = 128, two blocks a SM.
//  * ssd_state_kernel computes a chunk's state, 64 rows of N by 64
//    columns of P a block, from staged tiles of exp(cum_{L−1} − cum_j)·b_j
//    and x_j; its (n-tile 0, p-tile 0) block writes the chunk's decay.
//  * Every block forms its chunk's cumsum itself (a warp scan; L ≤ 256),
//    so the two kernels share no scratch and need no ordering.
//  * Each thread keeps a 4×4 register tile whose rows and columns are 16
//    apart, so the shared-memory reads of a warp hit distinct banks or
//    broadcast; rows of c and b are padded to N+1 floats.  SIMT f32 FMAs,
//    no tensor cores: wgmma with TMA-fed tiles is for a later PR.
//
// C interface, bound with ctypes: ssd_chunk(...) launches both kernels on
// the given stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 64;       // query rows, key rows, state rows, columns
constexpr int kThreads = 256;   // 16 × 16 threads, 4 × 4 outputs each
constexpr int kMaxL = 256;

struct Args {
  const float* xv;
  const float* a;
  const void* b;
  const void* c;
  float* y;
  float* states;
  float* decays;
  int S, H, G, N, P, L, nc, row_tiles, n_tiles, p_tiles;
};

__device__ __forceinline__ float load(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// cum[t] = a[chunk k, steps 0..t] summed, for t < L; ends with a barrier
__device__ void chunk_cumsum(const Args& q, int bi, int h, int k, float* cum) {
  __shared__ float warp_sum[kThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  float v = 0.f;
  if (t < q.L)
    v = q.a[((size_t)bi * q.S + (size_t)k * q.L + t) * q.H + h];
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += o;
  }
  if (lane == 31) warp_sum[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v += warp_sum[w];
  if (t < q.L) cum[t] = v;
  __syncthreads();
}

// y rows [r0, r0+64) × columns [p0, p0+64) of one (b, h, chunk)
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_intra_kernel(Args q) {
  extern __shared__ float smem[];
  const int N = q.N, L = q.L, ldn = N + 1;
  float* c_s = smem;                           // [kTile][ldn]  c_i
  float* b_s = c_s + kTile * ldn;              // [kTile][ldn]  b_j
  float* x_s = b_s + kTile * ldn;              // [kTile][kTile] x_j, p
  float* s_s = x_s + kTile * kTile;            // [kTile][kTile+1] scores
  float* cum = s_s + kTile * (kTile + 1);      // [kMaxL]

  int tile = blockIdx.x;
  const int pt = tile % q.p_tiles;
  tile /= q.p_tiles;
  const int rt = tile % q.row_tiles, k = tile / q.row_tiles;
  const int h = blockIdx.y, bi = blockIdx.z, g = h / (q.H / q.G);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int r0 = rt * kTile, p0 = pt * kTile;
  const size_t tok0 = (size_t)bi * q.S + (size_t)k * L;  // chunk's step 0
  const T* bp = static_cast<const T*>(q.b);
  const T* cp = static_cast<const T*>(q.c);

  chunk_cumsum(q, bi, h, k, cum);
  for (int e = threadIdx.x; e < kTile * N; e += kThreads) {
    const int i = e / N, n = e % N;
    c_s[i * ldn + n] = r0 + i < L
        ? load(cp, ((tok0 + r0 + i) * q.G + g) * N + n) : 0.f;
  }

  float acc[4][4] = {};
  for (int jt = 0; jt <= rt; ++jt) {           // key tiles up to the diagonal
    const int j0 = jt * kTile;
    __syncthreads();                           // b_s, x_s, s_s free again
    for (int e = threadIdx.x; e < kTile * N; e += kThreads) {
      const int j = e / N, n = e % N;
      b_s[j * ldn + n] = j0 + j < L
          ? load(bp, ((tok0 + j0 + j) * q.G + g) * N + n) : 0.f;
    }
    for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
      const int j = e / kTile, p = e % kTile;
      x_s[e] = j0 + j < L && p0 + p < q.P
          ? q.xv[((tok0 + j0 + j) * q.H + h) * q.P + p0 + p] : 0.f;
    }
    __syncthreads();
    float s[4][4] = {};
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        cv[r] = c_s[(ty + 16 * r) * ldn + n];
        bv[r] = b_s[(tx + 16 * r) * ldn + n];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) s[r][cc] += cv[r] * bv[cc];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int i = r0 + ty + 16 * r, j = j0 + tx + 16 * cc;
        s_s[(ty + 16 * r) * (kTile + 1) + tx + 16 * cc] =
            i < L && j <= i ? expf(cum[i] - cum[j]) * s[r][cc] : 0.f;
      }
    __syncthreads();
    for (int j = 0; j < kTile; ++j) {
      float sv[4], xw[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        sv[r] = s_s[(ty + 16 * r) * (kTile + 1) + j];
        xw[r] = x_s[j * kTile + tx + 16 * r];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[r][cc] += sv[r] * xw[cc];
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int i = r0 + ty + 16 * r, p = p0 + tx + 16 * cc;
      if (i < L && p < q.P) q.y[((tok0 + i) * q.H + h) * q.P + p] = acc[r][cc];
    }
}

// state rows [n0, n0+64) × columns [p0, p0+64) of one (b, h, chunk)
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_state_kernel(Args q) {
  __shared__ float wb_s[kTile][kTile + 1];     // exp(cum_L − cum_j)·b_j, n
  __shared__ float x_s[kTile][kTile];          // x_j, p
  __shared__ float cum[kMaxL];

  int tile = blockIdx.x;
  const int pt = tile % q.p_tiles;
  tile /= q.p_tiles;
  const int nt = tile % q.n_tiles, k = tile / q.n_tiles;
  const int h = blockIdx.y, bi = blockIdx.z, g = h / (q.H / q.G);
  const int N = q.N, L = q.L;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int n0 = nt * kTile, p0 = pt * kTile;
  const size_t tok0 = (size_t)bi * q.S + (size_t)k * L;
  const T* bp = static_cast<const T*>(q.b);

  chunk_cumsum(q, bi, h, k, cum);
  const float last = cum[L - 1];
  if (nt == 0 && pt == 0 && threadIdx.x == 0)
    q.decays[((size_t)bi * q.H + h) * q.nc + k] = expf(last);

  float acc[4][4] = {};
  for (int j0 = 0; j0 < L; j0 += kTile) {
    __syncthreads();
    for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
      const int j = e / kTile, col = e % kTile;
      const bool row = j0 + j < L;
      wb_s[j][col] = row && n0 + col < N
          ? expf(last - cum[j0 + j])
            * load(bp, ((tok0 + j0 + j) * q.G + g) * N + n0 + col) : 0.f;
      x_s[j][col] = row && p0 + col < q.P
          ? q.xv[((tok0 + j0 + j) * q.H + h) * q.P + p0 + col] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < kTile; ++j) {
      float wv[4], xw[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        wv[r] = wb_s[j][ty + 16 * r];
        xw[r] = x_s[j][tx + 16 * r];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) acc[r][cc] += wv[r] * xw[cc];
    }
  }
  float* out = q.states + (((size_t)bi * q.H + h) * q.nc + k) * N * q.P;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int n = n0 + ty + 16 * r, p = p0 + tx + 16 * cc;
      if (n < N && p < q.P) out[(size_t)n * q.P + p] = acc[r][cc];
    }
}

template <typename T>
int run(const Args& q, int B, cudaStream_t s) {
  const size_t smem =
      sizeof(float) * (2 * kTile * (q.N + 1) + kTile * kTile
                       + kTile * (kTile + 1) + kMaxL);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_intra_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_intra_kernel<T><<<dim3(q.nc * q.row_tiles * q.p_tiles, q.H, B),
                        kThreads, smem, s>>>(q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_state_kernel<T><<<dim3(q.nc * q.n_tiles * q.p_tiles, q.H, B),
                        kThreads, 0, s>>>(q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bc_dtype: 0 = float32, 1 = bfloat16 (b and c alike; xv, a and the
// outputs are float32).  S % L == 0, 1 ≤ L ≤ 256, H % G == 0, N ≤ 256.
extern "C" int ssd_chunk(const void* xv, const void* a, const void* b,
                         const void* c, void* y, void* states, void* decays,
                         int B, int S, int H, int G, int N, int P, int L,
                         int bc_dtype, void* stream) {
  if (L < 1 || L > kMaxL || S % L || G < 1 || H % G || N < 1 || N > 256
      || P < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto ceil_div = [](int x, int d) { return (x + d - 1) / d; };
  const Args q{static_cast<const float*>(xv), static_cast<const float*>(a),
               b, c, static_cast<float*>(y), static_cast<float*>(states),
               static_cast<float*>(decays), S, H, G, N, P, L, S / L,
               ceil_div(L, kTile), ceil_div(N, kTile), ceil_div(P, kTile)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bc_dtype == 0) return run<float>(q, B, s);
  if (bc_dtype == 1) return run<__nv_bfloat16>(q, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
