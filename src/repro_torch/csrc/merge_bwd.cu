// merge_bwd: the backwards of the weight-side merges, for sm_90a — what
// weight-mode training (`--peft-mode weight`, y = x · merge(W, adapter))
// runs for ETHER's W' = H_B W and ETHER+'s W' = H⁺_L W H̃⁺_R.
//
// Replaces the TPU kernels merge_left_bwd_pallas
// (src/repro/kernels/merge_bwd.py:131, _merge_left_bwd_kernel at :62 and,
// rank 2, _left_rank2_shim at :98; pallas_call at :145 and :156) and
// merge_right_bwd_pallas (:171, _merge_right_bwd_kernel at :105,
// pallas_call at :184).  Under the cotangent G of W' (both (d, f) in W's
// dtype, bf16 or f32), with û = u/(‖u‖ + 1e-8) per block and c_u = −2 for
// the rank-1 reflection, c_u = −1 and c_v = +1 for ETHER+'s rank 2:
//   left, per input block i (rows of W_i, G_i: (db, f)):
//     dW_i = G_i + c_u û(ûᵀG_i) [+ c_v v̂(v̂ᵀG_i)]
//     ĝ_u  = c_u [G_i (W_iᵀû) + W_i (G_iᵀû)]   (ĝ_v likewise)
//   right, per output block j (columns of W_j, G_j: (d, db)):
//     dW_j = G_j − (G_j û)ûᵀ + (G_j v̂)v̂ᵀ
//     ĝ_u  = −[G_jᵀ(W_j û) + W_jᵀ(G_j û)],  ĝ_v with +
//   du = norm_chain(u, ĝ_u) = ĝ/s − (u·ĝ) u / (r s²), r = ‖u‖, s = r + ε
// (src/repro/kernels/reflect_bwd.py:37).  Everything in f32; dW rounded
// once to W's dtype, du and dv in f32 (u's dtype).
//
// What bounds it on an H100 SXM (3.35 TB/s at 700 W): bytes.  The left
// pass reads W and G once and does ~10 flops an element (20 at rank 2);
// one smollm-360m layer's seven linears are 9.8M elements of each, bf16:
// 39.3 MB, 11.7 µs, without dW, 59.0 MB and 17.6 µs with it.  The right
// pass always writes dW (ETHER+'s dw1 feeds the left pass).
//
// What the design does about that — a simple kernel that is right first:
//  * Left: one CUDA block per (reflection block i, strip of 32 columns),
//    the layout of etherplus_merge_left.  Its eight warps take every
//    eighth row, a warp reading 32 neighbouring columns of W and G, and
//    keep the db × 32 strips in shared memory while they sum the column
//    dots ûᵀW, ûᵀG (v̂'s too) in a fixed order.  The second sweep over the
//    strip writes dW (only when asked: PEFT freezes W) and reduces each
//    row's c·[G(Wᵀû) + W(Gᵀû)] over the strip's 32 columns by a warp sum
//    into a per-strip partial of ĝ, (⌈f/32⌉, n, db) f32.  The strips stay
//    in shared memory only within the 48 KB a block has without opting in,
//    beside its 4 KB of column dots (db ≤ 160 in f32, 320 in bf16); past
//    that the second sweep reads W and G again (from L2).  Staging
//    Llama-2-7B's down_proj strips at n = 8 (db 1,376, 176 KB in bf16)
//    left one block on an SM and took 2× the time of the re-read branch
//    on twice the bytes in f32 (PERF.md).
//  * Right: this is, row by row, the backward of the rank-2 update that
//    rank2_rows_kernel applies to each row of W, so it runs
//    reflect_common.cuh's reflect_bwd_kernel with W in place of x: one
//    warp per (32-row tile, output block) — rank2_rows_kernel's mapping
//    with a loop over the tile's rows — writes dW and the tile's ĝ_u and
//    ĝ_v partials, (⌈d/32⌉, n, db) f32.  Any db_out: smollm-360m's k/v
//    projections have db_out = 10, its gate/up 80.
//  * chain_kernel: one CUDA block per (block i, direction) sums the
//    partials in a fixed order and applies the norm chain.  The Pallas
//    kernels carry ĝ in VMEM across their sequential grid; Hopper runs
//    blocks in any order, and float atomics would make the sum's order,
//    and so the bits of a train step, change from run to run.  No float
//    atomics here: a checkpoint restore under
//    torch.use_deterministic_algorithms(True) ends bitwise equal.
//
// C interface, bound with ctypes: merge_left_bwd(...) and
// merge_right_bwd(...) each launch two kernels on the given stream,
// allocate nothing and return cudaGetLastError().

#include "reflect_common.cuh"

namespace {

using namespace reflect;

constexpr int kCols = 32;  // one warp's columns
constexpr int kWarps = 8;
constexpr int kThreads = kCols * kWarps;
// dynamic shared memory that needs no opt-in beside the static 4 KB, and
// leaves room for five blocks on an SM
constexpr size_t kMaxStrip = 40 * 1024;
constexpr int kChainThreads = 256;

inline int strips(int f) { return (f + kCols - 1) / kCols; }

// grid (strips(f), n).  STAGED keeps the db × kCols strips of W and G in
// dynamic shared memory; each thread re-reads only the strip elements it
// wrote itself.  Lanes past f take part in the warp sums with zeros.
template <typename T, bool RANK2, bool STAGED, bool NEED_DW>
__global__ void __launch_bounds__(kThreads)
    merge_left_bwd_kernel(const T* __restrict__ w, const T* __restrict__ g,
                          const float* __restrict__ u,
                          const float* __restrict__ v, T* __restrict__ dw,
                          float* __restrict__ part_u,
                          float* __restrict__ part_v, int f, int n, int db) {
  extern __shared__ __align__(16) unsigned char strip_raw[];
  T* sw = reinterpret_cast<T*>(strip_raw);
  T* sg = sw + static_cast<long long>(db) * kCols;
  // the column dots: ûᵀW, ûᵀG [, v̂ᵀW, v̂ᵀG], one row per warp
  __shared__ float red[RANK2 ? 4 : 2][kWarps][kCols];
  __shared__ float s_norm[2];
  const int strip = blockIdx.x, i = blockIdx.y;
  const int lane = threadIdx.x % 32, wp = threadIdx.x / 32;
  const float* ui = u + static_cast<long long>(i) * db;
  const float* vi = RANK2 ? v + static_cast<long long>(i) * db : nullptr;
  if (wp < (RANK2 ? 2 : 1)) {  // warp 0: ‖u_i‖ + ε, warp 1: ‖v_i‖ + ε
    const float* a = wp == 0 ? ui : vi;
    float ss = 0.f;
    for (int r = lane; r < db; r += 32) ss = fmaf(a[r], a[r], ss);
    ss = warp_sum(ss);
    if (lane == 0) s_norm[wp] = sqrtf(ss) + kEps;
  }
  __syncthreads();
  const float nu = s_norm[0];
  const float nv = RANK2 ? s_norm[1] : 1.f;
  const long long c = static_cast<long long>(strip) * kCols + lane;
  const bool ok = c < f;
  const long long base = static_cast<long long>(i) * db * f + c;

  float pwu = 0.f, pgu = 0.f, pwv = 0.f, pgv = 0.f;
#pragma unroll 4
  for (int r = wp; r < db; r += kWarps) {
    float wv = 0.f, gv = 0.f;
    if (ok) {
      const long long o = base + static_cast<long long>(r) * f;
      const T wr = w[o], gr = g[o];
      if (STAGED) {
        sw[r * kCols + lane] = wr;
        sg[r * kCols + lane] = gr;
      }
      wv = to_f32(wr);
      gv = to_f32(gr);
    }
    const float uh = ui[r] / nu;
    pwu = fmaf(uh, wv, pwu);
    pgu = fmaf(uh, gv, pgu);
    if constexpr (RANK2) {
      const float vh = vi[r] / nv;
      pwv = fmaf(vh, wv, pwv);
      pgv = fmaf(vh, gv, pgv);
    }
  }
  red[0][wp][lane] = pwu;
  red[1][wp][lane] = pgu;
  if constexpr (RANK2) {
    red[2][wp][lane] = pwv;
    red[3][wp][lane] = pgv;
  }
  __syncthreads();
  float cwu = 0.f, cgu = 0.f, cwv = 0.f, cgv = 0.f;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {  // the same order in every thread
    cwu += red[0][k][lane];
    cgu += red[1][k][lane];
    if constexpr (RANK2) {
      cwv += red[2][k][lane];
      cgv += red[3][k][lane];
    }
  }
  constexpr float kCu = RANK2 ? -1.f : -2.f;
  for (int r = wp; r < db; r += kWarps) {
    const long long o = base + static_cast<long long>(r) * f;
    float wv = 0.f, gv = 0.f;
    if (ok) {
      wv = to_f32(STAGED ? sw[r * kCols + lane] : w[o]);
      gv = to_f32(STAGED ? sg[r * kCols + lane] : g[o]);
    }
    const float uh = ui[r] / nu;
    float tu = fmaf(gv, cwu, wv * cgu);
    float tv = 0.f;
    float d = fmaf(kCu * uh, cgu, gv);
    if constexpr (RANK2) {
      const float vh = vi[r] / nv;
      tv = fmaf(gv, cwv, wv * cgv);
      d = fmaf(vh, cgv, d);
    }
    if (NEED_DW && ok) dw[o] = from_f32<T>(d);
    tu = warp_sum(tu);
    if constexpr (RANK2) tv = warp_sum(tv);
    if (lane == 0) {
      const long long p = (static_cast<long long>(strip) * n + i) * db + r;
      part_u[p] = kCu * tu;
      if constexpr (RANK2) part_v[p] = tv;
    }
  }
}

// grid (n, directions): block i of direction y sums its `parts` partials
// ĝ = Σ_s part[s, i] in order s = 0, 1, ..., writes it to `out`, then
// rewrites out = norm_chain(a_i, ĝ).  Each thread re-reads only what it
// wrote; the block's two sums (‖a_i‖², a_i·ĝ) are added in a fixed order.
__global__ void __launch_bounds__(kChainThreads)
    chain_kernel(const float* __restrict__ part_u,
                 const float* __restrict__ part_v,
                 const float* __restrict__ u, const float* __restrict__ v,
                 float* __restrict__ du, float* __restrict__ dv, int n,
                 int db, int parts) {
  __shared__ float red[2][kChainThreads / 32];
  const bool second = blockIdx.y == 1;
  const long long at = static_cast<long long>(blockIdx.x) * db;
  const float* part = (second ? part_v : part_u) + at;
  const float* a = (second ? v : u) + at;
  float* out = (second ? dv : du) + at;
  const long long stride = static_cast<long long>(n) * db;
  float ss = 0.f, dot = 0.f;
  for (int j = threadIdx.x; j < db; j += kChainThreads) {
    float gh = 0.f;
    for (int s = 0; s < parts; ++s) gh += part[s * stride + j];
    out[j] = gh;
    ss = fmaf(a[j], a[j], ss);
    dot = fmaf(a[j], gh, dot);
  }
  ss = warp_sum(ss);
  dot = warp_sum(dot);
  const int lane = threadIdx.x % 32, wp = threadIdx.x / 32;
  if (lane == 0) {
    red[0][wp] = ss;
    red[1][wp] = dot;
  }
  __syncthreads();
  float tss = 0.f, tdot = 0.f;
#pragma unroll
  for (int k = 0; k < kChainThreads / 32; ++k) {
    tss += red[0][k];
    tdot += red[1][k];
  }
  const float rn = sqrtf(tss), s = rn + kEps;
  for (int j = threadIdx.x; j < db; j += kChainThreads)
    out[j] = out[j] / s - tdot * a[j] / (rn * s * s);
}

template <typename T, bool RANK2, bool STAGED, bool NEED_DW>
cudaError_t launch_left(const T* w, const T* g, const float* u,
                        const float* v, T* dw, float* part, float* du,
                        float* dv, int f, int n, int db, cudaStream_t s) {
  const dim3 grid(strips(f), n);
  const size_t strip = STAGED ? 2 * static_cast<size_t>(db) * kCols * sizeof(T)
                              : 0;  // ≤ kMaxStrip
  float* part_v = part + static_cast<long long>(strips(f)) * n * db;
  merge_left_bwd_kernel<T, RANK2, STAGED, NEED_DW>
      <<<grid, kThreads, strip, s>>>(w, g, u, v, dw, part, part_v, f, n, db);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  chain_kernel<<<dim3(n, RANK2 ? 2 : 1), kChainThreads, 0, s>>>(
      part, part_v, u, v, du, dv, n, db, strips(f));
  return cudaGetLastError();
}

template <typename T, bool RANK2>
cudaError_t left(const void* w, const void* g, const void* u, const void* v,
                 void* dw, void* part, void* du, void* dv, int f, int n,
                 int db, cudaStream_t s) {
  const T* wt = static_cast<const T*>(w);
  const T* gt = static_cast<const T*>(g);
  const float* uf = static_cast<const float*>(u);
  const float* vf = static_cast<const float*>(v);
  T* dwt = static_cast<T*>(dw);
  float* pf = static_cast<float*>(part);
  float* duf = static_cast<float*>(du);
  float* dvf = static_cast<float*>(dv);
  const bool staged = 2 * static_cast<size_t>(db) * kCols * sizeof(T) <=
                      kMaxStrip;
  if (staged && dw)
    return launch_left<T, RANK2, true, true>(wt, gt, uf, vf, dwt, pf, duf,
                                             dvf, f, n, db, s);
  if (staged)
    return launch_left<T, RANK2, true, false>(wt, gt, uf, vf, dwt, pf, duf,
                                              dvf, f, n, db, s);
  if (dw)
    return launch_left<T, RANK2, false, true>(wt, gt, uf, vf, dwt, pf, duf,
                                              dvf, f, n, db, s);
  return launch_left<T, RANK2, false, false>(wt, gt, uf, vf, dwt, pf, duf,
                                             dvf, f, n, db, s);
}

template <typename T>
cudaError_t right(const void* w, const void* g, const void* u, const void* v,
                  void* dw, void* part, void* du, void* dv, int d, int f,
                  int n, int db, cudaStream_t s) {
  const int tiles = row_tiles(d);
  float* part_u = static_cast<float*>(part);
  float* part_v = part_u + static_cast<long long>(tiles) * f;
  const float* uf = static_cast<const float*>(u);
  const float* vf = static_cast<const float*>(v);
  // reflect_bwd_kernel's own launch (launch_reflect_bwd's, without its
  // one-warp-per-block du_kernel: chain_kernel sums the partials)
  const cudaError_t err = launch_reflect_bwd_tiles<T, T, true>(
      static_cast<const T*>(w), static_cast<const T*>(g), uf, vf,
      static_cast<T*>(dw), part_u, part_v, d, f, n, db, tiles, tiles,
      Tenants{}, s);
  if (err != cudaSuccess) return err;
  chain_kernel<<<dim3(n, 2), kChainThreads, 0, s>>>(
      part_u, part_v, uf, vf, static_cast<float*>(du),
      static_cast<float*>(dv), n, db, tiles);
  return cudaGetLastError();
}

}  // namespace

// Floats of ĝ partials the caller's `part` scratch must hold per
// direction: merge_left_bwd_parts(f)·n·db (left, W (n·db, f)) and
// merge_right_bwd_parts(d)·f (right, W (d, f)).
extern "C" int merge_left_bwd_parts(int f) { return strips(f); }
extern "C" int merge_right_bwd_parts(int d) { return row_tiles(d); }

// dtype: 0 = float32, 1 = bfloat16 (w, g and dw alike); w and g are
// (n·db, f), u and v (n, db) f32 on its input dim.  v is null for ETHER's
// reflection, ETHER+'s second hyperplanes for rank 2 (dv is then
// written); dw is null when dW is not wanted.  part is f32 scratch of
// merge_left_bwd_parts(f)·n·db floats per direction, written before it is
// read; du, dv (n, db) f32.
extern "C" int merge_left_bwd(const void* w, const void* u, const void* v,
                              const void* g, void* part, void* dw, void* du,
                              void* dv, int f, int n, int db, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && !v)
    return static_cast<int>(
        left<float, false>(w, g, u, v, dw, part, du, dv, f, n, db, s));
  if (dtype == 1 && !v)
    return static_cast<int>(left<__nv_bfloat16, false>(w, g, u, v, dw, part,
                                                       du, dv, f, n, db, s));
  if (dtype == 0)
    return static_cast<int>(
        left<float, true>(w, g, u, v, dw, part, du, dv, f, n, db, s));
  if (dtype == 1)
    return static_cast<int>(left<__nv_bfloat16, true>(w, g, u, v, dw, part,
                                                      du, dv, f, n, db, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype as above; w, g and dw are (d, n·db), u and v (n, db) f32 on the
// output dim.  part is f32 scratch of 2·merge_right_bwd_parts(d)·f
// floats, written before it is read; du, dv (n, db) f32.
extern "C" int merge_right_bwd(const void* w, const void* u, const void* v,
                               const void* g, void* part, void* dw, void* du,
                               void* dv, int d, int n, int db, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int f = n * db;
  if (dtype == 0)
    return static_cast<int>(
        right<float>(w, g, u, v, dw, part, du, dv, d, f, n, db, s));
  if (dtype == 1)
    return static_cast<int>(
        right<__nv_bfloat16>(w, g, u, v, dw, part, du, dv, d, f, n, db, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
