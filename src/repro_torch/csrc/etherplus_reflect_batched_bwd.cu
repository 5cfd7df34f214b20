// etherplus_reflect_batched_bwd: the backward of ETHER+'s bank update
// out[b] = H⁺_t x[b], t = ids[b], H⁺ = I − ûûᵀ + v̂v̂ᵀ per block of tenant
// t of an adapter bank, for sm_90a.
//
// Replaces the TPU kernel etherplus_reflect_batched_bwd_pallas
// (src/repro/kernels/reflect_bwd_batched.py:118, _r2b_bwd_kernel at :54,
// pallas_call at :147): ETHER+ training through an AdapterBank runs it
// twice per adapted linear, for the output side (on y0 = xr·W over f)
// and the input side (on x over d), around the autograd of the shared
// frozen product (src/repro/core/methods.py:258-270 leaves that product
// to XLA).  For x, G (B·S, d) bf16 or f32 alike, u_bank, v_bank
// (A, n, db) f32 raw with n·db = d and ids (B,) int32 or int64 (mapped
// into [0, A) as the forward kernel maps them):
//   dx = G − (ûᵀG) û + (v̂ᵀG) v̂ per row, t its sequence's tenant
//   ĝu_seq[b] = −Σ_{t∈b} [(ûᵀx_t) G_t + (ûᵀG_t) x_t],  ĝv_seq with v̂, +
//   du_bank, dv_bank = norm_chain of the ĝ_seq summed per tenant
// ĝu_seq, ĝv_seq (B, n, db) f32 are the Pallas kernel's second and third
// outputs; du_bank, dv_bank what the JAX op's _bank_grad makes of them.
//
// What bounds it on an H100 SXM (3.35 TB/s at 700 W): bytes.  It reads x
// and G and writes dx, ~20 flops per element, far below the tensor
// cores' 295 a byte, so it uses none; at the train step of smollm-360m
// (B·S = 1024) gate_proj's output (d = 2560) is 3 × 5.2 MB in bf16, about
// 4.7 µs.
//
// The design is rank2_tiles.cuh's: rank2_tile_bwd_kernel, one CTA per
// tile of rows of one sequence (and column chunk), the tenant's û and v̂
// formed once in shared memory, x and G in with 16-byte cp.async, dx out
// with 16-byte stores, each tile's ĝ partials summed over its rows in
// order and written once; then bank_ghat_kernel, one launch for ĝ_seq
// and the bank's du and dv in a fixed order.  No float atomics: a train
// step gives the same bits every run.  The header's note states every
// sum's order.
//
// C interface, bound with ctypes: etherplus_reflect_batched_bwd(...)
// launches the two kernels on the given stream, allocates nothing and
// returns cudaGetLastError().

#include "rank2_tiles.cuh"

// dtype: 0 = float32, 1 = bfloat16 (x, G and dx alike).  ids: B = M / seq
// ids, int64 when ids64, else int32; tenants = A.  rows, bpc, vec and
// staged: the launch geometry (kernels/batched.py, rank2_geometry), which
// this checks.  part is f32 scratch of 2·B·⌈seq/rows⌉·n·db floats, written
// before it is read; ghat (2, B, n, db) f32 (ĝu_seq, then ĝv_seq), du and
// dv (A, n, db) f32 are outputs.
extern "C" int etherplus_reflect_batched_bwd(
    const void* x, const void* u, const void* v, const void* g,
    const void* ids, int ids64, int seq, int tenants, void* part, void* ghat,
    void* dx, void* du, void* dv, int M, int n, int db, int dtype, int rows,
    int bpc, int vec, int staged, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int es = dtype == 1 ? 2 : 4;
  const int tiles = seq > 0 && rows > 0 ? (seq + rows - 1) / rows : 0;
  const int chunks = bpc > 0 ? (n + bpc - 1) / bpc : 0;
  const r2t::Geometry geo{M,     n,   db,     seq, rows,
                          tiles, bpc, chunks, vec,  staged};
  if (tenants < 1 || (dtype != 0 && dtype != 1) ||
      !r2t::check_geometry(geo, es, true))
    return static_cast<int>(cudaErrorInvalidValue);
  const reflect::Tenants tn{ids, ids64, seq, tenants};
  const float* uf = static_cast<const float*>(u);
  const float* vf = static_cast<const float*>(v);
  float* pf = static_cast<float*>(part);
  float* gf = static_cast<float*>(ghat);
  float* duf = static_cast<float*>(du);
  float* dvf = static_cast<float*>(dv);
  if (dtype == 0)
    return static_cast<int>(r2t::launch_backward<float>(
        static_cast<const float*>(x), static_cast<const float*>(g), uf, vf,
        static_cast<float*>(dx), pf, gf, duf, dvf, geo, tn, s));
  return static_cast<int>(r2t::launch_backward<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(g), uf, vf,
      static_cast<__nv_bfloat16*>(dx), pf, gf, duf, dvf, geo, tn, s));
}
