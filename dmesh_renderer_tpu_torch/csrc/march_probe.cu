// The march-step experiment kernels for Hopper (sm_90a): the merged
// mega-row step (T3, mega_step, with a second two-table entry) and the fused
// march-step prototype (T4, proto_step). Driven by
// dmesh_renderer_tpu_torch/tools/exp_round3.py (e5) and
// dmesh_renderer_tpu_torch/tools/proto_march_kernel.py.
//
// T3 replaces the kernel of tools/exp_round3.py::e5 (mega_kernel, the
// pallas_call at :341). Per ray i it reads one 96-float mega row of its tet
// ct[i] (tet geometry 40, the slots' face and neighbour ids as exact f32 8,
// then the 12-float shade row of each of the four slot faces), selects the
// entry slot's shade by comparing the slot face ids with the ray's current
// face cf = state[3] (f32 ids, a sum of 0/1 masks times the four shade
// rows), forms the colour at (u, v) = state[1..2] times the intensity and
// the weight w = state[6] * alpha, runs the forward connectivity step
// (tet_walk.cuh walk_slots, with the reference's slot-0/last-exit fallback
// values on error lanes too) and writes
//
//   out[0] = col_r w + alpha l1a      out[1] = col_g w + next face
//   out[2] = col_b w + next tet       out[3] = t + u + v + err
//   out[4..16] = state[4..16].
//
// The second entry (two_table_step) computes the same function from the
// march tables as the renderer keeps them: the tet's geometry row [40] and
// int32 id row [8] by ct, and the four slot faces' shade rows [12] by face
// id. The two outputs are identical; e5 times one wide row per ray against
// several narrow ones.
//
// T4 replaces the kernel of tools/proto_march_kernel.py (the pallas_call at
// :168): the per-ray body of the fused march-step prototype. It reads the
// ray's pack row [48] (the tet geometry 40, then face and neighbour ids as
// f32) by ct and its shade row [12] by cf inside the kernel, and the 16
// state rows and the ray's consts rows 0..9 ((ox, oy, oz, dx, dy, dz), then
// the projective z/w coefficients); it runs the same connectivity step, the
// blend (depth (c6 + t c8) / (c7 + t c9 + 1e-4)), log T += l1a with one
// expf, advances when the step is valid and T > 1e-4, and writes 16 rows.
//
// One thread per ray for both. What bounds them: bytes (per ray about 180
// read and written, plus the table rows the gathers touch; the tables are
// 18 MB at the headline sizes and stay in the 50 MB L2); the ~420 f32
// operations a ray needs take a tenth of that time at the f32 peak.
//
// T4 reads the ray's pack row (48 f32, 192 bytes) and shade row (12 f32, 48
// bytes) as 12 + 3 float4 loads into registers, and walks and blends from
// there. On the tool's random tables each warp load touches 32 rows, so the
// 60 scalar loads it took before cost 60 x 32 row accesses a warp; the
// vector loads cost a quarter of that (0.117 -> 0.074 ms of device time at
// 640,000 rays on the H100). A warp that staged its 32 rows in shared
// memory with coalesced 16-byte copies first measured no faster. The rows
// held in registers raise the kernel to 96 registers, which costs
// occupancy where rows are L1 hits (the mesh tables, whose neighbouring
// rays share tets). The tables must be 16-byte aligned; proto_step's
// wrapper copies one that is not.
//
// Built with --fmad=false and IEEE division and square root, so that every
// f32 operation rounds as the elementwise torch ops of the plain versions
// (tools/exp_round3.py mega_step_plain, tools/proto_march_kernel.py
// proto_step_plain) do; expf, as the tet march K4, where the plain version
// takes torch.exp.

#include <cuda_runtime.h>
#include <math.h>

#include "tet_walk.cuh"

namespace {

using tet::kSH;
using tet::kTG;
using tet::kTI;

constexpr int kMega = kTG + kTI + 4 * kSH;  // 96
constexpr int kPack = kTG + kTI;            // 48
constexpr int kNS3 = 17;                    // T3 state rows
constexpr int kNS4 = 16;                    // T4 state rows
constexpr int kThreads = 128;

__device__ __forceinline__ int clampi(int x, int n) {
  return min(max(x, 0), n - 1);
}

// T3 for ray i: geometry row g [40], ids [8] as f32, the four slot faces'
// shade rows sh[j] [12].
__device__ __forceinline__ void mega_body(const float* __restrict__ g,
                                          const float* ids,
                                          const float* const* sh,
                                          const float* __restrict__ consts,
                                          const float* __restrict__ state,
                                          float* __restrict__ out, int i,
                                          int M) {
  const size_t m = (size_t)M;
  const float cf = state[3 * m + i];
  float is_j[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) is_j[j] = ids[j] == cf ? 1.0f : 0.0f;
  auto col = [&](int c) {
    float a = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) a = a + is_j[j] * sh[j][c];
    return a;
  };
  const float alpha = col(9), l1a = col(10), inten = col(11);
  const float u0 = state[1 * m + i], v0 = state[2 * m + i];
  float rgb[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float a = col(ch);
    rgb[ch] = (a + (col(3 + ch) - a) * u0 + (col(6 + ch) - a) * v0) * inten;
  }
  const float w = state[6 * m + i] * alpha;
  float t = 0.0f, u = 0.0f, v = 0.0f, nf = 0.0f, nt = 0.0f;
  const bool err = tet::walk_slots<1, float>(
      g, ids, cf, consts[0 * m + i], consts[1 * m + i], consts[2 * m + i],
      consts[3 * m + i], consts[4 * m + i], consts[5 * m + i], t, u, v, nf,
      nt);
  out[0 * m + i] = rgb[0] * w + alpha * l1a;
  out[1 * m + i] = rgb[1] * w + nf;
  out[2 * m + i] = rgb[2] * w + nt;
  out[3 * m + i] = t + u + v + (err ? 1.0f : 0.0f);
#pragma unroll
  for (int r = 4; r < kNS3; ++r) out[r * m + i] = state[r * m + i];
}

__global__ void __launch_bounds__(kThreads)
mega_step_kernel(const float* __restrict__ mega, const int* __restrict__ ct,
                 const float* __restrict__ consts,
                 const float* __restrict__ state, float* __restrict__ out,
                 int M, int T) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const float* row = mega + (size_t)clampi(ct[i], T) * kMega;
  const float* sh[4] = {row + kPack, row + kPack + kSH, row + kPack + 2 * kSH,
                        row + kPack + 3 * kSH};
  mega_body(row, row + kTG, sh, consts, state, out, i, M);
}

__global__ void __launch_bounds__(kThreads)
two_table_step_kernel(const float* __restrict__ tet_geo,
                      const int* __restrict__ tet_ids,
                      const float* __restrict__ shade,
                      const int* __restrict__ ct,
                      const float* __restrict__ consts,
                      const float* __restrict__ state, float* __restrict__ out,
                      int M, int T, int F) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const int c = clampi(ct[i], T);
  const int* id_row = tet_ids + (size_t)c * kTI;
  float ids[kTI];
  const float* sh[4];
#pragma unroll
  for (int k = 0; k < kTI; ++k) ids[k] = (float)id_row[k];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    sh[j] = shade + (size_t)clampi(id_row[j], F) * kSH;
  mega_body(tet_geo + (size_t)c * kTG, ids, sh, consts, state, out, i, M);
}

// n floats of a 16-byte aligned row into registers, as n / 4 float4 loads
template <int n>
__device__ __forceinline__ void load_row(const float4* __restrict__ src,
                                         float* dst) {
#pragma unroll
  for (int q = 0; q < n / 4; ++q) {
    const float4 a = src[q];
    dst[4 * q] = a.x;
    dst[4 * q + 1] = a.y;
    dst[4 * q + 2] = a.z;
    dst[4 * q + 3] = a.w;
  }
}

__global__ void __launch_bounds__(kThreads)
proto_step_kernel(const float4* __restrict__ pack,
                  const float4* __restrict__ shade,
                  const int* __restrict__ ct, const int* __restrict__ cf_idx,
                  const float* __restrict__ consts,
                  const float* __restrict__ state, float* __restrict__ out,
                  int M, int T, int F) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const size_t m = (size_t)M;
  // the ray's pack row (12 float4) and shade row (3 float4), in registers
  float p[kPack], sh[kSH];
  load_row<kPack>(pack + (size_t)clampi(ct[i], T) * (kPack / 4), p);
  load_row<kSH>(shade + (size_t)clampi(cf_idx[i], F) * (kSH / 4), sh);
  auto s = [&](int r) { return state[r * m + i]; };
  auto c = [&](int r) { return consts[r * m + i]; };
  const float cf = s(3), t0 = s(0), u0 = s(1), v0 = s(2);

  float nt_ = 0.0f, nu_ = 0.0f, nv_ = 0.0f, nface = 0.0f, ntet = 0.0f;
  const bool err = tet::walk_slots<1, float>(
      p, p + kTG, cf, c(0), c(1), c(2), c(3), c(4), c(5), nt_, nu_, nv_,
      nface, ntet);

  const float alpha = sh[9], l1a = sh[10], inten = sh[11];
  const float w = s(5) * alpha;
  float rgb[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    rgb[ch] = (sh[ch] + (sh[3 + ch] - sh[ch]) * u0 +
               (sh[6 + ch] - sh[ch]) * v0) * inten;
  const float dep = (c(6) + t0 * c(8)) / (c(7) + t0 * c(9) + 1e-4f);
  const float log_t = s(4) + l1a;
  const float tc2 = expf(log_t);
  const bool adv = !err && tc2 > 1e-4f;

  out[0 * m + i] = adv ? nt_ : t0;
  out[1 * m + i] = adv ? nu_ : u0;
  out[2 * m + i] = adv ? nv_ : v0;
  out[3 * m + i] = adv ? nface : cf;
  out[4 * m + i] = log_t;
  out[5 * m + i] = tc2;
  out[6 * m + i] = s(6) + rgb[0] * w;
  out[7 * m + i] = s(7) + rgb[1] * w;
  out[8 * m + i] = s(8) + rgb[2] * w;
  out[9 * m + i] = s(9) + dep * w;
  out[10 * m + i] = adv ? ntet : s(10);
  out[11 * m + i] = err ? 1.0f : 0.0f;
  out[12 * m + i] = s(12) + 1.0f;
  out[13 * m + i] = s(13);
  out[14 * m + i] = s(14);
  out[15 * m + i] = s(15);
}

int blocks(int M) { return (M + kThreads - 1) / kThreads; }

}  // namespace

// Launch T3 on `stream`: mega [T, 96] f32, ct [M] int32, consts [10, M] f32,
// state [17, M] f32, out [17, M] f32. Allocates nothing and does not
// synchronise. Returns the launch's cudaGetLastError().
extern "C" int mega_step(const void* mega, const void* ct, const void* consts,
                         const void* state, void* out, int M, int T,
                         void* stream) {
  if (M <= 0) return (int)cudaSuccess;
  mega_step_kernel<<<blocks(M), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)mega, (const int*)ct, (const float*)consts,
      (const float*)state, (float*)out, M, T);
  return (int)cudaGetLastError();
}

// T3's second entry: tet_geo [T, 40] f32, tet_ids [T, 8] int32, shade
// [F, 12] f32 in place of the mega table; the same outputs.
extern "C" int two_table_step(const void* tet_geo, const void* tet_ids,
                              const void* shade, const void* ct,
                              const void* consts, const void* state, void* out,
                              int M, int T, int F, void* stream) {
  if (M <= 0) return (int)cudaSuccess;
  two_table_step_kernel<<<blocks(M), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)tet_geo, (const int*)tet_ids, (const float*)shade,
      (const int*)ct, (const float*)consts, (const float*)state, (float*)out,
      M, T, F);
  return (int)cudaGetLastError();
}

// Launch T4 on `stream`: pack [T, 48] f32, shade [F, 12] f32 (both read as
// 16-byte rows: 16-byte aligned), ct and cf [M] int32, consts [C, M] f32 (C >= 10; rows 0..9 are read), state
// [16, M] f32, out [16, M] f32. Allocates nothing and does not synchronise.
// Returns the launch's cudaGetLastError().
extern "C" int proto_step(const void* pack, const void* shade, const void* ct,
                          const void* cf, const void* consts,
                          const void* state, void* out, int M, int T, int F,
                          void* stream) {
  if (M <= 0) return (int)cudaSuccess;
  proto_step_kernel<<<blocks(M), kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)pack, (const float4*)shade, (const int*)ct,
      (const int*)cf, (const float*)consts, (const float*)state, (float*)out,
      M, T, F);
  return (int)cudaGetLastError();
}
