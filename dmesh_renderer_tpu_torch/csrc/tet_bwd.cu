// Tet renderer backward kernel for Hopper (sm_90a): the backward march (K5).
//
// K5 replaces dmesh_renderer_tpu/ops/tet.py::_bwd_march_kernel (with
// _connectivity_step at direction -1). On the TPU each call is one lockstep
// step over all rays, driven by _compacted_while, with the rays' state in
// device memory between steps and the records scatter-added into a per-face
// table after every step. Here one thread carries one ray through its whole
// re-walk inside one launch, as the CUDA original's backward does: from the
// ray's last blended face back to its first face, visiting the faces the
// forward blended in reverse order. Per visited face it
//
//   - shades the face with the barycentric colour form
//     (i0 c0 + i1 c1 + i2 c2) * inten and the projective depth at t;
//   - rebuilds the log-transmittance before the face by subtracting the
//     face's log(1 - alpha) (not on the first visit, which starts from the
//     forward's final one), and takes one expf;
//   - updates the four suffix accumulators (colour and depth of what lies
//     behind the face);
//   - forms dL/dalpha, with the background term and its alpha == 1 case, and
//     the nine colour moments (inten * prevT * alpha) * bary_v * dL/dC_ch;
//   - stops at the first face, or when the walk leaves the mesh, or else
//     walks to the previous face (tet_walk.cuh, direction -1).
//
// Records. A ray with n records (its forward n_contrib; 0 for a ray that is
// inactive or blended nothing) owns the slots [off, off + n) of the record
// buffer, off the exclusive sum of the counts: visit k writes slot off + k,
// the face id as key and 10 f32 values (9 colour moments vertex-major, then
// dL/dalpha). There are no atomics: the per-face sums are taken later, in a
// fixed order, by the seg_sum kernel. The re-walk retraces the forward in
// exact arithmetic; where rounding makes it end early, overrun its n slots
// or miss the first face, the slots it did not fill take the absorber key F
// (a segment that is dropped) and zeros, and the ray's `bad` flag is set.
//
// What bounds it: per record 44 bytes written and ~90 f32 operations, per
// walk step ~330 (four Moller-Trumbore tests and normals); the tet and shade
// tables (14 MB at the tet headline) stay in the 50 MB L2. At the headline
// the record bytes dominate, so the bound is bytes. One thread per ray; a
// warp's rays walk for different lengths, and a finished thread idles until
// its warp is done.
//
// Numerics. Built with --fmad=false and IEEE division and square root, so
// that every f32 operation rounds as the elementwise torch ops of the plain
// version (bwd_march_plain) do, in the JAX kernel's order; the plain
// version's torch.exp on the card is the same expf. All literals are f32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tet_walk.cuh"

namespace {

using tet::clamp_w;
using tet::kSH;
using tet::kTG;
using tet::kTI;

constexpr int kRec = 10;  // record values: 9 colour moments, dL/dalpha

// per-ray float inputs, rows of ray_f [kRF, M]
enum { kT, kU, kV, kPLT, kGR, kGG, kGB, kGD, kBGD, kFT, kFPT, kRF };
// per-ray int inputs, rows of ray_i [4, M]
enum { kStartFace, kStartTet, kFirstFace, kNRec };

__global__ void __launch_bounds__(128)
tet_bwd_march_kernel(const float* __restrict__ ray_d,
                     const float* __restrict__ cam_o,
                     const float* __restrict__ zw,
                     const int* __restrict__ ray_i,
                     const float* __restrict__ ray_f,
                     const int64_t* __restrict__ off,
                     const float* __restrict__ tet_geo,
                     const int* __restrict__ tet_ids,
                     const float* __restrict__ shade,
                     int* __restrict__ keys, float* __restrict__ rec,
                     uint8_t* __restrict__ bad, int M, int N, int F) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const int n_rec = ray_i[kNRec * (size_t)M + i];
  if (n_rec == 0) {
    bad[i] = 0;
    return;
  }
  const int view = i / N;
  const float ox = cam_o[view * 3 + 0];
  const float oy = cam_o[view * 3 + 1];
  const float oz = cam_o[view * 3 + 2];
  const float dx = ray_d[(size_t)i * 3 + 0];
  const float dy = ray_d[(size_t)i * 3 + 1];
  const float dz = ray_d[(size_t)i * 3 + 2];
  const float4 pz = reinterpret_cast<const float4*>(zw)[i];
  const float poz = pz.x, pow_ = pz.y, pdz = pz.z, pdw = pz.w;
  const float* rf = ray_f + i;
  const float gcr = rf[kGR * (size_t)M], gcg = rf[kGG * (size_t)M];
  const float gcb = rf[kGB * (size_t)M], gd = rf[kGD * (size_t)M];
  const float bgd = rf[kBGD * (size_t)M];
  const float fT = rf[kFT * (size_t)M], fpT = rf[kFPT * (size_t)M];
  const int first_face = ray_i[kFirstFace * (size_t)M + i];

  int cf = ray_i[kStartFace * (size_t)M + i];
  int ct = ray_i[kStartTet * (size_t)M + i];
  float t = rf[kT * (size_t)M], i1 = rf[kU * (size_t)M];
  float i2 = rf[kV * (size_t)M], plt = rf[kPLT * (size_t)M];
  float la = 0.0f, lcr = 0.0f, lcg = 0.0f, lcb = 0.0f, ld = 0.0f;
  float acr = 0.0f, acg = 0.0f, acb = 0.0f, acd = 0.0f;
  const size_t base = (size_t)off[i];
  bool matched = false;
  int k = 0;
  while (k < n_rec) {
    // --- shade the current face ---
    const float* sh = shade + ((size_t)view * F + cf) * kSH;
    const float alpha = sh[9], l1a = sh[10], inten = sh[11];
    const float i0 = 1.0f - i1 - i2;
    const float cr = (i0 * sh[0] + i1 * sh[3] + i2 * sh[6]) * inten;
    const float cg = (i0 * sh[1] + i1 * sh[4] + i2 * sh[7]) * inten;
    const float cb = (i0 * sh[2] + i1 * sh[5] + i2 * sh[8]) * inten;
    const float dep = (poz + t * pdz) / clamp_w(pow_ + t * pdw);

    // --- transmittance before the face, suffix accumulators ---
    if (k > 0) plt = plt - l1a;
    const float prev_T = expf(plt);
    const float ar = la * lcr + (1.0f - la) * acr;
    const float ag = la * lcg + (1.0f - la) * acg;
    const float ab = la * lcb + (1.0f - la) * acb;
    const float ad = la * ld + (1.0f - la) * acd;

    // --- dL/dalpha with the background term, and the colour moments ---
    float dL_dop =
        ((cr - ar) * gcr + (cg - ag) * gcg + (cb - ab) * gcb + (dep - ad) * gd) *
        prev_T;
    const float bg_coef =
        alpha == 1.0f ? -fpT : -fT / fmaxf(1.0f - alpha, 1e-37f);
    dL_dop = dL_dop + bg_coef * bgd;
    const float wmask = inten * prev_T * alpha;
    const float bary[3] = {i0, i1, i2};
    const size_t slot = base + k;
    float* r = rec + slot * kRec;
#pragma unroll
    for (int vv = 0; vv < 3; ++vv) {
      const float wb = wmask * bary[vv];
      r[vv * 3 + 0] = wb * gcr;
      r[vv * 3 + 1] = wb * gcg;
      r[vv * 3 + 2] = wb * gcb;
    }
    r[9] = dL_dop;
    keys[slot] = cf;
    ++k;

    la = alpha;
    lcr = cr;
    lcg = cg;
    lcb = cb;
    ld = dep;
    acr = ar;
    acg = ag;
    acb = ab;
    acd = ad;

    // --- stop at the first face or past the mesh, else walk back ---
    if (cf == first_face) {
      matched = k == n_rec;
      break;
    }
    if (ct == -1 ||
        tet::walk_step<-1>(tet_geo + (size_t)ct * kTG,
                           tet_ids + (size_t)ct * kTI, cf, ox, oy, oz, dx, dy,
                           dz, t, i1, i2, cf, ct))
      break;
  }
  for (; k < n_rec; ++k) {
    const size_t slot = base + k;
    keys[slot] = F;
#pragma unroll
    for (int c = 0; c < kRec; ++c) rec[slot * kRec + c] = 0.0f;
  }
  bad[i] = matched ? 0 : 1;
}

}  // namespace

// Launch K5 on `stream` over M = B * N rays; allocates nothing and does not
// synchronise. Inputs: ray_d [M, 3], cam_o [B, 3], zw [M, 4] f32 (16-byte
// aligned), ray_i [4, M] int32 (start face, start tet, first face, record
// count), ray_f [11, M] f32 (t, u, v on the start face, the log T before it,
// dL/dC rgb, dL/dD, bg . dL/dC + dL/dD, final T, final prev T), off [M]
// int64 (first slot of each ray), the march tables. Outputs: keys [R] int32,
// rec [R, 10] f32, bad [M] uint8 (1: the re-walk did not retrace the
// forward). Returns the launch's cudaGetLastError().
extern "C" int tet_bwd_march(const void* ray_d, const void* cam_o,
                             const void* zw, const void* ray_i,
                             const void* ray_f, const void* off,
                             const void* tet_geo, const void* tet_ids,
                             const void* shade, void* keys, void* rec,
                             void* bad, int M, int N, int F, void* stream) {
  if (M <= 0) return (int)cudaSuccess;
  const int threads = 128;
  tet_bwd_march_kernel<<<(M + threads - 1) / threads, threads, 0,
                         (cudaStream_t)stream>>>(
      (const float*)ray_d, (const float*)cam_o, (const float*)zw,
      (const int*)ray_i, (const float*)ray_f, (const int64_t*)off,
      (const float*)tet_geo, (const int*)tet_ids, (const float*)shade,
      (int*)keys, (float*)rec, (uint8_t*)bad, M, N, F);
  return (int)cudaGetLastError();
}
