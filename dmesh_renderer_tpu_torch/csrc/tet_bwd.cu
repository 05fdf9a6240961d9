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
//     walks to the previous face (tet_walk.cuh's walk_nrm, direction -1).
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
// walk step ~230 (four Moller-Trumbore tests); the tet and shade tables
// (16 MB at the tet headline) stay in the 50 MB L2. At the headline the
// record bytes dominate, so the bound is bytes. The design, one thread per
// ray as before, does three things about it:
//
//   - records are staged: a warp's lanes write each visit's record to
//     shared memory, and every kStage visits the warp writes them out, each
//     lane's kStage consecutive slots as one contiguous run, the warp's 32
//     runs with consecutive threads on consecutive float2s. Written straight
//     from each lane, the 11 stores of a visit touched 32 far-apart sectors
//     each (a ray's slots lie ~9 records from its neighbour's);
//   - the walk (tet_walk.cuh's walk_nrm<-1>, K4's step with the direction
//     flipped) reads each slot's outward unit normal from the per-tet table
//     tet_nrm (ops/tet.py::march_tables, sign * n-hat, the same bits as the
//     normal rebuilt per step) instead of a cross product, a square root and
//     three divides per slot, and reads every table row as float4s;
//   - the lanes of a warp visit in lockstep: a lane whose ray is done (or
//     whose walk broke and that only fills absorber slots) waits for the
//     warp's longest ray. Neighbouring pixels walk for about as long (83 %
//     of the lanes' visits are busy at the headline), so rays are neither
//     compacted nor sorted by length: both cost more than they save.
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
using tet::kTN;

constexpr int kRec = 10;       // record values: 9 colour moments, dL/dalpha
constexpr int kThreads = 128;  // threads per block, 4 warps
constexpr int kStage = 4;      // visits staged per flush
constexpr int kRun = kStage * kRec;  // floats of one lane's staged records
constexpr int kRun2 = kRun / 2;      // ... as float2 (records are 8-byte
                                     // aligned: 40 bytes each)
constexpr int kRunPad = kRun + 2;    // padded, even: float2 rows, lanes
                                     // spread over the banks

// per-ray float inputs, rows of ray_f [kRF, M]
enum { kT, kU, kV, kPLT, kGR, kGG, kGB, kGD, kBGD, kFT, kFPT, kRF };
// per-ray int inputs, rows of ray_i [4, M]
enum { kStartFace, kStartTet, kFirstFace, kNRec };

__global__ void __launch_bounds__(kThreads)
tet_bwd_march_kernel(const float* __restrict__ ray_d,
                     const float* __restrict__ cam_o,
                     const float* __restrict__ zw,
                     const int* __restrict__ ray_i,
                     const float* __restrict__ ray_f,
                     const int64_t* __restrict__ off,
                     const float* __restrict__ tet_geo,
                     const float* __restrict__ tet_nrm,
                     const int* __restrict__ tet_ids,
                     const float* __restrict__ shade,
                     int* __restrict__ keys, float* __restrict__ rec,
                     uint8_t* __restrict__ bad, int M, int N, int F) {
  __shared__ __align__(16) float s_rec[kThreads * kRunPad];
  __shared__ int s_key[kThreads * (kStage + 1)];
  __shared__ long long s_off[kThreads];
  __shared__ int s_n[kThreads];
  const int lane = threadIdx.x & 31;
  const int w0 = threadIdx.x & ~31;  // the warp's first thread in the block
  const int ray = blockIdx.x * kThreads + threadIdx.x;
  const bool have = ray < M;
  // every lane runs the warp's loop (it holds __any_sync and __syncwarp);
  // a lane past M or with no records stages nothing
  const int i = have ? ray : 0;
  const int n_rec = have ? ray_i[kNRec * (size_t)M + i] : 0;
  const long long base = n_rec > 0 ? (long long)off[i] : 0;
  s_off[threadIdx.x] = base;
  s_n[threadIdx.x] = n_rec;

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
  bool matched = false, walking = n_rec > 0;
  float* my_rec = s_rec + threadIdx.x * kRunPad;
  int* my_key = s_key + threadIdx.x * (kStage + 1);

  for (int k0 = 0; __any_sync(0xffffffffu, k0 < n_rec); k0 += kStage) {
    for (int kk = 0; kk < kStage && k0 + kk < n_rec; ++kk) {
      const int k = k0 + kk;
      float* r = my_rec + kk * kRec;
      if (!walking) {
        // past an early end: the absorber key and zeros
#pragma unroll
        for (int c = 0; c < kRec; ++c) r[c] = 0.0f;
        my_key[kk] = F;
        continue;
      }
      // --- shade the current face ---
      const float4* sh = reinterpret_cast<const float4*>(
          shade + ((size_t)view * F + cf) * kSH);
      const float4 s0 = sh[0], s1 = sh[1], s2 = sh[2];
      const float alpha = s2.y, l1a = s2.z, inten = s2.w;
      const float i0 = 1.0f - i1 - i2;
      const float cr = (i0 * s0.x + i1 * s0.w + i2 * s1.z) * inten;
      const float cg = (i0 * s0.y + i1 * s1.x + i2 * s1.w) * inten;
      const float cb = (i0 * s0.z + i1 * s1.y + i2 * s2.x) * inten;
      const float dep = (poz + t * pdz) / clamp_w(pow_ + t * pdw);

      // --- transmittance before the face, suffix accumulators ---
      if (k > 0) plt = plt - l1a;
      const float prev_T = expf(plt);
      const float ar = la * lcr + (1.0f - la) * acr;
      const float ag = la * lcg + (1.0f - la) * acg;
      const float ab = la * lcb + (1.0f - la) * acb;
      const float ad = la * ld + (1.0f - la) * acd;

      // --- dL/dalpha with the background term, and the colour moments ---
      float dL_dop = ((cr - ar) * gcr + (cg - ag) * gcg + (cb - ab) * gcb +
                      (dep - ad) * gd) *
                     prev_T;
      const float bg_coef =
          alpha == 1.0f ? -fpT : -fT / fmaxf(1.0f - alpha, 1e-37f);
      dL_dop = dL_dop + bg_coef * bgd;
      const float wmask = inten * prev_T * alpha;
      const float bary[3] = {i0, i1, i2};
#pragma unroll
      for (int vv = 0; vv < 3; ++vv) {
        const float wb = wmask * bary[vv];
        r[vv * 3 + 0] = wb * gcr;
        r[vv * 3 + 1] = wb * gcg;
        r[vv * 3 + 2] = wb * gcb;
      }
      r[9] = dL_dop;
      my_key[kk] = cf;

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
        matched = k + 1 == n_rec;
        walking = false;
      } else if (ct == -1 ||
                 tet::walk_nrm<-1>(
                     reinterpret_cast<const float4*>(tet_geo +
                                                     (size_t)ct * kTG),
                     reinterpret_cast<const float4*>(tet_nrm +
                                                     (size_t)ct * kTN),
                     reinterpret_cast<const int4*>(tet_ids +
                                                   (size_t)ct * kTI),
                     cf, ox, oy, oz, dx, dy, dz, t, i1, i2, cf, ct)) {
        walking = false;
      }
    }
    // --- write the warp's staged records: lane l's visits k0.. as one run
    // at slot off_l + k0, consecutive threads on consecutive float2s ---
    __syncwarp();
    for (int f = lane; f < 32 * kRun2; f += 32) {
      const int l = f / kRun2;
      const int rem = f - l * kRun2;  // float2 rem holds floats 2 rem, +1
      if (k0 + (2 * rem) / kRec < s_n[w0 + l])
        reinterpret_cast<float2*>(rec + (s_off[w0 + l] + k0) * kRec)[rem] =
            reinterpret_cast<const float2*>(s_rec + (w0 + l) * kRunPad)[rem];
    }
    for (int f = lane; f < 32 * kStage; f += 32) {
      const int l = f / kStage;
      const int kk = f - l * kStage;
      if (k0 + kk < s_n[w0 + l])
        keys[s_off[w0 + l] + k0 + kk] = s_key[(w0 + l) * (kStage + 1) + kk];
    }
    __syncwarp();
  }
  if (have) bad[i] = (n_rec == 0 || matched) ? 0 : 1;
}

}  // namespace

// Launch K5 on `stream` over M = B * N rays; allocates nothing and does not
// synchronise. Inputs: ray_d [M, 3], cam_o [B, 3], zw [M, 4] f32, ray_i
// [4, M] int32 (start face, start tet, first face, record count), ray_f
// [11, M] f32 (t, u, v on the start face, the log T before it, dL/dC rgb,
// dL/dD, bg . dL/dC + dL/dD, final T, final prev T), off [M] int64 (first
// slot of each ray), the march tables tet_geo [T, 40], tet_nrm [T, 12],
// tet_ids [T, 8] and shade [B*F, 12] (zw and the tables 16-byte aligned).
// Outputs: keys [R] int32, rec [R, 10] f32, bad [M] uint8 (1: the re-walk
// did not retrace the forward). Returns the launch's cudaGetLastError().
extern "C" int tet_bwd_march(const void* ray_d, const void* cam_o,
                             const void* zw, const void* ray_i,
                             const void* ray_f, const void* off,
                             const void* tet_geo, const void* tet_nrm,
                             const void* tet_ids, const void* shade,
                             void* keys, void* rec, void* bad, int M, int N,
                             int F, void* stream) {
  if (M <= 0) return (int)cudaSuccess;
  tet_bwd_march_kernel<<<(M + kThreads - 1) / kThreads, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const float*)ray_d, (const float*)cam_o, (const float*)zw,
      (const int*)ray_i, (const float*)ray_f, (const int64_t*)off,
      (const float*)tet_geo, (const float*)tet_nrm, (const int*)tet_ids,
      (const float*)shade, (int*)keys, (float*)rec, (uint8_t*)bad, M, N, F);
  return (int)cudaGetLastError();
}
