// Tet renderer forward kernels for Hopper (sm_90a): the binned first hit
// (K3) and the ray march (K4).
//
// K3 replaces dmesh_renderer_tpu/ops/tet_first_hit.py::_fh_kernel. For every
// 32x32 binning tile it walks the tile's face list, sorted by per-face
// minimum depth, and per pixel keeps the strict Moller-Trumbore hit with the
// smallest ray parameter t (the first face in list order wins a tie). A
// pixel stops once it has a hit and the next face's minimum depth exceeds the
// hit face's maximum depth; that test comes before the hit test of the same
// face.
//
// Shape of K3. As the tri forward kernel: one block of 16x16 threads per
// 16x16 quarter of a tile, one pixel per thread. The tile's list is read in
// rounds of 256 slots: each thread stages one slot's 16-float face row
// (looked up through slot_face) in shared memory, then every thread walks
// the round in order. The block leaves at a round boundary once every pixel
// is done (__syncthreads_and); per-pixel results do not depend on when it
// leaves. Each block writes the number of slots it staged (`walked`).
//
// K4 replaces dmesh_renderer_tpu/ops/tet.py::_fwd_march_kernel (with
// _connectivity_step). On the TPU each call is one lockstep step over all
// rays, with the rays' state in device memory between steps. Here one
// thread carries one ray through its whole walk inside one launch, as the
// CUDA original does: per step it blends the current face (colour from the
// three corner colours at (u, v) times the view's intensity, depth from the
// projective z/w of the ray at t), updates log-transmittance with one expf,
// terminates when T < 1e-4 or the walk has left the mesh, and otherwise
// walks to the exit face of the current tet: the strict hit among the three
// other faces whose outward normal has a positive dot with the ray (the last
// such in slot order; slot 0 when none; tet_walk.cuh). The reference's three
// invariant violations (not three other faces, an entry face that does not
// oppose the ray, not exactly one exit) end the walk with the pixel inactive.
// A thread that is done retires: there is no lockstep, compaction or march
// log.
//
// What a K4 step reads: the tet's 40-float geometry row (p0, e1, e2 of the
// four face slots and the four outward signs) and 8-int id row (face and
// neighbour tet of each slot), and the current face's 12-float shade row
// (view * F + face). At the headline scene the tables are 9.2 MB and 4.7 MB,
// which stay in the card's 50 MB L2.
//
// Numerics. Built with --fmad=false and IEEE division and square root, so
// that every f32 operation rounds as the separate elementwise torch ops of
// the plain versions (first_hit_plain, fwd_march_plain) do. The unit
// normal is recomputed per step with the precompute's operation order
// (cross, sqrt of the sum of squares, max with 1e-4, divide). All literals
// are f32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tet_walk.cuh"

namespace {

using tet::clamp_w;
using tet::kSH;
using tet::kTG;
using tet::kTI;

constexpr int kTile = 32;
constexpr int kQuad = 16;
constexpr int kRound = kQuad * kQuad;
constexpr float kBig = 3.0e38f;
constexpr float kTEps = 1e-4f;

// first-hit table columns ([B*F, 16] f32, depth-sorted rows)
constexpr int kFH = 16;
constexpr int kTV = 0, kE1 = 3, kE2 = 6, kQV = 9, kMinD = 12, kMaxD = 13,
              kFid = 14;

__global__ void __launch_bounds__(kRound)
tet_first_hit_kernel(const int* __restrict__ starts,
                     const int* __restrict__ ends,
                     const int* __restrict__ slot_face,
                     const float* __restrict__ table,
                     const float* __restrict__ ray_d, float* __restrict__ tuv,
                     int* __restrict__ face, int* __restrict__ walked, int H,
                     int W, int gx, int gy) {
  __shared__ float4 sf[kRound][kFH / 4];

  const int b = blockIdx.z;
  const int x = blockIdx.x * kQuad + threadIdx.x;
  const int y = blockIdx.y * kQuad + threadIdx.y;
  const int tid = threadIdx.y * kQuad + threadIdx.x;
  const int tile = (b * gy + (blockIdx.y * kQuad) / kTile) * gx +
                   (blockIdx.x * kQuad) / kTile;
  const bool inside = x < W && y < H;
  const int start = starts[tile];
  const int end = ends[tile];

  const size_t pix = ((size_t)b * H + y) * W + x;
  float dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (inside) {
    dx = ray_d[pix * 3 + 0];
    dy = ray_d[pix * 3 + 1];
    dz = ray_d[pix * 3 + 2];
  }

  float bt = kBig, bmax = 0.0f, bu = 0.0f, bv = 0.0f;
  int bface = -1;
  bool done = !inside;
  int staged = 0;

  for (int r0 = start; r0 < end; r0 += kRound) {
    // also the barrier that keeps the previous round's rows in place until
    // every thread has walked them
    if (__syncthreads_and(done)) break;
    const int slot = r0 + tid;
    if (slot < end) {
      const float4* f =
          reinterpret_cast<const float4*>(table + (size_t)slot_face[slot] * kFH);
#pragma unroll
      for (int c = 0; c < kFH / 4; ++c) sf[tid][c] = f[c];
    }
    __syncthreads();
    const int n = min(kRound, end - r0);
    staged += n;
    for (int j = 0; j < n && !done; ++j) {
      const float* f = reinterpret_cast<const float*>(sf[j]);
      // depth-window early-out, before this face's hit test
      if (bt < kBig && f[kMinD] > bmax) {
        done = true;
        break;
      }
      const float e1x = f[kE1 + 0], e1y = f[kE1 + 1], e1z = f[kE1 + 2];
      const float e2x = f[kE2 + 0], e2y = f[kE2 + 1], e2z = f[kE2 + 2];
      const float qx = f[kQV + 0], qy = f[kQV + 1], qz = f[kQV + 2];
      const float Px = dy * e2z - dz * e2y;
      const float Py = dz * e2x - dx * e2z;
      const float Pz = dx * e2y - dy * e2x;
      const float denom = Px * e1x + Py * e1y + Pz * e1z;
      if (denom == 0.0f) continue;
      const float inv = 1.0f / denom;
      const float tt = (qx * e2x + qy * e2y + qz * e2z) * inv;
      const float u =
          (Px * f[kTV + 0] + Py * f[kTV + 1] + Pz * f[kTV + 2]) * inv;
      const float v = (qx * dx + qy * dy + qz * dz) * inv;
      const bool hit =
          tt >= 0.0f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f;
      if (hit && tt < bt) {
        bt = tt;
        bmax = f[kMaxD];
        bface = (int)f[kFid];
        bu = u;
        bv = v;
      }
    }
  }

  if (tid == 0)
    walked[((size_t)b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] =
        staged;
  if (!inside) return;
  const size_t plane = (size_t)H * W;
  const size_t o = (size_t)b * 3 * plane + (size_t)y * W + x;
  tuv[o + 0 * plane] = bt < kBig ? bt : 0.0f;
  tuv[o + 1 * plane] = bu;
  tuv[o + 2 * plane] = bv;
  face[pix] = bface;
}

__global__ void __launch_bounds__(128)
tet_fwd_march_kernel(const float* __restrict__ ray_d,
                     const float* __restrict__ cam_o,
                     const float* __restrict__ zw,
                     const int* __restrict__ first_face,
                     const int* __restrict__ first_tet,
                     const float* __restrict__ tuv,
                     const float* __restrict__ tet_geo,
                     const int* __restrict__ tet_ids,
                     const float* __restrict__ shade,
                     float* __restrict__ out_f, int* __restrict__ out_i,
                     int M, int N, int F, int max_steps,
                     float log_t_floor) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const int view = i / N;
  const float ox = cam_o[view * 3 + 0];
  const float oy = cam_o[view * 3 + 1];
  const float oz = cam_o[view * 3 + 2];
  const float dx = ray_d[(size_t)i * 3 + 0];
  const float dy = ray_d[(size_t)i * 3 + 1];
  const float dz = ray_d[(size_t)i * 3 + 2];
  const float4 pz = reinterpret_cast<const float4*>(zw)[i];
  const float poz = pz.x, pow_ = pz.y, pdz = pz.z, pdw = pz.w;

  int cf = first_face[i], ct = first_tet[i];
  float t = tuv[i], u = tuv[(size_t)M + i], v = tuv[2 * (size_t)M + i];
  float log_T = 0.0f, T_cur = 1.0f, prev_log_T = 0.0f;
  float Cr = 0.0f, Cg = 0.0f, Cb = 0.0f, D = 0.0f;
  int last_face = -1, last_tet = -1, n_contrib = 0, active = 0;
  bool done = cf == -1 || ct == -1;

  for (int step = 0; step < max_steps && !done; ++step) {
    // --- blend the current face ---
    const float* sh = shade + ((size_t)view * F + cf) * kSH;
    const float alpha = sh[9], l1a = sh[10], inten = sh[11];
    const float w = T_cur * alpha;
    const float cr = (sh[0] + (sh[3] - sh[0]) * u + (sh[6] - sh[0]) * v) * inten;
    const float cg = (sh[1] + (sh[4] - sh[1]) * u + (sh[7] - sh[1]) * v) * inten;
    const float cb = (sh[2] + (sh[5] - sh[2]) * u + (sh[8] - sh[2]) * v) * inten;
    const float dep = (poz + t * pdz) / clamp_w(pow_ + t * pdw);
    prev_log_T = log_T;
    log_T = alpha < 1.0f ? log_T + l1a : log_t_floor;
    T_cur = expf(log_T);
    Cr = Cr + cr * w;
    Cg = Cg + cg * w;
    Cb = Cb + cb * w;
    D = D + dep * w;
    last_face = cf;
    last_tet = ct;
    n_contrib += 1;

    // --- terminate: transmittance exhausted, or the walk left the mesh ---
    if (T_cur < kTEps || ct == -1) {
      active = 1;
      break;
    }

    // --- walk to the exit face of tet ct; an invariant violation leaves
    // the pixel inactive ---
    if (tet::walk_step<1>(tet_geo + (size_t)ct * kTG, tet_ids + (size_t)ct * kTI,
                          cf, ox, oy, oz, dx, dy, dz, t, u, v, cf, ct))
      break;
  }

  out_f[0 * (size_t)M + i] = Cr;
  out_f[1 * (size_t)M + i] = Cg;
  out_f[2 * (size_t)M + i] = Cb;
  out_f[3 * (size_t)M + i] = D;
  out_f[4 * (size_t)M + i] = log_T;
  out_f[5 * (size_t)M + i] = prev_log_T;
  out_i[0 * (size_t)M + i] = last_face;
  out_i[1 * (size_t)M + i] = last_tet;
  out_i[2 * (size_t)M + i] = n_contrib;
  out_i[3 * (size_t)M + i] = active;
}

}  // namespace

// Launch K3 on `stream`; allocates nothing and does not synchronise.
// Outputs: tuv [B, 3, H, W] f32 (t, 0 on a miss; u; v), face [B, H, W] int32
// (-1 on a miss), walked [B, qy, qx] int32 (slots each 16x16 block staged).
// Returns the launch's cudaGetLastError().
extern "C" int tet_first_hit(const void* starts, const void* ends,
                             const void* slot_face, const void* table,
                             const void* ray_d, void* tuv, void* face,
                             void* walked, int B, int H, int W, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  const int gx = (W + kTile - 1) / kTile;
  const int gy = (H + kTile - 1) / kTile;
  const dim3 grid((W + kQuad - 1) / kQuad, (H + kQuad - 1) / kQuad, B);
  const dim3 block(kQuad, kQuad, 1);
  tet_first_hit_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int*)starts, (const int*)ends, (const int*)slot_face,
      (const float*)table, (const float*)ray_d, (float*)tuv, (int*)face,
      (int*)walked, H, W, gx, gy);
  return (int)cudaGetLastError();
}

// Launch K4 on `stream` over M = B * N rays; allocates nothing and does not
// synchronise. Outputs: out_f [6, M] f32 (C rgb, D, log T, the log T before
// the last blend), out_i [4, M] int32 (last face, last tet, n_contrib,
// active). Returns the launch's cudaGetLastError().
extern "C" int tet_fwd_march(const void* ray_d, const void* cam_o,
                             const void* zw, const void* first_face,
                             const void* first_tet, const void* tuv,
                             const void* tet_geo, const void* tet_ids,
                             const void* shade, void* out_f, void* out_i,
                             int M, int N, int F, int max_steps,
                             float log_t_floor, void* stream) {
  if (M <= 0) return (int)cudaSuccess;
  const int threads = 128;
  tet_fwd_march_kernel<<<(M + threads - 1) / threads, threads, 0,
                         (cudaStream_t)stream>>>(
      (const float*)ray_d, (const float*)cam_o, (const float*)zw,
      (const int*)first_face, (const int*)first_tet, (const float*)tuv,
      (const float*)tet_geo, (const int*)tet_ids, (const float*)shade,
      (float*)out_f, (int*)out_i, M, N, F, max_steps, log_t_floor);
  return (int)cudaGetLastError();
}
