// Tri renderer forward compositing kernel (K1) for Hopper (sm_90a).
//
// Replaces: dmesh_renderer_tpu/ops/tri_binned.py::_fwd_kernel (the Pallas TPU
// kernel). Same function: for every 32x32 binning tile, walk the tile's
// depth-sorted face list [start, end) in order and, per pixel, test coverage
// in 16x16-subpixel fixed point (wrapped int32 edge functions, top-left bias
// in C), intersect the pixel ray with the face (permissive Moller-Trumbore
// from the precomputed T, E1, E2, Q), clamp the barycentrics, interpolate
// colour x intensity and vertex depth, and blend front to back until the
// transmittance drops below 1e-4.
//
// Shape. One block of 16x16 threads per 16x16 quarter of a 32x32 tile, one
// pixel per thread. The four quarters of a tile all walk the tile's whole
// list (coverage is per pixel, so the result does not depend on the
// quarter). The list is read in rounds of 256 slots: each thread loads one
// slot's face row (36 words, looked up through slot_face) into shared
// memory, then every thread walks the round in order. The block exits once
// every pixel is done (__syncthreads_count). Pixels past the image edge
// start done and write nothing.
//
// What bounds it. The card's floor for this work is close to even between
// bytes and operations: each face row, ray and output crosses device memory
// once, and each (pixel, slot) visit costs ~16 integer operations for the
// coverage test plus ~70 f32 operations where the face covers the pixel
// (chip_smoke.py computes both bounds from the run's own counts). Neither
// is what holds this version: each visit is a serial, dependent chain per
// pixel, pixels of one warp diverge on coverage and early exit, and the
// four quarter-blocks of a tile each load the tile's face rows. The design
// answers only the first-order costs: face rows are staged once per round
// in shared memory (no device-memory reads inside the walk), and a block
// leaves as soon as all its pixels are done. Batching faces per warp,
// sharing rows across the quarters and splitting long lists are later work.
//
// Numerics. Built with --fmad=false so that no a*b+c is contracted into an
// FMA: every f32 operation rounds as the separate elementwise torch ops of
// the plain version (fwd_composite_plain) do, which lets the kernel be held
// to it tightly. Edge functions are computed in uint32 (wrapping, as the
// JAX package's int32 arithmetic does) and reinterpreted as int32 for the
// sign test. All literals are f32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;       // binning tile side (coverage-rect granularity)
constexpr int kQuad = 16;       // block side: a quarter of a tile
constexpr int kRound = kQuad * kQuad;  // slots per shared-memory round
constexpr int kNF = 27;         // f32 face-table columns
constexpr int kNI = 9;          // int32 edge-coefficient columns
constexpr float kTEps = 1e-4f;

// f32 face-table columns
constexpr int kTV = 0, kE1 = 3, kE2 = 6, kQV = 9, kC0 = 12, kD0 = 21;
constexpr int kAlpha = 24, kInten = 25, kNondeg = 26;

__device__ __forceinline__ bool edge_neg(int a, int b, int c, uint32_t px,
                                         uint32_t py) {
  uint32_t s = (uint32_t)a * px + (uint32_t)b * py + (uint32_t)c;
  return (int32_t)s < 0;
}

__global__ void __launch_bounds__(kRound)
tri_fwd_kernel(const int* __restrict__ starts, const int* __restrict__ ends,
               const int* __restrict__ slot_face,
               const float* __restrict__ face_f32,
               const int* __restrict__ face_i32,
               const float* __restrict__ ray_d, float* __restrict__ out,
               int* __restrict__ n_contrib, int H, int W, int gx, int gy) {
  __shared__ float sf[kRound][kNF];
  __shared__ int si[kRound][kNI];

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
  const uint32_t px = (uint32_t)(x * 16 + 8);
  const uint32_t py = (uint32_t)(y * 16 + 8);

  float T = 1.0f, pT = 1.0f, Cr = 0.0f, Cg = 0.0f, Cb = 0.0f, D = 0.0f;
  int nc = 0;
  bool done = !inside;

  for (int r0 = start; r0 < end; r0 += kRound) {
    // also the barrier that keeps the previous round's rows in place until
    // every thread has walked them
    if (__syncthreads_count(done) == kRound) break;
    const int slot = r0 + tid;
    if (slot < end) {
      const size_t row = (size_t)slot_face[slot];
      const float* f = face_f32 + row * kNF;
      const int* e = face_i32 + row * kNI;
#pragma unroll
      for (int c = 0; c < kNF; ++c) sf[tid][c] = f[c];
#pragma unroll
      for (int c = 0; c < kNI; ++c) si[tid][c] = e[c];
    }
    __syncthreads();
    const int n = min(kRound, end - r0);
    for (int j = 0; j < n && !done; ++j) {
      const float* f = sf[j];
      const int* e = si[j];
      const bool cover = edge_neg(e[0], e[3], e[6], px, py) &&
                         edge_neg(e[1], e[4], e[7], px, py) &&
                         edge_neg(e[2], e[5], e[8], px, py) &&
                         f[kNondeg] > 0.0f;
      if (!cover) continue;
      const float Px = dy * f[kE2 + 2] - dz * f[kE2 + 1];
      const float Py = dz * f[kE2 + 0] - dx * f[kE2 + 2];
      const float Pz = dx * f[kE2 + 1] - dy * f[kE2 + 0];
      const float denom = Px * f[kE1 + 0] + Py * f[kE1 + 1] + Pz * f[kE1 + 2];
      if (denom == 0.0f) continue;
      const float inv = 1.0f / denom;
      const float u =
          (Px * f[kTV + 0] + Py * f[kTV + 1] + Pz * f[kTV + 2]) * inv;
      const float v =
          (f[kQV + 0] * dx + f[kQV + 1] * dy + f[kQV + 2] * dz) * inv;

      // barycentric clamp: the reference's 7 regions, first match wins
      float uc, vc;
      if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f) {
        uc = u; vc = v;
      } else if (u <= 0.0f && v <= 0.0f) {
        uc = 0.0f; vc = 0.0f;
      } else if ((u >= 1.0f && v <= 0.0f) || (v >= 0.0f && v <= u - 1.0f)) {
        uc = 1.0f; vc = 0.0f;
      } else if ((u <= 0.0f && v >= 1.0f) || (u >= 0.0f && v >= u + 1.0f)) {
        uc = 0.0f; vc = 1.0f;
      } else if (u <= 0.0f && v <= 1.0f && v >= 0.0f) {
        uc = 0.0f; vc = v;
      } else if (u <= 1.0f && u >= 0.0f && v <= 0.0f) {
        uc = u; vc = 0.0f;
      } else {
        uc = (1.0f + u - v) * 0.5f;
        vc = (1.0f - u + v) * 0.5f;
      }
      const float i0 = 1.0f - uc - vc;
      const float inten = f[kInten];
      const float cr =
          (i0 * f[kC0 + 0] + uc * f[kC0 + 3] + vc * f[kC0 + 6]) * inten;
      const float cg =
          (i0 * f[kC0 + 1] + uc * f[kC0 + 4] + vc * f[kC0 + 7]) * inten;
      const float cb =
          (i0 * f[kC0 + 2] + uc * f[kC0 + 5] + vc * f[kC0 + 8]) * inten;
      const float dep = i0 * f[kD0 + 0] + uc * f[kD0 + 1] + vc * f[kD0 + 2];

      const float a = f[kAlpha];
      const float w = a * T;
      Cr = Cr + cr * w;
      Cg = Cg + cg * w;
      Cb = Cb + cb * w;
      D = D + dep * w;
      pT = T;
      T = T * (1.0f - a);
      nc = r0 - start + j + 1;
      done = T < kTEps;
    }
  }

  if (!inside) return;
  const size_t plane = (size_t)H * W;
  const size_t o = (size_t)b * 6 * plane + (size_t)y * W + x;
  out[o + 0 * plane] = Cr;
  out[o + 1 * plane] = Cg;
  out[o + 2 * plane] = Cb;
  out[o + 3 * plane] = D;
  out[o + 4 * plane] = T;
  out[o + 5 * plane] = pT;
  n_contrib[pix] = nc;
}

}  // namespace

// Launch on `stream`; allocates nothing and does not synchronise. Outputs:
// out [B, 6, H, W] f32 (C rgb, D, T, prevT), n_contrib [B, H, W] int32.
// Returns the launch's cudaGetLastError().
extern "C" int tri_fwd_composite(const void* starts, const void* ends,
                                 const void* slot_face, const void* face_f32,
                                 const void* face_i32, const void* ray_d,
                                 void* out, void* n_contrib, int B, int H,
                                 int W, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  const int gx = (W + kTile - 1) / kTile;
  const int gy = (H + kTile - 1) / kTile;
  const dim3 grid((W + kQuad - 1) / kQuad, (H + kQuad - 1) / kQuad, B);
  const dim3 block(kQuad, kQuad, 1);
  tri_fwd_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int*)starts, (const int*)ends, (const int*)slot_face,
      (const float*)face_f32, (const int*)face_i32, (const float*)ray_d,
      (float*)out, (int*)n_contrib, H, W, gx, gy);
  return (int)cudaGetLastError();
}
