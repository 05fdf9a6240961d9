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
// What bounds it on the H100. The work a frame needs is small: at the tri
// headline (100k triangles, 800x800) 18.7 M (pixel, slot) coverage tests of
// ~16 integer operations, of which 6.2 M cover the pixel and add ~69 f32
// operations, and 43 MB that must cross device memory once (face rows,
// rays, outputs): 0.011 ms of operations, 0.013 ms of bytes (chip_smoke.py
// computes both from the run's counts). A kernel with one 256-thread block
// per 16x16 quarter of a tile, rows staged in rounds of 256 slots by one
// thread per row, and a warp that runs the whole intersection and blend
// whenever any of its lanes covers the slot took 0.148 ms: each quarter
// staged the tile's rows again, every round staged 256 rows while a pixel
// needs ~29 slots, the row loads touched 32 rows per warp instruction and
// nothing overlapped their latency, and a third of the visits cover, so
// most of the blend's issue went to idle lanes.
//
// Shape. One block of 1024 threads per 32x32 tile, one pixel per thread;
// each warp is an 8x4-pixel patch. The tile's list is staged once per block,
// in rounds of kRound = 32 slots, double-buffered: while the block walks
// round r, the 4-byte cp.async copies of round r + 1 are in flight. A row
// (27 f32 then 9 int32, looked up through slot_face) is copied by 36
// consecutive threads, one word each, so each warp's loads are coalesced
// along a row. Per round each warp
//
//   1. packs the round's covered (slot, pixel) pairs into a 32x32 bit
//      matrix: lane j tests slot j against the warp's 32 pixels, stepping
//      its three edge functions from pixel to pixel (uint32 wrapping
//      arithmetic is exact modulo 2^32, so s + 16 a has the bits of the
//      direct product), ~6 integer operations per test instead of ~16 and
//      ten row loads; pixels already done get no pairs;
//   2. transposes the matrix across the warp (five __shfl_xor_sync stages),
//      so that each lane holds its own pixel's covered slots;
//   3. and each lane walks only those, in slot order: intersection, clamp,
//      interpolation and blend, with the T < 1e-4 exit.
//
// So a warp steps once per covered slot of its busiest pixel in the round,
// not once per slot that any pixel covers. Packing the pairs across lanes
// instead (32 pairs computed at a time, then each lane blending its own)
// was built and measured slower: the blend is a per-pixel chain that must
// stay in slot order, so the exchange of results through shared memory cost
// more than the lanes it filled, and pairs past a pixel's exit were
// computed for nothing.
//
// A warp whose pixels are all done skips its rounds; the block stops
// staging once all its pixels are done (__syncthreads_and). Pixels past the
// image edge start done and write nothing. Each pixel blends the same
// faces, in the same order, with the same f32 operations as before, so the
// outputs and n_contrib keep their bits.
//
// Numerics. Built with --fmad=false so that no a*b+c is contracted into an
// FMA: every f32 operation rounds as the separate elementwise torch ops of
// the plain version (fwd_composite_plain) do, which lets the kernel be held
// to it tightly. Edge functions are computed in uint32 (wrapping, as the
// JAX package's int32 arithmetic does) and reinterpreted as int32 for the
// sign test. All literals are f32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

using acopy::cp_async4;
using acopy::cp_async_commit;
using acopy::cp_async_wait;

constexpr int kTile = 32;     // binning tile side (coverage-rect granularity)
constexpr int kThreads = kTile * kTile;  // one thread per pixel of a tile
constexpr int kRound = 32;    // slots per staged round (one mask bit each)
constexpr int kNF = 27;       // f32 face-table columns
constexpr int kNI = 9;        // int32 edge-coefficient columns
constexpr int kRow = kNF + kNI;        // words of a staged row
constexpr int kRowPad = kRow + 1;      // odd stride: lanes on distinct rows
                                       // read distinct banks
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTEps = 1e-4f;

// f32 face-table columns
constexpr int kTV = 0, kE1 = 3, kE2 = 6, kQV = 9, kC0 = 12, kD0 = 21;
constexpr int kAlpha = 24, kInten = 25, kNondeg = 26;

// The covered pixels of one slot for a warp's 8x4 patch, bit ly * 8 + lx
// for the pixel (x0 + lx, y0 + ly): the edge coefficients e (A1 A2 A3 B1
// B2 B3 C1 C2 C3) at the 16x16-subpixel centres, stepped by 16 A per
// pixel and 16 B per row. A pixel is covered when all three edge values
// are negative as int32, that is, when the AND of the three has its sign
// bit set.
__device__ __forceinline__ unsigned patch_cover(const int* __restrict__ e,
                                                uint32_t px0, uint32_t py0) {
  uint32_t row[3], dx[3], dy[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    row[i] = (uint32_t)e[i] * px0 + (uint32_t)e[3 + i] * py0 +
             (uint32_t)e[6 + i];
    dx[i] = (uint32_t)e[i] * 16u;
    dy[i] = (uint32_t)e[3 + i] * 16u;
  }
  unsigned m = 0;
#pragma unroll
  for (int ly = 0; ly < 4; ++ly) {
    uint32_t s0 = row[0], s1 = row[1], s2 = row[2];
#pragma unroll
    for (int lx = 0; lx < 8; ++lx) {
      m |= ((s0 & s1 & s2) >> 31) << (ly * 8 + lx);
      s0 += dx[0];
      s1 += dx[1];
      s2 += dx[2];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) row[i] += dy[i];
  }
  return m;
}

// Transpose the warp's 32x32 bit matrix: lane r holds row r on entry (bit
// c set for column c); on return lane c holds column c (bit r set for row
// r). Five stages, each swapping the off-diagonal blocks of size j.
__device__ __forceinline__ unsigned transpose32(unsigned a, int lane) {
  const unsigned kLow[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu,
                            0x33333333u, 0x55555555u};
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int j = 16 >> k;
    const unsigned lo = kLow[k];  // the columns c with (c & j) == 0
    const unsigned o = __shfl_xor_sync(0xffffffffu, a, j);
    a = (lane & j) ? (a & ~lo) | ((o & ~lo) >> j) : (a & lo) | ((o & lo) << j);
  }
  return a;
}

// Start the copies of the n rows of slots [r0, r0 + n) into buf: thread k
// copies word k % kRow of row k / kRow.
__device__ __forceinline__ void stage_round(
    float* __restrict__ buf, const int* __restrict__ slot_face,
    const float* __restrict__ face_f32, const int* __restrict__ face_i32,
    int r0, int n) {
  for (int k = threadIdx.x; k < n * kRow; k += kThreads) {
    const int s = k / kRow;
    const int c = k - s * kRow;
    const size_t row = (size_t)slot_face[r0 + s];
    const void* src = c < kNF ? (const void*)(face_f32 + row * kNF + c)
                              : (const void*)(face_i32 + row * kNI + c - kNF);
    cp_async4(buf + s * kRowPad + c, src);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
tri_fwd_kernel(const int* __restrict__ starts, const int* __restrict__ ends,
               const int* __restrict__ slot_face,
               const float* __restrict__ face_f32,
               const int* __restrict__ face_i32,
               const float* __restrict__ ray_d, float* __restrict__ out,
               int* __restrict__ n_contrib, int H, int W, int gx, int gy) {
  __shared__ float rows[2 * kRound * kRowPad];  // two rounds' face rows
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTile + (warp & 3) * 8;  // the warp's patch
  const int y0 = blockIdx.y * kTile + (warp >> 2) * 4;
  const int x = x0 + (lane & 7);
  const int y = y0 + (lane >> 3);
  const int tile = (b * gy + blockIdx.y) * gx + blockIdx.x;
  const bool inside = x < W && y < H;
  const int start = starts[tile];
  const int end = ends[tile];
  const int n_rounds = (end - start + kRound - 1) / kRound;

  const size_t pix = ((size_t)b * H + y) * W + x;
  float dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (inside) {
    dx = ray_d[pix * 3 + 0];
    dy = ray_d[pix * 3 + 1];
    dz = ray_d[pix * 3 + 2];
  }
  const uint32_t px0 = (uint32_t)(x0 * 16 + 8);
  const uint32_t py0 = (uint32_t)(y0 * 16 + 8);

  float T = 1.0f, pT = 1.0f, Cr = 0.0f, Cg = 0.0f, Cb = 0.0f, D = 0.0f;
  int nc = 0;
  bool done = !inside;

  if (n_rounds > 0)
    stage_round(rows, slot_face, face_f32, face_i32, start,
                min(kRound, end - start));
  cp_async_commit();
  for (int r = 0; r < n_rounds; ++r) {
    // also the barrier that keeps the other buffer's rows in place until
    // every thread has walked them
    if (__syncthreads_and(done)) break;
    const int r0 = start + r * kRound;
    if (r + 1 < n_rounds)
      stage_round(rows + ((r + 1) & 1) * kRound * kRowPad, slot_face,
                  face_f32, face_i32, r0 + kRound,
                  min(kRound, end - r0 - kRound));
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of round r have landed
    __syncthreads();     // and every thread's
    if (__all_sync(kFull, done)) continue;
    const float* rr = rows + (r & 1) * kRound * kRowPad;
    const int n = min(kRound, end - r0);

    // --- 1. the round's covered pairs: lane j's bits are the pixels that
    // slot j covers, among those not done ---
    const unsigned live = __ballot_sync(kFull, !done);
    unsigned cov = 0;
    if (lane < n) {
      const float* f = rr + lane * kRowPad;
      if (f[kNondeg] > 0.0f)
        cov = patch_cover(reinterpret_cast<const int*>(f + kNF), px0, py0) &
              live;
    }
    // --- 2. each lane's bits become its pixel's covered slots ---
    unsigned mine = transpose32(cov, lane);

    // --- 3. walk them in slot order ---
    while (mine) {
      const int sj = __ffs(mine) - 1;
      mine &= mine - 1;
      const float* f = rr + sj * kRowPad;
      const float Px = dy * f[kE2 + 2] - dz * f[kE2 + 1];
      const float Py = dz * f[kE2 + 0] - dx * f[kE2 + 2];
      const float Pz = dx * f[kE2 + 1] - dy * f[kE2 + 0];
      const float denom = Px * f[kE1 + 0] + Py * f[kE1 + 1] + Pz * f[kE1 + 2];
      if (denom == 0.0f) continue;  // a parallel ray: not blended
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
      nc = r0 - start + sj + 1;
      if (T < kTEps) {
        done = true;
        break;
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

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

// Launch on `stream`; allocates nothing and does not synchronise. One
// 1024-thread block per 32x32 tile. Outputs: out [B, 6, H, W] f32 (C rgb,
// D, T, prevT), n_contrib [B, H, W] int32. Returns the launch's
// cudaGetLastError().
extern "C" int tri_fwd_composite(const void* starts, const void* ends,
                                 const void* slot_face, const void* face_f32,
                                 const void* face_i32, const void* ray_d,
                                 void* out, void* n_contrib, int B, int H,
                                 int W, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  const int gx = (W + kTile - 1) / kTile;
  const int gy = (H + kTile - 1) / kTile;
  tri_fwd_kernel<<<dim3(gx, gy, B), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)starts, (const int*)ends, (const int*)slot_face,
      (const float*)face_f32, (const int*)face_i32, (const float*)ray_d,
      (float*)out, (int*)n_contrib, H, W, gx, gy);
  return (int)cudaGetLastError();
}
