// Tri renderer backward compositing kernel (K2) and the deterministic
// segment sum, for Hopper (sm_90a).
//
// K2 replaces: dmesh_renderer_tpu/ops/tri_binned.py::_bwd_kernel (with its
// per-face math _bwd_face_heavy), the Pallas TPU kernel of the backward.
// Same function: for every tile, walk its depth-sorted face list backwards
// from the last slot any pixel blended, and per pixel rebuild the
// transmittance by division from the forward's prevT (IEEE division, the
// `first` flag, 1 - alpha floored at 1e-30), keep the suffix accumulators
// of colour and depth, add the background term (alpha == 1 takes -prevT),
// and chain dL/dcolour and dL/ddepth through the interpolation weights, the
// barycentric clamp and the reference's Moller-Trumbore vertex gradients
// (the dv == dt quirk included). The per-pixel gradient fields are reduced
// over the pixels to 20 sums per slot -- dL/dalpha, the seven moments
// S(b), S(a d), S(c d) of the factored Moller-Trumbore gradient, nine
// vertex-colour and three vertex-depth moments -- and dL/dp0..dp2 are
// rebuilt from the moments and the face constants. Each (slot, quarter) of
// a tile's walked prefix writes one 22-column record; seg_sum folds them
// later.
//
// Records. A tile's walk covers its list up to min(list length, the
// largest n_contrib of its 32x32 pixels) (`offs`, the prefix sums of those
// counts, come from the caller); every later slot's records would be zero,
// so they get no row. The record of (tile t, position p, quarter q) is row
// (offs[t] + p) * 4 + q, and the kernel writes every row of the buffer:
// the records it builds, zeros for the slots a quarter walks with no
// active pixel and for the positions past its own walk, and (quarter 0)
// each row's slot id. At the tri headline that is 31,078 rows of 770,003
// slots; a stack whose pixels all blend their whole list walks every slot
// and compacts nothing, in the same code.
//
// Shape. As K1: one block of 16x16 threads per 16x16 quarter of a 32x32
// tile (every quarter of every tile, those past the image too), one pixel
// per thread, face rows staged in shared memory kRows slots at a time
// (here from the back), each with the per-face constants of the pixel math
// (1 - alpha floored, Q . E2, colour and depth differences) computed once.
// At most 64 registers, so that four blocks share an SM. The walk of a quarter starts at min(list length, the
// largest n_contrib of its pixels). The slots go in batches of kBatch:
// per slot each warp votes (__any_sync) whether any of its pixels is
// active (covered, ray not parallel, position below its n_contrib); a warp
// with none writes zero partials, the others sum their 20 values by a
// transposed halving reduce (21 shuffles; the butterfly of each value took
// 100) into shared memory, double-buffered. One barrier per batch; then
// the block's threads each add one record column's 8 warp partials in
// warp order and write it (dL/dp0..dp2 from the moments, a thread per
// column).
// The sums pair lanes as the xor butterfly does and add the warps in warp
// order, so the records have the bits of the per-slot butterfly version
// and of bwd_composite_plain's block_sum: fixed orders, so the records and
// everything reduced from them are bitwise deterministic. No atomics.
//
// What bounds it. The card's floor is set by the bytes (face rows of the
// walked slots, rays, the forward state, the upstream gradient, records)
// and by ~20 integer operations per walked (pixel, slot) visit plus ~175
// f32 operations per active visit and a 20-value block sum per live slot;
// chip_smoke.py computes both from the run's counts. What holds it is the
// serial walk per pixel (the longest quarter walks over a hundred slots)
// and the four quarter-blocks of a tile each loading the rows.
//
// Numerics. Built with --fmad=false and without fast math, so every f32
// operation rounds as the separate torch ops of bwd_composite_plain do
// (divisions are IEEE divisions), and the plain version reproduces the sum
// order: the two are held to each other tightly. Edge functions are
// computed in uint32 (wrapping). All literals are f32.
//
// seg_sum: out[s, c] = sum of values[order[k], c] for k in
// [offsets[s], offsets[s+1]), added in k order from 0: the same additions
// as seg_sum_plain, so the two agree bit for bit. It replaces no TPU
// kernel: it is the port's deterministic stand-in for the JAX package's XLA
// scatter-adds of the record and vertex reduces (tri_binned.py:301,
// tet.py:1685,1696). Bound by bytes: each value row and row id is read
// once, each sum written once. The rows of a segment lie anywhere in
// `values` (a face's records are spread over its tiles or its rays), so
// each row is a gather that waits on a load of its row id, and the sum's
// order forbids splitting a segment. The design keeps many rows of each
// segment in flight instead:
//
//   - a warp takes G segments and gives each W lanes, one per column (or
//     per two columns, float2, for an even row of at most 16 columns), so
//     one row is one coalesced read; a lane loads 4 rows at once;
//   - where rows are narrow and segments long, a segment also gets J lanes
//     per column, each loading 8 rows, so 8 J rows of it are in flight (48
//     at the tet record reduce, where the old thread per (segment, column)
//     had one); lane (j, w) passes its rows by shuffle to lane (0, w),
//     which adds them in row order;
//   - the launcher sizes J from the mean segment length (8 J about the
//     mean, at most 32 / W) and packs G = 32 / (J W) segments per warp:
//     short segments share a warp, long ones get its lanes.
//
// What still holds it: the rows are gathers from a layout their producers
// chose (a face's records lie in its tiles, or along its rays), so the
// card reads them at about 2 TB/s, and the longest segment (2,319 rows at
// the tet record reduce) adds its length over 8 J rows times the load
// latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kQuad = 16;
constexpr int kRound = kQuad * kQuad;
constexpr int kWarps = kRound / 32;
constexpr int kNF = 27;
constexpr int kNI = 9;
constexpr int kNS = 20;   // per-pixel values summed per live slot
constexpr int kRec = 22;  // record columns
constexpr int kBatch = 16;  // slots per barrier
constexpr int kRows = 128;   // face rows staged per round

// f32 face-table columns
constexpr int kTV = 0, kE1 = 3, kE2 = 6, kQV = 9, kC0 = 12, kD0 = 21;
constexpr int kAlpha = 24, kInten = 25, kNondeg = 26;
// per-face constants of the pixel math (sk): max(1 - alpha, 1e-30), Q . E2,
// the colour differences (c[k + 3] - c[k]) inten and (c[k + 6] - c[k])
// inten, and the depth differences d1 - d0, d2 - d0; each the same f32
// expression the pixel math had, so the same bits
constexpr int kOneMA = 0, kV2n = 1, kCu = 2, kCv = 5, kDd = 8, kNK = 10;

__device__ __forceinline__ bool edge_neg(int a, int b, int c, uint32_t px,
                                         uint32_t py) {
  uint32_t s = (uint32_t)a * px + (uint32_t)b * py + (uint32_t)c;
  return (int32_t)s < 0;
}

// The transposed reduce of a warp: N values per lane are halved level by
// level (offsets 16, 8, 4, 2, 1). At each level a lane keeps one half of
// its values and sends the other to its partner (lane ^ OFF), which keeps
// the opposite half, so each level costs ceil(N / 2) shuffles: 21 for 20
// values, where a butterfly of each value costs 100. Every value is added
// over the same lane pairs as an xor butterfly, and f32 addition is
// commutative, so its sum has the butterfly's bits. The sum of value k ends
// on the lane with halve_index(lane) == k, in v[0].
template <int N, int OFF>
struct Halve {
  static __device__ __forceinline__ void run(float (&v)[kNS], int lane) {
    constexpr int Nn = (N + 1) / 2;
    const bool hi = (lane & OFF) != 0;
#pragma unroll
    for (int i = 0; i < Nn; ++i) {
      const float a = v[i];
      const float b = Nn + i < N ? v[Nn + i] : 0.0f;
      const float send = hi ? a : b;
      v[i] = (hi ? b : a) + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
    Halve<Nn, OFF / 2>::run(v, lane);
  }
};
template <int N>
struct Halve<N, 0> {
  static __device__ __forceinline__ void run(float (&)[kNS], int) {}
};

// The value whose warp sum Halve<kNS, 16> leaves on `lane`, or -1.
__device__ __forceinline__ int halve_index(int lane) {
  int size = kNS, real = kNS, idx = 0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int half = (size + 1) / 2;
    if (lane & off) {
      idx += half;
      real = max(real - half, 0);
    } else {
      real = min(real, half);
    }
    size = half;
  }
  return real > 0 ? idx : -1;
}

// Column c of a live slot's record from its warp partials p [kWarps][kNS]
// (the block sums add them in warp order) and its face row f: dL/dalpha,
// dL/dp0..dp2 rebuilt from the moments (S(w (d x e2)) = S(w d) x e2 and the
// like), the colour and depth moments.
__device__ __forceinline__ float record_col(const float (*p)[kNS],
                                            const float* f, int c) {
  auto S = [p](int k) {
    float s = p[0][k];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s = s + p[w][k];
    return s;
  };
  if (c == 0) return S(0);
  if (c >= 10) return S(c - 2);
  const float S_b = S(1);
  const float S_ax = S(2), S_ay = S(3), S_az = S(4);
  const float S_cx = S(5), S_cy = S(6), S_cz = S(7);
  const float e1x = f[kE1 + 0], e1y = f[kE1 + 1], e1z = f[kE1 + 2];
  const float e2x = f[kE2 + 0], e2y = f[kE2 + 1], e2z = f[kE2 + 2];
  const float tvx = f[kTV + 0], tvy = f[kTV + 1], tvz = f[kTV + 2];
  const float qx = f[kQV + 0], qy = f[kQV + 1], qz = f[kQV + 2];
  float gp1, gp2, gt;
  switch ((c - 1) % 3) {
    case 0:
      gp1 = (S_ay * e2z - S_az * e2y) + S_b * (e2y * tvz - e2z * tvy);
      gp2 = ((tvy * S_cz - tvz * S_cy) + (e1y * S_az - e1z * S_ay)) +
            S_b * qx;
      gt = (S_cy * e2z - S_cz * e2y) + S_b * (e1y * e2z - e1z * e2y);
      break;
    case 1:
      gp1 = (S_az * e2x - S_ax * e2z) + S_b * (e2z * tvx - e2x * tvz);
      gp2 = ((tvz * S_cx - tvx * S_cz) + (e1z * S_ax - e1x * S_az)) +
            S_b * qy;
      gt = (S_cz * e2x - S_cx * e2z) + S_b * (e1z * e2x - e1x * e2z);
      break;
    default:
      gp1 = (S_ax * e2y - S_ay * e2x) + S_b * (e2x * tvy - e2y * tvx);
      gp2 = ((tvx * S_cy - tvy * S_cx) + (e1x * S_ay - e1y * S_ax)) +
            S_b * qz;
      gt = (S_cx * e2y - S_cy * e2x) + S_b * (e1x * e2y - e1y * e2x);
  }
  const int kind = (c - 1) / 3;
  return kind == 0 ? -gp1 - gp2 - gt : (kind == 1 ? gp1 : gp2);
}

__global__ void __launch_bounds__(kRound, 4)
tri_bwd_kernel(const int* __restrict__ starts, const int* __restrict__ ends,
               const int* __restrict__ slot_face,
               const float* __restrict__ face_f32,
               const int* __restrict__ face_i32,
               const float* __restrict__ ray_d,
               const float* __restrict__ final_T,
               const float* __restrict__ final_pT,
               const int* __restrict__ n_contrib,
               const float* __restrict__ gin, const int* __restrict__ offs,
               float* __restrict__ rec, int* __restrict__ slot_ids, int H,
               int W, int gx, int gy) {
  __shared__ float sf[kRows][kNF];
  __shared__ int si[kRows][kNI];
  // per-face constants of the pixel math, computed once per staged row
  __shared__ float sk[kRows][kNK];
  // each batch's warp partials and per-warp liveness, double-buffered
  __shared__ float part[2][kBatch][kWarps][kNS];
  __shared__ int wlive[2][kBatch][kWarps];
  __shared__ int wmax[kWarps];

  const int b = blockIdx.z;
  const int x = blockIdx.x * kQuad + threadIdx.x;
  const int y = blockIdx.y * kQuad + threadIdx.y;
  const int tid = threadIdx.y * kQuad + threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = (b * gy + (blockIdx.y >> 1)) * gx + (blockIdx.x >> 1);
  const int quarter = (blockIdx.y & 1) * 2 + (blockIdx.x & 1);
  const bool inside = x < W && y < H;
  const int start = starts[tile];
  const int count = ends[tile] - start;
  const int comp = offs[tile];
  const int walked = offs[tile + 1] - comp;

  const size_t plane = (size_t)H * W;
  const size_t pix = ((size_t)b * H + y) * W + x;
  float dx = 0.0f, dy = 0.0f, dz = 0.0f, fT = 1.0f, fpT = 1.0f;
  float g_r = 0.0f, g_g = 0.0f, g_b = 0.0f, g_d = 0.0f, bg_dot = 0.0f;
  int nc = 0;
  if (inside) {
    dx = ray_d[pix * 3 + 0];
    dy = ray_d[pix * 3 + 1];
    dz = ray_d[pix * 3 + 2];
    fT = final_T[pix];
    fpT = final_pT[pix];
    nc = n_contrib[pix];
    const size_t g0 = (size_t)b * 5 * plane + (size_t)y * W + x;
    g_r = gin[g0 + 0 * plane];
    g_g = gin[g0 + 1 * plane];
    g_b = gin[g0 + 2 * plane];
    g_d = gin[g0 + 3 * plane];
    bg_dot = gin[g0 + 4 * plane];
  }
  const uint32_t px = (uint32_t)(x * 16 + 8);
  const uint32_t py = (uint32_t)(y * 16 + 8);

  // the walk starts at the quarter's last contributor
  int m = nc;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) wmax[warp] = m;
  __syncthreads();
  int max_nc = wmax[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) max_nc = max(max_nc, wmax[w]);
  const int n_eff = min(count, max_nc);

  // the record of walked position p is row (comp + p) * 4 + quarter; the
  // positions of the tile's prefix that this quarter does not walk are
  // zero, and quarter 0 writes the prefix's slot ids
  float* rq = rec + ((size_t)comp * 4 + quarter) * kRec;
  for (int k = n_eff * kRec + tid; k < walked * kRec; k += kRound) {
    const int p = k / kRec;
    rq[(size_t)p * 4 * kRec + (k - p * kRec)] = 0.0f;
  }
  if (quarter == 0)
    for (int p = tid; p < walked; p += kRound) slot_ids[comp + p] = start + p;
  const int my_sum = halve_index(lane);

  float T = fpT;
  bool first = true;
  float la = 0.0f, lr = 0.0f, lg = 0.0f, lb = 0.0f, ld = 0.0f;
  float ar = 0.0f, ag = 0.0f, ab = 0.0f, ad = 0.0f;
  int buf = 0;

  for (int hi = n_eff; hi > 0; hi -= kRows) {
    const int lo = max(hi - kRows, 0);
    const int n = hi - lo;
    // the previous round's rows (and record math) are done with
    __syncthreads();
    if (tid < n) {
      const size_t row = (size_t)slot_face[start + lo + tid];
      const float* f = face_f32 + row * kNF;
      const int* e = face_i32 + row * kNI;
#pragma unroll
      for (int c = 0; c < kNF; ++c) sf[tid][c] = f[c];
#pragma unroll
      for (int c = 0; c < kNI; ++c) si[tid][c] = e[c];
      float* k = sk[tid];
      k[kOneMA] = fmaxf(1.0f - f[kAlpha], 1e-30f);
      k[kV2n] = f[kQV + 0] * f[kE2 + 0] + f[kQV + 1] * f[kE2 + 1] +
                f[kQV + 2] * f[kE2 + 2];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        k[kCu + c] = (f[kC0 + 3 + c] - f[kC0 + c]) * f[kInten];
        k[kCv + c] = (f[kC0 + 6 + c] - f[kC0 + c]) * f[kInten];
      }
      k[kDd + 0] = f[kD0 + 1] - f[kD0 + 0];
      k[kDd + 1] = f[kD0 + 2] - f[kD0 + 0];
    }
    __syncthreads();

    // batches of kBatch slots, walked from the back: each warp reduces its
    // pixels' 20 values per slot into part, then one barrier, then the
    // block builds and writes the batch's kBatch x 22 record columns
    for (int j0 = n - 1; j0 >= 0; j0 -= kBatch) {
      const int nb = min(kBatch, j0 + 1);
      for (int jb = 0; jb < nb; ++jb) {
        const int j = j0 - jb;
        const float* f = sf[j];
        const int* e = si[j];
        const int pos = lo + j;
        bool active = false;
        float Px = 0.0f, Py = 0.0f, Pz = 0.0f, denom = 0.0f;
        if (pos < nc && f[kNondeg] > 0.0f &&
            edge_neg(e[0], e[3], e[6], px, py) &&
            edge_neg(e[1], e[4], e[7], px, py) &&
            edge_neg(e[2], e[5], e[8], px, py)) {
          Px = dy * f[kE2 + 2] - dz * f[kE2 + 1];
          Py = dz * f[kE2 + 0] - dx * f[kE2 + 2];
          Pz = dx * f[kE2 + 1] - dy * f[kE2 + 0];
          denom = Px * f[kE1 + 0] + Py * f[kE1 + 1] + Pz * f[kE1 + 2];
          active = denom != 0.0f;
        }
        const bool warp_live = __any_sync(0xffffffffu, active);
        if (lane == 0) wlive[buf][jb][warp] = warp_live;
        if (!warp_live) {
          // no active pixel in this warp: its sums are +0
          if (lane < kNS) part[buf][jb][warp][lane] = 0.0f;
          continue;
        }

        float vals[kNS];
#pragma unroll
        for (int k = 0; k < kNS; ++k) vals[k] = 0.0f;
        if (active) {
          const float inv = 1.0f / denom;
          const float u =
              (Px * f[kTV + 0] + Py * f[kTV + 1] + Pz * f[kTV + 2]) * inv;
          const float v =
              (f[kQV + 0] * dx + f[kQV + 1] * dy + f[kQV + 2] * dz) * inv;
          // barycentric clamp: the reference's 7 regions, first match wins
          float uc, vc;
          int code;
          if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f) {
            uc = u; vc = v; code = 0;
          } else if (u <= 0.0f && v <= 0.0f) {
            uc = 0.0f; vc = 0.0f; code = 1;
          } else if ((u >= 1.0f && v <= 0.0f) || (v >= 0.0f && v <= u - 1.0f)) {
            uc = 1.0f; vc = 0.0f; code = 2;
          } else if ((u <= 0.0f && v >= 1.0f) || (u >= 0.0f && v >= u + 1.0f)) {
            uc = 0.0f; vc = 1.0f; code = 3;
          } else if (u <= 0.0f && v <= 1.0f && v >= 0.0f) {
            uc = 0.0f; vc = v; code = 4;
          } else if (u <= 1.0f && u >= 0.0f && v <= 0.0f) {
            uc = u; vc = 0.0f; code = 5;
          } else {
            uc = (1.0f + u - v) * 0.5f;
            vc = (1.0f - u + v) * 0.5f;
            code = 6;
          }
          const float i0 = 1.0f - uc - vc;
          const float i1 = uc, i2 = vc;

          const float* fk = sk[j];
          const float a = f[kAlpha];
          const float one_m_a = fk[kOneMA];
          if (!first) T = T / one_m_a;
          first = false;

          const float inten = f[kInten];
          const float* c = f + kC0;
          const float* d = f + kD0;
          const float cr = (i0 * c[0] + i1 * c[3] + i2 * c[6]) * inten;
          const float cg = (i0 * c[1] + i1 * c[4] + i2 * c[7]) * inten;
          const float cb = (i0 * c[2] + i1 * c[5] + i2 * c[8]) * inten;
          const float dep = i0 * d[0] + i1 * d[1] + i2 * d[2];
          const float ar_n = la * lr + (1.0f - la) * ar;
          const float ag_n = la * lg + (1.0f - la) * ag;
          const float ab_n = la * lb + (1.0f - la) * ab;
          const float ad_n = la * ld + (1.0f - la) * ad;

          const float aT = a * T;
          const float dic_r = g_r * aT, dic_g = g_g * aT, dic_b = g_b * aT;
          const float did = g_d * aT;
          float dalpha = ((cr - ar_n) * g_r + (cg - ag_n) * g_g +
                          (cb - ab_n) * g_b + (dep - ad_n) * g_d) * T;
          const float bg_coef = (a == 1.0f) ? -fpT : -fT / one_m_a;
          dalpha = dalpha + bg_coef * bg_dot;

          ar = ar_n; ag = ag_n; ab = ab_n; ad = ad_n;
          lr = cr; lg = cg; lb = cb; ld = dep; la = a;

          const float dL_duc = fk[kCu + 0] * dic_r + fk[kCu + 1] * dic_g +
                               fk[kCu + 2] * dic_b + fk[kDd + 0] * did;
          const float dL_dvc = fk[kCv + 0] * dic_r + fk[kCv + 1] * dic_g +
                               fk[kCv + 2] * dic_b + fk[kDd + 1] * did;
          const float is0 = code == 0 ? 1.0f : 0.0f;
          const float is4 = code == 4 ? 1.0f : 0.0f;
          const float is5 = code == 5 ? 1.0f : 0.0f;
          const float is6 = code == 6 ? 1.0f : 0.0f;
          const float duc_du = is0 + is5 + 0.5f * is6;
          const float dvc_dv = is0 + is4 + 0.5f * is6;
          const float duc_dv = -0.5f * is6;
          const float dvc_du = -0.5f * is6;
          const float dL_du = dL_duc * duc_du + dL_dvc * dvc_du;
          const float dL_dv = dL_duc * duc_dv + dL_dvc * dvc_dv;

          const float den2 = denom * denom;
          const float inv2 = 1.0f / (den2 == 0.0f ? 1.0f : den2);
          const float v0 = u * denom;
          const float v2n = fk[kV2n];
          const float a_m = -(dL_du * v0 + dL_dv * v2n) * inv2;
          const float b_m = dL_dv * denom * inv2;
          const float c_m = dL_du * denom * inv2;

          vals[0] = dalpha;
          vals[1] = b_m;
          vals[2] = a_m * dx; vals[3] = a_m * dy; vals[4] = a_m * dz;
          vals[5] = c_m * dx; vals[6] = c_m * dy; vals[7] = c_m * dz;
          vals[8] = i0 * dic_r; vals[9] = i0 * dic_g; vals[10] = i0 * dic_b;
          vals[11] = i1 * dic_r; vals[12] = i1 * dic_g; vals[13] = i1 * dic_b;
          vals[14] = i2 * dic_r; vals[15] = i2 * dic_g; vals[16] = i2 * dic_b;
          vals[17] = i0 * did; vals[18] = i1 * did; vals[19] = i2 * did;
          }

        Halve<kNS, 16>::run(vals, lane);
        if (my_sum >= 0) part[buf][jb][warp][my_sum] = vals[0];
      }
      __syncthreads();
      for (int k = tid; k < nb * kRec; k += kRound) {
        const int jb = k / kRec;
        const int c = k - jb * kRec;
        const int j = j0 - jb;
        int live = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) live |= wlive[buf][jb][w];
        // a slot no pixel of the quarter blended keeps a zero record
        rq[(size_t)(lo + j) * 4 * kRec + c] =
            live ? record_col(part[buf][jb], sf[j], c) : 0.0f;
      }
      buf ^= 1;
    }
  }
}

template <int V> struct Vec;
template <> struct Vec<1> {
  typedef float T;
  static __device__ __forceinline__ T zero() { return 0.0f; }
  static __device__ __forceinline__ void add(T& a, T b) { a = a + b; }
  static __device__ __forceinline__ T shfl(T a, int src) {
    return __shfl_sync(0xffffffffu, a, src);
  }
};
template <> struct Vec<2> {
  typedef float2 T;
  static __device__ __forceinline__ T zero() { return make_float2(0.f, 0.f); }
  static __device__ __forceinline__ void add(T& a, T b) {
    a.x = a.x + b.x;
    a.y = a.y + b.y;
  }
  static __device__ __forceinline__ T shfl(T a, int src) {
    return make_float2(__shfl_sync(0xffffffffu, a.x, src),
                       __shfl_sync(0xffffffffu, a.y, src));
  }
};

// W vector columns of V floats per row. Without kRows (J = 1) the lanes are
// (segment g < G, column w < W), G = 32 / W, and each lane loads U rows of
// its segment at once; when W > 32 (G = 1) a lane takes the columns w, w +
// 32, ... With kRows the lanes are (segment g < G, row j < J, column w),
// U rows per lane, so J U rows of a segment are in flight, and lane (j, w)
// passes each of its rows by shuffle to lane (0, w), which adds them in row
// order; there every lane runs the warp's loop (the shuffles need all 32).
template <int V, int U, bool kRows>
__global__ void __launch_bounds__(256)
seg_sum_kernel(const float* __restrict__ values, const int* __restrict__ order,
               const int64_t* __restrict__ offsets, float* __restrict__ out,
               int n_seg, int W, int J, int G) {
  typedef Vec<V> Ops;
  typedef typename Vec<V>::T T;
  const int lane = threadIdx.x & 31;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const T* vals = reinterpret_cast<const T*>(values);
  T* o = reinterpret_cast<T*>(out);
  if (!kRows) {
    const int g = W <= 32 ? lane / W : 0;
    const int w0 = W <= 32 ? lane - g * W : lane;
    const long long s = warp * G + g;
    if (g >= G || s >= n_seg) return;
    const int64_t k0 = offsets[s], k1 = offsets[s + 1];
    for (int w = w0; w < W; w += 32) {
      T acc = Ops::zero();
      int64_t k = k0;
      for (; k + U <= k1; k += U) {
        int r[U];
        T x[U];
#pragma unroll
        for (int u = 0; u < U; ++u) r[u] = order[k + u];
#pragma unroll
        for (int u = 0; u < U; ++u) x[u] = vals[(int64_t)r[u] * W + w];
#pragma unroll
        for (int u = 0; u < U; ++u) Ops::add(acc, x[u]);
      }
      if (k < k1) {
        int r[U];
        T x[U];
#pragma unroll
        for (int u = 0; u < U; ++u) r[u] = k + u < k1 ? order[k + u] : 0;
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (k + u < k1) x[u] = vals[(int64_t)r[u] * W + w];
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (k + u < k1) Ops::add(acc, x[u]);
      }
      o[s * W + w] = acc;
    }
    return;
  }
  const int per = J * W;  // lanes of one segment
  const int g = lane / per;
  const int rem = lane - g * per;
  const int j = rem / W;
  const int w = rem - j * W;
  const long long s = warp * G + g;
  const bool live = g < G && s < n_seg;
  const int64_t k0 = live ? offsets[s] : 0;
  const int64_t k1 = live ? offsets[s + 1] : 0;
  const int src0 = g * per + w;  // lane (0, w) of this segment
  T acc = Ops::zero();
  for (int64_t kb = k0;; kb += (int64_t)J * U) {
    if (!__any_sync(0xffffffffu, kb < k1)) break;
    int r[U];
    T x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t k = kb + u * J + j;
      r[u] = k < k1 ? order[k] : -1;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      x[u] = r[u] >= 0 ? vals[(int64_t)r[u] * W + w] : Ops::zero();
    // row u J + jj of the batch is in register u of lane (jj, w)
#pragma unroll
    for (int u = 0; u < U; ++u) {
      for (int jj = 0; jj < J; ++jj) {
        const T v = Ops::shfl(x[u], src0 + jj * W);
        if (j == 0 && kb + u * J + jj < k1) Ops::add(acc, v);
      }
    }
  }
  if (live && j == 0) o[s * W + w] = acc;
}

}  // namespace

// Launch K2 on `stream`; allocates nothing and does not synchronise. offs
// [n_tiles + 1] int32 holds the exclusive prefix sum of the tiles' walked
// counts; rec [offs[n_tiles], 4, 22] f32 and slot_ids [offs[n_tiles]] int32
// are written in full. Returns cudaGetLastError().
extern "C" int tri_bwd_composite(const void* starts, const void* ends,
                                 const void* slot_face, const void* face_f32,
                                 const void* face_i32, const void* ray_d,
                                 const void* final_T, const void* final_pT,
                                 const void* n_contrib, const void* gin,
                                 const void* offs, void* rec, void* slot_ids,
                                 int B, int H, int W, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  const int gx = (W + kTile - 1) / kTile;
  const int gy = (H + kTile - 1) / kTile;
  // every quarter of every tile, those past the image too: they write the
  // zero records of their tile's walked prefix
  const dim3 grid(2 * gx, 2 * gy, B);
  const dim3 block(kQuad, kQuad, 1);
  tri_bwd_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int*)starts, (const int*)ends, (const int*)slot_face,
      (const float*)face_f32, (const int*)face_i32, (const float*)ray_d,
      (const float*)final_T, (const float*)final_pT, (const int*)n_contrib,
      (const float*)gin, (const int*)offs, (float*)rec, (int*)slot_ids, H, W,
      gx, gy);
  return (int)cudaGetLastError();
}

// Launch seg_sum on `stream`: out [n_seg, C] f32 from values [N, C] f32
// (8-byte aligned when C is even), order [N] int32 and offsets [n_seg + 1]
// int64. Returns cudaGetLastError().
extern "C" int seg_sum(const void* values, const void* order,
                       const void* offsets, void* out, int n_seg, int C,
                       int N, void* stream) {
  if (n_seg <= 0 || C <= 0) return (int)cudaSuccess;
  // float2 for narrow even rows, whose lanes then go to more rows; a row
  // of over 16 columns fills the warp's lanes either way
  const int V = C % 2 == 0 && C <= 16 ? 2 : 1;
  const int W = C / V;
  // rows of a segment in flight: about its mean length, 8 per lane over J
  // lanes, while the columns leave lanes free
  long long J = ((long long)N + 8LL * n_seg - 1) / (8LL * n_seg);
  J = W > 16 ? 1 : (J < 1 ? 1 : (J > 32 / W ? 32 / W : J));
  const int G = J > 1 ? (int)(32 / (J * W)) : (W <= 32 ? 32 / W : 1);
  const long long warps = ((long long)n_seg + G - 1) / G;
  const int threads = 256;
  const unsigned blocks = (unsigned)((warps * 32 + threads - 1) / threads);
  const cudaStream_t st = (cudaStream_t)stream;
  const float* v = (const float*)values;
  const int* od = (const int*)order;
  const int64_t* of = (const int64_t*)offsets;
  float* ou = (float*)out;
  const int j = (int)J;
  if (J > 1 && V == 2)
    seg_sum_kernel<2, 8, true><<<blocks, threads, 0, st>>>(v, od, of, ou,
                                                           n_seg, W, j, G);
  else if (J > 1)
    seg_sum_kernel<1, 8, true><<<blocks, threads, 0, st>>>(v, od, of, ou,
                                                           n_seg, W, j, G);
  else if (V == 2)
    seg_sum_kernel<2, 4, false><<<blocks, threads, 0, st>>>(v, od, of, ou,
                                                            n_seg, W, 1, G);
  else
    seg_sum_kernel<1, 4, false><<<blocks, threads, 0, st>>>(v, od, of, ou,
                                                            n_seg, W, 1, G);
  return (int)cudaGetLastError();
}
