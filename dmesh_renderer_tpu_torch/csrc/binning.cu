// Tri tile binning for Hopper (sm_90a): the exact path of
// ops/binning.py::emit_and_sort (emit_exact_plain's counts, (face, tile-row)
// run table and key slots), with work that follows the live faces, runs and
// pairs.
//
// bin_count, one thread per (view, face) in the original order: loops over
// the face's own rect rows (never the whole grid), applies the corner test
// of _row_tile_interval, the wrap-risk rule (_edge_wrap_risk) and the
// tiles > 0 & nondeg mask, and writes exact_tile_counts' [B, F] int32
// counts, the rows the face emits (ny where its count is positive, else 0)
// and a 64-byte row of what bin_runs reads of it (the nine edge
// coefficients as f32, rx, nx, ry and the wrap-risk flag).
//
// Between the launches, torch: the per-view depth presort (sigma), the
// inclusive int64 scan of the emitted rows in sigma order (each face's last
// run row + 1; the last entry is `runs`), the run table's counts set to 0
// (a memset), and the inclusive int64 scan of those counts (each run's
// last pair + 1; the last entry is `total`).
//
// bin_runs, one thread per depth-sorted face: writes each of the face's rows
// that falls below the run table's capacity as (sorted face, first tile,
// tile row, tile count); the rows past the live runs keep count 0.
//
// bin_emit, one thread per run-table row and per key slot: a run writes the
// tile key and the sorted face of each of its pairs at run offset + k where
// that is below kcap; a slot at or past min(total, kcap) takes the sentinel
// key B * n_tiles and face B * F. Keys are int32, the width _sort_and_ranges
// sorts them at (the wrapper raises where B * n_tiles reaches 2^31).
//
// Numerics. Built with --fmad=false and IEEE division, so that every f32
// operation rounds as the separate elementwise torch ops of the plain body
// do, in their order. torch.minimum/maximum and clamp keep a NaN, so these
// do too. f32 -> int32 is __float2int_rz: truncation toward zero, saturated,
// NaN -> 0, as geometry.sat_i32. Python float literals of the plain body are
// rounded to f32 as torch rounds a scalar operand.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kEps6 = (float)1e-6;
constexpr float kEps3 = (float)1e-3;

// torch.maximum / torch.minimum on the card
__device__ __forceinline__ float t_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float t_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
// torch.clamp(x, lo, hi) with scalar bounds
__device__ __forceinline__ float t_clamp(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

struct Face {
  float a[3], b[3], c[3];
  float rx, nx;
  int ry, risk;
};

// _row_tile_interval for one tile row: the covered tiles [lo, lo + cnt) as
// f32, its operations in order
__device__ __forceinline__ void row_interval(const Face& f, float tyf,
                                             float ts, float gx2, float* lo,
                                             float* cnt) {
  const float far = ts - 16.0f + 8.0f;
  float lof = f.rx;
  float hif = f.rx + f.nx - 1.0f;
  bool empty = false;
  for (int e = 0; e < 3; ++e) {
    const float a = f.a[e], b = f.b[e], c = f.c[e];
    const float ox = a > 0.0f ? 8.0f : far;
    const float oy = b > 0.0f ? 8.0f : far;
    const float yrow = ts * tyf + oy;
    const float h = a * ox + b * yrow + c;
    const float eps =
        512.0f + kEps6 * (fabsf(a) * ts + fabsf(b * yrow) + fabsf(c));
    const float g = a * ts;
    const float bound =
        t_clamp(__fdiv_rn(eps - h, g == 0.0f ? 1.0f : g), -2.0f, gx2);
    if (g > 0.0f) hif = t_min(hif, floorf(bound + kEps3));
    if (g < 0.0f) lof = t_max(lof, ceilf(bound - kEps3));
    empty = empty || (g == 0.0f && h >= eps);
  }
  lof = t_max(lof, f.rx);
  hif = t_min(hif, f.rx + f.nx - 1.0f);
  const float d = hif - lof + 1.0f;
  *lo = lof;
  *cnt = empty ? 0.0f : (d != d ? d : fmaxf(d, 0.0f));
}

__global__ void __launch_bounds__(kThreads)
    bin_count_kernel(const int* __restrict__ ea0, const int* __restrict__ ea1,
                     const int* __restrict__ ea2, const int* __restrict__ eb0,
                     const int* __restrict__ eb1, const int* __restrict__ eb2,
                     const int* __restrict__ ec0, const int* __restrict__ ec1,
                     const int* __restrict__ ec2,
                     const int* __restrict__ rect_min,
                     const int* __restrict__ rect_max,
                     const int* __restrict__ tiles,
                     const bool* __restrict__ nondeg, int* __restrict__ counts,
                     int* __restrict__ ny_eff, float4* __restrict__ rows,
                     int n, int gx, int gy, int tile_px) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  Face f;
  const int* ea[3] = {ea0, ea1, ea2};
  const int* eb[3] = {eb0, eb1, eb2};
  const int* ec[3] = {ec0, ec1, ec2};
  for (int e = 0; e < 3; ++e) {
    f.a[e] = (float)ea[e][i];
    f.b[e] = (float)eb[e][i];
    f.c[e] = (float)ec[e][i];
  }
  const int x0 = rect_min[2 * (int64_t)i], y0 = rect_min[2 * (int64_t)i + 1];
  const int x1 = rect_max[2 * (int64_t)i], y1 = rect_max[2 * (int64_t)i + 1];
  f.rx = (float)x0;
  f.nx = (float)(x1 - x0);
  f.ry = y0;
  const int ny = y1 - y0;

  // _edge_wrap_risk (SUBPIXEL 16)
  const float s_max = (float)(16.0 * tile_px * max(gx, gy));
  float m = 0.0f;
  for (int e = 0; e < 3; ++e)
    m = t_max(m, (fabsf(f.a[e]) + fabsf(f.b[e])) * s_max + fabsf(f.c[e]));
  f.risk = m >= 1073741824.0f;

  // exact_tile_counts: the rows r < ny of the grid, summed in f32 (whole
  // numbers: exact in any order)
  const float ts = 16.0f * (float)tile_px;
  const float gx2 = (float)(gx + 2.0);
  const int nrow = min(ny, gy);
  float sum = 0.0f;
  for (int r = 0; r < nrow; ++r) {
    float lo, cnt = f.nx;
    if (!f.risk) row_interval(f, (float)(y0 + r), ts, gx2, &lo, &cnt);
    sum += cnt;
  }
  const int count = (tiles[i] > 0 && nondeg[i]) ? __float2int_rz(sum) : 0;
  counts[i] = count;
  ny_eff[i] = count > 0 ? ny : 0;
  float4* row = rows + 4 * (int64_t)i;
  row[0] = make_float4(f.a[0], f.a[1], f.a[2], f.b[0]);
  row[1] = make_float4(f.b[1], f.b[2], f.c[0], f.c[1]);
  row[2] = make_float4(f.c[2], f.rx, f.nx, __int_as_float(f.ry));
  row[3] = make_float4(__int_as_float(f.risk), 0.0f, 0.0f, 0.0f);
}

__global__ void __launch_bounds__(kThreads)
    bin_runs_kernel(const int64_t* __restrict__ sigma,
                    const int64_t* __restrict__ row_incl,
                    const float4* __restrict__ rows, int* __restrict__ run_bf,
                    int* __restrict__ run_lo, int* __restrict__ run_ty,
                    int* __restrict__ run_cnt, int n, int64_t nr_cap, int gx,
                    int gy, int tile_px) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t end = row_incl[i];
  const int64_t first = i > 0 ? row_incl[i - 1] : 0;
  if (end == first || first >= nr_cap) return;
  const float4* row = rows + 4 * sigma[i];
  const float4 r0 = row[0], r1 = row[1], r2 = row[2], r3 = row[3];
  Face f;
  f.a[0] = r0.x, f.a[1] = r0.y, f.a[2] = r0.z;
  f.b[0] = r0.w, f.b[1] = r1.x, f.b[2] = r1.y;
  f.c[0] = r1.z, f.c[1] = r1.w, f.c[2] = r2.x;
  f.rx = r2.y, f.nx = r2.z;
  f.ry = __float_as_int(r2.w);
  f.risk = __float_as_int(r3.x);
  const float ts = 16.0f * (float)tile_px;
  const float gx2 = (float)(gx + 2.0);
  const float x_hi = (float)(gx - 1.0), y_hi = (float)(gy - 1.0);
  const int64_t stop = min(end, nr_cap);
  for (int64_t j = first; j < stop; ++j) {
    const float tyf = (float)f.ry + (float)(j - first);
    float lo = f.rx, cnt = f.nx;
    if (!f.risk) row_interval(f, tyf, ts, gx2, &lo, &cnt);
    run_bf[j] = i;
    run_lo[j] = __float2int_rz(t_clamp(lo, 0.0f, x_hi));
    run_ty[j] = __float2int_rz(t_clamp(tyf, 0.0f, y_hi));
    run_cnt[j] = __float2int_rz(cnt);
  }
}

__global__ void __launch_bounds__(kThreads)
    bin_emit_kernel(const int* __restrict__ run_bf,
                    const int* __restrict__ run_lo,
                    const int* __restrict__ run_ty,
                    const int* __restrict__ run_cnt,
                    const int64_t* __restrict__ pair_incl,
                    int* __restrict__ key, int* __restrict__ face,
                    int64_t n_threads, int64_t nr_cap, int kcap, int B, int F,
                    int gx, int gy) {
  const int64_t t = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  if (t >= n_threads) return;
  const int64_t n_tiles = (int64_t)gx * gy;
  if (t < nr_cap) {
    const int cnt = run_cnt[t];
    const int64_t start = pair_incl[t] - cnt;
    if (cnt > 0 && start < kcap) {
      const int bf = run_bf[t];
      const int64_t base =
          (int64_t)(bf / F) * n_tiles + (int64_t)run_ty[t] * gx + run_lo[t];
      const int stop = (int)min((int64_t)cnt, kcap - start);
      for (int k = 0; k < stop; ++k) {
        key[start + k] = (int)(base + k);
        face[start + k] = bf;
      }
    }
  }
  if (t < kcap && t >= min(pair_incl[nr_cap - 1], (int64_t)kcap)) {
    key[t] = (int)(B * n_tiles);
    face[t] = B * F;
  }
}

unsigned blocks(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// Count the (face, tile) pairs of each of the n = B * F (view, face) rows on
// `stream`; allocates nothing and does not synchronise. Inputs: the nine
// edge coefficients (edge_a[0..2], edge_b[0..2], edge_c[0..2]) [n] int32,
// rect_min and rect_max [n, 2] int32, tiles [n] int32, nondeg [n] bool.
// Outputs: counts [n] int32, ny_eff [n] int32, rows [n, 16] f32 (16-byte
// aligned). Returns the launch's cudaGetLastError().
extern "C" int bin_count(const void* ea0, const void* ea1, const void* ea2,
                         const void* eb0, const void* eb1, const void* eb2,
                         const void* ec0, const void* ec1, const void* ec2,
                         const void* rect_min, const void* rect_max,
                         const void* tiles, const void* nondeg, void* counts,
                         void* ny_eff, void* rows, int n, int gx, int gy,
                         int tile_px, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  bin_count_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)ea0, (const int*)ea1, (const int*)ea2, (const int*)eb0,
      (const int*)eb1, (const int*)eb2, (const int*)ec0, (const int*)ec1,
      (const int*)ec2, (const int*)rect_min, (const int*)rect_max,
      (const int*)tiles, (const bool*)nondeg, (int*)counts, (int*)ny_eff,
      (float4*)rows, n, gx, gy, tile_px);
  return (int)cudaGetLastError();
}

// Fill the run table's live rows (below nr_cap) on `stream`, one thread per
// depth-sorted face; allocates nothing and does not synchronise. Inputs:
// sigma [n] int64, row_incl [n] int64 (the inclusive scan of ny_eff[sigma]),
// bin_count's rows. Outputs: run_bf, run_lo, run_ty, run_cnt [nr_cap] int32
// (run_cnt zeroed before). Returns the launch's cudaGetLastError().
extern "C" int bin_runs(const void* sigma, const void* row_incl,
                        const void* rows, void* run_bf, void* run_lo,
                        void* run_ty, void* run_cnt, int n, int64_t nr_cap,
                        int gx, int gy, int tile_px, void* stream) {
  if (n <= 0 || nr_cap <= 0) return (int)cudaSuccess;
  bin_runs_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)sigma, (const int64_t*)row_incl, (const float4*)rows,
      (int*)run_bf, (int*)run_lo, (int*)run_ty, (int*)run_cnt, n, nr_cap, gx,
      gy, tile_px);
  return (int)cudaGetLastError();
}

// Write all kcap key slots on `stream`, one thread per run-table row and per
// slot; allocates nothing and does not synchronise. Inputs: the run table
// and pair_incl [nr_cap] int64 (the inclusive scan of run_cnt). Outputs: key
// and face [kcap] int32 (B * gx * gy < 2^31). Returns the launch's
// cudaGetLastError().
extern "C" int bin_emit(const void* run_bf, const void* run_lo,
                        const void* run_ty, const void* run_cnt,
                        const void* pair_incl, void* key, void* face,
                        int64_t nr_cap, int kcap, int B, int F, int gx, int gy,
                        void* stream) {
  const int64_t n = max(nr_cap, (int64_t)kcap);
  if (nr_cap <= 0 || n <= 0) return (int)cudaSuccess;
  bin_emit_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)run_bf, (const int*)run_lo, (const int*)run_ty,
      (const int*)run_cnt, (const int64_t*)pair_incl, (int*)key, (int*)face,
      n, nr_cap, kcap, B, F, gx, gy);
  return (int)cudaGetLastError();
}
