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
// What bounds K3 on the H100. At the tet headline (98,400 faces, 800x800)
// the pixels need 18.8 M (pixel, slot) tests of ~41 f32 operations, one
// IEEE reciprocal among them, and the tiles' longest walks need 23,576 of
// the 321,998 listed rows: 0.0115 ms of operations (chip_smoke.py counts
// both from the run). The earlier shape, one 256-thread block per 16x16
// quarter of a tile with 256-slot rounds, staged the tile's rows once per
// quarter and a whole round at a time: 546,225 rows.
//
// Shape of K3. One block of 1024 threads per 32x32 tile, one pixel a
// thread at the start, each warp an 8x4-pixel patch. The tile's list is
// staged once, in rounds of kRound = 32 slots, double-buffered: while the
// block walks round r, the 16-byte cp.async copies of round r + 1 are in
// flight (a row is four of them, the first 128 threads one each), and each
// copying thread already holds the slot_face entry of its row in the round
// after that. The block stops staging once every pixel is done, tested at
// each round boundary; `walked` is the rows it staged, the prefetched round
// included: min(list length, 32 x (rounds walked + 1)), 49,619 at the
// headline. At each round boundary the live pixels are also packed into
// the first threads (their state moves through shared memory) when that
// empties warps, so that the pixels that miss every face and walk the whole
// list (32,540 at the headline, 10 % of the tests) fill their warps. A
// thread tests kUnroll = 4 rows per step (four independent chains, the
// reciprocal's latency among them) and then takes the results in slot
// order with selects.
//
// Measured on the H100 (chip_smoke.py; k3_variants.py builds one-line
// variants of this file): 0.105 ms of device time against the quarter
// shape's 0.116 at the headline; without the packing 0.154, with one slot
// a step 0.111. Two or four pixels a thread (a row read once for all of
// them, fewer resident warps), starting the tiles at the image's border
// first, and skipping the reciprocal where a numerator's sign already
// rules a hit out were built and measured slower. So the kernel is held
// neither by the rows it stages nor by shared-memory reads; it gains from
// independent tests per warp, and the latency of each test's dependent
// chain with one 1024-thread block per SM is what is left (not measured
// directly: ncu does not run on the card's machine).
//
// Each pixel tests the same faces, in the same order, with the same f32
// operations as first_hit_plain, so its outputs keep their bits; no
// per-pixel result depends on when the block stops or which thread walks
// the pixel.
//
// K4 replaces dmesh_renderer_tpu/ops/tet.py::_fwd_march_kernel (with
// _connectivity_step). On the TPU each call is one lockstep step over all
// rays, with the rays' state in device memory between steps. Here one
// thread carries one ray through its whole walk inside one launch, as the
// CUDA original does: per step it blends the current face (colour from the
// three corner colours at (u, v) times the view's intensity, depth from the
// projective z/w of the ray at t), updates log-transmittance with one expf,
// terminates when T < 1e-4 or the walk has left the mesh, and otherwise
// walks to the exit face of the current tet (tet_walk.cuh's walk_nrm<1>,
// the step K5 takes with the direction flipped). The reference's three
// invariant violations (not three other faces, an entry face that does not
// oppose the ray, not exactly one exit) end the walk with the pixel
// inactive. A thread that is done retires: there is no lockstep, compaction
// or march log.
//
// What bounds K4 on the H100. A step reads the tet's geometry (144 of its
// 160 bytes), normal (48) and id (32) rows and the face's shade row (48).
// The tables (16 MB at the tet headline) stay in the 50 MB L2, so the card's
// floor is to read them and each ray's inputs once and write its outputs
// (72 MB), and to do ~44 f32 operations per blend and 4 x (5 + 51 + 5) per
// walk step: about 0.021 ms either way at the headline's 5.4 M blends and
// 4.8 M steps (chip_smoke.py counts both). A step that rebuilds the four
// outward unit normals (four correctly rounded square roots, twelve IEEE
// divides) and reads the rows with 60 scalar loads ran at 15 % of that
// bound (0.188 ms). So the normals come from march_tables' tet_nrm (sign *
// n-hat, the same bits), a step's only divisions are its four
// Moller-Trumbore reciprocals, and every row is read as float4s / int4s (17
// vector loads per step). Those loads, 272 bytes per step, are L1 and L2
// traffic: the lanes of a warp are an 8x4-pixel patch (a block two such
// warps side by side), whose rays walk through mostly the same tets, so
// more of their rows are L1 hits than for 32 pixels of one image row;
// neighbouring rays also walk for about as long.
//
// Numerics. Built with --fmad=false and IEEE division and square root, so
// that every f32 operation rounds as the separate elementwise torch ops of
// the plain versions (first_hit_plain, fwd_march_plain) do. All literals
// are f32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "tet_walk.cuh"

namespace {

using acopy::cp_async16;
using acopy::cp_async_commit;
using acopy::cp_async_wait;

using tet::clamp_w;
using tet::kSH;
using tet::kTG;
using tet::kTI;
using tet::kTN;

constexpr int kTile = 32;
constexpr float kBig = 3.0e38f;
constexpr float kTEps = 1e-4f;
// K4: one ray per thread, a block per 16x4-pixel patch of a view (two
// warps of 8x4 pixels)
constexpr int kRayTileW = 16, kRayTileH = 4;
constexpr int kMarchThreads = kRayTileW * kRayTileH;

// K3: one block per 32x32 tile, one pixel a thread at the start (each warp
// an 8x4-pixel patch), rows staged in rounds of kRound slots, kUnroll slots
// tested per step
constexpr int kFhThreads = kTile * kTile;
constexpr int kRound = 32;
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;

// first-hit table columns ([B*F, 16] f32, depth-sorted rows): T = o - p0
// (0-2), E1 (3-5), E2 (6-8), Q = T x E1 (9-11), min depth, max depth, face
// id, pad; as float4s: (T, E1x) (E1yz, E2xy) (E2z, Q) (minD, maxD, id, -)
constexpr int kFH = 16;
constexpr int kRowVec = kFH / 4;
static_assert(kRound * kRowVec <= kFhThreads, "one 16-byte copy a thread");
static_assert(kFhThreads == 32 * 32, "block_scan: one warp count a lane");

// One pixel's test of one staged row: the strict Moller-Trumbore hit with
// the same f32 operations as first_hit_plain (the reciprocal of a zero
// denominator is computed and never used), and the row's depth window.
struct FaceTest {
  float tt, u, v, min_d, max_d, fid;
  bool hit;
};

__device__ __forceinline__ FaceTest test_row(const float4* __restrict__ f,
                                             float dx, float dy, float dz) {
  const float4 f0 = f[0], f1 = f[1], f2 = f[2], f3 = f[3];
  const float tvx = f0.x, tvy = f0.y, tvz = f0.z;
  const float e1x = f0.w, e1y = f1.x, e1z = f1.y;
  const float e2x = f1.z, e2y = f1.w, e2z = f2.x;
  const float qx = f2.y, qy = f2.z, qz = f2.w;
  const float Px = dy * e2z - dz * e2y;
  const float Py = dz * e2x - dx * e2z;
  const float Pz = dx * e2y - dy * e2x;
  const float denom = Px * e1x + Py * e1y + Pz * e1z;
  const float tnum = qx * e2x + qy * e2y + qz * e2z;
  const float unum = Px * tvx + Py * tvy + Pz * tvz;
  const float vnum = qx * dx + qy * dy + qz * dz;
  FaceTest h;
  h.min_d = f3.x;
  h.max_d = f3.y;
  h.fid = f3.z;
  const float inv = 1.0f / denom;
  h.tt = tnum * inv;
  h.u = unum * inv;
  h.v = vnum * inv;
  h.hit = denom != 0.0f && h.tt >= 0.0f && h.u >= 0.0f && h.v >= 0.0f &&
          h.u + h.v <= 1.0f;
  return h;
}

// The exclusive prefix count of `flag` over K3's 1024 threads (in thread
// order) and, in `total`, the block's count. Uses `warp_n` [32]; ends with
// a barrier, so it can be called again at once.
__device__ __forceinline__ int block_scan(bool flag, int* warp_n, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned bal = __ballot_sync(kFull, flag);
  if (lane == 0) warp_n[warp] = __popc(bal);
  __syncthreads();
  const int c = warp_n[lane];
  int incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  total = __shfl_sync(kFull, incl, 31);
  const int off = __shfl_sync(kFull, incl - c, warp);
  __syncthreads();
  return off + __popc(bal & ((1u << lane) - 1u));
}

__global__ void __launch_bounds__(kFhThreads)
tet_first_hit_kernel(const int* __restrict__ starts,
                     const int* __restrict__ ends,
                     const int* __restrict__ slot_face,
                     const float4* __restrict__ table,
                     const float* __restrict__ ray_d, float* __restrict__ tuv,
                     int* __restrict__ face, int* __restrict__ walked, int H,
                     int W, int gx, int gy) {
  __shared__ float4 rows[2][kRound][kRowVec];  // two rounds' rows
  __shared__ float moved[8][kFhThreads];       // live pixels being packed
  __shared__ int moved_pix[kFhThreads];
  __shared__ int warp_n[32];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.z;
  const int tile = (b * gy + blockIdx.y) * gx + blockIdx.x;
  const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
  const int start = starts[tile];
  const int end = ends[tile];
  const int n_rounds = (end - start + kRound - 1) / kRound;
  const size_t plane = (size_t)H * W;

  // the pixel this thread walks (its index in the tile, row-major) and its
  // state; `live`: it holds a pixel that is not done
  int pix = ((warp >> 2) * 4 + (lane >> 3)) * kTile + (warp & 3) * 8 +
            (lane & 7);
  bool live = x0 + pix % kTile < W && y0 + pix / kTile < H;
  float dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (live) {
    const size_t p =
        ((size_t)b * H + y0 + pix / kTile) * W + x0 + pix % kTile;
    dx = ray_d[p * 3 + 0];
    dy = ray_d[p * 3 + 1];
    dz = ray_d[p * 3 + 2];
  }
  float bt = kBig, bmax = 0.0f, bu = 0.0f, bv = 0.0f;
  int bface = -1;
  auto write_out = [&]() {
    const size_t yx = (size_t)(y0 + pix / kTile) * W + x0 + pix % kTile;
    const size_t o = (size_t)b * 3 * plane + yx;
    tuv[o + 0 * plane] = bt < kBig ? bt : 0.0f;
    tuv[o + 1 * plane] = bu;
    tuv[o + 2 * plane] = bv;
    face[(size_t)b * plane + yx] = bface;
  };

  // thread k < 128 copies float4 k % 4 of row k / 4 of each round; `next`
  // is the table row of its slot in the next round to stage (-1: none)
  const int srow = threadIdx.x / kRowVec;
  const int svec = threadIdx.x % kRowVec;
  auto row_of = [&](int r) {
    const int s = start + r * kRound + srow;
    return srow < kRound && s < end ? slot_face[s] : -1;
  };
  auto stage = [&](int r, int row) {
    if (row >= 0)
      cp_async16(&rows[r & 1][srow][svec],
                 table + (size_t)row * kRowVec + svec);
  };
  int next = row_of(0);
  stage(0, next);
  cp_async_commit();
  next = row_of(1);
  int staged = min(n_rounds, 1);

  for (int r = 0; r < n_rounds; ++r) {
    // --- count the live pixels, stop once there are none; the barriers
    // also keep the other buffer's rows in place until every thread has
    // walked them ---
    int n_live;
    const int off = block_scan(live, warp_n, n_live);
    if (n_live == 0) break;
    // --- pack them into the first threads when that empties warps: their
    // state moves through shared memory, so each still walks its own slots
    // in order with its own values ---
    const bool busy = __any_sync(kFull, live);
    if (__syncthreads_count(busy && lane == 0) > (n_live + 31) / 32) {
      if (live) {
        moved[0][off] = dx;
        moved[1][off] = dy;
        moved[2][off] = dz;
        moved[3][off] = bt;
        moved[4][off] = bmax;
        moved[5][off] = bu;
        moved[6][off] = bv;
        moved[7][off] = __int_as_float(bface);
        moved_pix[off] = pix;
      }
      __syncthreads();
      live = threadIdx.x < n_live;
      if (live) {
        dx = moved[0][threadIdx.x];
        dy = moved[1][threadIdx.x];
        dz = moved[2][threadIdx.x];
        bt = moved[3][threadIdx.x];
        bmax = moved[4][threadIdx.x];
        bu = moved[5][threadIdx.x];
        bv = moved[6][threadIdx.x];
        bface = __float_as_int(moved[7][threadIdx.x]);
        pix = moved_pix[threadIdx.x];
      }
    }
    if (r + 1 < n_rounds) {
      stage(r + 1, next);
      next = row_of(r + 2);
      ++staged;
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of round r have landed
    __syncthreads();     // and every thread's

    // --- walk round r: kUnroll rows tested at a time (the tests do not
    // depend on each other), then taken in slot order with selects: the
    // depth-window exit before a face's hit, the first face in order
    // winning a tie ---
    const int n = min(kRound, end - start - r * kRound);
    bool exited = false;
    for (int j = 0; live && j < n; j += kUnroll) {
      FaceTest h[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        h[k] = test_row(rows[r & 1][min(j + k, n - 1)], dx, dy, dz);
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const bool in = live && j + k < n;
        const bool ex = in && bt < kBig && h[k].min_d > bmax;
        const bool up = in && !ex && h[k].hit && h[k].tt < bt;
        bmax = up ? h[k].max_d : bmax;
        bface = up ? (int)h[k].fid : bface;
        bu = up ? h[k].u : bu;
        bv = up ? h[k].v : bv;
        bt = up ? h[k].tt : bt;
        exited = exited || ex;
        live = live && !ex;
      }
    }
    if (exited) write_out();
  }
  cp_async_wait<0>();  // no copy outlives the block

  if (threadIdx.x == 0) walked[tile] = min(end - start, staged * kRound);
  if (live) write_out();  // walked its whole list, or the list is empty
}

__global__ void __launch_bounds__(kMarchThreads)
tet_fwd_march_kernel(const float* __restrict__ ray_d,
                     const float* __restrict__ cam_o,
                     const float* __restrict__ zw,
                     const int* __restrict__ first_face,
                     const int* __restrict__ first_tet,
                     const float* __restrict__ tuv,
                     const float* __restrict__ tet_geo,
                     const float* __restrict__ tet_nrm,
                     const int* __restrict__ tet_ids,
                     const float* __restrict__ shade,
                     float* __restrict__ out_f, int* __restrict__ out_i,
                     int M, int H, int W, int F, int max_steps,
                     float log_t_floor) {
  // a block is a 16x4-pixel patch of one view, each warp 8x4 pixels
  const int lane = threadIdx.x & 31;
  const int x = blockIdx.x * kRayTileW + (threadIdx.x >> 5) * 8 + (lane & 7);
  const int y = blockIdx.y * kRayTileH + (lane >> 3);
  if (x >= W || y >= H) return;
  const int view = blockIdx.z;
  const int i = (view * H + y) * W + x;
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
    // --- blend the current face: its shade row as three float4s (9 corner
    // colours, alpha, log(1 - alpha), intensity) ---
    const float4* sh = reinterpret_cast<const float4*>(
        shade + ((size_t)view * F + cf) * kSH);
    const float4 s0 = sh[0], s1 = sh[1], s2 = sh[2];
    const float alpha = s2.y, l1a = s2.z, inten = s2.w;
    const float w = T_cur * alpha;
    const float cr = (s0.x + (s0.w - s0.x) * u + (s1.z - s0.x) * v) * inten;
    const float cg = (s0.y + (s1.x - s0.y) * u + (s1.w - s0.y) * v) * inten;
    const float cb = (s0.z + (s1.y - s0.z) * u + (s2.x - s0.z) * v) * inten;
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
    if (tet::walk_nrm<1>(
            reinterpret_cast<const float4*>(tet_geo + (size_t)ct * kTG),
            reinterpret_cast<const float4*>(tet_nrm + (size_t)ct * kTN),
            reinterpret_cast<const int4*>(tet_ids + (size_t)ct * kTI), cf,
            ox, oy, oz, dx, dy, dz, t, u, v, cf, ct))
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

// Launch K3 on `stream`; allocates nothing and does not synchronise. One
// block per 32x32 tile. The table [B*F, 16] f32 is read as 16-byte rows and
// must be 16-byte aligned. Outputs: tuv [B, 3, H, W] f32 (t, 0 on a miss;
// u; v), face [B, H, W] int32 (-1 on a miss), walked [B, gy, gx] int32
// (the slots each tile's block staged). Returns the launch's
// cudaGetLastError().
extern "C" int tet_first_hit(const void* starts, const void* ends,
                             const void* slot_face, const void* table,
                             const void* ray_d, void* tuv, void* face,
                             void* walked, int B, int H, int W, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  const int gx = (W + kTile - 1) / kTile;
  const int gy = (H + kTile - 1) / kTile;
  tet_first_hit_kernel<<<dim3(gx, gy, B), kFhThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int*)starts, (const int*)ends, (const int*)slot_face,
      (const float4*)table, (const float*)ray_d, (float*)tuv, (int*)face,
      (int*)walked, H, W, gx, gy);
  return (int)cudaGetLastError();
}

// Launch K4 on `stream` over M = B * H * W rays (view-major, each view's
// pixels row-major); allocates nothing and does not synchronise. Outputs:
// out_f [6, M] f32 (C rgb, D, log T, the log T before the last blend),
// out_i [4, M] int32 (last face, last tet, n_contrib, active). zw and the
// tables tet_geo [T, 40], tet_nrm [T, 12], tet_ids [T, 8] and shade
// [B*F, 12] are read as 16-byte rows and must be 16-byte aligned. Returns
// the launch's cudaGetLastError().
extern "C" int tet_fwd_march(const void* ray_d, const void* cam_o,
                             const void* zw, const void* first_face,
                             const void* first_tet, const void* tuv,
                             const void* tet_geo, const void* tet_nrm,
                             const void* tet_ids, const void* shade,
                             void* out_f, void* out_i, int B, int H, int W,
                             int F, int max_steps, float log_t_floor,
                             void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  const dim3 grid((W + kRayTileW - 1) / kRayTileW,
                  (H + kRayTileH - 1) / kRayTileH, B);
  tet_fwd_march_kernel<<<grid, kMarchThreads, 0, (cudaStream_t)stream>>>(
      (const float*)ray_d, (const float*)cam_o, (const float*)zw,
      (const int*)first_face, (const int*)first_tet, (const float*)tuv,
      (const float*)tet_geo, (const float*)tet_nrm, (const int*)tet_ids,
      (const float*)shade, (float*)out_f, (int*)out_i, B * H * W, H, W, F,
      max_steps, log_t_floor);
  return (int)cudaGetLastError();
}
