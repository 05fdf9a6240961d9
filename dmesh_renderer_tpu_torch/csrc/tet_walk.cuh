// The tet march's shared device code: the march tables' row widths, the
// projective-depth clamp and the connectivity step, used by the forward
// march (K4, tet_fwd.cu), the backward march (K5, tet_bwd.cu) and the
// experiment kernels (march_probe.cu).
//
// The step replaces dmesh_renderer_tpu/ops/tet.py::_connectivity_step. From
// face cf inside tet ct it finds the face the ray leaves through: the strict
// Moller-Trumbore hit among the three other faces whose outward normal has a
// positive (kDir = +1, forward) or negative (kDir = -1, backward) dot with
// the ray, the last such in slot order. The reference's three invariant
// violations are errors: not three other faces, an entry face that does not
// oppose the walk (forward: its outward dot >= 0; backward: <= 0), not
// exactly one exit.
//
// walk_nrm<kDir> is the step of K4 and K5. A step's work is its four
// ray/face tests (~244 f32 operations) on the tet's rows (144 + 48 + 32
// bytes, from L1 or the 50 MB L2). Rebuilt per step, the four outward unit
// normals would add four correctly rounded square roots and twelve IEEE
// divides, each a multi-instruction sequence in --prec-div/--prec-sqrt
// code. walk_nrm reads them from the march tables' tet_nrm instead (sign *
// n-hat, the same bits), so a step's only divisions are the tests'
// reciprocals, and it loads every row as 16-byte vectors (14 loads, not
// 48). Skipping the entry slot's test, whose values a successful step never
// uses, was tried and not kept: selecting the other three slots' rows cost
// more than the test it saved.
//
// walk_slots<kDir, Id> is the step with the reference's fallback and the
// rebuilt normals, for the experiment kernels: it always writes the
// selected slot's values (the last exit in slot order, slot 0 when there is
// none), error or not, and returns the error flag. The unit normal is
// recomputed with the precompute's operation order (cross, sqrt of the sum
// of squares, max with 1e-4, divide). Id is int for the march tables' id
// rows and float for rows that carry the ids as exact f32.
//
// Built with --fmad=false and IEEE division and square root, so that every
// f32 operation rounds as the elementwise torch ops of the plain versions
// (ops/tet.py::_walk) do.

#pragma once

#include <cuda_runtime.h>

namespace tet {

// march tables: tet geometry [T, 40] f32 (p0, e1, e2 of the four face slots,
// then the four outward signs), tet normals [T, 12] f32 (each slot's
// outward unit normal), tet ids [T, 8] int32 (the slots' face ids,
// then each slot's neighbour tet), shade [B*F, 12] f32 (9 corner colours,
// alpha, log(max(1 - alpha, 1e-37)), the view's intensity)
constexpr int kTG = 40, kTN = 12, kTI = 8, kSH = 12;
constexpr float kWEps = 1e-4f;

__device__ __forceinline__ float clamp_w(float w) {
  if (w >= 0.0f && w < kWEps) return kWEps;
  if (w < 0.0f && w > -kWEps) return -kWEps;
  return w;
}

// One connectivity step with the reference's fallback values: writes the
// next face, its tet (-1 past the mesh's boundary) and the hit's t, u, v of
// the selected slot whatever the outcome, and returns true on an invariant
// violation.
template <int kDir, typename Id>
__device__ __forceinline__ bool walk_slots(const float* __restrict__ g,
                                           const Id* __restrict__ ids, Id cf,
                                           float ox, float oy, float oz,
                                           float dx, float dy, float dz,
                                           float& t, float& u, float& v,
                                           Id& next_face, Id& next_tet) {
  int n_other = 0, n_exit = 0;
  float d_entry = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float p0x = g[9 * j + 0], p0y = g[9 * j + 1], p0z = g[9 * j + 2];
    const float e1x = g[9 * j + 3], e1y = g[9 * j + 4], e1z = g[9 * j + 5];
    const float e2x = g[9 * j + 6], e2y = g[9 * j + 7], e2z = g[9 * j + 8];
    const float sgn = g[36 + j];
    const Id tfj = ids[j], nbj = ids[4 + j];

    const float nx = e1y * e2z - e1z * e2y;
    const float ny = e1z * e2x - e1x * e2z;
    const float nz = e1x * e2y - e1y * e2x;
    const float norm = fmaxf(sqrtf(nx * nx + ny * ny + nz * nz), 1e-4f);
    const float outd =
        sgn * ((nx / norm) * dx + (ny / norm) * dy + (nz / norm) * dz);

    const float tvx = ox - p0x, tvy = oy - p0y, tvz = oz - p0z;
    const float pvx = dy * e2z - dz * e2y;
    const float pvy = dz * e2x - dx * e2z;
    const float pvz = dx * e2y - dy * e2x;
    const float qvx = tvy * e1z - tvz * e1y;
    const float qvy = tvz * e1x - tvx * e1z;
    const float qvz = tvx * e1y - tvy * e1x;
    const float denom = pvx * e1x + pvy * e1y + pvz * e1z;
    const bool nd = denom != 0.0f;
    const float inv = 1.0f / (nd ? denom : 1.0f);
    const float tj = (qvx * e2x + qvy * e2y + qvz * e2z) * inv;
    const float uj = (pvx * tvx + pvy * tvy + pvz * tvz) * inv;
    const float vj = (qvx * dx + qvy * dy + qvz * dz) * inv;
    const bool hit =
        nd && tj >= 0.0f && uj >= 0.0f && vj >= 0.0f && uj + vj <= 1.0f;

    const bool is_entry = tfj == cf;
    n_other += is_entry ? 0 : 1;
    d_entry = d_entry + (is_entry ? outd : 0.0f);
    const bool dir_ok = kDir > 0 ? outd > 0.0f : outd < 0.0f;
    const bool ex = !is_entry && hit && dir_ok;
    n_exit += ex ? 1 : 0;
    if (j == 0 || ex) {
      t = tj;
      u = uj;
      v = vj;
      next_face = tfj;
      next_tet = nbj;
    }
  }
  const bool entry_bad = kDir > 0 ? d_entry >= 0.0f : d_entry <= 0.0f;
  return n_other != 3 || entry_bad || n_exit != 1;
}

// One connectivity step that reads each slot's outward unit normal from the
// tet's tet_nrm row (ops/tet.py::march_tables: sign * n-hat, the bits of the
// normal walk_slots rebuilds, and a sign of +-1 multiplies exactly, so the
// dot rounds as sign * (n-hat . d) does). The tet's rows are read as 16-byte
// vectors: geometry g4 (10 float4: 160 bytes, the signs unused), normals n4
// (3 float4) and ids i4 (2 int4). The same exit test, selection and errors
// as walk_slots. On success writes the next face, its tet (-1 past the
// mesh's boundary) and the hit's t, u, v and returns false; on an invariant
// violation returns true and writes nothing. K4 walks with kDir = +1, K5
// with kDir = -1.
template <int kDir>
__device__ __forceinline__ bool walk_nrm(const float4* __restrict__ g4,
                                         const float4* __restrict__ n4,
                                         const int4* __restrict__ i4, int cf,
                                         float ox, float oy, float oz,
                                         float dx, float dy, float dz,
                                         float& t, float& u, float& v,
                                         int& next_face, int& next_tet) {
  float g[36], nr[kTN];
  int ids[kTI];
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const float4 a = g4[q];
    g[4 * q] = a.x;
    g[4 * q + 1] = a.y;
    g[4 * q + 2] = a.z;
    g[4 * q + 3] = a.w;
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const float4 a = n4[q];
    nr[4 * q] = a.x;
    nr[4 * q + 1] = a.y;
    nr[4 * q + 2] = a.z;
    nr[4 * q + 3] = a.w;
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int4 a = i4[q];
    ids[4 * q] = a.x;
    ids[4 * q + 1] = a.y;
    ids[4 * q + 2] = a.z;
    ids[4 * q + 3] = a.w;
  }
  int n_other = 0, n_exit = 0;
  float d_entry = 0.0f;
  float st = 0.0f, su = 0.0f, sv = 0.0f;
  int sf = -1, stt = -1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float p0x = g[9 * j + 0], p0y = g[9 * j + 1], p0z = g[9 * j + 2];
    const float e1x = g[9 * j + 3], e1y = g[9 * j + 4], e1z = g[9 * j + 5];
    const float e2x = g[9 * j + 6], e2y = g[9 * j + 7], e2z = g[9 * j + 8];
    const int tfj = ids[j], nbj = ids[4 + j];
    const float outd =
        nr[3 * j] * dx + nr[3 * j + 1] * dy + nr[3 * j + 2] * dz;

    const float tvx = ox - p0x, tvy = oy - p0y, tvz = oz - p0z;
    const float pvx = dy * e2z - dz * e2y;
    const float pvy = dz * e2x - dx * e2z;
    const float pvz = dx * e2y - dy * e2x;
    const float qvx = tvy * e1z - tvz * e1y;
    const float qvy = tvz * e1x - tvx * e1z;
    const float qvz = tvx * e1y - tvy * e1x;
    const float denom = pvx * e1x + pvy * e1y + pvz * e1z;
    const bool nd = denom != 0.0f;
    const float inv = 1.0f / (nd ? denom : 1.0f);
    const float tj = (qvx * e2x + qvy * e2y + qvz * e2z) * inv;
    const float uj = (pvx * tvx + pvy * tvy + pvz * tvz) * inv;
    const float vj = (qvx * dx + qvy * dy + qvz * dz) * inv;
    const bool hit =
        nd && tj >= 0.0f && uj >= 0.0f && vj >= 0.0f && uj + vj <= 1.0f;

    const bool is_entry = tfj == cf;
    n_other += is_entry ? 0 : 1;
    d_entry = d_entry + (is_entry ? outd : 0.0f);
    const bool dir_ok = kDir > 0 ? outd > 0.0f : outd < 0.0f;
    const bool ex = !is_entry && hit && dir_ok;
    n_exit += ex ? 1 : 0;
    if (j == 0 || ex) {
      st = tj;
      su = uj;
      sv = vj;
      sf = tfj;
      stt = nbj;
    }
  }
  const bool entry_bad = kDir > 0 ? d_entry >= 0.0f : d_entry <= 0.0f;
  if (n_other != 3 || entry_bad || n_exit != 1) return true;
  t = st;
  u = su;
  v = sv;
  next_face = sf;
  next_tet = stt;
  return false;
}

}  // namespace tet
