// The tet march's shared device code: the march tables' row widths, the
// projective-depth clamp and the connectivity step, used by the forward
// march (K4, tet_fwd.cu) and the experiment kernels (march_probe.cu). The
// backward march (K5, tet_bwd.cu) takes the widths and the clamp, and walks
// with its own variant of the step, walk_back, which reads the outward
// normals from the march tables' tet_nrm instead of rebuilding them.
//
// walk_step<kDir> replaces dmesh_renderer_tpu/ops/tet.py::_connectivity_step.
// From face cf inside tet ct (its geometry row g, id row ids) it finds the
// face the ray leaves through: the strict Moller-Trumbore hit among the three
// other faces whose outward normal has a positive (kDir = +1, forward) or
// negative (kDir = -1, backward) dot with the ray, the last such in slot
// order. The reference's three invariant violations are errors: not three
// other faces, an entry face that does not oppose the walk (forward: its
// outward dot >= 0; backward: <= 0), not exactly one exit. The unit normal is
// recomputed with the precompute's operation order (cross, sqrt of the sum
// of squares, max with 1e-4, divide).
//
// walk_slots<kDir, Id> is the same step with the reference's fallback: it
// always writes the selected slot's values (the last exit in slot order,
// slot 0 when there is none), error or not, and returns the error flag. Id
// is int for the march tables' id rows and float for rows that carry the
// ids as exact f32 (the experiment kernels of march_probe.cu).
//
// Built with --fmad=false and IEEE division and square root, so that every
// f32 operation rounds as the elementwise torch ops of the plain versions
// (ops/tet.py::_walk) do.

#pragma once

#include <cuda_runtime.h>

namespace tet {

// march tables: tet geometry [T, 40] f32 (p0, e1, e2 of the four face slots,
// then the four outward signs), tet ids [T, 8] int32 (the slots' face ids,
// then each slot's neighbour tet), shade [B*F, 12] f32 (9 corner colours,
// alpha, log(max(1 - alpha, 1e-37)), the view's intensity)
constexpr int kTG = 40, kTI = 8, kSH = 12;
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

// One connectivity step. On success writes the next face, its tet (-1 past
// the mesh's boundary) and the hit's t, u, v, and returns false; on an
// invariant violation returns true and writes nothing.
template <int kDir>
__device__ __forceinline__ bool walk_step(const float* __restrict__ g,
                                          const int* __restrict__ ids, int cf,
                                          float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float& t, float& u, float& v,
                                          int& next_face, int& next_tet) {
  float nt_ = 0.0f, nu_ = 0.0f, nv_ = 0.0f;
  int nface = -1, ntet = -1;
  if (walk_slots<kDir, int>(g, ids, cf, ox, oy, oz, dx, dy, dz, nt_, nu_,
                            nv_, nface, ntet))
    return true;
  t = nt_;
  u = nu_;
  v = nv_;
  next_face = nface;
  next_tet = ntet;
  return false;
}

}  // namespace tet
