// Tet renderer march tables and ray starts for Hopper (sm_90a): the glue
// between the first hit (K3) and the march (K4).
//
// tet_tables builds ops/tet.py::march_tables_plain's tables in one launch,
// one thread per face and one per tet:
//
//   - a face thread writes the face's geo row [F, 12] (p0, e1, e2 and the
//     unit normal n-hat = n / max(|n|, 1e-4), n = e1 x e2) and its shade row
//     [B*F, 12] in every view (the corners' nine colours, alpha,
//     log(max(1 - alpha, 1e-37)) and the view's intensity);
//   - a tet thread rebuilds the geometry of its four faces (the same bits
//     as the face threads': the same operations in the same order), takes
//     the centroid, and writes sign [T, 4] (-1 where the normal points to
//     the centroid's side), tet_geo [T, 40], tet_nrm [T, 12] (sign * n-hat)
//     and tet_ids [T, 8] (the face ids, then each face's other tet: the
//     first entry of face_tets that is neither this tet nor -1).
//
// tet_ray_start writes each ray's march inputs, one thread per ray:
// first_tet [M] int32 (start_tets_plain's rule: of the first face's two
// tets, the one whose outward normal of that face opposes the ray, the
// second when both do), zw [M, 4] (projective_zw_plain: z and w of
// proj(mv(o + t d)) as affine functions of t) and tuv [3, M] (the first
// hit's t, u, v).
//
// They replace ~60 elementwise torch launches and eight dim-0 gathers,
// each launched with one small block per gathered row (640,000 one-warp
// blocks for a per-ray gather at the tet headline): 3.1 ms a train step.
// What bounds them: ~22 MB of tables written and ~60 bytes a ray moved,
// the gathered tables (verts, geo, sign, tet_faces) in the L2: ~0.012 ms at
// the headline. A thread's row is written as float4s / int4s.
//
// Numerics. Built with --fmad=false and IEEE division and square root, so
// that every f32 operation rounds as the separate elementwise torch ops of
// the plain versions do, in their order; torch.log on the card is the same
// logf. torch.maximum keeps a NaN, so the clamps do too. All literals are
// f32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGeo = 12, kSign = 4, kTG = 40, kTN = 12, kTI = 8, kSH = 12;

// torch.maximum(a, b) for a b that is not NaN
__device__ __forceinline__ float max_keep_nan(float a, float b) {
  return a != a ? a : fmaxf(a, b);
}

struct FaceGeo {
  float p[3], e1[3], e2[3], n[3];
};

// p0, e1, e2 and n-hat of face f, march_tables_plain's operations in order
__device__ __forceinline__ FaceGeo face_geo(const float* __restrict__ verts,
                                            const int* __restrict__ faces,
                                            int f) {
  FaceGeo g;
  const float* a = verts + 3 * (int64_t)faces[3 * (int64_t)f];
  const float* b = verts + 3 * (int64_t)faces[3 * (int64_t)f + 1];
  const float* c = verts + 3 * (int64_t)faces[3 * (int64_t)f + 2];
  for (int k = 0; k < 3; ++k) {
    g.p[k] = a[k];
    g.e1[k] = b[k] - g.p[k];
    g.e2[k] = c[k] - g.p[k];
  }
  const float nx = g.e1[1] * g.e2[2] - g.e1[2] * g.e2[1];
  const float ny = g.e1[2] * g.e2[0] - g.e1[0] * g.e2[2];
  const float nz = g.e1[0] * g.e2[1] - g.e1[1] * g.e2[0];
  const float sq = nx * nx + ny * ny + nz * nz;
  const float norm = max_keep_nan(__fsqrt_rn(sq), 1e-4f);
  g.n[0] = __fdiv_rn(nx, norm);
  g.n[1] = __fdiv_rn(ny, norm);
  g.n[2] = __fdiv_rn(nz, norm);
  return g;
}

__device__ __forceinline__ void store4(float* dst, const float* src, int n4) {
  float4* d = reinterpret_cast<float4*>(dst);
  for (int q = 0; q < n4; ++q)
    d[q] = make_float4(src[4 * q], src[4 * q + 1], src[4 * q + 2],
                       src[4 * q + 3]);
}

__global__ void __launch_bounds__(kThreads)
tet_tables_kernel(const float* __restrict__ verts,
                  const int* __restrict__ faces,
                  const int4* __restrict__ tets,
                  const int4* __restrict__ tet_faces,
                  const int2* __restrict__ face_tets,
                  const float* __restrict__ verts_color,
                  const float* __restrict__ faces_opacity,
                  const float* __restrict__ faces_intense,
                  float* __restrict__ geo, float* __restrict__ sign,
                  float* __restrict__ tet_geo, float* __restrict__ tet_nrm,
                  int* __restrict__ tet_ids, float* __restrict__ shade,
                  int F, int T, int B) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < F) {
    const int f = (int)i;
    const FaceGeo g = face_geo(verts, faces, f);
    float row[kGeo];
    for (int k = 0; k < 3; ++k) {
      row[k] = g.p[k];
      row[3 + k] = g.e1[k];
      row[6 + k] = g.e2[k];
      row[9 + k] = g.n[k];
    }
    store4(geo + (int64_t)f * kGeo, row, kGeo / 4);
    float sh[kSH];
    for (int c = 0; c < 3; ++c) {
      const float* col = verts_color + 3 * (int64_t)faces[3 * (int64_t)f + c];
      for (int k = 0; k < 3; ++k) sh[3 * c + k] = col[k];
    }
    const float alpha = faces_opacity[f];
    sh[9] = alpha;
    sh[10] = logf(max_keep_nan(1.0f - alpha, 1e-37f));
    for (int b = 0; b < B; ++b) {
      const int64_t r = (int64_t)b * F + f;
      sh[11] = faces_intense[r];
      store4(shade + r * kSH, sh, kSH / 4);
    }
    return;
  }
  if (i >= (int64_t)F + T) return;
  const int t = (int)(i - F);
  const int4 tv = tets[t];
  const int tvi[4] = {tv.x, tv.y, tv.z, tv.w};
  float cen[3];
  for (int k = 0; k < 3; ++k) {
    float s = verts[3 * (int64_t)tvi[0] + k] + verts[3 * (int64_t)tvi[1] + k];
    s = s + verts[3 * (int64_t)tvi[2] + k];
    s = s + verts[3 * (int64_t)tvi[3] + k];
    cen[k] = __fdiv_rn(s, 4.0f);
  }
  const int4 tf4 = tet_faces[t];
  const int tf[4] = {tf4.x, tf4.y, tf4.z, tf4.w};
  float gr[kTG], nr[kTN], sg[kSign];
  int nb[4];
  for (int j = 0; j < 4; ++j) {
    const int fj = max(tf[j], 0);
    const FaceGeo g = face_geo(verts, faces, fj);
    const float dot = g.n[0] * (cen[0] - g.p[0]) + g.n[1] * (cen[1] - g.p[1])
                      + g.n[2] * (cen[2] - g.p[2]);
    const float s = dot > 0.0f ? -1.0f : 1.0f;
    for (int k = 0; k < 3; ++k) {
      gr[9 * j + k] = g.p[k];
      gr[9 * j + 3 + k] = g.e1[k];
      gr[9 * j + 6 + k] = g.e2[k];
      nr[3 * j + k] = s * g.n[k];
    }
    gr[36 + j] = s;
    sg[j] = s;
    const int2 ft = face_tets[fj];
    nb[j] = (ft.x != t && ft.x != -1) ? ft.x
            : (ft.y != t && ft.y != -1) ? ft.y : -1;
  }
  store4(tet_geo + (int64_t)t * kTG, gr, kTG / 4);
  store4(tet_nrm + (int64_t)t * kTN, nr, kTN / 4);
  store4(sign + (int64_t)t * kSign, sg, 1);
  int4* ids = reinterpret_cast<int4*>(tet_ids + (int64_t)t * kTI);
  ids[0] = tf4;
  ids[1] = make_int4(nb[0], nb[1], nb[2], nb[3]);
}

__global__ void __launch_bounds__(kThreads)
tet_ray_start_kernel(const int* __restrict__ first_face,
                     const float* __restrict__ ray_d,
                     const float* __restrict__ t_in,
                     const float* __restrict__ u_in,
                     const float* __restrict__ v_in,
                     const float* __restrict__ cam_o,
                     const float* __restrict__ mv_t,
                     const float* __restrict__ proj_t,
                     const float4* __restrict__ geo,
                     const float4* __restrict__ sign,
                     const int2* __restrict__ face_tets,
                     const int4* __restrict__ tet_faces,
                     int* __restrict__ first_tet, float4* __restrict__ zw,
                     float* __restrict__ tuv, int M, int N) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= M) return;
  const float dx = ray_d[3 * (int64_t)i], dy = ray_d[3 * (int64_t)i + 1],
              dz = ray_d[3 * (int64_t)i + 2];
  tuv[i] = t_in[i];
  tuv[M + i] = u_in[i];
  tuv[2 * (int64_t)M + i] = v_in[i];
  // mv(j, k) = mv_t[b, j, k], pj likewise: projective_zw_plain's order
  const int b = i / N;
  const float* mv = mv_t + 16 * b;
  const float* pj = proj_t + 16 * b;
  const float ox = cam_o[3 * b], oy = cam_o[3 * b + 1],
              oz = cam_o[3 * b + 2];
  float pvo[3], dv[3];
  for (int k = 0; k < 3; ++k) {
    pvo[k] = ox * mv[k] + oy * mv[4 + k] + oz * mv[8 + k] + mv[12 + k];
    dv[k] = dx * mv[k] + dy * mv[4 + k] + dz * mv[8 + k];
  }
  zw[i] = make_float4(
      pvo[0] * pj[2] + pvo[1] * pj[6] + pvo[2] * pj[10] + pj[14],
      pvo[0] * pj[3] + pvo[1] * pj[7] + pvo[2] * pj[11] + pj[15],
      dv[0] * pj[2] + dv[1] * pj[6] + dv[2] * pj[10],
      dv[0] * pj[3] + dv[1] * pj[7] + dv[2] * pj[11]);
  const int ff = first_face[i];
  int start = -1;
  if (ff >= 0) {
    const float4 n = geo[3 * (int64_t)ff + 2];  // columns 8-11: n-hat in yzw
    const float ndot = n.y * dx + n.z * dy + n.w * dz;
    const int2 cand = face_tets[ff];
    const int c[2] = {cand.x, cand.y};
    for (int q = 0; q < 2; ++q) {
      if (c[q] < 0) continue;
      const int4 cf = tet_faces[c[q]];
      const float4 cs = sign[c[q]];
      // at most one slot holds the face: the masked sum is its sign
      float s = cf.x == ff ? cs.x : 0.0f;
      s = s + (cf.y == ff ? cs.y : 0.0f);
      s = s + (cf.z == ff ? cs.z : 0.0f);
      s = s + (cf.w == ff ? cs.w : 0.0f);
      if (s * ndot < 0.0f) start = c[q];
    }
  }
  first_tet[i] = start;
}

}  // namespace

// Build the march tables on `stream`, one thread per face and one per tet;
// allocates nothing and does not synchronise. Inputs: verts [P, 3], faces
// [F, 3] int32, tets [T, 4] int32, tet_faces [T, 4] int32, face_tets
// [F, 2] int32, verts_color [P, 3], faces_opacity [F], faces_intense [B, F]
// (tets and tet_faces 16-byte aligned, face_tets 8-byte aligned). Outputs:
// geo [F, 12], sign [T, 4], tet_geo [T, 40], tet_nrm [T, 12] f32, tet_ids
// [T, 8] int32, shade [B*F, 12] f32. Returns the launch's
// cudaGetLastError().
extern "C" int tet_tables(const void* verts, const void* faces,
                          const void* tets, const void* tet_faces,
                          const void* face_tets, const void* verts_color,
                          const void* faces_opacity,
                          const void* faces_intense, void* geo, void* sign,
                          void* tet_geo, void* tet_nrm, void* tet_ids,
                          void* shade, int F, int T, int B, void* stream) {
  const int64_t n = (int64_t)F + T;
  if (n <= 0 || B < 0) return (int)cudaSuccess;
  tet_tables_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const float*)verts, (const int*)faces, (const int4*)tets,
      (const int4*)tet_faces, (const int2*)face_tets,
      (const float*)verts_color, (const float*)faces_opacity,
      (const float*)faces_intense, (float*)geo, (float*)sign,
      (float*)tet_geo, (float*)tet_nrm, (int*)tet_ids, (float*)shade, F, T,
      B);
  return (int)cudaGetLastError();
}

// Write the march's per-ray inputs on `stream` over M = B * N rays, one
// thread per ray; allocates nothing and does not synchronise. Inputs:
// first_face [M] int32, ray_d [M, 3], t, u, v [M], cam_o [B, 3], mv_t and
// proj_t [B, 4, 4], geo [F, 12], sign [T, 4], face_tets [F, 2] int32,
// tet_faces [T, 4] int32. Outputs: first_tet [M] int32, zw [M, 4], tuv
// [3, M]. geo, sign, tet_faces and zw are 16-byte aligned, face_tets 8-byte.
// Returns the launch's cudaGetLastError().
extern "C" int tet_ray_start(const void* first_face, const void* ray_d,
                             const void* t, const void* u, const void* v,
                             const void* cam_o, const void* mv_t,
                             const void* proj_t, const void* geo,
                             const void* sign, const void* face_tets,
                             const void* tet_faces, void* first_tet, void* zw,
                             void* tuv, int M, int N, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  tet_ray_start_kernel<<<(M + kThreads - 1) / kThreads, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int*)first_face, (const float*)ray_d, (const float*)t,
      (const float*)u, (const float*)v, (const float*)cam_o,
      (const float*)mv_t, (const float*)proj_t, (const float4*)geo,
      (const float4*)sign, (const int2*)face_tets, (const int4*)tet_faces,
      (int*)first_tet, (float4*)zw, (float*)tuv, M, N);
  return (int)cudaGetLastError();
}
