// Device helpers shared by the LBVH kernels (bvh_kernels.cu) and the
// candidate-list kernels (cull_kernels.cu).
//
// Each is the per-ray counterpart of a helper of the Pallas kernels in
// raytracer_tpu/render/pallas_engine.py (_ray_recips, _slab_terms,
// _quat_rotate_tile, _box_face_hit, _intersect_instance, _occlude_instance)
// and of the plain versions in render/cuda_engine.py.  Every
// expression keeps their operation order: built with -fmad=false, each
// operation rounds once, like the separately rounded torch ops of the plain
// versions, so the two agree bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace rt {

// Table layouts: equal to render/cuda_engine.py (a CPU test parses these).
constexpr int IF_BMIN = 0;
constexpr int IF_BMAX = 3;
constexpr int IF_POS = 6;
constexpr int IF_QUAT = 9;
constexpr int IF_FNRM = 19;
constexpr int IF_WIDTH = 40;

constexpr int II_TMPL_START = 0;
constexpr int II_TRI_COUNT = 1;
constexpr int II_WTRI_START = 2;
constexpr int II_VALID = 3;
constexpr int II_IS_BOX = 4;
constexpr int II_MAT = 5;
constexpr int II_FACE_WTRI = 8;
constexpr int II_FACE_WTRI2 = 14;
constexpr int II_WIDTH = 24;

constexpr int TF_A = 0;
constexpr int TF_B = 3;
constexpr int TF_C = 6;
constexpr int TF_PNU = 9;
constexpr int TF_AREA = 12;
constexpr int TF_MAT = 13;
constexpr int TF_NA = 16;
constexpr int TF_NB = 19;
constexpr int TF_NC = 22;
constexpr int TF_WIDTH = 32;

constexpr int NODE_WIDTH = 8;  // min xyz, max xyz, valid, pad

constexpr float THRESHOLD = 1e-5f;
// exact_uv: a face triangle contains the hit when its signed barycentrics
// u, v >= -BARY_EPS and u + v <= BARY_HI (= 1 + BARY_EPS in f32)
constexpr float BARY_EPS = 1e-5f;
constexpr float BARY_HI = 1.00001f;
constexpr float F32_BIG = 3.0e38f;
constexpr float F32_NEG_BIG = -3.0e38f;

struct Tables {
  const float* __restrict__ nodes;    // [2n-1, NODE_WIDTH] (walk only)
  const int* __restrict__ ordering;   // [n], -1 for padding leaves
  int n_leaves;
  const float* __restrict__ inst_f;   // [N, IF_WIDTH]
  const int* __restrict__ inst_i;     // [N, II_WIDTH]
  const float* __restrict__ tmpl;     // [T, TF_WIDTH]
};

// torch.minimum / torch.maximum semantics: a NaN operand wins.  One
// instruction each (min.NaN / max.NaN, sm_80 on): the result is NaN when an
// operand is, where torch keeps that operand's NaN, and of -0 and +0 it
// takes -0 (max: +0), where a comparison takes either.  Neither shows in
// what the kernels compute from it: comparisons only (a NaN fails each,
// the zeros are equal), and a hit's t is at least THRESHOLD.
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

struct Ray {
  float o[3];
  float d[3];
  float inv[3];
  bool par[3];
};

// _ray_recips: only EXACT zeros count as parallel axes.
__device__ __forceinline__ Ray make_ray(const float o[3], const float d[3]) {
  Ray ray;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ray.o[k] = o[k];
    ray.d[k] = d[k];
    ray.par[k] = d[k] == 0.0f;
    ray.inv[k] = 1.0f / (ray.par[k] ? 1.0f : d[k]);
  }
  return ray;
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ ro,
                                        const float* __restrict__ rd, int r) {
  const float o[3] = {ro[3 * r], ro[3 * r + 1], ro[3 * r + 2]};
  const float d[3] = {rd[3 * r], rd[3 * r + 1], rd[3 * r + 2]};
  return make_ray(o, d);
}

struct Slab {
  float tn[3];
  float tf[3];
  bool inside;  // parallel-axis containment
};

// _slab_terms against box[0:6] = (min xyz, max xyz).
__device__ __forceinline__ Slab slab_terms(const float* __restrict__ box,
                                           const Ray& r) {
  Slab s;
  s.inside = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float t1 = (box[k] - r.o[k]) * r.inv[k];
    const float t2 = (box[k + 3] - r.o[k]) * r.inv[k];
    s.tn[k] = r.par[k] ? F32_NEG_BIG : nan_min(t1, t2);
    s.tf[k] = r.par[k] ? F32_BIG : nan_max(t1, t2);
    s.inside = s.inside &&
               (!r.par[k] || (r.o[k] >= box[k] && r.o[k] <= box[k + 3]));
  }
  return s;
}

__device__ __forceinline__ float slab_entry(const Slab& s) {
  return nan_max(nan_max(s.tn[0], s.tn[1]), s.tn[2]);
}
__device__ __forceinline__ float slab_exit(const Slab& s) {
  return nan_min(nan_min(s.tf[0], s.tf[1]), s.tf[2]);
}

// _quat_rotate_tile: rotate v by the (normalized-on-the-fly) quaternion q.
__device__ __forceinline__ void quat_rotate(const float q[4], const float v[3],
                                            float out[3]) {
  const float qx = q[0], qy = q[1], qz = q[2], qw = q[3];
  const float n2 = qx * qx + qy * qy + qz * qz + qw * qw;
  const float s = n2 > 1e-12f ? 1.0f / n2 : 0.0f;
  const float xx = 2.0f * qx * qx * s, yy = 2.0f * qy * qy * s,
              zz = 2.0f * qz * qz * s;
  const float wx = 2.0f * qw * qx * s, wy = 2.0f * qw * qy * s,
              wz = 2.0f * qw * qz * s;
  const float xy = 2.0f * qx * qy * s, xz = 2.0f * qx * qz * s,
              yz = 2.0f * qy * qz * s;
  out[0] = (1.0f - (yy + zz)) * v[0] + (xy - wz) * v[1] + (xz + wy) * v[2];
  out[1] = (xy + wz) * v[0] + (1.0f - (xx + zz)) * v[1] + (yz - wx) * v[2];
  out[2] = (xz - wy) * v[0] + (yz + wx) * v[1] + (1.0f - (xx + yy)) * v[2];
}

struct Best {
  float t;
  int tri;
  float u, v;
  float n[3];
  int mat;
};

// _init_best: a miss is t = +inf, tri 0, uv 0, normal (0, 0, 1), mat 0.
__device__ __forceinline__ Best miss() {
  Best b;
  b.t = __int_as_float(0x7f800000);
  b.tri = 0;
  b.u = 0.0f;
  b.v = 0.0f;
  b.n[0] = 0.0f;
  b.n[1] = 0.0f;
  b.n[2] = 1.0f;
  b.mat = 0;
  return b;
}

// _write_best: the interpolated normal is re-normalized once, at the end.
__device__ __forceinline__ void write_best(const Best& best, int r,
                                           float* __restrict__ t_out,
                                           int* __restrict__ tri_out,
                                           float* __restrict__ uv_out,
                                           float* __restrict__ n_out,
                                           int* __restrict__ mat_out) {
  const float nlen = sqrtf(best.n[0] * best.n[0] + best.n[1] * best.n[1] +
                           best.n[2] * best.n[2]);
  const float ninv = 1.0f / nan_max(nlen, THRESHOLD);
  t_out[r] = best.t;
  tri_out[r] = best.tri;
  uv_out[2 * r] = best.u;
  uv_out[2 * r + 1] = best.v;
#pragma unroll
  for (int k = 0; k < 3; ++k) n_out[3 * r + k] = best.n[k] * ninv;
  mat_out[r] = best.mat;
}

// _box_face_hit: the slab entry (or, from inside, exit) face of an
// identity-rotation box is its closest triangle hit.  Ties pick x, y, z;
// side_hi = (d >= 0) XOR is_entry; face = axis * 2 + side_hi.
__device__ __forceinline__ bool box_face_hit(const Slab& s, const Ray& r,
                                             const float* __restrict__ f,
                                             const int* __restrict__ ii,
                                             float& t_hit, int& wtri,
                                             int& face, float n[3]) {
  const float t_entry = slab_entry(s);
  const float t_exit = slab_exit(s);
  const bool hit_box = t_entry <= t_exit && s.inside;
  const bool is_entry = t_entry >= THRESHOLD;
  t_hit = is_entry ? t_entry : t_exit;
  const float tx = is_entry ? s.tn[0] : s.tf[0];
  const float ty = is_entry ? s.tn[1] : s.tf[1];
  const bool ax_x = tx == t_hit;
  const bool ax_y = !ax_x && ty == t_hit;
  const float dsel = ax_x ? r.d[0] : (ax_y ? r.d[1] : r.d[2]);
  const bool side_hi = (dsel >= 0.0f) != is_entry;
  face = (ax_x ? 0 : (ax_y ? 1 : 2)) * 2 + (side_hi ? 1 : 0);
  wtri = ii[II_FACE_WTRI + face];
#pragma unroll
  for (int k = 0; k < 3; ++k) n[k] = f[IF_FNRM + 3 * face + k];
  return hit_box && t_hit >= THRESHOLD;
}

__device__ __forceinline__ float edge_area(const float p0[3],
                                           const float p1[3]) {
  const float ex = p0[1] * p1[2] - p0[2] * p1[1];
  const float ey = p0[2] * p1[0] - p0[0] * p1[2];
  const float ez = p0[0] * p1[1] - p0[1] * p1[0];
  return sqrtf(ex * ex + ey * ey + ez * ez);
}

struct TriHit {
  bool ok;  // plane, barycentric and t >= THRESHOLD tests passed
  float tt, b0, b1, b2;
};

// Plane + barycentric-area test of one template triangle, ray in the
// instance frame (lo, ld) -- the body of the template loops.
__device__ __forceinline__ TriHit template_tri(const float* __restrict__ row,
                                               const float lo[3],
                                               const float ld[3]) {
  const float* a = row + TF_A;
  const float* b = row + TF_B;
  const float* c = row + TF_C;
  const float* n = row + TF_PNU;
  const float area = row[TF_AREA];
  TriHit th;
  const float denom = ld[0] * n[0] + ld[1] * n[1] + ld[2] * n[2];
  const bool plane_ok = fabsf(denom) >= THRESHOLD;
  th.tt = ((a[0] - lo[0]) * n[0] + (a[1] - lo[1]) * n[1] +
           (a[2] - lo[2]) * n[2]) / (plane_ok ? denom : 1.0f);
  float ch[3], bh[3], ah[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float h = lo[k] + th.tt * ld[k];
    ch[k] = c[k] - h;
    bh[k] = b[k] - h;
    ah[k] = a[k] - h;
  }
  const float inv_area = 1.0f / (area > 0.0f ? area : 1.0f);
  th.b0 = edge_area(ch, bh) * inv_area;
  th.b1 = edge_area(ch, ah) * inv_area;
  th.b2 = edge_area(ah, bh) * inv_area;
  const bool inside = fabsf(th.b0 + th.b1 + th.b2 - 1.0f) <= THRESHOLD;
  th.ok = plane_ok && inside && area > 0.0f && th.tt >= THRESHOLD;
  return th;
}

// Ray into the instance frame: o' = q (o - p), d' = q d.
__device__ __forceinline__ void to_local(const float* __restrict__ f,
                                         const Ray& r, float q[4],
                                         float lo[3], float ld[3]) {
  float op[3];
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = f[IF_QUAT + k];
#pragma unroll
  for (int k = 0; k < 3; ++k) op[k] = r.o[k] - f[IF_POS + k];
  quat_rotate(q, op, lo);
  quat_rotate(q, r.d, ld);
}

// Signed barycentrics (u: the b weight, v: the c weight) of the
// instance-local point h against template triangle row: ((h - a) x (c -
// a)).n / |n_raw| and ((b - a) x (h - a)).n / |n_raw|, n the unit plane
// normal -- the exact_uv branch's bary() of _intersect_instance, and the
// reconstruction the reparam rule differentiates (cast_vjp.py).
__device__ __forceinline__ void signed_bary(const float* __restrict__ row,
                                            const float h[3], float& u,
                                            float& v) {
  const float* a = row + TF_A;
  const float* b = row + TF_B;
  const float* c = row + TF_C;
  const float* n = row + TF_PNU;
  const float inv = 1.0f / nan_max(row[TF_AREA], 1e-20f);
  const float pax = h[0] - a[0], pay = h[1] - a[1], paz = h[2] - a[2];
  const float cax = c[0] - a[0], cay = c[1] - a[1], caz = c[2] - a[2];
  const float bax = b[0] - a[0], bay = b[1] - a[1], baz = b[2] - a[2];
  u = ((pay * caz - paz * cay) * n[0] + (paz * cax - pax * caz) * n[1] +
       (pax * cay - pay * cax) * n[2]) * inv;
  v = ((bay * paz - baz * pay) * n[0] + (baz * pax - bax * paz) * n[1] +
       (bax * pay - bay * pax) * n[2]) * inv;
}

// The exact_uv branch of the box fast path: the hit face's two triangles
// (II_FACE_WTRI, II_FACE_WTRI2) from their template rows, the local hit
// point o + t d - pos (identity rotation), the first triangle unless only
// the second contains the hit (eps BARY_EPS), and its true (u, v).
__device__ __forceinline__ void box_exact_uv(const float* __restrict__ f,
                                             const int* __restrict__ ii,
                                             const float* __restrict__ tmpl,
                                             const Ray& r, float t_hit,
                                             int face, Best& best) {
  float h[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) h[k] = r.o[k] + t_hit * r.d[k] - f[IF_POS + k];
  const int base = ii[II_TMPL_START] - ii[II_WTRI_START];
  const int w1 = ii[II_FACE_WTRI + face];
  const int w2 = ii[II_FACE_WTRI2 + face];
  float u1, v1, u2, v2;
  signed_bary(tmpl + (w1 + base) * TF_WIDTH, h, u1, v1);
  signed_bary(tmpl + (w2 + base) * TF_WIDTH, h, u2, v2);
  const bool in1 = u1 >= -BARY_EPS && v1 >= -BARY_EPS && u1 + v1 <= BARY_HI;
  const bool in2 = u2 >= -BARY_EPS && v2 >= -BARY_EPS && u2 + v2 <= BARY_HI;
  const bool use2 = !in1 && in2;
  best.u = use2 ? u2 : u1;
  best.v = use2 ? v2 : v1;
  best.tri = use2 ? w2 : w1;
}

// _intersect_instance: closest-hit update of instance i (its leaf box test
// already passed for this ray).  kExactUv: the box fast path resolves the
// true triangle of the hit face and its barycentrics (box_exact_uv) where
// the plain fast path writes the face's first triangle and uv (1/3, 1/3).
template <bool kExactUv>
__device__ __forceinline__ void intersect_instance(int i, const Slab& s,
                                                   const Ray& r,
                                                   const Tables& tb,
                                                   Best& best) {
  const float* f = tb.inst_f + i * IF_WIDTH;
  const int* ii = tb.inst_i + i * II_WIDTH;
  if (ii[II_IS_BOX] > 0) {
    float t_hit, n[3];
    int wtri, face;
    if (box_face_hit(s, r, f, ii, t_hit, wtri, face, n) && t_hit < best.t) {
      best.t = t_hit;
      best.tri = wtri;
      best.u = 1.0f / 3.0f;
      best.v = 1.0f / 3.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) best.n[k] = n[k];
      best.mat = ii[II_MAT];
      if (kExactUv) box_exact_uv(f, ii, tb.tmpl, r, t_hit, face, best);
    }
    return;
  }
  float q[4], lo[3], ld[3];
  to_local(f, r, q, lo, ld);
  const float qc[4] = {-q[0], -q[1], -q[2], q[3]};
  const int start = ii[II_TMPL_START];
  const int count = ii[II_TRI_COUNT];
  const int wstart = ii[II_WTRI_START];
  for (int j = 0; j < count; ++j) {
    const float* row = tb.tmpl + (start + j) * TF_WIDTH;
    const TriHit th = template_tri(row, lo, ld);
    if (th.ok && th.tt < best.t) {
      float sn[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        sn[k] = th.b0 * row[TF_NA + k] + th.b1 * row[TF_NB + k] +
                th.b2 * row[TF_NC + k];
      best.t = th.tt;
      best.tri = wstart + j;
      best.u = th.b1;
      best.v = th.b2;
      quat_rotate(qc, sn, best.n);
      best.mat = static_cast<int>(row[TF_MAT]);
    }
  }
}

// _occlude_instance: does instance i block the ray within [THRESHOLD, max_t]?
__device__ __forceinline__ bool occlude_instance(int i, const Slab& s,
                                                 const Ray& r, float max_t,
                                                 const Tables& tb) {
  const float* f = tb.inst_f + i * IF_WIDTH;
  const int* ii = tb.inst_i + i * II_WIDTH;
  if (ii[II_IS_BOX] > 0) {
    const float tmin = slab_entry(s);
    const float tmax = slab_exit(s);
    const float t_hit = tmin >= THRESHOLD ? tmin : tmax;
    return tmin <= tmax && s.inside && t_hit >= THRESHOLD && t_hit <= max_t;
  }
  float q[4], lo[3], ld[3];
  to_local(f, r, q, lo, ld);
  const int start = ii[II_TMPL_START];
  const int count = ii[II_TRI_COUNT];
  for (int j = 0; j < count; ++j) {
    const TriHit th = template_tri(tb.tmpl + (start + j) * TF_WIDTH, lo, ld);
    if (th.ok && th.tt <= max_t) return true;
  }
  return false;
}

// A node's vote apart from the prune: the slab interval is not empty, ends
// at or after THRESHOLD, a parallel axis holds the origin, the node is
// valid; the caller adds tmin < best t.
struct NodeGate {
  Slab s;
  float tmin;
  bool ok;
};

__device__ __forceinline__ NodeGate node_gate(const Tables& tb, int total,
                                              int v, const Ray& ray) {
  const float* node = tb.nodes + (total - v) * NODE_WIDTH;
  NodeGate g;
  g.s = slab_terms(node, ray);
  g.tmin = slab_entry(g.s);
  const float tmax = slab_exit(g.s);
  g.ok = g.tmin <= tmax && tmax >= THRESHOLD && g.s.inside && node[6] > 0.0f;
  return g;
}

// K1's closest-hit walk of the implicit-heap LBVH, both children of a node
// a step (its design: bvh_kernels.cu).  Shared by K1 and the transmissive
// march, so that each march step's t, normal and material are K1's own.
// kVisits: adds the node boxes the walk tests to `visits` (2 a step).
template <bool kExactUv, bool kVisits>
__device__ __forceinline__ Best closest_walk(const Ray& ray, const Tables& tb,
                                             int& visits) {
  Best best = miss();
  const int total = 2 * tb.n_leaves - 1;

  // a leaf's own gate under the current best, then its instance
  auto leaf = [&](int u, const NodeGate& g) {
    if (g.ok && g.tmin < best.t) {
      const int i = tb.ordering[total - u];
      if (i >= 0) intersect_instance<kExactUv>(i, g.s, ray, tb, best);
    }
  };

  int v = 0;  // the entered node (its vote passed); 0 ends the walk
  {
    const NodeGate g = node_gate(tb, total, 1, ray);
    if (tb.n_leaves == 1)
      leaf(1, g);
    else if (g.ok && g.tmin < best.t)
      v = 1;
  }
  int depth = 0;      // of v
  unsigned pend = 0;  // bit d: a right child at depth d still to enter
  while (v > 0) {
    // both children of v, adjacent rows, two independent slab tests
    const int c = 2 * v;
    const NodeGate g0 = node_gate(tb, total, c, ray);
    const NodeGate g1 = node_gate(tb, total, c + 1, ray);
    if (kVisits) visits += 2;
    if (c >= tb.n_leaves) {  // two leaves, in preorder
      leaf(c, g0);
      leaf(c + 1, g1);
    } else {
      const bool go0 = g0.ok && g0.tmin < best.t;
      const bool go1 = g1.ok && g1.tmin < best.t;
      if (go0 || go1) {
        // the right child's vote is kept (too kind at worst: bvh_kernels.cu)
        if (go0 && go1) pend |= 1u << (depth + 1);
        v = go0 ? c : c + 1;
        ++depth;
        continue;
      }
    }
    // on to the deepest right child still to enter, or the end
    if (pend == 0) break;
    const int d = 31 - __clz(pend);
    pend &= ~(1u << d);
    v = (v >> (depth - d)) | 1;
    depth = d;
  }
  return best;
}

}  // namespace rt
