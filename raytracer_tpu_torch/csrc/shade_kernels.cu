// One wavefront round's shading as two kernels around its shadow queries:
// shade_rays_kernel before them (hit points, light directions, the query
// origins, the attenuation inside a medium) and shade_phong_kernel after
// them (Phong of every light, weighted into the round's contribution), one
// lane a thread.
//
// They replace no Pallas kernel: they fuse the JAX package's shading glue
// (raytracer_tpu/render/shading.py:200 illuminate, :185 phong_term, and
// _radiance_dense's process_round around them).  Their plain version is the
// torch path of render/engine.py process_round (shading.illuminate), a few
// hundred whole-queue torch ops a round; render/fused_shading.py says where
// each runs.  The shadow queries between them keep their own kernels (K2,
// K3 or the fused march).
//
// What bounds them on an H100: bytes.  shade_rays reads a lane's ray, hit
// and flags (~50 B) and writes its hit point, flag, light directions and
// query origins (~80 B with a point and a directional light); shade_phong
// reads the ray direction, normal, material id, flag, hit point, shadow
// masks or the marches' light, and the attenuation (~75-110 B) and writes
// one float4.  At the 2,088,960 lanes of a 1080p round that is ~0.15 ms a
// round at 3.35 TB/s, where the torch path ran a few hundred passes, each
// reading and writing whole [R], [R, 3] or [R, 4] arrays.  The arithmetic
// (~200 FP32 operations and one powf a lane and light) is far below the
// card's rate.
//
// What the design does about it: every intermediate stays in registers;
// [R, 4] rows move as one float4, [R, 3] rows as three coalesced scalars;
// shade_phong recomputes a point light's direction and distance from the
// hit point (12 B) instead of reading them back (16 B a light); the
// material rows (ke, ka, kd, ks, alpha: 80 B a material) sit in shared
// memory; a lane whose hit is not shaded writes 0 and reads nothing more.
//
// Each operation rounds as the torch ops of the plain version do: their
// order, -fmad=false, sqrtf and / exact (no fast math).  powf may differ
// from torch's pow in the last place, as the fused march's does.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (render/kernels.py).

#include <cuda_runtime.h>

#include "bvh_walk.cuh"

namespace rt {
namespace {

constexpr int kShadeThreads = 128;
constexpr int kMaxLights = 8;        // point + directional lights
constexpr int kMatFloat4 = 5;        // ke, ka, kd, ks, (alpha, 0, 0, 0)
constexpr int kMaxSmem = 48 * 1024;  // without an opt-in attribute
constexpr float kPark = 1e30f;       // a parked query origin

// The scene's shading constants (render/fused_shading.py _ShadeScene
// mirrors this layout): the materials' fields, [K, 4] or [K]; the lights,
// [L, 3] / [L, 4] and [M, 3] / [M, 4]; ambience [4]; dist_atten [3].
struct ShadeScene {
  const float* ke;
  const float* ka;
  const float* kd;
  const float* ks;
  const float* kt;
  const float* alpha;
  const float* point_pos;
  const float* point_col;
  const float* dir_dir;
  const float* dir_col;
  const float* ambience;
  const float* dist_atten;
  int n_mats;
  int n_point;
  int n_dir;
};

struct RaysIO {
  const float* o;        // [R, 3]
  const float* d;        // [R, 3]
  const float* atten;    // [R, 4] (read where atten_eff is set)
  const bool* in_obj;    // [R]
  const bool* active;    // [R]
  const bool* valid;     // [R]
  const float* t;        // [R], +inf on a miss
  const int* mat;        // [R]
  int n_rays;
  float* hit_pos;        // [R, 3]
  bool* h_valid;         // [R]
  float* atten_eff;      // [R, 4], or null: no medium attenuates
  float* ldir;           // [Q, R, 3]: point lights, then directional ones
  float* ldist;          // [L, R]
  float* qorig;          // [Q, R, 3], or null: no any-hit query
  float* dunit;          // [M, 3]
};

struct Shadow {
  const void* p[kMaxLights];  // bool [R] blocked, or float [R, 4] light
};

struct PhongIO {
  const float* d;          // [R, 3]
  const float* normal;     // [R, 3]
  const int* mat;          // [R]
  const bool* h_valid;     // [R]
  const float* hit_pos;    // [R, 3]
  const float* atten_eff;  // [R, 4]
  int march;               // Shadow holds the marches' light
  int n_rays;
  float* contrib;          // [R, 4]
};

// raymath.dot, left to right
__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// raymath.norm: 0 where the squared length is not above 0
__device__ __forceinline__ float norm3(const float v[3]) {
  const float s = dot3(v, v);
  return s > 0.0f ? sqrtf(s) : 0.0f;
}

// raymath.normalize: the zero vector at a length of THRESHOLD or less
__device__ __forceinline__ void normalize3(const float v[3], float out[3]) {
  const float ln = norm3(v);
  const bool ok = ln > THRESHOLD;
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = ok ? v[k] / ln : 0.0f;
}

// raymath.safe_pow: powf's values at 0 (pow(0, 0) = 1, pow(0, e > 0) = 0)
__device__ __forceinline__ float safe_pow(float base, float e) {
  const float val = powf(base > 0.0f ? base : 1.0f, e);
  return base > 0.0f ? val : (e == 0.0f ? 1.0f : 0.0f);
}

// A point light's unit direction and distance from the hit point p
// (shading.shadow_rays and illuminate's point-light loop).
__device__ __forceinline__ float to_point(const float* __restrict__ pos,
                                          const float p[3], float u[3]) {
  const float disp[3] = {pos[0] - p[0], pos[1] - p[1], pos[2] - p[2]};
  normalize3(disp, u);
  return norm3(disp);
}

__device__ __forceinline__ float4 load4(const float* __restrict__ x) {
  return make_float4(x[0], x[1], x[2], x[3]);
}

__global__ void __launch_bounds__(kShadeThreads)
shade_rays_kernel(ShadeScene sc, RaysIO a) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t R = a.n_rays;
  if (r == 0) {  // the directional lights' unit directions, for the march
    for (int j = 0; j < sc.n_dir; ++j) {
      const float* dd = sc.dir_dir + 3 * j;
      const float l[3] = {-dd[0], -dd[1], -dd[2]};
      normalize3(l, a.dunit + 3 * j);
    }
  }
  if (r >= a.n_rays) return;
  const bool valid = a.valid[r];
  const float t = valid ? a.t[r] : 1.0f;  // miss times sanitized
  const bool hv = a.active[r] && valid;
  float p[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p[k] = a.o[3 * r + k] + t * a.d[3 * r + k];
    a.hit_pos[3 * r + k] = p[k];
  }
  a.h_valid[r] = hv;
  if (a.atten_eff) {
    // inside a medium a hit attenuates by Kt^t (engine.trans_attenuation)
    float4 at = reinterpret_cast<const float4*>(a.atten)[r];
    if (a.in_obj[r] && hv) {
      const float base = nan_max(t, 0.0f);
      const float* kt = sc.kt + 4 * a.mat[r];
      at.x = at.x * safe_pow(base, kt[0]);
      at.y = at.y * safe_pow(base, kt[1]);
      at.z = at.z * safe_pow(base, kt[2]);
      at.w = at.w * safe_pow(base, kt[3]);
    }
    reinterpret_cast<float4*>(a.atten_eff)[r] = at;
  }
  // query origins: parked far outside the scene on a lane not shaded, then
  // THRESHOLD along the query
  float park[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) park[k] = hv ? p[k] : kPark;
  for (int i = 0; i < sc.n_point; ++i) {
    float u[3];
    const float dist = to_point(sc.point_pos + 3 * i, p, u);
    a.ldist[i * R + r] = dist;
    float* ld = a.ldir + 3 * (i * R + r);
#pragma unroll
    for (int k = 0; k < 3; ++k) ld[k] = u[k];
    if (a.qorig) {
      float* q = a.qorig + 3 * (i * R + r);
#pragma unroll
      for (int k = 0; k < 3; ++k) q[k] = park[k] + THRESHOLD * u[k];
    }
  }
  if (!a.qorig) return;  // the march takes its direction as [3]
  for (int j = 0; j < sc.n_dir; ++j) {
    const float* dd = sc.dir_dir + 3 * j;
    const float l[3] = {-dd[0], -dd[1], -dd[2]};
    float u[3];
    normalize3(l, u);
    const size_t row = (sc.n_point + j) * R + r;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a.ldir[3 * row + k] = u[k];
      a.qorig[3 * row + k] = park[k] + THRESHOLD * u[k];
    }
  }
}

// shading.phong_term of one light, added into col:
// (max(L.N, 0) Kd + max(-reflect(-L, N).V, 0)^alpha Ks) * incoming
__device__ __forceinline__ void add_phong(const float4 kd, const float4 ks,
                                          float alpha, const float inc[4],
                                          const float v[3], const float l[3],
                                          const float n[3], float col[4]) {
  const float nd = nan_max(dot3(l, n), 0.0f);
  // raymath.reflect(-L, N): both normalized, reflected, re-normalized and
  // scaled by |L|
  const float ml[3] = {-l[0], -l[1], -l[2]};
  const float d_len = norm3(ml);
  float dn[3], nn[3];
  normalize3(ml, dn);
  normalize3(n, nn);
  const float c2 = 2.0f * dot3(dn, nn);
  float rr[3], rn[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) rr[k] = dn[k] - c2 * nn[k];
  normalize3(rr, rn);
  const float mr[3] = {-(d_len * rn[0]), -(d_len * rn[1]), -(d_len * rn[2])};
  const float sp = safe_pow(nan_max(dot3(mr, v), 0.0f), alpha);
  const float kd4[4] = {kd.x, kd.y, kd.z, kd.w};
  const float ks4[4] = {ks.x, ks.y, ks.z, ks.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    col[k] = col[k] + (nd * kd4[k] + sp * ks4[k]) * inc[k];
}

// the light arriving from light q: the march's, or the colour unless the
// any-hit query found a blocker
__device__ __forceinline__ void arriving(const Shadow& sh, int q, int march,
                                         int r, const float* __restrict__ col,
                                         float lit[4]) {
  if (march) {
    const float4 rv = reinterpret_cast<const float4*>(sh.p[q])[r];
    lit[0] = rv.x;
    lit[1] = rv.y;
    lit[2] = rv.z;
    lit[3] = rv.w;
    return;
  }
  const bool blocked = static_cast<const bool*>(sh.p[q])[r];
#pragma unroll
  for (int k = 0; k < 4; ++k) lit[k] = blocked ? 0.0f : col[k];
}

__global__ void __launch_bounds__(kShadeThreads)
shade_phong_kernel(ShadeScene sc, PhongIO a, Shadow sh) {
  extern __shared__ float4 smat[];  // [K, kMatFloat4]
  for (int i = threadIdx.x; i < sc.n_mats; i += blockDim.x) {
    float4* row = smat + kMatFloat4 * i;
    row[0] = load4(sc.ke + 4 * i);
    row[1] = load4(sc.ka + 4 * i);
    row[2] = load4(sc.kd + 4 * i);
    row[3] = load4(sc.ks + 4 * i);
    row[4] = make_float4(sc.alpha[i], 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.n_rays) return;
  float4* out = reinterpret_cast<float4*>(a.contrib) + r;
  if (!a.h_valid[r]) {
    *out = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
  const float4* m = smat + kMatFloat4 * a.mat[r];
  const float4 ke = m[0], ka = m[1], kd = m[2], ks = m[3];
  const float alpha = m[4].x;
  float col[4] = {ke.x + ka.x * sc.ambience[0], ke.y + ka.y * sc.ambience[1],
                  ke.z + ka.z * sc.ambience[2], ke.w + ka.w * sc.ambience[3]};
  float v[3], n[3], p[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    v[k] = a.d[3 * r + k];
    n[k] = a.normal[3 * r + k];
    p[k] = a.hit_pos[3 * r + k];
  }
  const float c0 = sc.dist_atten[0], c1 = sc.dist_atten[1],
              c2 = sc.dist_atten[2];
  for (int i = 0; i < sc.n_point; ++i) {
    float u[3];
    const float dist = to_point(sc.point_pos + 3 * i, p, u);
    // shading.distance_attenuation: 1 / max(1, c + l d + q d^2)
    const float quad = c0 + c1 * dist + c2 * dist * dist;
    const float datt = quad < 1.0f ? 1.0f : 1.0f / nan_max(quad, 1.0f);
    float lit[4], inc[4];
    arriving(sh, i, a.march, r, sc.point_col + 4 * i, lit);
#pragma unroll
    for (int k = 0; k < 4; ++k) inc[k] = datt * lit[k];
    add_phong(kd, ks, alpha, inc, v, u, n, col);
  }
  for (int j = 0; j < sc.n_dir; ++j) {
    const float* dd = sc.dir_dir + 3 * j;
    const float l[3] = {-dd[0], -dd[1], -dd[2]};  // raw: Phong takes it so
    float lit[4];
    arriving(sh, sc.n_point + j, a.march, r, sc.dir_col + 4 * j, lit);
    add_phong(kd, ks, alpha, lit, v, l, n, col);
  }
  const float4 at = reinterpret_cast<const float4*>(a.atten_eff)[r];
  *out = make_float4(at.x * col[0], at.y * col[1], at.z * col[2],
                     at.w * col[3]);
}

inline int shade_blocks(int n) {
  return (n + kShadeThreads - 1) / kShadeThreads;
}

}  // namespace
}  // namespace rt

// Plain C entry points for ctypes.  Each launches on the given stream,
// allocates nothing, and returns cudaGetLastError() (0 on success).

// queries: 1 writes every light's per-lane direction and query origin
// (ldir and qorig [L + M, R, 3]), 0 the point lights' directions alone
// (ldir [L, R, 3], qorig null).  atten_eff null: no medium attenuates
// (atten and in_obj are not read).
extern "C" int rt_shade_rays(const void* scene, const void* o, const void* d,
                             const void* atten, const void* in_obj,
                             const void* active, const void* valid,
                             const void* t, const void* mat, int queries,
                             int n_rays, void* hit_pos, void* h_valid,
                             void* atten_eff, void* ldir, void* ldist,
                             void* qorig, void* dunit, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const rt::ShadeScene& sc = *static_cast<const rt::ShadeScene*>(scene);
  if (n_rays < 1 || sc.n_point < 0 || sc.n_dir < 0 ||
      sc.n_point + sc.n_dir > rt::kMaxLights ||
      (queries != 0) != (qorig != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const rt::RaysIO a{static_cast<const float*>(o),
                     static_cast<const float*>(d),
                     static_cast<const float*>(atten),
                     static_cast<const bool*>(in_obj),
                     static_cast<const bool*>(active),
                     static_cast<const bool*>(valid),
                     static_cast<const float*>(t),
                     static_cast<const int*>(mat),
                     n_rays,
                     static_cast<float*>(hit_pos),
                     static_cast<bool*>(h_valid),
                     static_cast<float*>(atten_eff),
                     static_cast<float*>(ldir),
                     static_cast<float*>(ldist),
                     static_cast<float*>(qorig),
                     static_cast<float*>(dunit)};
  rt::shade_rays_kernel<<<rt::shade_blocks(n_rays), rt::kShadeThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(sc, a);
  return static_cast<int>(cudaGetLastError());
}

// shadow: a host array of the L + M lights' pointers, point lights first:
// bool [R] masks (a blocker found), or with march float [R, 4] light.
extern "C" int rt_shade_phong(const void* scene, const void* d,
                              const void* normal, const void* mat,
                              const void* h_valid, const void* hit_pos,
                              const void* atten_eff, const void* shadow,
                              int march, int n_rays, void* contrib,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const rt::ShadeScene& sc = *static_cast<const rt::ShadeScene*>(scene);
  const int n_lights = sc.n_point + sc.n_dir;
  const size_t smem = sizeof(float4) * rt::kMatFloat4 *
                      static_cast<size_t>(sc.n_mats < 0 ? 0 : sc.n_mats);
  if (n_rays < 1 || sc.n_mats < 1 || smem > size_t{rt::kMaxSmem} ||
      sc.n_point < 0 ||
      sc.n_dir < 0 || n_lights > rt::kMaxLights)
    return static_cast<int>(cudaErrorInvalidValue);
  rt::Shadow sh{};
  const void* const* ptrs = static_cast<const void* const*>(shadow);
  for (int q = 0; q < n_lights; ++q) sh.p[q] = ptrs[q];
  const rt::PhongIO a{static_cast<const float*>(d),
                      static_cast<const float*>(normal),
                      static_cast<const int*>(mat),
                      static_cast<const bool*>(h_valid),
                      static_cast<const float*>(hit_pos),
                      static_cast<const float*>(atten_eff),
                      march,
                      n_rays,
                      static_cast<float*>(contrib)};
  rt::shade_phong_kernel<<<rt::shade_blocks(n_rays), rt::kShadeThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(sc, a, sh);
  return static_cast<int>(cudaGetLastError());
}
