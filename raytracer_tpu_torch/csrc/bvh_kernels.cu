// LBVH closest-hit cast (K1), fused two-light shadow query (K2) and
// single shadow query (K3).
//
// Replaces the Pallas TPU kernels _bvh_cast_kernel, _bvh_occlude2_kernel and
// _bvh_occlude_kernel (raytracer_tpu/render/pallas_engine.py:916, :1033 and
// :983).  Their plain PyTorch versions are bvh_cast_reference /
// bvh_occlude2_reference / bvh_occlude_reference in render/cuda_engine.py.
//
// What bounds them on an H100: not FLOPs.  Each ray walks the implicit-heap
// LBVH in its own order, so the warp diverges at every descend/skip choice,
// and each step reads a node row, an instance row and (off the box fast
// path) template rows from scattered addresses.  A 640x480 frame of the
// terrain8 world reads a few tens of KB of tables (380 instances x 160 B,
// 1023 nodes x 32 B, 24 template rows x 128 B), which stay in L1/L2.
//
// What this design does about it, first version: one thread per ray, a
// stackless per-thread preorder walk (no stack memory, no shared state), the
// tables read through const __restrict__ pointers so loads go through the
// read-only cache, and rays ordered in 32x32 screen blocks by the caller so
// neighbouring threads mostly take the same path.  Warp-wide votes
// (__any_sync, the reference renderer's ballot) and tables in shared memory
// are left for later work.
//
// Per-thread walks give the tile walk's hits: votes are conservative (a
// ray reaches every leaf whose box it hits, since ancestor boxes contain
// their children exactly) and leaf updates use strict < in the same
// preorder.  Only visit counts differ, and they are not reported.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (render/kernels.py).  No fast math:
// IEEE division and square root, one rounding per operation.

#include <cuda_runtime.h>

#include "bvh_walk.cuh"

namespace rt {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
bvh_cast_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                int n_rays, Tables tb, float* __restrict__ t_out,
                int* __restrict__ tri_out, float* __restrict__ uv_out,
                float* __restrict__ n_out, int* __restrict__ mat_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const Ray ray = load_ray(ro, rd, r);
  Best best = miss();

  const int total = 2 * tb.n_leaves - 1;
  int v = 1;  // virtual heap index; flat row = total - v
  while (v > 0) {
    const int flat = total - v;
    const float* node = tb.nodes + flat * NODE_WIDTH;
    const Slab s = slab_terms(node, ray);
    const float tmin = slab_entry(s);
    const float tmax = slab_exit(s);
    const bool vote = tmin <= tmax && tmax >= THRESHOLD && tmin < best.t &&
                      s.inside && node[6] > 0.0f;
    const bool is_leaf = v >= tb.n_leaves;
    if (vote && is_leaf) {
      const int i = tb.ordering[flat];
      if (i >= 0) intersect_instance(i, s, ray, tb, best);
    }
    v = (vote && !is_leaf) ? 2 * v : skip_next(v);
  }
  write_best(best, r, t_out, tri_out, uv_out, n_out, mat_out);
}

__global__ void __launch_bounds__(kThreads)
bvh_occlude2_kernel(const float* __restrict__ o1, const float* __restrict__ d1,
                    const float* __restrict__ mt1,
                    const float* __restrict__ o2, const float* __restrict__ d2,
                    const float* __restrict__ mt2, int n_rays, Tables tb,
                    bool* __restrict__ blk1_out, bool* __restrict__ blk2_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const Ray r1 = load_ray(o1, d1, r);
  const Ray r2 = load_ray(o2, d2, r);
  const float max_t1 = mt1[r];
  const float max_t2 = mt2[r];
  bool blk1 = false, blk2 = false;

  const int total = 2 * tb.n_leaves - 1;
  int v = 1;
  // the walk ends early once both queries are blocked
  while (v > 0 && !(blk1 && blk2)) {
    const int flat = total - v;
    const float* node = tb.nodes + flat * NODE_WIDTH;
    const bool node_ok = node[6] > 0.0f;
    const Slab s1 = slab_terms(node, r1);
    const float tmin1 = slab_entry(s1);
    const float tmax1 = slab_exit(s1);
    const bool hit1 = tmin1 <= tmax1 && tmax1 >= THRESHOLD && !blk1 &&
                      tmin1 <= max_t1 && s1.inside && node_ok;
    const Slab s2 = slab_terms(node, r2);
    const float tmin2 = slab_entry(s2);
    const float tmax2 = slab_exit(s2);
    const bool hit2 = tmin2 <= tmax2 && tmax2 >= THRESHOLD && !blk2 &&
                      tmin2 <= max_t2 && s2.inside && node_ok;
    const bool is_leaf = v >= tb.n_leaves;
    if (is_leaf && (hit1 || hit2)) {
      const int i = tb.ordering[flat];
      if (i >= 0) {
        if (hit1) blk1 = occlude_instance(i, s1, r1, max_t1, tb);
        if (hit2) blk2 = occlude_instance(i, s2, r2, max_t2, tb);
      }
    }
    v = ((hit1 || hit2) && !is_leaf) ? 2 * v : skip_next(v);
  }
  blk1_out[r] = blk1;
  blk2_out[r] = blk2;
}

// K3: one any-hit query per thread.  A subtree is pruned when its slab
// entry lies beyond max_t or the slab test misses; the walk ends as soon as
// the ray is blocked (the loop condition, so no visit tests !blk).
__global__ void __launch_bounds__(kThreads)
bvh_occlude_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                   const float* __restrict__ mt, int n_rays, Tables tb,
                   bool* __restrict__ blk_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const Ray ray = load_ray(ro, rd, r);
  const float max_t = mt[r];
  bool blk = false;

  const int total = 2 * tb.n_leaves - 1;
  int v = 1;
  while (v > 0 && !blk) {
    const int flat = total - v;
    const float* node = tb.nodes + flat * NODE_WIDTH;
    const Slab s = slab_terms(node, ray);
    const float tmin = slab_entry(s);
    const float tmax = slab_exit(s);
    const bool hit = tmin <= tmax && tmax >= THRESHOLD && tmin <= max_t &&
                     s.inside && node[6] > 0.0f;
    const bool is_leaf = v >= tb.n_leaves;
    if (hit && is_leaf) {
      const int i = tb.ordering[flat];
      if (i >= 0) blk = occlude_instance(i, s, ray, max_t, tb);
    }
    v = (hit && !is_leaf) ? 2 * v : skip_next(v);
  }
  blk_out[r] = blk;
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace rt

// Plain C entry points for ctypes.  Each launches on the given stream,
// allocates nothing, and returns cudaGetLastError() (0 on success).

extern "C" int rt_bvh_cast(const void* ro, const void* rd, int n_rays,
                           const void* nodes, const void* ordering,
                           int n_leaves, const void* inst_f,
                           const void* inst_i, const void* tmpl, void* t,
                           void* tri, void* uv, void* normal, void* mat,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const rt::Tables tb{static_cast<const float*>(nodes),
                      static_cast<const int*>(ordering), n_leaves,
                      static_cast<const float*>(inst_f),
                      static_cast<const int*>(inst_i),
                      static_cast<const float*>(tmpl)};
  rt::bvh_cast_kernel<<<rt::blocks_for(n_rays), rt::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ro), static_cast<const float*>(rd), n_rays,
      tb, static_cast<float*>(t), static_cast<int*>(tri),
      static_cast<float*>(uv), static_cast<float*>(normal),
      static_cast<int*>(mat));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_bvh_occlude2(const void* o1, const void* d1,
                               const void* mt1, const void* o2,
                               const void* d2, const void* mt2, int n_rays,
                               const void* nodes, const void* ordering,
                               int n_leaves, const void* inst_f,
                               const void* inst_i, const void* tmpl,
                               void* blk1, void* blk2, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const rt::Tables tb{static_cast<const float*>(nodes),
                      static_cast<const int*>(ordering), n_leaves,
                      static_cast<const float*>(inst_f),
                      static_cast<const int*>(inst_i),
                      static_cast<const float*>(tmpl)};
  rt::bvh_occlude2_kernel<<<rt::blocks_for(n_rays), rt::kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o1), static_cast<const float*>(d1),
      static_cast<const float*>(mt1), static_cast<const float*>(o2),
      static_cast<const float*>(d2), static_cast<const float*>(mt2), n_rays,
      tb, static_cast<bool*>(blk1), static_cast<bool*>(blk2));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_bvh_occlude(const void* ro, const void* rd, const void* mt,
                              int n_rays, const void* nodes,
                              const void* ordering, int n_leaves,
                              const void* inst_f, const void* inst_i,
                              const void* tmpl, void* blk, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const rt::Tables tb{static_cast<const float*>(nodes),
                      static_cast<const int*>(ordering), n_leaves,
                      static_cast<const float*>(inst_f),
                      static_cast<const int*>(inst_i),
                      static_cast<const float*>(tmpl)};
  rt::bvh_occlude_kernel<<<rt::blocks_for(n_rays), rt::kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ro), static_cast<const float*>(rd),
      static_cast<const float*>(mt), n_rays, tb, static_cast<bool*>(blk));
  return static_cast<int>(cudaGetLastError());
}
