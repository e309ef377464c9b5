// Candidate-list closest hit (K4) and any-hit query (K5).
//
// Replace the Pallas TPU kernels _cast_kernel and _occlude_kernel
// (raytracer_tpu/render/pallas_engine.py:869 and :1102).  Their plain
// PyTorch versions are cull_cast_reference / cull_occlude_reference in
// render/cull.py, which also builds the per-tile lists they read
// (tile_candidates: cand [T, C] instance ids near to far, info [T, 2] = trip
// count, overflow flag; on overflow the loop runs over every instance).
//
// What bounds them on an H100: not FLOPs and not bytes.  A frame reads
// its rays once (24-28 B each) and tables of a few tens of KB (terrain6:
// 204 instances x 160 B + 96 B), which stay in L1/L2; each ray then does a
// slab test per list entry (~30 FP32 operations) and, where it passes, the
// box-face or template test.  The loop is as long as the tile's list (up to
// 64 entries, or every instance on overflow), every thread of a warp reads
// the same instance row at the same step, and the prune (tmin < best) and
// K5's early exit make threads leave or skip at different steps.
//
// What this design does about it, first version: one thread per ray, the
// tile's list walked in its order by every thread of the tile (the rows a
// warp reads at one step are the same address, one broadcast load), the
// tables read through const __restrict__ pointers (read-only cache), and
// the shared device helpers of bvh_walk.cuh, so K4/K5 compute exactly what
// K1/K3 compute for a leaf.  The TPU's tile-wide vote (any lane hits) is a
// per-ray test here: votes are conservative, so the hits are the same.
// Lists in shared memory and a warp-wide early exit are left for later work.
//
// Build: as bvh_kernels.cu (render/kernels.py), -fmad=false, no fast math.

#include <cuda_runtime.h>

#include "bvh_walk.cuh"

namespace rt {

constexpr int kCullThreads = 128;

struct Lists {
  const int* __restrict__ cand;  // [T, n_cols] instance ids
  const int* __restrict__ info;  // [T, 2]: trip count, overflow flag
  int n_cols;
  int tile;  // rays per tile
};

// The instance a ray of tile t visits at step k: slot k of the tile's list,
// or k itself on overflow.
__device__ __forceinline__ int list_instance(const Lists& ls, int t, int k,
                                             bool overflow) {
  return overflow ? k : ls.cand[t * ls.n_cols + min(k, ls.n_cols - 1)];
}

__global__ void __launch_bounds__(kCullThreads)
cull_cast_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                 int n_rays, Lists ls, Tables tb, float* __restrict__ t_out,
                 int* __restrict__ tri_out, float* __restrict__ uv_out,
                 float* __restrict__ n_out, int* __restrict__ mat_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const Ray ray = load_ray(ro, rd, r);
  Best best = miss();
  const int t = r / ls.tile;
  const int loop_n = ls.info[2 * t];
  const bool overflow = ls.info[2 * t + 1] > 0;
  for (int k = 0; k < loop_n; ++k) {
    const int i = list_instance(ls, t, k, overflow);
    const bool valid = tb.inst_i[i * II_WIDTH + II_VALID] > 0;
    const Slab s = slab_terms(tb.inst_f + i * IF_WIDTH + IF_BMIN, ray);
    const float tmin = slab_entry(s);
    const float tmax = slab_exit(s);
    // the prune: boxes no nearer than the current best cannot win
    if (tmin <= tmax && tmax >= THRESHOLD && tmin < best.t && s.inside &&
        valid)
      intersect_instance(i, s, ray, tb, best);
  }
  write_best(best, r, t_out, tri_out, uv_out, n_out, mat_out);
}

__global__ void __launch_bounds__(kCullThreads)
cull_occlude_kernel(const float* __restrict__ ro,
                    const float* __restrict__ rd,
                    const float* __restrict__ mt, int n_rays, Lists ls,
                    Tables tb, bool* __restrict__ blk_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const Ray ray = load_ray(ro, rd, r);
  const float max_t = mt[r];
  bool blk = false;
  const int t = r / ls.tile;
  const int loop_n = ls.info[2 * t];
  const bool overflow = ls.info[2 * t + 1] > 0;
  // the per-ray form of the tile's any(blk == 0) exit
  for (int k = 0; k < loop_n && !blk; ++k) {
    const int i = list_instance(ls, t, k, overflow);
    const bool valid = tb.inst_i[i * II_WIDTH + II_VALID] > 0;
    const Slab s = slab_terms(tb.inst_f + i * IF_WIDTH + IF_BMIN, ray);
    const float tmin = slab_entry(s);
    const float tmax = slab_exit(s);
    if (tmin <= tmax && tmax >= THRESHOLD && tmin <= max_t && s.inside &&
        valid)
      blk = occlude_instance(i, s, ray, max_t, tb);
  }
  blk_out[r] = blk;
}

inline int cull_blocks(int n) {
  return (n + kCullThreads - 1) / kCullThreads;
}

inline Tables table_only(const void* inst_f, const void* inst_i,
                         const void* tmpl) {
  return Tables{nullptr, nullptr, 0, static_cast<const float*>(inst_f),
                static_cast<const int*>(inst_i),
                static_cast<const float*>(tmpl)};
}

}  // namespace rt

// Plain C entry points for ctypes: launch on the given stream, allocate
// nothing, return cudaGetLastError().  n_rays is a whole number of tiles.

extern "C" int rt_cull_cast(const void* ro, const void* rd, int n_rays,
                            const void* cand, const void* info, int n_cols,
                            int tile, const void* inst_f, const void* inst_i,
                            const void* tmpl, void* t, void* tri, void* uv,
                            void* normal, void* mat, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const rt::Lists ls{static_cast<const int*>(cand),
                     static_cast<const int*>(info), n_cols, tile};
  rt::cull_cast_kernel<<<rt::cull_blocks(n_rays), rt::kCullThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ro), static_cast<const float*>(rd), n_rays,
      ls, rt::table_only(inst_f, inst_i, tmpl), static_cast<float*>(t),
      static_cast<int*>(tri), static_cast<float*>(uv),
      static_cast<float*>(normal), static_cast<int*>(mat));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_cull_occlude(const void* ro, const void* rd, const void* mt,
                               int n_rays, const void* cand, const void* info,
                               int n_cols, int tile, const void* inst_f,
                               const void* inst_i, const void* tmpl,
                               void* blk, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const rt::Lists ls{static_cast<const int*>(cand),
                     static_cast<const int*>(info), n_cols, tile};
  rt::cull_occlude_kernel<<<rt::cull_blocks(n_rays), rt::kCullThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ro), static_cast<const float*>(rd),
      static_cast<const float*>(mt), n_rays, ls,
      rt::table_only(inst_f, inst_i, tmpl), static_cast<bool*>(blk));
  return static_cast<int>(cudaGetLastError());
}
