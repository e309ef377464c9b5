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
// What K4's design does about it, first version: one thread per ray, the
// tile's list walked in its order by every thread of the tile (the rows a
// warp reads at one step are the same address, one broadcast load), the
// tables read through const __restrict__ pointers (read-only cache), and
// the shared device helpers of bvh_walk.cuh, so K4/K5 compute exactly what
// K1/K3 compute for a leaf.  The TPU's tile-wide vote (any lane hits) is a
// per-ray test here: votes are conservative, so the hits are the same.
//
// What K5's design does about it: a list step read from global memory is a
// chain of two dependent loads (the list slot, then the instance's row)
// that the next step waits for, and a tile's 204-step walk on overflow sets
// the launch's time.  So a block of kOccThreads rays of one tile
//
// * stages the tile's list once: the box, the valid and is_box flags and the
//   instance of each listed entry (of every instance on overflow), 32 bytes
//   an entry, into dynamic shared memory, all entries' loads in flight at
//   once; the step loop then reads shared memory only, as broadcasts;
// * tests kOccGroup entries per iteration, unrolled, so their slab tests
//   are independent work; an any-hit mask is an OR over the list, so the
//   order of the tests does not change it, and each entry's arithmetic is
//   slab_terms / occlude_instance as before: the mask is bit-identical;
// * leaves early what cannot be blocked: a warp leaves once every lane is
//   blocked or dead.  A lane is dead when it fails the slab gate on the
//   union of the staged valid boxes for certain (every comparison taken in
//   its negated form, so a NaN, from 0 * inf or a NaN max_t, keeps the lane
//   alive).  (b - o) * inv is monotone in b for every rounding, so the
//   union's entry time is no later and its exit time no earlier than each
//   box's: a ray the gate fails on the union fails it on every listed box.
//   Parked shadow lanes (origin 1e30) are dead at once;
// * by the same argument passes over a group of kOccGroup entries when every
//   open lane of the warp fails the gate on the union of that group's valid
//   boxes (staged beside the entries): one slab test instead of four.  An
//   overflowed tile walks every instance, in table order, where neighbours
//   in the list are neighbours in space, and a warp's rays are coherent.
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

constexpr int kOccThreads = 128;  // rays of one tile a K5 block takes
constexpr int kOccGroup = 4;      // list entries tested per iteration
constexpr int kOccEntry = 8;      // floats of a staged entry

// A staged entry: box min xyz, box max xyz, flags (bit 0 valid, bit 1
// is_box), the instance -- the last two as int bits.
struct OccEntry {
  float box[6];
  bool valid, is_box;
  int inst;
};

__device__ __forceinline__ OccEntry load_entry(const float4* __restrict__ e) {
  const float4 lo = e[0], hi = e[1];
  OccEntry en;
  en.box[0] = lo.x; en.box[1] = lo.y; en.box[2] = lo.z;
  en.box[3] = lo.w; en.box[4] = hi.x; en.box[5] = hi.y;
  const int flags = __float_as_int(hi.z);
  en.valid = flags & 1;
  en.is_box = flags & 2;
  en.inst = __float_as_int(hi.w);
  return en;
}

// Fails the slab gate on box for certain: every comparison in its negated
// form, so a NaN (0 * inf, a NaN max_t) is no failure.
__device__ __forceinline__ bool gate_fails(const float box[6], const Ray& ray,
                                           float max_t) {
  const Slab s = slab_terms(box, ray);
  const float tmin = slab_entry(s);
  const float tmax = slab_exit(s);
  return tmin > tmax || tmax < THRESHOLD || tmin > max_t || !s.inside;
}

__device__ __forceinline__ void widen(float u[6], const float box[6]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    u[k] = fminf(u[k], box[k]);
    u[k + 3] = fmaxf(u[k + 3], box[k + 3]);
  }
}

// grid (ceil(tile / kOccThreads), T).  Dynamic shared memory: for each of
// the cap = max(n_cols, n_inst) entries of the longest walk 32 bytes, then
// 32 bytes for each group of kOccGroup entries (the union of its valid
// boxes).
__global__ void __launch_bounds__(kOccThreads)
cull_occlude_kernel(const float* __restrict__ ro,
                    const float* __restrict__ rd,
                    const float* __restrict__ mt, Lists ls, int cap,
                    Tables tb, bool* __restrict__ blk_out) {
  extern __shared__ float4 staged[];  // [cap][2], then [groups][2]
  float4* group_box = staged + 2 * cap;
  const int t = blockIdx.y;
  const int in_tile = blockIdx.x * blockDim.x + threadIdx.x;
  const bool has_ray = in_tile < ls.tile;
  const int r = t * ls.tile + (has_ray ? in_tile : 0);
  const int loop_n = min(ls.info[2 * t], cap);  // what was staged for
  const int n_groups = (loop_n + kOccGroup - 1) / kOccGroup;
  const bool overflow = ls.info[2 * t + 1] > 0;
  if (loop_n == 0) {  // an empty list blocks nothing: no ray is read
    if (has_ray) blk_out[r] = false;
    return;
  }

  for (int e = threadIdx.x; e < loop_n; e += blockDim.x) {
    const int i = list_instance(ls, t, e, overflow);
    const float* f = tb.inst_f + i * IF_WIDTH + IF_BMIN;
    const int* ii = tb.inst_i + i * II_WIDTH;
    const float4 lo = *reinterpret_cast<const float4*>(f);      // min, max x
    const float2 hi = *reinterpret_cast<const float2*>(f + 4);  // max y, z
    const int flags = (ii[II_VALID] > 0 ? 1 : 0) | (ii[II_IS_BOX] > 0 ? 2 : 0);
    staged[2 * e] = lo;
    staged[2 * e + 1] =
        make_float4(hi.x, hi.y, __int_as_float(flags), __int_as_float(i));
  }
  __syncthreads();
  // a group without a valid entry keeps the inverted box; whether a ray
  // fails on that or not, the group's entries fail on their valid flag
  for (int g = threadIdx.x; g < n_groups; g += blockDim.x) {
    float u[6] = {F32_BIG, F32_BIG, F32_BIG,
                  F32_NEG_BIG, F32_NEG_BIG, F32_NEG_BIG};
    for (int k = g * kOccGroup; k < min(loop_n, (g + 1) * kOccGroup); ++k) {
      const OccEntry en = load_entry(staged + 2 * k);
      if (en.valid) widen(u, en.box);
    }
    group_box[2 * g] = make_float4(u[0], u[1], u[2], u[3]);
    group_box[2 * g + 1] = make_float4(u[4], u[5], 0.0f, 0.0f);
  }
  __syncthreads();

  // the union of all valid boxes, by every warp for itself
  const int lane = threadIdx.x & 31;
  float ubox[6] = {F32_BIG, F32_BIG, F32_BIG,
                   F32_NEG_BIG, F32_NEG_BIG, F32_NEG_BIG};
  for (int g = lane; g < n_groups; g += 32)
    widen(ubox, load_entry(group_box + 2 * g).box);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    for (int d = 16; d > 0; d >>= 1) {
      ubox[k] = fminf(ubox[k], __shfl_xor_sync(0xffffffffu, ubox[k], d));
      ubox[k + 3] =
          fmaxf(ubox[k + 3], __shfl_xor_sync(0xffffffffu, ubox[k + 3], d));
    }
  }

  const Ray ray = load_ray(ro, rd, r);
  const float max_t = mt[r];
  const bool dead = !has_ray || gate_fails(ubox, ray, max_t);
  bool blk = false;
  for (int g = 0; g < n_groups; ++g) {
    if (__all_sync(0xffffffffu, blk || dead)) break;
    // the warp passes over a group that none of its open lanes can enter
    const bool skip =
        blk || dead || gate_fails(load_entry(group_box + 2 * g).box, ray,
                                  max_t);
    if (__all_sync(0xffffffffu, skip)) continue;
#pragma unroll
    for (int j = 0; j < kOccGroup; ++j) {
      const int k = g * kOccGroup + j;
      if (k < loop_n) {
        const OccEntry en = load_entry(staged + 2 * k);
        const Slab s = slab_terms(en.box, ray);
        const float tmin = slab_entry(s);
        const float tmax = slab_exit(s);
        if (tmin <= tmax && tmax >= THRESHOLD && tmin <= max_t && s.inside &&
            en.valid && !blk && !dead) {
          if (en.is_box) {
            // occlude_instance's box branch: the slab decides
            const float t_hit = tmin >= THRESHOLD ? tmin : tmax;
            blk = t_hit >= THRESHOLD && t_hit <= max_t;
          } else {
            blk = occlude_instance(en.inst, s, ray, max_t, tb);
          }
        }
      }
    }
  }
  if (has_ray) blk_out[r] = blk;
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
// nothing, return cudaGetLastError().  n_rays is a whole number of tiles;
// n_inst is the number of rows of the instance tables.

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
                               const void* inst_i, int n_inst,
                               const void* tmpl, void* blk, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const rt::Lists ls{static_cast<const int*>(cand),
                     static_cast<const int*>(info), n_cols, tile};
  if (tile <= 0 || n_rays % tile || n_cols <= 0 || n_inst < 0 ||
      n_rays / tile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cap = n_cols > n_inst ? n_cols : n_inst;
  const size_t shared =
      sizeof(float) * rt::kOccEntry *
      (cap + (cap + rt::kOccGroup - 1) / rt::kOccGroup);
  if (shared > 48 * 1024) {
    err = cudaFuncSetAttribute(rt::cull_occlude_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((tile + rt::kOccThreads - 1) / rt::kOccThreads,
                  n_rays / tile);
  rt::cull_occlude_kernel<<<grid, rt::kOccThreads, shared,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ro), static_cast<const float*>(rd),
      static_cast<const float*>(mt), ls, cap,
      rt::table_only(inst_f, inst_i, tmpl), static_cast<bool*>(blk));
  return static_cast<int>(cudaGetLastError());
}
