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
// slab test per list entry (~30 FP32 operations, ~80 instructions without
// FMA and with NaN-aware min/max) and, where it passes, the box-face or
// template test.  The loop is as long as the tile's list (up to 64
// entries, or every instance on overflow).  Read from global memory, a
// list step is a chain of two dependent loads (the list slot, then the
// instance's row) that the next step waits for: 0.35-0.4 us a step, and
// the overflowed tiles' 204-step walks were 76% of K4's launch
// (probe_kernels.py, PERF.md).
//
// What both designs do about it: a block of kCullThreads rays of one tile
//
// * stages the tile's list once: the box, the valid and is_box flags and the
//   instance of each listed entry (of every instance on overflow), 32 bytes
//   an entry, into dynamic shared memory, all entries' loads in flight at
//   once, and beside it the union of the valid boxes of each group of
//   kGroup entries; the step loop then reads shared memory only, as
//   broadcasts, and tests kGroup entries an iteration, unrolled;
// * passes over what no lane can use.  A lane fails a gate on a union box
//   "for certain" when every comparison fails in its negated form, so a
//   NaN (0 * inf, a NaN max_t or best t) keeps the lane.  (b - o) * inv is
//   monotone in b for every rounding, so the union's entry time is no later
//   and its exit time no earlier than each member's: a lane that fails the
//   gate on the union fails it on every member.  An empty list reads no
//   ray.
//
// K5 (any hit): its mask is an OR over the list, so the order of the tests
// does not change it.  A warp leaves once every lane is blocked or fails
// the gate on the union of all the list's boxes, and passes over a group
// every open lane fails.
//
// K4 (closest hit): the order does matter -- the strict < keeps the first
// of equal t -- so entries are tested in list order, near to far by the
// tile's entry time (or table order on overflow), with the prune tmin <
// best t.  A lane's best t only falls along the list, so a lane that fails
// the prune on a union now fails it on every member later.  Groups of
// kGroup entries sit in spans of kSpan groups; one warp stages each span's
// union and its suffix union (every valid box from the span to the end of
// the list) by a scan from the back.  A warp leaves once every lane fails
// the gate on the suffix union -- after a close hit, the rest of a sorted
// list is behind it -- and passes over a span, then a group, that every
// lane fails: an overflowed tile's 204 entries cost 13 span tests where
// the warp's rays see little of the terrain.
//
// Build: as bvh_kernels.cu (render/kernels.py), -fmad=false, no fast math.

#include <cuda_runtime.h>

#include "bvh_walk.cuh"

namespace rt {

constexpr int kCullThreads = 128;  // rays of one tile a block takes
constexpr int kGroup = 4;           // list entries tested per iteration
constexpr int kSpan = 4;            // K4: groups under one union box
constexpr int kEntry = 8;           // floats of a staged entry or box

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

// A staged entry: box min xyz, box max xyz, flags (bit 0 valid, bit 1
// is_box), the instance -- the last two as int bits.  A staged box (a
// group's union) has the same layout with the last two words unused.
struct Entry {
  float box[6];
  bool valid, is_box;
  int inst;
};

__device__ __forceinline__ Entry load_entry(const float4* __restrict__ e) {
  const float4 lo = e[0], hi = e[1];
  Entry en;
  en.box[0] = lo.x; en.box[1] = lo.y; en.box[2] = lo.z;
  en.box[3] = lo.w; en.box[4] = hi.x; en.box[5] = hi.y;
  const int flags = __float_as_int(hi.z);
  en.valid = flags & 1;
  en.is_box = flags & 2;
  en.inst = __float_as_int(hi.w);
  return en;
}

__device__ __forceinline__ void store_box(float4* __restrict__ e,
                                          const float u[6]) {
  e[0] = make_float4(u[0], u[1], u[2], u[3]);
  e[1] = make_float4(u[4], u[5], 0.0f, 0.0f);
}

__device__ __forceinline__ void widen(float u[6], const float box[6]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    u[k] = fminf(u[k], box[k]);
    u[k + 3] = fmaxf(u[k + 3], box[k + 3]);
  }
}

// Stages tile t's list in shared memory, all entries' loads in flight at
// once: staged[2e..2e+1] the entry e (of every instance on overflow), then
// group_box[2g..2g+1] the union of the valid boxes of entries [kGroup g,
// kGroup (g + 1)).  A group without a valid entry keeps the inverted box;
// whether a ray fails on that or not, its entries fail on their valid
// flag.  Ends with the block synchronised.
__device__ __forceinline__ void stage_list(float4* __restrict__ staged,
                                           float4* __restrict__ group_box,
                                           const Lists& ls, int t,
                                           int loop_n, bool overflow,
                                           const Tables& tb) {
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
  const int n_groups = (loop_n + kGroup - 1) / kGroup;
  for (int g = threadIdx.x; g < n_groups; g += blockDim.x) {
    float u[6] = {F32_BIG, F32_BIG, F32_BIG,
                  F32_NEG_BIG, F32_NEG_BIG, F32_NEG_BIG};
    for (int k = g * kGroup; k < min(loop_n, (g + 1) * kGroup); ++k) {
      const Entry en = load_entry(staged + 2 * k);
      if (en.valid) widen(u, en.box);
    }
    store_box(group_box + 2 * g, u);
  }
  __syncthreads();
}

// The gates' "fails for certain": every comparison in its negated form, so
// a NaN (0 * inf, a NaN max_t) is no failure.  (b - o) * inv is monotone
// in b for every rounding, so a union box's entry time is no later and its
// exit time no earlier than each member's: a ray that fails a gate on a
// union for certain fails it on every member.

// K5's gate: tmin <= max_t.
__device__ __forceinline__ bool gate_fails(const float box[6], const Ray& ray,
                                           float max_t) {
  const Slab s = slab_terms(box, ray);
  const float tmin = slab_entry(s);
  const float tmax = slab_exit(s);
  return tmin > tmax || tmax < THRESHOLD || tmin > max_t || !s.inside;
}

// K4's gate, the prune: tmin < best_t.  best_t only falls along the list,
// so a ray that fails it now fails it on every later member too.
__device__ __forceinline__ bool cast_gate_fails(const float box[6],
                                                const Ray& ray,
                                                float best_t) {
  const Slab s = slab_terms(box, ray);
  const float tmin = slab_entry(s);
  const float tmax = slab_exit(s);
  return tmin > tmax || tmax < THRESHOLD || tmin >= best_t || !s.inside;
}

// grid (ceil(tile / kCullThreads), T).  Dynamic shared memory: for each of
// the cap = max(n_cols, n_inst) entries of the longest walk 32 bytes, then
// 32 bytes for each group of kGroup entries (its union box), then for each
// span of kSpan groups 32 bytes (its union box) and 32 bytes (the suffix
// union: the valid boxes from the span to the end of the list).
__global__ void __launch_bounds__(kCullThreads)
cull_cast_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                 Lists ls, int cap, Tables tb, float* __restrict__ t_out,
                 int* __restrict__ tri_out, float* __restrict__ uv_out,
                 float* __restrict__ n_out, int* __restrict__ mat_out) {
  extern __shared__ float4 staged[];  // [cap], [groups], [spans] x 2, x2
  const int cap_groups = (cap + kGroup - 1) / kGroup;
  const int cap_spans = (cap_groups + kSpan - 1) / kSpan;
  float4* group_box = staged + 2 * cap;
  float4* span_box = group_box + 2 * cap_groups;
  float4* suffix_box = span_box + 2 * cap_spans;
  const int t = blockIdx.y;
  const int in_tile = blockIdx.x * blockDim.x + threadIdx.x;
  const bool has_ray = in_tile < ls.tile;
  const int r = t * ls.tile + (has_ray ? in_tile : 0);
  const int loop_n = min(ls.info[2 * t], cap);  // what was staged for
  const int n_groups = (loop_n + kGroup - 1) / kGroup;
  const int n_spans = (n_groups + kSpan - 1) / kSpan;
  const bool overflow = ls.info[2 * t + 1] > 0;
  if (loop_n == 0) {  // an empty list: misses, no ray is read
    if (has_ray)
      write_best(miss(), r, t_out, tri_out, uv_out, n_out, mat_out);
    return;
  }
  stage_list(staged, group_box, ls, t, loop_n, overflow, tb);

  // the spans' unions and their suffix unions, by one warp: an inclusive
  // scan from the last span down, 32 spans at a time, each chunk widened
  // by the one after it
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float carry[6] = {F32_BIG, F32_BIG, F32_BIG,
                      F32_NEG_BIG, F32_NEG_BIG, F32_NEG_BIG};
    for (int c0 = (n_spans - 1) / 32 * 32; c0 >= 0; c0 -= 32) {
      const int p = c0 + lane;
      float u[6] = {F32_BIG, F32_BIG, F32_BIG,
                    F32_NEG_BIG, F32_NEG_BIG, F32_NEG_BIG};
      for (int g = p * kSpan; g < min(n_groups, (p + 1) * kSpan); ++g)
        widen(u, load_entry(group_box + 2 * g).box);
      if (p < n_spans) store_box(span_box + 2 * p, u);
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {  // a lane past 31 reads its own value
          u[k] = fminf(u[k], __shfl_down_sync(0xffffffffu, u[k], d));
          u[k + 3] =
              fmaxf(u[k + 3], __shfl_down_sync(0xffffffffu, u[k + 3], d));
        }
      }
      widen(u, carry);
      if (p < n_spans) store_box(suffix_box + 2 * p, u);
#pragma unroll
      for (int k = 0; k < 6; ++k) carry[k] = __shfl_sync(0xffffffffu, u[k], 0);
    }
  }
  __syncthreads();

  const Ray ray = load_ray(ro, rd, r);
  Best best = miss();
  // entries in list order (near to far, or table order on overflow): the
  // strict < keeps the first of equal t.  A warp leaves once every lane
  // fails the gate on the rest of the list, and passes over a span or a
  // group that every lane fails; the lanes' own gates decide the rest.
  for (int p = 0; p < n_spans; ++p) {
    const bool done =
        !has_ray ||
        cast_gate_fails(load_entry(suffix_box + 2 * p).box, ray, best.t);
    if (__all_sync(0xffffffffu, done)) break;
    if (__all_sync(0xffffffffu,
                   done || cast_gate_fails(load_entry(span_box + 2 * p).box,
                                           ray, best.t)))
      continue;
    for (int g = p * kSpan; g < min(n_groups, (p + 1) * kSpan); ++g) {
      if (__all_sync(0xffffffffu,
                     done || cast_gate_fails(
                                 load_entry(group_box + 2 * g).box, ray,
                                 best.t)))
        continue;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int k = g * kGroup + j;
        if (k < loop_n) {
          const Entry en = load_entry(staged + 2 * k);
          const Slab s = slab_terms(en.box, ray);
          const float tmin = slab_entry(s);
          const float tmax = slab_exit(s);
          // the prune: boxes no nearer than the current best cannot win
          if (tmin <= tmax && tmax >= THRESHOLD && tmin < best.t &&
              s.inside && en.valid)
            intersect_instance(en.inst, s, ray, tb, best);
        }
      }
    }
  }
  if (has_ray)
    write_best(best, r, t_out, tri_out, uv_out, n_out, mat_out);
}

// grid (ceil(tile / kCullThreads), T).  Dynamic shared memory: for each of
// the cap = max(n_cols, n_inst) entries of the longest walk 32 bytes, then
// 32 bytes for each group of kGroup entries (its union box).
__global__ void __launch_bounds__(kCullThreads)
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
  const int n_groups = (loop_n + kGroup - 1) / kGroup;
  const bool overflow = ls.info[2 * t + 1] > 0;
  if (loop_n == 0) {  // an empty list blocks nothing: no ray is read
    if (has_ray) blk_out[r] = false;
    return;
  }
  stage_list(staged, group_box, ls, t, loop_n, overflow, tb);

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
    for (int j = 0; j < kGroup; ++j) {
      const int k = g * kGroup + j;
      if (k < loop_n) {
        const Entry en = load_entry(staged + 2 * k);
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

// Bytes of dynamic shared memory a K4 (spans too) or K5 block stages for
// lists of at most cap entries.
inline size_t staged_bytes(int cap, bool spans) {
  const size_t groups = (cap + kGroup - 1) / kGroup;
  const size_t n_spans = spans ? 2 * ((groups + kSpan - 1) / kSpan) : 0;
  return sizeof(float) * kEntry * (cap + groups + n_spans);
}

inline Tables table_only(const void* inst_f, const void* inst_i,
                         const void* tmpl) {
  return Tables{nullptr, nullptr, 0, static_cast<const float*>(inst_f),
                static_cast<const int*>(inst_i),
                static_cast<const float*>(tmpl)};
}

// A launch of K4 or K5 over n_rays rays in tiles of tile rays: checks the
// shape, sets cap and the staged bytes, lets the kernel have them where
// that is above 48 KB, and gives the grid (ceil(tile / kCullThreads), T).
template <typename Kernel>
inline cudaError_t list_launch(Kernel kernel, int n_rays, int n_cols,
                               int tile, int n_inst, bool spans, int& cap,
                               size_t& shared, dim3& grid) {
  if (tile <= 0 || n_rays % tile || n_cols <= 0 || n_inst < 0 ||
      n_rays / tile > 65535)
    return cudaErrorInvalidValue;
  cap = n_cols > n_inst ? n_cols : n_inst;
  shared = staged_bytes(cap, spans);
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return err;
  }
  grid = dim3((tile + kCullThreads - 1) / kCullThreads, n_rays / tile);
  return cudaSuccess;
}

}  // namespace rt

// Plain C entry points for ctypes: launch on the given stream, allocate
// nothing, return cudaGetLastError().  n_rays is a whole number of tiles;
// n_inst is the number of rows of the instance tables.

extern "C" int rt_cull_cast(const void* ro, const void* rd, int n_rays,
                            const void* cand, const void* info, int n_cols,
                            int tile, const void* inst_f, const void* inst_i,
                            int n_inst, const void* tmpl, void* t, void* tri,
                            void* uv, void* normal, void* mat, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int cap;
  size_t shared;
  dim3 grid;
  err = rt::list_launch(rt::cull_cast_kernel, n_rays, n_cols, tile, n_inst,
                        true, cap, shared, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const rt::Lists ls{static_cast<const int*>(cand),
                     static_cast<const int*>(info), n_cols, tile};
  rt::cull_cast_kernel<<<grid, rt::kCullThreads, shared,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ro), static_cast<const float*>(rd), ls, cap,
      rt::table_only(inst_f, inst_i, tmpl), static_cast<float*>(t),
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
  int cap;
  size_t shared;
  dim3 grid;
  err = rt::list_launch(rt::cull_occlude_kernel, n_rays, n_cols, tile,
                        n_inst, false, cap, shared, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const rt::Lists ls{static_cast<const int*>(cand),
                     static_cast<const int*>(info), n_cols, tile};
  rt::cull_occlude_kernel<<<grid, rt::kCullThreads, shared,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ro), static_cast<const float*>(rd),
      static_cast<const float*>(mt), ls, cap,
      rt::table_only(inst_f, inst_i, tmpl), static_cast<bool*>(blk));
  return static_cast<int>(cudaGetLastError());
}
