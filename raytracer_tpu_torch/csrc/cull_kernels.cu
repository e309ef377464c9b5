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
// kGroup entries sit in spans of kSpan groups; the block stages each
// span's union and its suffix union (every valid box from the span to the
// end of the list), a span a thread.  A warp leaves once every lane fails
// the gate on the suffix union -- after a close hit, the rest of a sorted
// list is behind it -- and passes over a span, then a group, that every
// lane fails: an overflowed tile's 204 entries cost 13 span tests where
// the warp's rays see little of the terrain.
//
// Lists of any length: a block stages its list in pieces of at most
// kPiece entries (22.5 KB of shared memory with the boxes), in list order,
// one piece after the other.  A listed tile's list (at most n_cols <=
// kPiece entries) is one piece; an overflowed tile's list is every
// instance in table order, the same list for every overflowed tile, so the
// union box of each of its pieces is built once per launch into global
// memory (piece_boxes_kernel) wherever it has more than one piece.  K4's
// suffix unions then carry the unions of the pieces still to come, and
// K5's union of the whole list is that of the pieces.  A block leaves the
// piece loop once every warp has left.
//
// kPieces: whether a list can have more than one piece (more than kPiece
// instances); without it the piece loop folds to the one piece at compile
// time, and the kernels keep the registers of their one-piece form.  K4
// also comes as kExactUv (the JAX kernel's exact_uv=True,
// cfg.edge_aware_grads; bvh_walk.cuh box_exact_uv) or not.
//
// Build: as bvh_kernels.cu (render/kernels.py), -fmad=false, no fast math.

#include <cuda_runtime.h>

#include "bvh_walk.cuh"

namespace rt {

constexpr int kCullThreads = 128;  // rays of one tile a block takes
constexpr int kGroup = 4;           // list entries tested per iteration
constexpr int kSpan = 4;            // K4: groups under one union box
constexpr int kPiece = 512;         // entries staged at a time: 32 spans
constexpr int kEntry = 8;           // floats of a staged entry or box

struct Lists {
  const int* __restrict__ cand;  // [T, n_cols] instance ids
  const int* __restrict__ info;  // [T, 2]: trip count, overflow flag
  int n_cols;
  int tile;     // rays per tile
  int longest;  // max(n_cols, n_inst): no list is longer
  int piece;    // entries a block stages at a time: min(kPiece, longest)
  // [n_pieces][2] the union box of each piece of the overflow list (every
  // instance in table order); null where that list is one piece
  const float4* __restrict__ piece_box;
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

__device__ __forceinline__ void empty_box(float u[6]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    u[k] = F32_BIG;
    u[k + 3] = F32_NEG_BIG;
  }
}

// An instance's box and flags as a staged entry.
__device__ __forceinline__ void stage_entry(float4* __restrict__ e, int i,
                                            const Tables& tb) {
  const float* f = tb.inst_f + i * IF_WIDTH + IF_BMIN;
  const int* ii = tb.inst_i + i * II_WIDTH;
  const float4 lo = *reinterpret_cast<const float4*>(f);      // min, max x
  const float2 hi = *reinterpret_cast<const float2*>(f + 4);  // max y, z
  const int flags = (ii[II_VALID] > 0 ? 1 : 0) | (ii[II_IS_BOX] > 0 ? 2 : 0);
  e[0] = lo;
  e[1] = make_float4(hi.x, hi.y, __int_as_float(flags), __int_as_float(i));
}

// Stages entries [first, first + m) of tile t's list in shared memory, all
// entries' loads in flight at once: staged[2e..2e+1] the entry first + e,
// then group_box[2g..2g+1] the union of the valid boxes of the piece's
// entries [kGroup g, kGroup (g + 1)).  A group without a valid entry keeps
// the inverted box; whether a ray fails on that or not, its entries fail
// on their valid flag.  Ends with the block synchronised.
__device__ __forceinline__ void stage_list(float4* __restrict__ staged,
                                           float4* __restrict__ group_box,
                                           const Lists& ls, int t, int first,
                                           int m, bool overflow,
                                           const Tables& tb) {
  for (int e = threadIdx.x; e < m; e += blockDim.x)
    stage_entry(staged + 2 * e, list_instance(ls, t, first + e, overflow),
                tb);
  __syncthreads();
  const int n_groups = (m + kGroup - 1) / kGroup;
  for (int g = threadIdx.x; g < n_groups; g += blockDim.x) {
    float u[6];
    empty_box(u);
    for (int k = g * kGroup; k < min(m, (g + 1) * kGroup); ++k) {
      const Entry en = load_entry(staged + 2 * k);
      if (en.valid) widen(u, en.box);
    }
    store_box(group_box + 2 * g, u);
  }
  __syncthreads();
}

// grid (n_pieces): the union of the valid boxes of each piece of kPiece
// instances, in table order, into out[2p..2p+1] -- the overflow list's
// pieces, built once per launch.
__global__ void __launch_bounds__(kCullThreads)
piece_boxes_kernel(Tables tb, int n_inst, float4* __restrict__ out) {
  __shared__ float part[kCullThreads / 32][6];
  float u[6];
  empty_box(u);
  const int end = min(n_inst, (blockIdx.x + 1) * kPiece);
  for (int i = blockIdx.x * kPiece + threadIdx.x; i < end; i += blockDim.x) {
    float4 e[2];
    stage_entry(e, i, tb);
    const Entry en = load_entry(e);
    if (en.valid) widen(u, en.box);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    for (int d = 16; d > 0; d >>= 1) {
      u[k] = fminf(u[k], __shfl_xor_sync(0xffffffffu, u[k], d));
      u[k + 3] = fmaxf(u[k + 3], __shfl_xor_sync(0xffffffffu, u[k + 3], d));
    }
  }
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0)
    for (int k = 0; k < 6; ++k) part[warp][k] = u[k];
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kCullThreads / 32; ++w) widen(u, part[w]);
    store_box(out + 2 * blockIdx.x, u);
  }
}

// The union of the overflow list's pieces [from, n_pieces) (the inverted
// box when there are none).
__device__ __forceinline__ void pieces_union(const Lists& ls, int from,
                                             int n_pieces, float u[6]) {
  empty_box(u);
  for (int p = from; p < n_pieces; ++p)
    widen(u, load_entry(ls.piece_box + 2 * p).box);
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

// grid (ceil(tile / kCullThreads), T).  Dynamic shared memory for a piece
// of ls.piece entries: 32 bytes an entry, then 32 bytes for each group of
// kGroup entries (its union box), then for each span of kSpan groups 32
// bytes (its union box) and 32 bytes (the suffix union: the valid boxes
// from the span to the end of the list, later pieces included).
template <bool kExactUv, bool kPieces>
__global__ void __launch_bounds__(kCullThreads)
cull_cast_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                 Lists ls, Tables tb, float* __restrict__ t_out,
                 int* __restrict__ tri_out, float* __restrict__ uv_out,
                 float* __restrict__ n_out, int* __restrict__ mat_out) {
  extern __shared__ float4 staged[];  // [piece], [groups], [spans] x 2, x2
  const int cap_groups = (ls.piece + kGroup - 1) / kGroup;
  const int cap_spans = (cap_groups + kSpan - 1) / kSpan;
  float4* group_box = staged + 2 * ls.piece;
  float4* span_box = group_box + 2 * cap_groups;
  float4* suffix_box = span_box + 2 * cap_spans;
  const int t = blockIdx.y;
  const int in_tile = blockIdx.x * blockDim.x + threadIdx.x;
  const bool has_ray = in_tile < ls.tile;
  const int r = t * ls.tile + (has_ray ? in_tile : 0);
  const int loop_n = min(ls.info[2 * t], ls.longest);
  const bool overflow = ls.info[2 * t + 1] > 0;
  if (loop_n == 0) {  // an empty list: misses, no ray is read
    if (has_ray)
      write_best(miss(), r, t_out, tri_out, uv_out, n_out, mat_out);
    return;
  }
  const int n_pieces = kPieces ? (loop_n + ls.piece - 1) / ls.piece : 1;
  Best best = miss();
  bool left = false;  // the warp has left the list (the same in every lane)

  for (int q = 0; q < n_pieces; ++q) {
    // every warp done with the last piece: restage, or leave together
    if (q > 0 && __syncthreads_and(left)) break;
    const int first = q * ls.piece;
    const int m = min(ls.piece, loop_n - first);
    const int n_groups = (m + kGroup - 1) / kGroup;
    const int n_spans = (n_groups + kSpan - 1) / kSpan;
    stage_list(staged, group_box, ls, t, first, m, overflow, tb);

    // the spans' unions, then their suffix unions (every valid box from
    // the span to the end of the list: the piece's spans from it on, and
    // the pieces still to come), a span a thread
    for (int p = threadIdx.x; p < n_spans; p += blockDim.x) {
      float u[6];
      empty_box(u);
      for (int g = p * kSpan; g < min(n_groups, (p + 1) * kSpan); ++g)
        widen(u, load_entry(group_box + 2 * g).box);
      store_box(span_box + 2 * p, u);
    }
    __syncthreads();
    for (int p = threadIdx.x; p < n_spans; p += blockDim.x) {
      float u[6];
      pieces_union(ls, q + 1, n_pieces, u);
      for (int p2 = p; p2 < n_spans; ++p2)
        widen(u, load_entry(span_box + 2 * p2).box);
      store_box(suffix_box + 2 * p, u);
    }
    __syncthreads();
    if (left) continue;
    const Ray ray = load_ray(ro, rd, r);

    // entries in list order (near to far, or table order on overflow): the
    // strict < keeps the first of equal t.  A warp leaves once every lane
    // fails the gate on the rest of the list, and passes over a span or a
    // group that every lane fails; the lanes' own gates decide the rest.
    for (int p = 0; p < n_spans; ++p) {
      const bool done =
          !has_ray ||
          cast_gate_fails(load_entry(suffix_box + 2 * p).box, ray, best.t);
      if (__all_sync(0xffffffffu, done)) {
        left = true;
        break;
      }
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
          if (k < m) {
            const Entry en = load_entry(staged + 2 * k);
            const Slab s = slab_terms(en.box, ray);
            const float tmin = slab_entry(s);
            const float tmax = slab_exit(s);
            // the prune: boxes no nearer than the current best cannot win
            if (tmin <= tmax && tmax >= THRESHOLD && tmin < best.t &&
                s.inside && en.valid)
              intersect_instance<kExactUv>(en.inst, s, ray, tb, best);
          }
        }
      }
    }
    // through the piece: leave now if every lane fails on the pieces to
    // come, so that a block whose warps all do stages no more
    if (!left && q + 1 < n_pieces) {
      float later[6];
      pieces_union(ls, q + 1, n_pieces, later);
      left = __all_sync(0xffffffffu,
                        !has_ray || cast_gate_fails(later, ray, best.t));
    }
  }
  if (has_ray)
    write_best(best, r, t_out, tri_out, uv_out, n_out, mat_out);
}

// grid (ceil(tile / kCullThreads), T).  Dynamic shared memory for a piece
// of ls.piece entries: 32 bytes an entry, then 32 bytes for each group of
// kGroup entries (its union box).
template <bool kPieces>
__global__ void __launch_bounds__(kCullThreads)
cull_occlude_kernel(const float* __restrict__ ro,
                    const float* __restrict__ rd,
                    const float* __restrict__ mt, Lists ls, Tables tb,
                    bool* __restrict__ blk_out) {
  extern __shared__ float4 staged[];  // [piece][2], then [groups][2]
  float4* group_box = staged + 2 * ls.piece;
  const int t = blockIdx.y;
  const int in_tile = blockIdx.x * blockDim.x + threadIdx.x;
  const bool has_ray = in_tile < ls.tile;
  const int r = t * ls.tile + (has_ray ? in_tile : 0);
  const int loop_n = min(ls.info[2 * t], ls.longest);
  const bool overflow = ls.info[2 * t + 1] > 0;
  if (loop_n == 0) {  // an empty list blocks nothing: no ray is read
    if (has_ray) blk_out[r] = false;
    return;
  }
  const int n_pieces = kPieces ? (loop_n + ls.piece - 1) / ls.piece : 1;
  bool blk = false;
  bool dead = true;
  bool left = false;  // the warp has left the list (the same in every lane)

  for (int q = 0; q < n_pieces; ++q) {
    if (q > 0 && __syncthreads_and(left)) break;
    const int first = q * ls.piece;
    const int m = min(ls.piece, loop_n - first);
    const int n_groups = (m + kGroup - 1) / kGroup;
    stage_list(staged, group_box, ls, t, first, m, overflow, tb);
    const Ray ray = load_ray(ro, rd, r);
    const float max_t = mt[r];
    if (q == 0) {
      // the union of all valid boxes: the pieces' where there are several,
      // else by every warp for itself from the staged groups
      float ubox[6];
      if (n_pieces > 1) {
        pieces_union(ls, 0, n_pieces, ubox);
      } else {
        const int lane = threadIdx.x & 31;
        empty_box(ubox);
        for (int g = lane; g < n_groups; g += 32)
          widen(ubox, load_entry(group_box + 2 * g).box);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          for (int d = 16; d > 0; d >>= 1) {
            ubox[k] = fminf(ubox[k],
                            __shfl_xor_sync(0xffffffffu, ubox[k], d));
            ubox[k + 3] = fmaxf(
                ubox[k + 3], __shfl_xor_sync(0xffffffffu, ubox[k + 3], d));
          }
        }
      }
      dead = !has_ray || gate_fails(ubox, ray, max_t);
    }
    if (left) continue;
    for (int g = 0; g < n_groups; ++g) {
      if (__all_sync(0xffffffffu, blk || dead)) {
        left = true;
        break;
      }
      // the warp passes over a group that none of its open lanes can enter
      const bool skip =
          blk || dead || gate_fails(load_entry(group_box + 2 * g).box, ray,
                                    max_t);
      if (__all_sync(0xffffffffu, skip)) continue;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int k = g * kGroup + j;
        if (k < m) {
          const Entry en = load_entry(staged + 2 * k);
          const Slab s = slab_terms(en.box, ray);
          const float tmin = slab_entry(s);
          const float tmax = slab_exit(s);
          if (tmin <= tmax && tmax >= THRESHOLD && tmin <= max_t &&
              s.inside && en.valid && !blk && !dead) {
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
    left = left || __all_sync(0xffffffffu, blk || dead);
  }
  if (has_ray) blk_out[r] = blk;
}

// Bytes of dynamic shared memory a K4 (spans too) or K5 block stages for a
// piece of piece entries.
inline size_t staged_bytes(int piece, bool spans) {
  const size_t groups = (piece + kGroup - 1) / kGroup;
  const size_t n_spans = spans ? 2 * ((groups + kSpan - 1) / kSpan) : 0;
  return sizeof(float) * kEntry * (piece + groups + n_spans);
}

inline Tables table_only(const void* inst_f, const void* inst_i,
                         const void* tmpl) {
  return Tables{nullptr, nullptr, 0, static_cast<const float*>(inst_f),
                static_cast<const int*>(inst_i),
                static_cast<const float*>(tmpl)};
}

// A launch of K4 or K5 over n_rays rays in tiles of tile rays: checks the
// shape, sets the piece (the longest list, at most kPiece entries) and its
// staged bytes, builds the overflow list's piece boxes into piece_box
// ([ceil(n_inst / kPiece)][8] floats) where that list has more than one
// piece, and gives the grid (ceil(tile / kCullThreads), T).
inline cudaError_t list_launch(int n_rays, const void* cand, const void* info,
                               int n_cols, int tile, const Tables& tb,
                               int n_inst, void* piece_box, bool spans,
                               cudaStream_t stream, Lists& ls,
                               size_t& shared, dim3& grid) {
  if (tile <= 0 || n_rays % tile || n_cols <= 0 || n_cols > kPiece ||
      n_inst < 0 || n_rays / tile > 65535)
    return cudaErrorInvalidValue;
  const int longest = n_cols > n_inst ? n_cols : n_inst;
  ls = Lists{static_cast<const int*>(cand), static_cast<const int*>(info),
             n_cols, tile, longest, longest < kPiece ? longest : kPiece,
             nullptr};
  if (n_inst > kPiece) {
    if (piece_box == nullptr) return cudaErrorInvalidValue;
    piece_boxes_kernel<<<(n_inst + kPiece - 1) / kPiece, kCullThreads, 0,
                         stream>>>(tb, n_inst,
                                   static_cast<float4*>(piece_box));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ls.piece_box = static_cast<const float4*>(piece_box);
  }
  shared = staged_bytes(ls.piece, spans);
  grid = dim3((tile + kCullThreads - 1) / kCullThreads, n_rays / tile);
  return cudaSuccess;
}

}  // namespace rt

// Plain C entry points for ctypes: launch on the given stream, allocate
// nothing, return cudaGetLastError().  n_rays is a whole number of tiles;
// n_inst is the number of rows of the instance tables; piece_box is scratch
// of ceil(n_inst / 512) * 8 floats (may be null when n_inst <= 512).

extern "C" int rt_cull_cast(const void* ro, const void* rd, int n_rays,
                            const void* cand, const void* info, int n_cols,
                            int tile, const void* inst_f, const void* inst_i,
                            int n_inst, const void* tmpl, void* piece_box,
                            int exact_uv, void* t, void* tri, void* uv,
                            void* normal, void* mat, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const rt::Tables tb = rt::table_only(inst_f, inst_i, tmpl);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  rt::Lists ls;
  size_t shared;
  dim3 grid;
  err = rt::list_launch(n_rays, cand, info, n_cols, tile, tb, n_inst,
                        piece_box, true, st, ls, shared, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool pieces = ls.piece_box != nullptr;
  const auto kernel =
      exact_uv ? (pieces ? rt::cull_cast_kernel<true, true>
                         : rt::cull_cast_kernel<true, false>)
               : (pieces ? rt::cull_cast_kernel<false, true>
                         : rt::cull_cast_kernel<false, false>);
  kernel<<<grid, rt::kCullThreads, shared, st>>>(
      static_cast<const float*>(ro), static_cast<const float*>(rd), ls, tb,
      static_cast<float*>(t), static_cast<int*>(tri),
      static_cast<float*>(uv), static_cast<float*>(normal),
      static_cast<int*>(mat));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_cull_occlude(const void* ro, const void* rd, const void* mt,
                               int n_rays, const void* cand, const void* info,
                               int n_cols, int tile, const void* inst_f,
                               const void* inst_i, int n_inst,
                               const void* tmpl, void* piece_box, void* blk,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const rt::Tables tb = rt::table_only(inst_f, inst_i, tmpl);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  rt::Lists ls;
  size_t shared;
  dim3 grid;
  err = rt::list_launch(n_rays, cand, info, n_cols, tile, tb, n_inst,
                        piece_box, false, st, ls, shared, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto kernel = ls.piece_box != nullptr
                          ? rt::cull_occlude_kernel<true>
                          : rt::cull_occlude_kernel<false>;
  kernel<<<grid, rt::kCullThreads, shared, st>>>(
      static_cast<const float*>(ro), static_cast<const float*>(rd),
      static_cast<const float*>(mt), ls, tb, static_cast<bool*>(blk));
  return static_cast<int>(cudaGetLastError());
}
