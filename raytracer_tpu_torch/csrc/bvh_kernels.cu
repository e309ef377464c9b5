// LBVH closest-hit cast (K1), fused two-light shadow query (K2) and
// single shadow query (K3): walks of the implicit-heap LBVH, a ray a thread.
//
// Replaces the Pallas TPU kernels _bvh_cast_kernel, _bvh_occlude2_kernel and
// _bvh_occlude_kernel (raytracer_tpu/render/pallas_engine.py:916, :1033 and
// :983).  Their plain PyTorch versions are bvh_cast_reference /
// bvh_occlude2_reference / bvh_occlude_reference in render/cuda_engine.py.
//
// What bounds them on an H100: not FLOPs and not bytes.  A 640x480 frame of
// the terrain8 world reads a few tens of KB of tables (380 instances x 160
// B, 1023 nodes x 32 B), which stay in L1/L2.  Each ray walks the
// implicit-heap LBVH in its own order, one thread a ray, and a warp runs as
// long as its longest lane: a step is a chain of a node-row load, a slab
// test (~70 instructions without FMA), the vote and the next index, each
// waiting on the one before.  The probe (probe_kernels.py) measured walks
// of up to 67 nodes and ~0.5 us a step where few warps are left to hide
// it: the longest warps set most of a 640x480 launch, and at 1080p the
// launch is bound by issue (~240 instructions a warp-step over the card).
//
// What K1's design does about it:
// * both children of a node in one step: adjacent rows, two independent
//   slab tests, so the dependent chain is one step per node entered, about
//   half the per-thread walk's visits.  Of two inner children that both
//   vote, the left is entered and the right's vote kept in a bit per depth
//   (no stack memory); with nothing to enter the walk pops to the deepest
//   kept right child (a count of leading zeros, no loop).  The kept vote
//   was taken under a best t no smaller than the one the walk has when it
//   gets there, so it is only ever too kind; a child entered on a kind vote
//   has leaves that fail their own gates by containment (a node's box holds
//   its children's, and (b - o) * inv is monotone in b for every rounding;
//   where 0 * inf makes a node's slab NaN, the children that share the
//   plane are NaN too and the others lie wholly on one side of the origin).
//   Two leaves go through their own gates in preorder, the second under the
//   best t the first left: the hits are the per-thread walk's, which are
//   the plain version's all-leaves loop.  The leaves all sit at one depth
//   (n_leaves a power of two, as build_lbvh pads it; the entry point checks
//   it), so an inner node's children are both inner or both leaves.
// * NaN-propagating min and max as one instruction each (bvh_walk.cuh),
//   where they were a compare-compare-select: ten in every slab test.
//
// K2 and K3 (occlude_walk) take the same pair walk under a fixed max_t.
// On terrain8's shadow queries every instance a ray tests blocks it, so a
// walk is the path down to its first passing leaf plus the dead ends on
// the way; the probe measured per-thread walks of up to 57 nodes and the
// longest 1% of warps taking most of a 640x480 launch.  The pair walk
// halves that chain (longest 28 steps).  An any-hit query is an OR over the
// leaves it reaches, so the order is free and a kept vote never goes stale
// (max_t is fixed): a pop needs no retest, and two leaves go through their
// instances left first, the walk ending at a block.  A node row comes in
// two 16-B loads (4-10% off K2's and K3's device time on an H100, in
// turns; 52-56 registers).  K2 runs one walk a
// query (2R threads, query-major: a warp holds one kind of query), not one
// walk of the union of a pixel's two queries with two slab tests a node,
// as the JAX kernel does to share node loads: on this card the nodes sit
// in L1, and the union walk cost every lane the longer of its two walks.
// A leaf is reached only through ancestors that vote: where 0 * inf makes
// an ancestor's slab NaN, a leaf that lies wholly on one side of the origin
// can pass its own gate only with a box hit at t = +inf (under max_t =
// +inf); no walk reaches it, and the plain version gates each leaf by its
// ancestors' votes so as to agree.
//
// K1 comes in three instantiations: the frame path's <false, false>;
// <true, false>, kExactUv (the JAX kernel's exact_uv=True,
// cfg.edge_aware_grads: the box fast path resolves the true triangle of the
// hit face and its barycentrics, two barycentric evaluations on a hit face;
// bvh_walk.cuh box_exact_uv); and <false, true>, kVisits (visits_out: the
// nodes whose boxes the walk tests, per ray, 1 + 2 a step; the JAX kernel
// counts per tile).
//
// Not taken (measured with probe_kernels.py, PERF.md): the top of the tree
// in shared memory with a fixed crew of blocks (slower at 1080p), box faces
// looked up once at the end (no gain, and spills with the pair walk), a
// warp-vote walk (its union of the lanes' walks is up to 1.23x the longest
// lane's in the longest warps: more steps, not fewer); for K2 and K3, the
// nearer child first (the smaller slab entry: no fewer steps, since every
// passing leaf blocks, and 1.5-1.8x slower at 1080p) and K2's two walks one
// after the other in one thread (its chain is both walks').
//
// The transmissive shadow march (bvh_cast_kernel(MarchArgs, Tables), an
// overload of K1's name, so that a profile counts it among the closest-hit
// queries) replaces no Pallas kernel: it fuses the JAX package's
// _march_shadow loop (raytracer_tpu/render/shading.py) with K1's walk
// (bvh_walk.cuh closest_walk), one lane a thread.  Its plain version is
// shading.march_steps, a loop of whole-queue torch ops over K1 casts.  The
// loop is short and per ray (walk, read a material, attenuate, move), so a
// lane that stops costs nothing more and no host read asks whether any
// walks on.  What bounds it: not its bytes (45 B a lane: origin,
// direction, max_t, the active flag in, rv out; 94 MB, 28 us at 3.35 TB/s
// for the 2,088,960-lane queue of a 1080p frame) but its walks, up to
// shadow_steps closest hits a lane, each as long as K1's: 0.09-0.17 ms a
// launch there on an H100, the later rounds' few active lanes spread over
// more warps.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
// -fmad=false -shared -Xcompiler -fPIC (render/kernels.py).  No fast math:
// IEEE division and square root, one rounding per operation.

#include <climits>

#include <cuda_runtime.h>

#include "bvh_walk.cuh"

namespace rt {

constexpr int kThreads = 128;

template <bool kExactUv, bool kVisits>
__global__ void __launch_bounds__(kThreads)
bvh_cast_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                int n_rays, Tables tb, float* __restrict__ t_out,
                int* __restrict__ tri_out, float* __restrict__ uv_out,
                float* __restrict__ n_out, int* __restrict__ mat_out,
                int* __restrict__ visits_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  int visits = 1;  // kVisits: node boxes tested, the root's first
  const Best best =
      closest_walk<kExactUv, kVisits>(load_ray(ro, rd, r), tb, visits);
  write_best(best, r, t_out, tri_out, uv_out, n_out, mat_out);
  if (kVisits) visits_out[r] = visits;
}

// The any-hit walk of K2 and K3: K1's pair walk under a fixed max_t.  An
// any-hit query is an OR over the leaves whose own gates pass, and every
// prune is conservative (a node's box holds its children's, max_t is fixed
// for the ray, the walk leaves at the first block), so a walk that visits a
// superset of those leaves, in any order, gives the plain version's mask;
// a kept vote never goes stale, so a pop needs no retest.
struct OccGate {
  Slab s;
  float tmin;
  bool go;
};

__device__ __forceinline__ OccGate occ_gate(const Tables& tb, int total, int v,
                                            const Ray& ray, float max_t) {
  // a node row is 32 B, 32-B aligned (the wrapper checks the base): two
  // vector loads where the compiler issues seven
  const float4* row =
      reinterpret_cast<const float4*>(tb.nodes + (total - v) * NODE_WIDTH);
  const float4 lo = __ldg(row), hi = __ldg(row + 1);
  const float node[7] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z};
  OccGate g;
  g.s = slab_terms(node, ray);
  g.tmin = slab_entry(g.s);
  const float tmax = slab_exit(g.s);
  g.go = g.tmin <= tmax && tmax >= THRESHOLD && g.tmin <= max_t &&
         g.s.inside && node[6] > 0.0f;
  return g;
}

__device__ __forceinline__ bool occlude_walk(const Ray& ray, float max_t,
                                             const Tables& tb) {
  const int total = 2 * tb.n_leaves - 1;
  // a leaf whose gate passed: does its instance block the ray?
  auto leaf = [&](int u, const OccGate& g) {
    if (!g.go) return false;
    const int i = tb.ordering[total - u];
    return i >= 0 && occlude_instance(i, g.s, ray, max_t, tb);
  };
  const OccGate root = occ_gate(tb, total, 1, ray, max_t);
  if (tb.n_leaves == 1) return leaf(1, root);
  if (!root.go) return false;
  int v = 1;          // the entered node (its vote passed)
  int depth = 0;      // of v
  unsigned pend = 0;  // bit d: a right child at depth d still to enter
  while (true) {
    // both children of v, adjacent rows, two independent slab tests
    const int c = 2 * v;
    const OccGate g0 = occ_gate(tb, total, c, ray, max_t);
    const OccGate g1 = occ_gate(tb, total, c + 1, ray, max_t);
    if (c >= tb.n_leaves) {  // two leaves, the left first; a block ends
      if (leaf(c, g0) || leaf(c + 1, g1)) return true;
    } else if (g0.go || g1.go) {
      if (g0.go && g1.go) pend |= 1u << (depth + 1);
      v = g0.go ? c : c + 1;
      ++depth;
      continue;
    }
    // on to the deepest right child still to enter, or the end
    if (pend == 0) return false;
    const int d = 31 - __clz(pend);
    pend &= ~(1u << d);
    v = (v >> (depth - d)) | 1;
    depth = d;
  }
}

// K2: the two queries of a fused two-light round in one launch, one query
// a thread: threads [0, n) take query 1 and [n, 2n) query 2, so a warp
// holds one kind of query and each lane ends at its own block.
__global__ void __launch_bounds__(kThreads)
bvh_occlude2_kernel(const float* __restrict__ o1, const float* __restrict__ d1,
                    const float* __restrict__ mt1,
                    const float* __restrict__ o2, const float* __restrict__ d2,
                    const float* __restrict__ mt2, int n_rays, Tables tb,
                    bool* __restrict__ blk1_out, bool* __restrict__ blk2_out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 2 * n_rays) return;
  const bool second = t >= n_rays;
  const int r = second ? t - n_rays : t;
  const Ray ray = load_ray(second ? o2 : o1, second ? d2 : d1, r);
  const bool blk = occlude_walk(ray, (second ? mt2 : mt1)[r], tb);
  (second ? blk2_out : blk1_out)[r] = blk;
}

// K3: one any-hit query a thread.
__global__ void __launch_bounds__(kThreads)
bvh_occlude_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                   const float* __restrict__ mt, int n_rays, Tables tb,
                   bool* __restrict__ blk_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  blk_out[r] = occlude_walk(load_ray(ro, rd, r), mt[r], tb);
}

// The transmissive shadow march of one lane a thread.  An active lane
// starts THRESHOLD along the ray and takes up to `steps` closest hits: a
// miss, or a hit beyond what is left of max_t, leaves rv as it is; a
// material with no kt channel above 0 zeroes it; else the lane moves on to
// the hit point, and where it leaves the blocker (n.d > 0) rv takes
// safe_pow(kt, t) per channel.  An inactive lane writes the light's
// colour.  Each operation rounds as shading.march_steps' torch ops do
// (-fmad=false); powf may differ from torch's pow in the last place.
struct MarchArgs {
  const float* __restrict__ origin;  // [R, 3]
  const float* __restrict__ dir;     // [R, 3], or [3] when dir_step is 0
  int dir_step;                      // 3, or 0: one direction for all lanes
  const float* __restrict__ max_t;   // [R], or null: max_t_all for all
  float max_t_all;
  const bool* __restrict__ active;   // [R]
  const float* __restrict__ light;   // [4]
  const float* __restrict__ kt;      // [K, 4]
  int steps;
  int n_rays;
  float* __restrict__ rv;  // [R, 4]
};

// raymath.safe_pow: powf's values at 0 (pow(0, 0) = 1, pow(0, e > 0) = 0)
__device__ __forceinline__ float safe_pow(float base, float e) {
  const float val = powf(base > 0.0f ? base : 1.0f, e);
  return base > 0.0f ? val : (e == 0.0f ? 1.0f : 0.0f);
}

__global__ void __launch_bounds__(kThreads)
bvh_cast_kernel(MarchArgs a, Tables tb) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.n_rays) return;
  float rv[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) rv[k] = a.light[k];
  if (a.active[r]) {
    float o[3], d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      d[k] = a.dir[a.dir_step * r + k];
      o[k] = a.origin[3 * r + k] + THRESHOLD * d[k];
    }
    float remaining = a.max_t ? a.max_t[r] : a.max_t_all;
    for (int step = 0; step < a.steps; ++step) {
      int visits = 0;
      const Best b = closest_walk<false, false>(make_ray(o, d), tb, visits);
      // a miss (t = +inf) or a blocker beyond the light: rv as it is
      if (!(b.t < __int_as_float(0x7f800000)) || b.t > remaining) break;
      const float* kt = a.kt + 4 * b.mat;
      const float kt4[4] = {kt[0], kt[1], kt[2], kt[3]};
      if (!(kt4[0] > 0.0f || kt4[1] > 0.0f || kt4[2] > 0.0f ||
            kt4[3] > 0.0f)) {  // an opaque blocker
#pragma unroll
        for (int k = 0; k < 4; ++k) rv[k] = 0.0f;
        break;
      }
      // the normal as write_best gives it, then n.d left to right
      const float nlen =
          sqrtf(b.n[0] * b.n[0] + b.n[1] * b.n[1] + b.n[2] * b.n[2]);
      const float ninv = 1.0f / nan_max(nlen, THRESHOLD);
      const float nd = (b.n[0] * ninv) * d[0] + (b.n[1] * ninv) * d[1] +
                       (b.n[2] * ninv) * d[2];
      if (nd > 0.0f) {
#pragma unroll
        for (int k = 0; k < 4; ++k) rv[k] = rv[k] * safe_pow(kt4[k], b.t);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) o[k] = o[k] + b.t * d[k];
      remaining = remaining - b.t;
    }
  }
  reinterpret_cast<float4*>(a.rv)[r] = make_float4(rv[0], rv[1], rv[2], rv[3]);
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

template <bool kExactUv, bool kVisits>
inline void launch_bvh_cast(const float* ro, const float* rd, int n_rays,
                            const Tables& tb, float* t, int* tri, float* uv,
                            float* normal, int* mat, int* visits,
                            cudaStream_t stream) {
  bvh_cast_kernel<kExactUv, kVisits>
      <<<blocks_for(n_rays), kThreads, 0, stream>>>(
          ro, rd, n_rays, tb, t, tri, uv, normal, mat, visits);
}

}  // namespace rt

// Plain C entry points for ctypes.  Each launches on the given stream,
// allocates nothing, and returns cudaGetLastError() (0 on success).

// K1: exact_uv picks the exact_uv instantiation; visits (int [n_rays]) the
// one that writes the visit counts, when it is not null.  The walk reads
// only the best t, which exact_uv leaves as it is, so the counts take no
// exact_uv variant.
extern "C" int rt_bvh_cast(const void* ro, const void* rd, int n_rays,
                           const void* nodes, const void* ordering,
                           int n_leaves, const void* inst_f,
                           const void* inst_i, const void* tmpl, void* t,
                           void* tri, void* uv, void* normal, void* mat,
                           int exact_uv, void* visits, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_leaves < 1 || (n_leaves & (n_leaves - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const rt::Tables tb{static_cast<const float*>(nodes),
                      static_cast<const int*>(ordering), n_leaves,
                      static_cast<const float*>(inst_f),
                      static_cast<const int*>(inst_i),
                      static_cast<const float*>(tmpl)};
  const auto launch = visits ? rt::launch_bvh_cast<false, true>
      : exact_uv             ? rt::launch_bvh_cast<true, false>
                             : rt::launch_bvh_cast<false, false>;
  launch(static_cast<const float*>(ro), static_cast<const float*>(rd), n_rays,
         tb, static_cast<float*>(t), static_cast<int*>(tri),
         static_cast<float*>(uv), static_cast<float*>(normal),
         static_cast<int*>(mat), static_cast<int*>(visits),
         static_cast<cudaStream_t>(stream));
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
  if (n_leaves < 1 || (n_leaves & (n_leaves - 1)) || n_rays > INT_MAX / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const rt::Tables tb{static_cast<const float*>(nodes),
                      static_cast<const int*>(ordering), n_leaves,
                      static_cast<const float*>(inst_f),
                      static_cast<const int*>(inst_i),
                      static_cast<const float*>(tmpl)};
  rt::bvh_occlude2_kernel<<<rt::blocks_for(2 * n_rays), rt::kThreads, 0,
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
  if (n_leaves < 1 || (n_leaves & (n_leaves - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
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

// The transmissive march: dir_step 3 for a direction a lane ([R, 3]) or 0
// for one ([3]); max_t null for max_t_all on every lane.
extern "C" int rt_bvh_march(const void* origin, const void* dir, int dir_step,
                            const void* max_t, float max_t_all,
                            const void* active, const void* light,
                            const void* kt, int steps, int n_rays,
                            const void* nodes, const void* ordering,
                            int n_leaves, const void* inst_f,
                            const void* inst_i, const void* tmpl, void* rv,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_leaves < 1 || (n_leaves & (n_leaves - 1)) ||
      (dir_step != 0 && dir_step != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const rt::Tables tb{static_cast<const float*>(nodes),
                      static_cast<const int*>(ordering), n_leaves,
                      static_cast<const float*>(inst_f),
                      static_cast<const int*>(inst_i),
                      static_cast<const float*>(tmpl)};
  const rt::MarchArgs args{static_cast<const float*>(origin),
                           static_cast<const float*>(dir),
                           dir_step,
                           static_cast<const float*>(max_t),
                           max_t_all,
                           static_cast<const bool*>(active),
                           static_cast<const float*>(light),
                           static_cast<const float*>(kt),
                           steps,
                           n_rays,
                           static_cast<float*>(rv)};
  rt::bvh_cast_kernel<<<rt::blocks_for(n_rays), rt::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(args, tb);
  return static_cast<int>(cudaGetLastError());
}
