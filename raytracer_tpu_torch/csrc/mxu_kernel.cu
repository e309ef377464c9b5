// Pluecker closest hit over listed or dense triangle columns (K6).
//
// Replaces the Pallas TPU kernel _mxu_kernel
// (raytracer_tpu/render/pallas_mxu.py:119).  Its plain PyTorch version is
// mxu_cast_reference in render/mxu.py.  Per tile of 512 rays the staging
// (stage_mxu) lists the columns of the tile's candidate instances: ids
// [T, K], the world triangle of each column, -1 for a dead one; the live
// ones lie within the first info[t, 0] * max_tris positions.  A column is a
// row of the [Wp, 40] table: the five 8-wide rows edge_a, edge_b, edge_c,
// plane_num, plane_den.  A tile whose list overflowed sweeps the n_tris
// triangles of the table instead (the dense fallback).
//
// Per ray and column: five 8-term dot products (the bilinear Pluecker edge
// weights of [d, o x d] against the three edges, the plane numerator and
// denominator of [o, d, 1] against the unit plane), the barycentric signs
// against BARY_TOL, and the hit time.  The TPU does the products as
// [tile, 8] @ [8, K] matmuls at full FP32; here they are FP32 multiplies and
// adds on the CUDA cores, each rounded once (-fmad=false), in the order the
// plain version writes them out.  Hopper's tensor cores take TF32 at best,
// which would move hit/miss decisions at triangle edges.
//
// What bounds it on an H100: operations.  62 FP32 operations per ray and
// live column that a zero-free count charges (45 in the dot products); a
// 640x480 frame of terrain6 is ~1.45 GFLOP over ~46,000 live columns, against
// ~25 MB of rays, ids and outputs and a 430 KB table that stays in L2.
// Without FMA the kernel's own ceiling is half of the card's 67 TFLOP/s, and
// it runs ~110 instructions per column with the zero terms and the IEEE
// divisions.
//
// What this design does about it:
//
// * Live columns only.  A block reads its part of the tile's ids, compacts
//   the live positions in order (one warp, ballots), and gathers just those
//   rows from the table into shared memory with cp.async, kMxuCols at a time
//   in a ring of two, so the next columns arrive while these are computed.
//   No [T, K, 40] copy of the columns exists in device memory.  A sky tile
//   writes its misses and leaves.
// * Every tile's positions (the list's first info[t, 0] * max_tris, or the
//   n_tris of the dense sweep) are cut into up to kMxuSplit chunks of at
//   least kMxuCols positions (terrain6's 2,448 triangles: 39 chunks of 64),
//   so a dense tile runs on many SMs, not on one.  Most tiles have one chunk
//   or none (sky), and a grid of kMxuSplit blocks a tile would be blocks
//   that leave at once (with 16 a tile: 57,000 of them at 1080p, 0.16 ms).
//   So the first launch, a block a tile, writes the misses of the sky tiles
//   and lists the chunks of the others; the second launch is two blocks an
//   SM that take (tile, chunk) items off that list until it is empty.  The
//   items are of about one size, so the card stays even to the end.
// * One thread per ray, the ray's 16 values in registers; every thread of
//   the block reads the same column at the same step, as 16-byte broadcast
//   loads (10 per ~110 FP32 instructions), so the FP32 pipes set the pace.
//   The hit time's division is taken only where the barycentric and plane
//   tests passed (the quotient is used nowhere else).
// * The first minimum in column order wins, as the JAX kernel's colmin pick
//   and ct < bt merge.  Inside a chunk that is a strict < scan.  Across the
//   chunks of a tile, which finish in any order, it is an atomicMin on a
//   64-bit key per ray, (bits of t) << 32 | position: a valid t is >= 1e-5 >
//   0, so its bits order as the floats do, and equal t fall to the lower
//   position.  Integer atomics only: the result does not depend on the order
//   of arrival.  A last small kernel then recomputes u and v of the winning
//   column with the same arithmetic (mxu_resolve_kernel).  Partials in a
//   scratch tensor scanned in chunk order would need [chunks, R, 4] floats,
//   1.3 GB at 1080p, for tiles that are mostly single-chunk; the keys are 8
//   bytes a ray.  A tile of one chunk writes its outputs directly and takes
//   no part in the last pass.
//
// A split of the products over the tensor cores (3xTF32) is left for later
// work.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace rt {

constexpr int kMxuCols = 64;    // columns in shared memory per ring slot
constexpr int kMxuWidth = 40;   // floats per column: 5 rows of 8
constexpr int kMxuQuads = kMxuWidth / 4;
constexpr int kMxuMaxTile = 512;  // the 4 x 128-ray tile of the JAX kernel
constexpr int kMxuSplit = 40;   // chunks a tile's positions are cut into
constexpr float kThreshold = 1e-5f;
constexpr float kBaryTol = 1e-5f;
constexpr unsigned long long kMissKey = ~0ull;  // what the memset leaves

// acc = x0 y0 + x1 y1 + ... + x7 y7, left to right, each step rounded once
__device__ __forceinline__ float dot8(const float x[8], float4 y0,
                                      float4 y1) {
  float acc = x[0] * y0.x;
  acc = acc + x[1] * y0.y;
  acc = acc + x[2] * y0.z;
  acc = acc + x[3] * y0.w;
  acc = acc + x[4] * y1.x;
  acc = acc + x[5] * y1.y;
  acc = acc + x[6] * y1.z;
  acc = acc + x[7] * y1.w;
  return acc;
}

struct ColumnHit {
  bool ok;  // every test but the hit time's passed
  float num, den, bb, bc;
};

// One ray against one column (ten float4: the five rows).
__device__ __forceinline__ ColumnHit column_test(const float a[8],
                                                 const float p[8],
                                                 const float4* col) {
  const float wa = dot8(a, col[0], col[1]);
  const float wb = dot8(a, col[2], col[3]);
  const float wc = dot8(a, col[4], col[5]);
  ColumnHit h;
  h.num = dot8(p, col[6], col[7]);
  h.den = dot8(p, col[8], col[9]);
  const float s = wa + wb + wc;
  const bool s_ok = fabsf(s) > 1e-30f;
  const float inv_s = 1.0f / (s_ok ? s : 1.0f);
  const float ba = wa * inv_s;
  h.bb = wb * inv_s;
  h.bc = wc * inv_s;
  const bool inside = ba >= -kBaryTol && h.bb >= -kBaryTol &&
                      h.bc >= -kBaryTol;
  h.ok = inside && fabsf(h.den) >= kThreshold && s_ok;
  return h;
}

// The positions of tile t (listed: the slots the list fills; dense: the
// table's triangles) and how they are cut: per positions a chunk.
struct TileCut {
  bool dense;
  int limit;  // positions
  int per;    // positions per chunk, >= kMxuCols
  int chunks;
};

__device__ __forceinline__ TileCut tile_cut(const int* __restrict__ info,
                                            int t, int n_tris, int k_cols,
                                            int max_tris, int split) {
  TileCut c;
  c.dense = info[2 * t + 1] > 0;
  c.limit = c.dense ? n_tris : min(info[2 * t] * max_tris, k_cols);
  c.per = max(kMxuCols, (c.limit + split - 1) / split);
  c.chunks = (c.limit + c.per - 1) / c.per;
  return c;
}

__device__ __forceinline__ void load_ray_rows(const float* __restrict__ rd6,
                                              const float* __restrict__ rp8,
                                              int r, float a[8], float p[8]) {
  const float4* a4 = reinterpret_cast<const float4*>(rd6 + 8 * r);
  const float4* p4 = reinterpret_cast<const float4*>(rp8 + 8 * r);
  const float4 a0 = a4[0], a1 = a4[1], p0 = p4[0], p1 = p4[1];
  a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;  // [d, o x d, 0, 0]
  a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
  p[0] = p0.x; p[1] = p0.y; p[2] = p0.z; p[3] = p0.w;  // [o, d, 1, 0]
  p[4] = p1.x; p[5] = p1.y; p[6] = p1.z; p[7] = p1.w;
}

struct MxuArgs {
  const int* __restrict__ info;     // [T, 2]
  const float* __restrict__ table;  // [Wp, 40]
  int n_tris;
  const float* __restrict__ ids;    // [T, k_cols]
  int k_cols, max_tris, split;
  const float* __restrict__ rd6;    // [R, 8]
  const float* __restrict__ rp8;
  float* __restrict__ t_out;        // [R] each
  float* __restrict__ id_out;
  float* __restrict__ u_out;
  float* __restrict__ v_out;
  unsigned long long* __restrict__ keys;  // [R]
  // [2 + 2 * T * split]: work items so far, next item to take, then the
  // items, (tile, chunk) pairs
  int* __restrict__ work;
  // null, or per block of the first and the second launch its start and its
  // end, %globaltimer ns
  unsigned long long* __restrict__ stamps;
};

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  return now;
}

// Chunk y of tile t, by the whole block (blockDim = tile rays): its outputs
// where the tile has at most this chunk, else its keys.  Dynamic shared memory:
// the chunk's live positions and their table rows, 2 * max(kMxuCols,
// ceil(k_cols / split)) ints.
__device__ __forceinline__ void run_chunk(const MxuArgs& g, int t, int y,
                                          const TileCut& cut) {
  __shared__ float4 ring[2][kMxuCols * kMxuQuads];
  __shared__ int n_live_s;
  extern __shared__ int lists[];

  const int tile = blockDim.x;
  const int r = t * tile + threadIdx.x;
  const int begin = y * cut.per;
  const int end = min(cut.limit, begin + cut.per);
  // the live positions of [begin, end), in order
  int* pos_s = lists;
  int* row_s = lists + max(kMxuCols, (g.k_cols + g.split - 1) / g.split);
  int n_live = max(end - begin, 0);
  if (!cut.dense) {
    if (threadIdx.x < 32) {
      int base = 0;
      for (int c0 = begin; c0 < end; c0 += 32) {
        const int c = c0 + threadIdx.x;
        const float id =
            c < end ? g.ids[static_cast<size_t>(t) * g.k_cols + c] : -1.0f;
        const unsigned live = __ballot_sync(0xffffffffu, id >= 0.0f);
        if (id >= 0.0f) {
          const int slot = base + __popc(live & ((1u << threadIdx.x) - 1u));
          pos_s[slot] = c;
          row_s[slot] = static_cast<int>(id);
        }
        base += __popc(live);
      }
      if (threadIdx.x == 0) n_live_s = base;
    }
    __syncthreads();
    n_live = n_live_s;
  }

  float bt = __int_as_float(0x7f800000), bb = 0.0f, bc = 0.0f;
  int bpos = 0, brow = 0;
  if (n_live > 0) {  // a sky tile reads no ray
    float a[8], p[8];
    load_ray_rows(g.rd6, g.rp8, r, a, p);

    // columns [j0, j0 + kMxuCols) of the live ones into ring slot s
    auto fetch = [&](int j0, int s) {
      const int n = min(kMxuCols, n_live - j0) * kMxuQuads;
      for (int q = threadIdx.x; q < n; q += tile) {
        const int j = j0 + q / kMxuQuads;
        const int row = cut.dense ? begin + j : row_s[j];
        __pipeline_memcpy_async(&ring[s][q],
                                g.table + static_cast<size_t>(row) * kMxuWidth +
                                    4 * (q % kMxuQuads),
                                sizeof(float4));
      }
      __pipeline_commit();
    };

    fetch(0, 0);
    for (int j0 = 0, s = 0; j0 < n_live; j0 += kMxuCols, s ^= 1) {
      if (j0 + kMxuCols < n_live) {
        fetch(j0 + kMxuCols, s ^ 1);
        __pipeline_wait_prior(1);  // all but the newest: slot s has landed
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();  // every thread's part of slot s
      const int n = min(kMxuCols, n_live - j0);
      for (int c = 0; c < n; ++c) {
        const ColumnHit h = column_test(a, p, ring[s] + c * kMxuQuads);
        if (h.ok) {
          const float tt = h.num / h.den;
          if (tt >= kThreshold && tt < bt) {
            bt = tt;
            bb = h.bb;
            bc = h.bc;
            bpos = cut.dense ? begin + j0 + c : pos_s[j0 + c];
            brow = cut.dense ? bpos : row_s[j0 + c];
          }
        }
      }
      __syncthreads();  // slot s is read before the fetch after next refills it
    }
  }

  const bool hit = bt < __int_as_float(0x7f800000);
  if (cut.chunks <= 1) {
    g.t_out[r] = bt;
    g.id_out[r] = hit ? static_cast<float>(brow) : 0.0f;
    g.u_out[r] = bb;
    g.v_out[r] = bc;
  } else if (hit) {
    atomicMin(g.keys + r,
              (static_cast<unsigned long long>(__float_as_uint(bt)) << 32) |
                  static_cast<unsigned>(bpos));
  }
}

// The first launch, grid T: a sky tile writes its misses; the chunks of any
// other tile are put on the work list.
__global__ void __launch_bounds__(kMxuMaxTile, 2)
mxu_tiles_kernel(MxuArgs g) {
  __shared__ int base_s;
  const unsigned long long start = g.stamps ? now_ns() : 0;
  const int t = blockIdx.x;
  const TileCut cut =
      tile_cut(g.info, t, g.n_tris, g.k_cols, g.max_tris, g.split);
  if (cut.chunks == 0) {
    run_chunk(g, t, 0, cut);
  } else {
    if (threadIdx.x == 0) base_s = atomicAdd(g.work, cut.chunks);
    __syncthreads();
    for (int y = threadIdx.x; y < cut.chunks; y += blockDim.x) {
      g.work[2 + 2 * (base_s + y)] = t;
      g.work[3 + 2 * (base_s + y)] = y;
    }
  }
  if (g.stamps != nullptr && threadIdx.x == 0) {
    g.stamps[2 * blockIdx.x] = start;
    g.stamps[2 * blockIdx.x + 1] = now_ns();
  }
}

// The second launch, a fixed number of blocks (two an SM): each takes the
// next work item, chunk y of tile t, until none is left.  Which block takes
// which item, and the order of the list, change from run to run; the keys
// do not care.
__global__ void __launch_bounds__(kMxuMaxTile, 2)
mxu_chunks_kernel(MxuArgs g, int stamp_base) {
  __shared__ int item_s;
  const unsigned long long start = g.stamps ? now_ns() : 0;
  const int n_items = g.work[0];
  for (;;) {
    if (threadIdx.x == 0) item_s = atomicAdd(g.work + 1, 1);
    __syncthreads();
    const int item = item_s;
    __syncthreads();  // read before the next round writes it
    if (item >= n_items) break;
    const int t = g.work[2 + 2 * item];
    run_chunk(g, t, g.work[3 + 2 * item],
              tile_cut(g.info, t, g.n_tris, g.k_cols, g.max_tris, g.split));
  }
  if (g.stamps != nullptr && threadIdx.x == 0) {
    g.stamps[2 * (stamp_base + blockIdx.x)] = start;
    g.stamps[2 * (stamp_base + blockIdx.x) + 1] = now_ns();
  }
}

// The last launch, grid T: the rays of a tile that was cut into several
// chunks read their key and recompute the winning column.
__global__ void __launch_bounds__(kMxuMaxTile)
mxu_resolve_kernel(const int* __restrict__ info,
                   const float* __restrict__ table, int n_tris,
                   const float* __restrict__ ids, int k_cols, int max_tris,
                   int split, const float* __restrict__ rd6,
                   const float* __restrict__ rp8,
                   const unsigned long long* __restrict__ keys,
                   float* __restrict__ t_out, float* __restrict__ id_out,
                   float* __restrict__ u_out, float* __restrict__ v_out) {
  const int t = blockIdx.x;
  const TileCut cut = tile_cut(info, t, n_tris, k_cols, max_tris, split);
  if (cut.chunks <= 1) return;
  const int r = t * blockDim.x + threadIdx.x;
  const unsigned long long key = keys[r];
  float bt = __int_as_float(0x7f800000), bi = 0.0f, bb = 0.0f, bc = 0.0f;
  if (key != kMissKey) {
    const int pos = static_cast<int>(key & 0xffffffffull);
    const int row =
        cut.dense ? pos
                  : static_cast<int>(ids[static_cast<size_t>(t) * k_cols + pos]);
    float a[8], p[8];
    load_ray_rows(rd6, rp8, r, a, p);
    float4 col[kMxuQuads];
    const float4* src = reinterpret_cast<const float4*>(
        table + static_cast<size_t>(row) * kMxuWidth);
#pragma unroll
    for (int q = 0; q < kMxuQuads; ++q) col[q] = src[q];
    const ColumnHit h = column_test(a, p, col);
    bt = __uint_as_float(static_cast<unsigned>(key >> 32));
    bi = static_cast<float>(row);
    bb = h.bb;
    bc = h.bc;
  }
  t_out[r] = bt;
  id_out[r] = bi;
  u_out[r] = bb;
  v_out[r] = bc;
}

}  // namespace rt

// Plain C entry points for ctypes.  rt_mxu_cast runs the three launches on
// the given stream (blockDim = tile rays, n_rays a whole number of tiles);
// allocates nothing; returns cudaGetLastError().  Scratch, filled here:
// keys, n_rays 64-bit words; work, 2 + 2 * T * rt_mxu_split() ints.  stamps: null, or 2 * (T +
// rt_mxu_workers(device)) 64-bit words for the start and end in ns of each
// block of the first two launches.

extern "C" int rt_mxu_split() { return rt::kMxuSplit; }

extern "C" int rt_mxu_workers(int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return 0;
  return 2 * sms;
}

extern "C" int rt_mxu_cast(const void* info, const void* table, int n_tris,
                           const void* ids, int k_cols, int max_tris,
                           const void* rd6, const void* rp8, int n_rays,
                           int tile, void* t, void* id, void* u, void* v,
                           void* keys, void* work, void* stamps, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tile <= 0 || tile > rt::kMxuMaxTile || tile % 32 || n_rays % tile ||
      k_cols <= 0 || max_tris <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int split = rt::kMxuSplit;
  const int per = k_cols / split + (k_cols % split ? 1 : 0);
  const size_t lists = 2 * sizeof(int) *
                       static_cast<size_t>(per > rt::kMxuCols ? per
                                                              : rt::kMxuCols);
  const int workers = rt_mxu_workers(device);
  if (lists > 24 * 1024 || workers <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = n_rays / tile;
  err = cudaMemsetAsync(keys, 0xff, sizeof(unsigned long long) * n_rays, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(work, 0, 2 * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const rt::MxuArgs g{
      static_cast<const int*>(info), static_cast<const float*>(table), n_tris,
      static_cast<const float*>(ids), k_cols, max_tris, split,
      static_cast<const float*>(rd6), static_cast<const float*>(rp8),
      static_cast<float*>(t), static_cast<float*>(id), static_cast<float*>(u),
      static_cast<float*>(v), static_cast<unsigned long long*>(keys),
      static_cast<int*>(work), static_cast<unsigned long long*>(stamps)};
  rt::mxu_tiles_kernel<<<n_tiles, tile, lists, s>>>(g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rt::mxu_chunks_kernel<<<workers, tile, lists, s>>>(g, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rt::mxu_resolve_kernel<<<n_tiles, tile, 0, s>>>(
      g.info, g.table, n_tris, g.ids, k_cols, max_tris, split, g.rd6, g.rp8,
      g.keys, g.t_out, g.id_out, g.u_out, g.v_out);
  return static_cast<int>(cudaGetLastError());
}
