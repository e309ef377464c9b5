// Pluecker closest hit over staged or dense triangle columns (K6).
//
// Replaces the Pallas TPU kernel _mxu_kernel
// (raytracer_tpu/render/pallas_mxu.py:119).  Its plain PyTorch version is
// mxu_cast_reference in render/mxu.py, which also stages what it reads
// (make_mxu_cast's XLA-side staging): per tile of 512 rays, the K columns of
// the triangles of its candidate instances, each column 40 floats (the five
// 8-wide rows edge_a, edge_b, edge_c, plane_num, plane_den), and a column id
// (the world triangle, -1 for a dead column).  A tile whose list overflowed
// sweeps every column of the [Wp, 40] table instead (the dense fallback).
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
// What bounds it on an H100: operations.  About 100 FP32 operations per ray
// and column (75 in the dot products), 384 columns per staged tile: a
// 640x480 frame is ~12 GFLOP against ~60 MB of staged columns and rays.
//
// What this design does about it, first version: one block per tile, one
// thread per ray, the ray's 16 values in registers; the tile's columns go
// through shared memory kMxuCols at a time, and every thread of the block
// reads the same column at the same step, as 16-byte broadcast loads (10 per
// column), so the FP32 pipes and not the loads set the pace.  The first
// minimum in column order wins (strict <), which is the JAX kernel's colmin
// pick within a block and its ct < bt merge across chunks.  A split of the
// products over the tensor cores (3xTF32) is left for later work.

#include <cuda_runtime.h>

namespace rt {

constexpr int kMxuCols = 64;    // columns in shared memory per step
constexpr int kMxuWidth = 40;   // floats per column: 5 rows of 8
constexpr int kMxuQuads = kMxuWidth / 4;
constexpr int kMxuMaxTile = 512;  // the 4 x 128-ray tile of the JAX kernel
constexpr float kThreshold = 1e-5f;
constexpr float kBaryTol = 1e-5f;

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

__global__ void __launch_bounds__(kMxuMaxTile)
mxu_cast_kernel(const int* __restrict__ info, const float* __restrict__ table,
                int n_tris, int wp, const float* __restrict__ staged,
                const float* __restrict__ ids, int k_cols,
                const float* __restrict__ rd6, const float* __restrict__ rp8,
                float* __restrict__ t_out, float* __restrict__ id_out,
                float* __restrict__ u_out, float* __restrict__ v_out) {
  __shared__ float4 cols[kMxuCols * kMxuQuads];
  __shared__ float col_id[kMxuCols];
  const int tile = blockDim.x;
  const int t = blockIdx.x;
  const int r = t * tile + threadIdx.x;
  const bool overflow = info[2 * t + 1] > 0;

  float a[8], p[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    a[k] = rd6[8 * r + k];  // [d, o x d, 0, 0]
    p[k] = rp8[8 * r + k];  // [o, d, 1, 0]
  }
  float bt = __int_as_float(0x7f800000), bi = 0.0f, bu = 0.0f, bv = 0.0f;

  const float* src =
      overflow ? table : staged + static_cast<size_t>(t) * k_cols * kMxuWidth;
  const int n_cols = overflow ? wp : k_cols;
  for (int c0 = 0; c0 < n_cols; c0 += kMxuCols) {
    __syncthreads();  // the previous step's columns are read
    const float4* s4 = reinterpret_cast<const float4*>(
        src + static_cast<size_t>(c0) * kMxuWidth);
    for (int q = threadIdx.x; q < kMxuCols * kMxuQuads; q += tile)
      cols[q] = s4[q];
    for (int q = threadIdx.x; q < kMxuCols; q += tile) {
      const int c = c0 + q;
      col_id[q] = overflow
                      ? (c < n_tris ? static_cast<float>(c) : -1.0f)
                      : ids[static_cast<size_t>(t) * k_cols + c];
    }
    __syncthreads();
    for (int c = 0; c < kMxuCols; ++c) {
      const float4* col = cols + c * kMxuQuads;
      const float wa = dot8(a, col[0], col[1]);
      const float wb = dot8(a, col[2], col[3]);
      const float wc = dot8(a, col[4], col[5]);
      const float num = dot8(p, col[6], col[7]);
      const float den = dot8(p, col[8], col[9]);
      const float s = wa + wb + wc;
      const bool s_ok = fabsf(s) > 1e-30f;
      const float inv_s = 1.0f / (s_ok ? s : 1.0f);
      const float ba = wa * inv_s;
      const float bb = wb * inv_s;
      const float bc = wc * inv_s;
      const bool inside = ba >= -kBaryTol && bb >= -kBaryTol &&
                          bc >= -kBaryTol;
      const bool den_ok = fabsf(den) >= kThreshold;
      const float tt = num / (den_ok ? den : 1.0f);
      const float id = col_id[c];
      const bool valid = inside && den_ok && s_ok && tt >= kThreshold &&
                         id >= 0.0f;
      if (valid && tt < bt) {
        bt = tt;
        bi = id;
        bu = bb;
        bv = bc;
      }
    }
  }
  t_out[r] = bt;
  id_out[r] = bi;
  u_out[r] = bu;
  v_out[r] = bv;
}

}  // namespace rt

// Plain C entry point for ctypes: one block per tile (blockDim = tile rays,
// n_rays a whole number of tiles), on the given stream; allocates nothing;
// returns cudaGetLastError().  k_cols and wp are multiples of kMxuCols.

extern "C" int rt_mxu_cast(const void* info, const void* table, int n_tris,
                           int wp, const void* staged, const void* ids,
                           int k_cols, const void* rd6, const void* rp8,
                           int n_rays, int tile, void* t, void* id, void* u,
                           void* v, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tile <= 0 || tile > rt::kMxuMaxTile || n_rays % tile ||
      k_cols % rt::kMxuCols || wp % rt::kMxuCols)
    return static_cast<int>(cudaErrorInvalidValue);
  rt::mxu_cast_kernel<<<n_rays / tile, tile, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(info), static_cast<const float*>(table),
      n_tris, wp, static_cast<const float*>(staged),
      static_cast<const float*>(ids), k_cols,
      static_cast<const float*>(rd6), static_cast<const float*>(rp8),
      static_cast<float*>(t), static_cast<float*>(id),
      static_cast<float*>(u), static_cast<float*>(v));
  return static_cast<int>(cudaGetLastError());
}
