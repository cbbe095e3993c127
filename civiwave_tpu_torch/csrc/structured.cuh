// Device code shared by the structured-grid kernels (K1 and K5
// keff_structured_halo, K2 pc_keff_structured, K3 block_jacobi_apply, K4
// interior_stencil, K6 pcg_iteration_structured, G2 keff_boundary).
//
// Layout: every solver vector is component-separated, (3, X, Y, Z) f32,
// row-major with Z contiguous; the Dirichlet mask is (3, X, Y, Z) bytes
// (torch.bool).  K1/K5, K2, K3 and K6 launch one block per (x, y) row of
// the node grid and let the threads stride over z; K4 and G2 give each
// thread one node of the flat index.  Either way neighbouring threads touch
// neighbouring addresses.  Offsets into the vectors are 64-bit.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace civi {

// Boundary class of node index i along an axis of n cells: 0 on the low
// face, 2 on the high face and beyond it (the dead +X pad planes, which are
// constrained), 1 inside.  n == 1 has no interior class.
__device__ __forceinline__ int node_class(int i, int n) {
  return i == 0 ? 0 : (i >= n ? 2 : 1);
}

// Lumped-mass weight of one axis class: the stored mass is exactly
// m8 * wx * wy * wz with 0.5 per boundary axis (power-of-2 scaling, so the
// product reproduces the stored f32 grid bit for bit).
__device__ __forceinline__ float class_weight(int c) {
  return c == 1 ? 1.0f : 0.5f;
}

// a += K v for one neighbour: the 3x3 tap block k (row-major, read through
// the read-only cache) times its three sanitized components (K1/K5).
__device__ __forceinline__ void add_taps(const float* __restrict__ k, float v0,
                                         float v1, float v2, float& a0,
                                         float& a1, float& a2) {
  a0 += __ldg(k + 0) * v0 + __ldg(k + 1) * v1 + __ldg(k + 2) * v2;
  a1 += __ldg(k + 3) * v0 + __ldg(k + 4) * v1 + __ldg(k + 5) * v2;
  a2 += __ldg(k + 6) * v0 + __ldg(k + 7) * v1 + __ldg(k + 8) * v2;
}

// z = M^-1 r for one node from the (6, 3, 3, 3) block-Jacobi class table
// [m][x-class][y-class][z-class], packed components m = 00, 11, 22, 01, 02,
// 12 of the symmetric inverse; cls = (cx * 3 + cy) * 3 + cz.
__device__ __forceinline__ void block_jacobi_node(
    const float* __restrict__ table, int cls, float r0, float r1, float r2,
    float& z0, float& z1, float& z2) {
  const float c00 = __ldg(table + 0 * 27 + cls);
  const float c11 = __ldg(table + 1 * 27 + cls);
  const float c22 = __ldg(table + 2 * 27 + cls);
  const float c01 = __ldg(table + 3 * 27 + cls);
  const float c02 = __ldg(table + 4 * 27 + cls);
  const float c12 = __ldg(table + 5 * 27 + cls);
  z0 = c00 * r0 + c01 * r1 + c02 * r2;
  z1 = c01 * r0 + c11 * r1 + c12 * r2;
  z2 = c02 * r0 + c12 * r1 + c22 * r2;
}

// Threads per row block: Z rounded up to whole warps, at most 256.
inline unsigned row_threads(int z) {
  const int t = ((z + 31) / 32) * 32;
  return static_cast<unsigned>(t > 256 ? 256 : t);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sums three per-thread values over the block (at most 256 threads, whole
// warps) and has thread 0 write them to partials[k * rows + row], k = 0, 1,
// 2.  One block owns one row, so the sums need no atomics and are
// deterministic.  Every thread of the block must call it.
__device__ __forceinline__ void store_row_sums3(float s0, float s1, float s2,
                                                float* __restrict__ partials,
                                                int64_t rows, int row) {
  __shared__ float sh[3][8];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  s0 = warp_sum(s0);
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    sh[0][warp] = s0;
    sh[1][warp] = s1;
    sh[2][warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t0 = 0.0f, t1 = 0.0f, t2 = 0.0f;
    for (int i = 0; i < static_cast<int>(blockDim.x >> 5); ++i) {
      t0 += sh[0][i];
      t1 += sh[1][i];
      t2 += sh[2][i];
    }
    partials[row] = t0;
    partials[rows + row] = t1;
    partials[2 * rows + row] = t2;
  }
}

}  // namespace civi
