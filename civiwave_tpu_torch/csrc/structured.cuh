// Device code shared by the structured-grid kernels (K1 keff_structured,
// K2 pc_keff_structured, K3 block_jacobi_apply).
//
// Layout: every solver vector is component-separated, (3, X, Y, Z) f32,
// row-major with Z contiguous; the Dirichlet mask is (3, X, Y, Z) bytes
// (torch.bool).  All three kernels launch one block per (x, y) row of the
// node grid and let the threads stride over z, so neighbouring threads
// touch neighbouring addresses.  Offsets into the vectors are 64-bit.
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

}  // namespace civi
