// K3 block_jacobi_apply: z = M^-1 r from the (6, 3, 3, 3) block-Jacobi
// class table of a homogeneous structured grid, z = +0.0 (by select) on
// constrained components.
//
// Replaces the Pallas TPU kernel apply_block_jacobi_pallas
// (civiwave_tpu/ops/pallas/block_jacobi_apply.py:144, pallas_call at :170),
// which streams B-plane slabs through VMEM, paints the x-interior class
// everywhere and repaints the boundary rows, columns and x-face planes.
// Here the op is pointwise: each thread takes one node, picks its 6
// coefficients by its per-axis boundary class (civi::block_jacobi_node,
// shared with K2) and writes the symmetric 3x3 product.
//
// f64 instance (civi_block_jacobi_apply_f64, precision.vectors: fp64,
// where the reference runs its XLA form): r and z double, the f32 table
// widened per node, as the plain form multiplies f32 coefficient grids
// into f64 residuals; ~0.86 GB at 255^3 (8 B per value, the mask).
//
// A shard of a multi-device decomposition passes its global node offsets
// (x0, y0): a node's class is taken at its global coordinate, so the same
// table serves every slab or tile (0, 0 on an unsharded grid).
//
// Bound on the H100: device memory — r in (12 B/node), the mask (3 B/node),
// z out (12 B/node): ~0.45 GB at 255^3 cells.  The 648-byte table stays in
// the read-only cache.  Nothing to reuse across nodes, so the simple
// one-pass form is already the memory-bound design.
#include "structured.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256) block_jacobi_apply_kernel(
    const float* __restrict__ table, const T* __restrict__ r,
    const uint8_t* __restrict__ bc, T* __restrict__ z, int X, int Y, int Z,
    int nx, int ny, int nz, int x0, int y0) {
  const int row = blockIdx.x;  // x * Y + y
  const int ix = row / Y;
  const int iy = row - ix * Y;
  const int64_t comp = static_cast<int64_t>(X) * Y * Z;
  const int cxy =
      (civi::node_class(x0 + ix, nx) * 3 + civi::node_class(y0 + iy, ny)) * 3;
  for (int iz = threadIdx.x; iz < Z; iz += blockDim.x) {
    const int64_t n0 = static_cast<int64_t>(row) * Z + iz;
    T z0, z1, z2;
    civi::block_jacobi_node(table, cxy + civi::node_class(iz, nz), r[n0],
                            r[n0 + comp], r[n0 + 2 * comp], z0, z1, z2);
    z[n0] = bc[n0] ? T(0) : z0;
    z[n0 + comp] = bc[n0 + comp] ? T(0) : z1;
    z[n0 + 2 * comp] = bc[n0 + 2 * comp] ? T(0) : z2;
  }
}

template <typename T>
int launch(const float* table, const T* r, const unsigned char* bc, T* z,
           int X, int Y, int Z, int nx, int ny, int nz, int x0, int y0,
           void* stream) {
  if (X <= 0 || Y <= 0 || Z <= 0) return 0;
  block_jacobi_apply_kernel<T><<<static_cast<unsigned>(X * Y),
                                 civi::row_threads(Z), 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      table, r, bc, z, X, Y, Z, nx, ny, nz, x0, y0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int civi_block_jacobi_apply(const float* table, const float* r,
                                       const unsigned char* bc, float* z,
                                       int X, int Y, int Z, int nx, int ny,
                                       int nz, int x0, int y0, void* stream) {
  return launch<float>(table, r, bc, z, X, Y, Z, nx, ny, nz, x0, y0, stream);
}

extern "C" int civi_block_jacobi_apply_f64(const float* table,
                                           const double* r,
                                           const unsigned char* bc, double* z,
                                           int X, int Y, int Z, int nx, int ny,
                                           int nz, int x0, int y0,
                                           void* stream) {
  return launch<double>(table, r, bc, z, X, Y, Z, nx, ny, nz, x0, y0, stream);
}
