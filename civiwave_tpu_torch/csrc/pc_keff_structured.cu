// K2 pc_keff_structured: one launch computes
//
//   u = M^-1 r              (block-Jacobi class table, +0.0 on constrained)
//   w = bc ? u : ss * K(u) + mf * mass * u
//
// and, when `partials` is not null, the per-(x, y)-row f32 partials of
// (r, u), (r, r) and (w, u), each reduced over z and the 3 components, into
// partials[3][X * Y] (the caller sums them in f64).
//
// Replaces the Pallas TPU kernel apply_pc_keff_fused_pallas
// (civiwave_tpu/ops/pallas/structured_stencil.py:820, pallas_call at :895),
// which transforms delivered residual planes to u in VMEM and feeds its
// rolling plane window.  Here u = M^-1 r is pointwise, so each thread
// recomputes u at its 27 neighbours from r with the K3 device function
// (civi::block_jacobi_node) instead of passing u through device memory
// between two kernels, then applies its per-boundary-class stencil exactly
// as K1 does.  The row partials replace the TPU kernel's (X, 2, Y) and
// (X, 1, Y) lane sums; one block owns one row, so no atomics are needed and
// the sums are deterministic.
//
// Bound on the H100: device memory in principle — r and the mask in
// (15 B/node), u and w out (24 B/node): ~0.65 GB at 255^3 cells.  The 27-fold
// recompute of u adds ~27 x 15 FMAs per node (~7 GFLOP at 255^3), far below
// the card's f32 rate; neighbour reuse is left to L1/L2 in this first
// version.
#include "structured.cuh"

namespace {

__global__ void __launch_bounds__(256) pc_keff_structured_kernel(
    const float* __restrict__ pc_table, const float* __restrict__ stencil,
    const float* __restrict__ r, const uint8_t* __restrict__ bc,
    float* __restrict__ u, float* __restrict__ w, float* __restrict__ partials,
    int X, int Y, int Z, int nx, int ny, int nz, float ss, float mf, float m8) {
  const int row = blockIdx.x;  // x * Y + y
  const int ix = row / Y;
  const int iy = row - ix * Y;
  const int64_t comp = static_cast<int64_t>(X) * Y * Z;
  const int cx = civi::node_class(ix, nx);
  const int cy = civi::node_class(iy, ny);
  float ru = 0.0f, rr = 0.0f, wu = 0.0f;
  for (int iz = threadIdx.x; iz < Z; iz += blockDim.x) {
    const int cz = civi::node_class(iz, nz);
    const float* tab = stencil + ((cx * 3 + cy) * 3 + cz) * 27 * 9;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
    float uc0 = 0.0f, uc1 = 0.0f, uc2 = 0.0f;
    for (int dx = -1; dx <= 1; ++dx) {
      const int jx = ix + dx;
      if (jx < 0 || jx >= X) continue;
      const int cjx = civi::node_class(jx, nx);
      for (int dy = -1; dy <= 1; ++dy) {
        const int jy = iy + dy;
        if (jy < 0 || jy >= Y) continue;
        const int cjxy = (cjx * 3 + civi::node_class(jy, ny)) * 3;
        for (int dz = -1; dz <= 1; ++dz) {
          const int jz = iz + dz;
          if (jz < 0 || jz >= Z) continue;
          const int64_t n = (static_cast<int64_t>(jx) * Y + jy) * Z + jz;
          float q0, q1, q2;
          civi::block_jacobi_node(pc_table, cjxy + civi::node_class(jz, nz),
                                  r[n], r[n + comp], r[n + 2 * comp], q0, q1,
                                  q2);
          // select, not multiply: a constrained component is +0.0
          q0 = bc[n] ? 0.0f : q0;
          q1 = bc[n + comp] ? 0.0f : q1;
          q2 = bc[n + 2 * comp] ? 0.0f : q2;
          if (dx == 0 && dy == 0 && dz == 0) {
            uc0 = q0;
            uc1 = q1;
            uc2 = q2;
          }
          const float* k = tab + (((dx + 1) * 3 + (dy + 1)) * 3 + (dz + 1)) * 9;
          a0 += __ldg(k + 0) * q0 + __ldg(k + 1) * q1 + __ldg(k + 2) * q2;
          a1 += __ldg(k + 3) * q0 + __ldg(k + 4) * q1 + __ldg(k + 5) * q2;
          a2 += __ldg(k + 6) * q0 + __ldg(k + 7) * q1 + __ldg(k + 8) * q2;
        }
      }
    }
    const int64_t n0 = static_cast<int64_t>(row) * Z + iz;
    const float mass = m8 * civi::class_weight(cx) * civi::class_weight(cy) *
                       civi::class_weight(cz);
    const float mm = mf * mass;
    const float acc[3] = {a0, a1, a2};
    const float uc[3] = {uc0, uc1, uc2};
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const int64_t nb = n0 + b * comp;
      // identity row: the operator input u is already +0.0 there
      const float wb = bc[nb] ? uc[b] : ss * acc[b] + mm * uc[b];
      u[nb] = uc[b];
      w[nb] = wb;
      if (partials != nullptr) {
        const float rb = r[nb];
        ru += rb * uc[b];
        rr += rb * rb;
        wu += wb * uc[b];
      }
    }
  }
  if (partials == nullptr) return;  // uniform across the block
  civi::store_row_sums3(ru, rr, wu, partials, static_cast<int64_t>(X) * Y,
                        row);
}

}  // namespace

extern "C" int civi_pc_keff_structured(
    const float* pc_table, const float* stencil, const float* r,
    const unsigned char* bc, float* u, float* w, float* partials, int X, int Y,
    int Z, int nx, int ny, int nz, float ss, float mf, float m8,
    void* stream) {
  if (X <= 0 || Y <= 0 || Z <= 0) return 0;
  pc_keff_structured_kernel<<<static_cast<unsigned>(X * Y),
                              civi::row_threads(Z), 0,
                              static_cast<cudaStream_t>(stream)>>>(
      pc_table, stencil, r, bc, u, w, partials, X, Y, Z, nx, ny, nz, ss, mf,
      m8);
  return static_cast<int>(cudaGetLastError());
}
