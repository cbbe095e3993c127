// K1 keff_structured: the complete effective-stiffness matvec of a
// homogeneous structured hex8 grid,
//
//   out = bc ? x : ss * K(xs) + mf * mass * xs,    xs = bc ? 0 : x.
//
// Replaces the Pallas TPU kernel apply_keff_fused_pallas
// (civiwave_tpu/ops/pallas/structured_stencil.py:931, pallas_call at
// :1041/:1068).  That kernel streams X planes through VMEM, rolls (Y, Z)
// planes in registers and subtracts inclusion-exclusion face/edge/corner
// corrections.  None of that carries over.  Here one thread computes the 3
// components of one node: it reads its 27 neighbours (zero outside the
// grid), sanitizes them by the constraint mask and applies the node's own
// per-boundary-class stencil from a (27 classes, 27 offsets, 3, 3) f32 table
// (ops/structured.py class_stencil_table, 26 KB, read through the read-only
// cache).  The class table already holds each node's exact taps, so no
// correction pass exists.  The lumped mass is synthesized from m8 and the
// node's class.  ss, mf and m8 are launch arguments: a new dt rebuilds
// nothing.
//
// Bound on the H100: device memory.  Per matvec the kernel must read x
// (12 B/node) and the mask (3 B/node) once and write out (12 B/node):
// ~0.45 GB at 255^3 cells (16.8M nodes), ~0.13 ms at 3.35 TB/s.  The 27-fold
// neighbour reuse is left to L1/L2 in this first version (z-fastest blocks
// keep each neighbour row in cache); shared-memory 2.5-D blocking is later
// work.
#include "structured.cuh"

namespace {

__global__ void __launch_bounds__(256) keff_structured_kernel(
    const float* __restrict__ x, const uint8_t* __restrict__ bc,
    const float* __restrict__ stencil, float* __restrict__ out, int X, int Y,
    int Z, int nx, int ny, int nz, float ss, float mf, float m8) {
  const int row = blockIdx.x;  // x * Y + y
  const int ix = row / Y;
  const int iy = row - ix * Y;
  const int64_t comp = static_cast<int64_t>(X) * Y * Z;
  const int cx = civi::node_class(ix, nx);
  const int cy = civi::node_class(iy, ny);
  for (int iz = threadIdx.x; iz < Z; iz += blockDim.x) {
    const int cz = civi::node_class(iz, nz);
    const float* tab = stencil + ((cx * 3 + cy) * 3 + cz) * 27 * 9;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
    for (int dx = -1; dx <= 1; ++dx) {
      const int jx = ix + dx;
      if (jx < 0 || jx >= X) continue;
      for (int dy = -1; dy <= 1; ++dy) {
        const int jy = iy + dy;
        if (jy < 0 || jy >= Y) continue;
        for (int dz = -1; dz <= 1; ++dz) {
          const int jz = iz + dz;
          if (jz < 0 || jz >= Z) continue;
          const int64_t n = (static_cast<int64_t>(jx) * Y + jy) * Z + jz;
          const float v0 = bc[n] ? 0.0f : x[n];
          const float v1 = bc[n + comp] ? 0.0f : x[n + comp];
          const float v2 = bc[n + 2 * comp] ? 0.0f : x[n + 2 * comp];
          const float* k = tab + (((dx + 1) * 3 + (dy + 1)) * 3 + (dz + 1)) * 9;
          a0 += __ldg(k + 0) * v0 + __ldg(k + 1) * v1 + __ldg(k + 2) * v2;
          a1 += __ldg(k + 3) * v0 + __ldg(k + 4) * v1 + __ldg(k + 5) * v2;
          a2 += __ldg(k + 6) * v0 + __ldg(k + 7) * v1 + __ldg(k + 8) * v2;
        }
      }
    }
    const int64_t n0 = static_cast<int64_t>(row) * Z + iz;
    const float mass = m8 * civi::class_weight(cx) * civi::class_weight(cy) *
                       civi::class_weight(cz);
    const float mm = mf * mass;
    const float acc[3] = {a0, a1, a2};
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const int64_t nb = n0 + b * comp;
      const float xb = x[nb];
      // identity row by select: a constrained output is the input itself
      out[nb] = bc[nb] ? xb : ss * acc[b] + mm * xb;
    }
  }
}

}  // namespace

extern "C" int civi_keff_structured(const float* x, const unsigned char* bc,
                                    const float* stencil, float* out, int X,
                                    int Y, int Z, int nx, int ny, int nz,
                                    float ss, float mf, float m8,
                                    void* stream) {
  if (X <= 0 || Y <= 0 || Z <= 0) return 0;
  keff_structured_kernel<<<static_cast<unsigned>(X * Y), civi::row_threads(Z),
                           0, static_cast<cudaStream_t>(stream)>>>(
      x, bc, stencil, out, X, Y, Z, nx, ny, nz, ss, mf, m8);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* civi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
