// G2 keff_boundary: the boundary corrections and the envelope around the
// interior stencil K4, which together give the effective-stiffness matvec
// of a homogeneous structured hex8 grid on the slender route,
//
//   out = bc ? x : ss * (interior - corr) + mf * mass * xs,
//   corr[b][n] = sum_d sum_c G[cls(n)][d][b][c] * xs[c][n + d],
//
// with xs = bc ? 0 : x and interior = K4(xs).  No Pallas kernel: it stands
// for the XLA code the reference runs around interior_stencil_pallas
// (civiwave_tpu/ops/structured.py:449-471, the face/edge/corner
// corrections of _apply_homogeneous_stiffness, and :607-609, scale, mass
// term and identity rows), as one pass with one thread per node.  The
// reference subtracts inclusion-exclusion face, edge and corner stencils;
// here G = interior - class_stencil_table[cls] (ops/structured.py
// ghost_stencil_table, 26 KB, read through the read-only cache) holds each
// boundary class's ghost taps, so corr agrees with the reference to
// rounding, not bit for bit.  The interior class (13) has no ghost taps and
// skips the neighbour loop.  The lumped mass is synthesized from m8 and the
// node's class, bit-equal to the stored grid; constrained outputs are
// written by select (+-0.0 kept).  ss, mf and m8 are launch arguments.
//
// Bound on the H100: device memory.  Per matvec it must read interior
// (12 B/node), x (12) and the mask (3) and write out (12): 39 B/node,
// 0.028 ms for the 1024x48x48 soil column at 3.35 TB/s.  On a slender grid
// nearly every warp holds a boundary node (z = 0 or z = nz), so the
// neighbour loop runs in most warps for a few threads; compacting the
// boundary nodes is later work.
#include "structured.cuh"

namespace {

constexpr int kInteriorClass = 13;  // class (1, 1, 1)

__global__ void __launch_bounds__(256) keff_boundary_kernel(
    const float* __restrict__ interior, const float* __restrict__ x,
    const uint8_t* __restrict__ bc, const float* __restrict__ ghost,
    float* __restrict__ out, int X, int Y, int Z, int nx, int ny, int nz,
    float ss, float mf, float m8) {
  const int64_t comp = static_cast<int64_t>(X) * Y * Z;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n0 >= comp) return;
  const int iz = static_cast<int>(n0 % Z);
  const int64_t row = n0 / Z;
  const int iy = static_cast<int>(row % Y);
  const int ix = static_cast<int>(row / Y);
  const int cx = civi::node_class(ix, nx);
  const int cy = civi::node_class(iy, ny);
  const int cz = civi::node_class(iz, nz);
  const int cls = (cx * 3 + cy) * 3 + cz;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  if (cls != kInteriorClass) {
    const float* tab = ghost + cls * 27 * 9;
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
          c0 += __ldg(k + 0) * v0 + __ldg(k + 1) * v1 + __ldg(k + 2) * v2;
          c1 += __ldg(k + 3) * v0 + __ldg(k + 4) * v1 + __ldg(k + 5) * v2;
          c2 += __ldg(k + 6) * v0 + __ldg(k + 7) * v1 + __ldg(k + 8) * v2;
        }
      }
    }
  }
  const float mass = m8 * civi::class_weight(cx) * civi::class_weight(cy) *
                     civi::class_weight(cz);
  const float mm = mf * mass;
  const float corr[3] = {c0, c1, c2};
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    const int64_t nb = n0 + b * comp;
    const float xb = x[nb];
    // identity row by select: a constrained output is the input itself
    out[nb] = bc[nb] ? xb : ss * (interior[nb] - corr[b]) + mm * xb;
  }
}

}  // namespace

extern "C" int civi_keff_boundary(const float* interior, const float* x,
                                  const unsigned char* bc, const float* ghost,
                                  float* out, int X, int Y, int Z, int nx,
                                  int ny, int nz, float ss, float mf, float m8,
                                  void* stream) {
  if (X <= 0 || Y <= 0 || Z <= 0) return 0;
  const int64_t nodes = static_cast<int64_t>(X) * Y * Z;
  const unsigned blocks = static_cast<unsigned>((nodes + 255) / 256);
  keff_boundary_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      interior, x, bc, ghost, out, X, Y, Z, nx, ny, nz, ss, mf, m8);
  return static_cast<int>(cudaGetLastError());
}
