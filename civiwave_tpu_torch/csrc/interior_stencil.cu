// K4 interior_stencil: the interior 27-tap block stencil of a homogeneous
// structured hex8 grid, zero padded on all six sides,
//
//   out[b][n] = sum_d sum_c T[d][b][c] * xs[c][n + d],
//
// over the 27 offsets d, with xs (3, X, Y, Z) f32 already sanitized.
// Replaces the Pallas TPU kernel interior_stencil_pallas
// (civiwave_tpu/ops/pallas/structured_stencil.py:110, pallas_call at
// :127).  That kernel walks X one plane per grid step with three input
// planes in VMEM and rolls (Y, Z) vregs for the in-plane offsets, behind
// an explicit zero plane of X padding.  None of that carries over: here
// one thread computes the 3 components of one node from its in-range
// neighbours (an out-of-range neighbour reads as zero, which is the
// padding on every side, the n = 1 axes and odd sizes included).  The 243
// coefficients T[(dx*3+dy)*3+dz][b][c] travel as a kernel parameter (the
// constant bank), so every thread reads them without a memory access.  The
// boundary corrections, scale, mass and identity rows are G2's
// (keff_boundary.cu).
//
// Bound on the H100: device memory.  The kernel must read xs and write out
// once, 24 B/node, against 454 f32 operations/node (227 nonzero taps):
// 0.017 ms for the 1024x48x48 soil column, 0.120 ms at 256^3 nodes, at
// 3.35 TB/s.  Threads run over the flat node index (Z fastest, so loads
// coalesce) and leave the 27-fold neighbour reuse to L1/L2, as K1 does;
// shared-memory plane tiling is later work.
#include "structured.cuh"

namespace {

struct Taps {
  float t[243];
};

__global__ void __launch_bounds__(256) interior_stencil_kernel(
    const float* __restrict__ xs, const Taps taps, float* __restrict__ out,
    int X, int Y, int Z) {
  const int64_t comp = static_cast<int64_t>(X) * Y * Z;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n0 >= comp) return;
  const int iz = static_cast<int>(n0 % Z);
  const int64_t row = n0 / Z;
  const int iy = static_cast<int>(row % Y);
  const int ix = static_cast<int>(row / Y);
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
#pragma unroll
  for (int dx = -1; dx <= 1; ++dx) {
    const bool okx = ix + dx >= 0 && ix + dx < X;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
      const bool oky = okx && iy + dy >= 0 && iy + dy < Y;
#pragma unroll
      for (int dz = -1; dz <= 1; ++dz) {
        if (!(oky && iz + dz >= 0 && iz + dz < Z)) continue;
        const int64_t n = n0 + (static_cast<int64_t>(dx) * Y + dy) * Z + dz;
        const float v0 = __ldg(xs + n);
        const float v1 = __ldg(xs + n + comp);
        const float v2 = __ldg(xs + n + 2 * comp);
        const float* k = taps.t + (((dx + 1) * 3 + (dy + 1)) * 3 + (dz + 1)) * 9;
        a0 += k[0] * v0 + k[1] * v1 + k[2] * v2;
        a1 += k[3] * v0 + k[4] * v1 + k[5] * v2;
        a2 += k[6] * v0 + k[7] * v1 + k[8] * v2;
      }
    }
  }
  out[n0] = a0;
  out[n0 + comp] = a1;
  out[n0 + 2 * comp] = a2;
}

}  // namespace

// taps: 243 host floats, copied into the launch's parameters
extern "C" int civi_interior_stencil(const float* xs, const float* taps,
                                     float* out, int X, int Y, int Z,
                                     void* stream) {
  if (X <= 0 || Y <= 0 || Z <= 0) return 0;
  Taps t;
  for (int i = 0; i < 243; ++i) t.t[i] = taps[i];
  const int64_t nodes = static_cast<int64_t>(X) * Y * Z;
  const unsigned blocks = static_cast<unsigned>((nodes + 255) / 256);
  interior_stencil_kernel<<<blocks, 256, 0,
                            static_cast<cudaStream_t>(stream)>>>(xs, t, out,
                                                                 X, Y, Z);
  return static_cast<int>(cudaGetLastError());
}
