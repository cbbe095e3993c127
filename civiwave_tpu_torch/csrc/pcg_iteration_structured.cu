// K6 pcg_iteration_structured: one whole Chronopoulos-Gear PCG iteration on
// a homogeneous structured grid in one launch.  Per node n and component b,
// with free = !bc and the step scalars alpha, beta read from the device:
//
//   p' = free ? u + beta p : 0        s' = free ? w + beta s : 0
//   x' = x + alpha p'                 r' = r - alpha s'
//   u' = M^-1 r'                      (block-Jacobi class table, +0.0 on bc)
//   w' = bc ? u' : ss * K(u') + mf * mass * u'
//
// and the per-(x, y)-row f32 partials of (r', u'), (r', r') and (w', u'),
// each reduced over z and the 3 components, into partials[3][X * Y] (the
// caller sums them in the reduction dtype).
//
// Replaces the Pallas TPU kernel pcg_iteration_fused_pallas
// (civiwave_tpu/ops/pallas/structured_stencil.py:1226, pallas_call at :1285,
// body _make_pcg_iter_kernel :1096).  That kernel streams x_ext-padded
// carries through VMEM blocks and lags the stencil one block behind the
// recurrence (u_cur/u_prev/last_u scratch and a flush grid step), because
// a TPU grid step cannot see the next block.  None of that carries over:
// the design is K2's.  One block owns one (x, y) row and its threads stride
// over z.  Each thread recomputes s', r' and u' at its 27 neighbours from
// r, w, s and the mask there (u' is pointwise in r', r' in s'), then applies
// its per-boundary-class stencil as K1 does, so no thread depends on
// another's output and one launch does the whole iteration.  The row
// partials are reduced as in K2 (warp shuffles + shared memory, no
// atomics, deterministic).
//
// Buffers: other threads read r, w and s at this node, so r', w' and s' go
// to separate output buffers (the caller swaps them each iteration); x, u
// and p are read only at the thread's own node and are updated IN PLACE.
// The carries therefore take nine vectors, not twelve.
//
// Bound on the H100: device memory.  Least traffic per node is the six
// carries in (72 B) and out (72 B) and the mask (3 B): 147 B, ~2.47 GB at
// 255^3 cells (0.74 ms at 3.35 TB/s).  The f32 work (~560 operations per
// node, ~9.4 GFLOP) is far below the card's rate.  The 27-fold neighbour
// reads now touch three vectors (K2: one); their reuse is left to L1/L2 in
// this first version, as in K1/K2.
#include "structured.cuh"

namespace {

// s' and r' of one component at one node (the recurrence, recomputed at
// every neighbour with the same arithmetic as at the node itself).
__device__ __forceinline__ float next_residual(float r, float w, float s,
                                               bool fixed, float alpha,
                                               float beta, float& s_new) {
  s_new = fixed ? 0.0f : w + beta * s;
  return r - alpha * s_new;
}

__global__ void __launch_bounds__(256) pcg_iteration_structured_kernel(
    const float* __restrict__ pc_table, const float* __restrict__ stencil,
    const float* __restrict__ alpha_beta, float* __restrict__ x,
    const float* __restrict__ r, float* __restrict__ u,
    const float* __restrict__ w, float* __restrict__ p,
    const float* __restrict__ s, const uint8_t* __restrict__ bc,
    float* __restrict__ r_out, float* __restrict__ w_out,
    float* __restrict__ s_out, float* __restrict__ partials, int X, int Y,
    int Z, int nx, int ny, int nz, float ss, float mf, float m8) {
  const int row = blockIdx.x;  // x * Y + y
  const int ix = row / Y;
  const int iy = row - ix * Y;
  const int64_t comp = static_cast<int64_t>(X) * Y * Z;
  const int cx = civi::node_class(ix, nx);
  const int cy = civi::node_class(iy, ny);
  const float alpha = __ldg(alpha_beta);
  const float beta = __ldg(alpha_beta + 1);
  float ru = 0.0f, rr = 0.0f, wu = 0.0f;
  for (int iz = threadIdx.x; iz < Z; iz += blockDim.x) {
    const int cz = civi::node_class(iz, nz);
    const float* tab = stencil + ((cx * 3 + cy) * 3 + cz) * 27 * 9;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
    float uc[3] = {0.0f, 0.0f, 0.0f};
    float rc[3] = {0.0f, 0.0f, 0.0f};
    float sc[3] = {0.0f, 0.0f, 0.0f};
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
          bool fixed[3];
          float rn[3], sn[3];
#pragma unroll
          for (int b = 0; b < 3; ++b) {
            const int64_t nb = n + b * comp;
            fixed[b] = bc[nb] != 0;
            rn[b] = next_residual(r[nb], w[nb], s[nb], fixed[b], alpha, beta,
                                  sn[b]);
          }
          float q0, q1, q2;
          civi::block_jacobi_node(pc_table, cjxy + civi::node_class(jz, nz),
                                  rn[0], rn[1], rn[2], q0, q1, q2);
          // select, not multiply: a constrained component is +0.0
          q0 = fixed[0] ? 0.0f : q0;
          q1 = fixed[1] ? 0.0f : q1;
          q2 = fixed[2] ? 0.0f : q2;
          if (dx == 0 && dy == 0 && dz == 0) {
            uc[0] = q0;
            uc[1] = q1;
            uc[2] = q2;
#pragma unroll
            for (int b = 0; b < 3; ++b) {
              rc[b] = rn[b];
              sc[b] = sn[b];
            }
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
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const int64_t nb = n0 + b * comp;
      const bool fixed = bc[nb] != 0;
      // the deferred direction update, then the x axpy (own node only)
      const float pb = fixed ? 0.0f : u[nb] + beta * p[nb];
      x[nb] = x[nb] + alpha * pb;
      p[nb] = pb;
      u[nb] = uc[b];
      // identity row: the operator input u' is already +0.0 there
      const float wb = fixed ? uc[b] : ss * acc[b] + mm * uc[b];
      r_out[nb] = rc[b];
      s_out[nb] = sc[b];
      w_out[nb] = wb;
      ru += rc[b] * uc[b];
      rr += rc[b] * rc[b];
      wu += wb * uc[b];
    }
  }
  civi::store_row_sums3(ru, rr, wu, partials, static_cast<int64_t>(X) * Y,
                        row);
}

}  // namespace

extern "C" int civi_pcg_iteration_structured(
    const float* pc_table, const float* stencil, const float* alpha_beta,
    float* x, const float* r, float* u, const float* w, float* p,
    const float* s, const unsigned char* bc, float* r_out, float* w_out,
    float* s_out, float* partials, int X, int Y, int Z, int nx, int ny, int nz,
    float ss, float mf, float m8, void* stream) {
  if (X <= 0 || Y <= 0 || Z <= 0) return 0;
  pcg_iteration_structured_kernel<<<static_cast<unsigned>(X * Y),
                                    civi::row_threads(Z), 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      pc_table, stencil, alpha_beta, x, r, u, w, p, s, bc, r_out, w_out, s_out,
      partials, X, Y, Z, nx, ny, nz, ss, mf, m8);
  return static_cast<int>(cudaGetLastError());
}
