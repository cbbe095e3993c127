// K7 element_forces: the per-element force phase of the general path's
// K_eff * x.  For every element e of one block (tet4: NL = 4 nodes, NGP = 1
// point; hex8: NL = 8 nodes, NGP = 8 Gauss points):
//
//   u_l   = where(bc, 0, x[conn[e, l]])                  (gather + sanitize)
//   G_ab  = sum_l dN_la u_lb                             (per Gauss point)
//   S_ab  = V ss (lam tr(G) d_ab + mu (G_ab + G_ba))
//   f_lb += sum_a dN_la S_ab
//
// and writes the NL force rows e*NL + l of its block, which the assembly
// kernel G1 (assemble_csr.cu) gathers per node.
//
// Replaces the Pallas TPU kernels hex_force_streams / tet_force_streams
// (civiwave_tpu/ops/pallas/element_forces.py:125, :130; pallas_call at :110
// in _run).  The TPU kernel takes pre-gathered (24, Hq, 128) displacement
// streams that XLA built in a separate gather pass; here each thread owns
// one element, reads its conn row and gathers its corner rows of x itself
// (through L2: pack sorts elements by their min corner node, so the
// neighbouring threads of a warp gather from neighbouring rows), and
// sanitizes them by the bc mask, which saves the separate sanitize pass.
// It reads the tables in the layouts pack stores, gp-major with the
// element axis last — grads (NGP, NL, 3, E), vol (NGP, E), lam (E), mu (E)
// — so the 32 threads of a warp read 32 consecutive floats of every table
// row.  u, the Gauss point's gradients, G, S and f stay in registers
// (24 + 24 + 9 + 9 + 24 floats for hex).
//
// Output form: row form, (E * NL, 3) f32 — the layout the assembly gathers
// (one 12-byte row per incidence).  Each thread stores its NL*3 floats as
// float4s (48 B for tet, 96 B for hex, contiguous); a warp's store
// instruction therefore touches 32 addresses 48 or 96 B apart instead of
// one 128-B line, but every byte of the row block is written exactly once
// and the lines fill in L2, so the cost is store instructions, not DRAM
// traffic.
//
// Bound on the H100: device memory.  Least traffic per hex: grads 768 B,
// vol 32, lam+mu 8, conn 32, out 96 = 936 B, plus 15 B per node (x and the
// mask, each read once); per tet: 48 + 4 + 8 + 16 + 48 = 124 B.  About
// 2.6 kFLOP per hex and 0.2 kFLOP per tet, far below the f32 rate.
//
// f64 instances (civi_element_forces_{tet,hex}_f64, precision.vectors:
// fp64, where the reference runs its XLA form): x, u, G, S, f and the force
// rows double, stored as double2s (96 B per tet, 192 B per hex); the packed
// streams stay the f32 that pack builds and are widened, and V ss is the
// f64 product of the widened volume and an f64 ss, as the plain form (and
// the reference's f32 tables times its f64 scalars) forms it.  Least
// traffic per hex: 936 - 96 + 192 = 1,032 B plus 27 B per node; per tet
// 124 - 48 + 96 = 172 B.  ~2.6 kFLOP per hex stays below the f64 rate too.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <int NL>
__device__ __forceinline__ void load_conn(const int* __restrict__ conn,
                                          int64_t e, int (&node)[NL]) {
  const int4* row = reinterpret_cast<const int4*>(conn + e * NL);
#pragma unroll
  for (int q = 0; q < NL / 4; ++q) {
    const int4 v = __ldg(row + q);
    node[4 * q + 0] = v.x;
    node[4 * q + 1] = v.y;
    node[4 * q + 2] = v.z;
    node[4 * q + 3] = v.w;
  }
}

// Stores the NL * 3 forces of element e: float4s (48 / 96 B per element)
// or double2s (96 / 192 B); 16-byte aligned, as the wrapper checks the base.
template <int NL>
__device__ __forceinline__ void store_rows(float* rows, int64_t e,
                                           const float (&f)[NL][3]) {
  float4* out = reinterpret_cast<float4*>(rows + e * (NL * 3));
#pragma unroll
  for (int q = 0; q < NL * 3 / 4; ++q) {
    const int i = 4 * q;
    out[q] = make_float4(f[(i + 0) / 3][(i + 0) % 3], f[(i + 1) / 3][(i + 1) % 3],
                         f[(i + 2) / 3][(i + 2) % 3], f[(i + 3) / 3][(i + 3) % 3]);
  }
}

template <int NL>
__device__ __forceinline__ void store_rows(double* rows, int64_t e,
                                           const double (&f)[NL][3]) {
  double2* out = reinterpret_cast<double2*>(rows + e * (NL * 3));
#pragma unroll
  for (int q = 0; q < NL * 3 / 2; ++q) {
    const int i = 2 * q;
    out[q] = make_double2(f[i / 3][i % 3], f[(i + 1) / 3][(i + 1) % 3]);
  }
}

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename T, int NL, int NGP>
__global__ void __launch_bounds__(128) element_forces_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ bc,
    const int* __restrict__ conn, const float* __restrict__ grads,
    const float* __restrict__ vol, const float* __restrict__ lam,
    const float* __restrict__ mu, T* __restrict__ rows, int E, T ss) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= E) return;

  int node[NL];
  load_conn<NL>(conn, e, node);
  T u[NL][3];
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    const int64_t k = static_cast<int64_t>(node[l]) * 3;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      u[l][b] = __ldg(bc + k + b) ? T(0) : __ldg(x + k + b);
    }
  }
  const T lm = __ldg(lam + e);
  const T m = __ldg(mu + e);

  T f[NL][3];
#pragma unroll
  for (int l = 0; l < NL; ++l) {
#pragma unroll
    for (int b = 0; b < 3; ++b) f[l][b] = T(0);
  }

#pragma unroll 1
  for (int g = 0; g < NGP; ++g) {
    T gr[NL][3];
#pragma unroll
    for (int l = 0; l < NL; ++l) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        gr[l][a] = __ldg(grads + (static_cast<int64_t>((g * NL + l) * 3 + a)) * E + e);
      }
    }
    // V ss in the vectors' type
    const T vs =
        mul_rn(static_cast<T>(__ldg(vol + static_cast<int64_t>(g) * E + e)), ss);
    T G[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        T s = gr[0][a] * u[0][b];
#pragma unroll
        for (int l = 1; l < NL; ++l) s += gr[l][a] * u[l][b];
        G[a][b] = s;
      }
    }
    const T tr = G[0][0] + G[1][1] + G[2][2];
    T S[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const T diag = (a == b) ? lm * tr : T(0);
        S[a][b] = vs * (m * (G[a][b] + G[b][a]) + diag);
      }
    }
#pragma unroll
    for (int l = 0; l < NL; ++l) {
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        f[l][b] += gr[l][0] * S[0][b] + gr[l][1] * S[1][b] + gr[l][2] * S[2][b];
      }
    }
  }

  store_rows<NL>(rows, e, f);
}

template <int NL, int NGP, typename T>
int launch(const T* x, const unsigned char* bc, const int* conn,
           const float* grads, const float* vol, const float* lam,
           const float* mu, T* rows, int E, T ss, void* stream) {
  if (E <= 0) return 0;
  const int threads = 128;
  const unsigned blocks = static_cast<unsigned>((E + threads - 1) / threads);
  element_forces_kernel<T, NL, NGP>
      <<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
          x, bc, conn, grads, vol, lam, mu, rows, E, ss);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int civi_element_forces_tet(const float* x, const unsigned char* bc,
                                       const int* conn, const float* grads,
                                       const float* vol, const float* lam,
                                       const float* mu, float* rows, int E,
                                       float ss, void* stream) {
  return launch<4, 1>(x, bc, conn, grads, vol, lam, mu, rows, E, ss, stream);
}

extern "C" int civi_element_forces_hex(const float* x, const unsigned char* bc,
                                       const int* conn, const float* grads,
                                       const float* vol, const float* lam,
                                       const float* mu, float* rows, int E,
                                       float ss, void* stream) {
  return launch<8, 8>(x, bc, conn, grads, vol, lam, mu, rows, E, ss, stream);
}

extern "C" int civi_element_forces_tet_f64(
    const double* x, const unsigned char* bc, const int* conn,
    const float* grads, const float* vol, const float* lam, const float* mu,
    double* rows, int E, double ss, void* stream) {
  return launch<4, 1>(x, bc, conn, grads, vol, lam, mu, rows, E, ss, stream);
}

extern "C" int civi_element_forces_hex_f64(
    const double* x, const unsigned char* bc, const int* conn,
    const float* grads, const float* vol, const float* lam, const float* mu,
    double* rows, int E, double ss, void* stream) {
  return launch<8, 8>(x, bc, conn, grads, vol, lam, mu, rows, E, ss, stream);
}
