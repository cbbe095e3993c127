// G1 assemble_csr: the assembly phase of the general path's K_eff * x.
// For every node n (one thread each):
//
//   a_b    = sum_d rows[csr_idx[n, d], b] * csr_weight[n, d]   (slot order)
//   out_nb = bc_nb ? x_nb : a_b + (mf * m_n) * where(bc_nb, 0, x_nb)
//
// i.e. the dual-CSR gather-sum over the element force rows that K7
// (element_forces.cu) wrote, the lumped-mass term and the Dirichlet
// identity rows (civiwave_tpu/ops/apply_keff.py:283-294 and :400-401).
//
// In the JAX package this phase is XLA, not Pallas.  Its plain PyTorch form
// is D >= 8 full-size gathers and multiply-adds (D = 24 on a tet box), so
// it gets a kernel of its own.  It keeps the reference engine's assembly
// contract: a gather, no float atomics — each output is summed by one
// thread in slot order, so the result is deterministic.  The products and
// sums use __fmul_rn / __fadd_rn (no FMA contraction), which makes the
// output equal, bit for bit, to the plain version's unrolled
// ``out = out + rows[idx[:, d]] * w[:, d]`` on the same rows.
//
// Each thread reads its CSR row as int4 / float4 vectors (D is a multiple
// of 8, so rows are 32-byte aligned) and gathers the 12-byte force rows
// through L2 (pack sorts elements by min corner node, so a node's incident
// rows sit close together).  Zero-weight pad slots point at row 0 and add
// exact zeros.
//
// Bound on the H100: device memory.  Least traffic per node: csr_idx and
// csr_weight 8 D B (192 B at D = 24), mass 4, x 12, mask 3, out 12, plus
// every force row read once (12 B per incidence).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void add_row(const float* __restrict__ rows, int r,
                                        float w, float& a0, float& a1,
                                        float& a2) {
  const float* p = rows + static_cast<int64_t>(r) * 3;
  a0 = __fadd_rn(a0, __fmul_rn(__ldg(p + 0), w));
  a1 = __fadd_rn(a1, __fmul_rn(__ldg(p + 1), w));
  a2 = __fadd_rn(a2, __fmul_rn(__ldg(p + 2), w));
}

__global__ void __launch_bounds__(256) assemble_csr_kernel(
    const float* __restrict__ rows, const int* __restrict__ csr_idx,
    const float* __restrict__ csr_weight, const float* __restrict__ mass,
    const float* __restrict__ x, const uint8_t* __restrict__ bc,
    float* __restrict__ out, int N, int D, float mf) {
  const int64_t n = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int4* ip = reinterpret_cast<const int4*>(csr_idx + n * D);
  const float4* wp = reinterpret_cast<const float4*>(csr_weight + n * D);
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  for (int q = 0; q < D / 4; ++q) {
    const int4 i = __ldg(ip + q);
    const float4 w = __ldg(wp + q);
    add_row(rows, i.x, w.x, a0, a1, a2);
    add_row(rows, i.y, w.y, a0, a1, a2);
    add_row(rows, i.z, w.z, a0, a1, a2);
    add_row(rows, i.w, w.w, a0, a1, a2);
  }
  const float mm = __fmul_rn(mf, __ldg(mass + n));
  const float acc[3] = {a0, a1, a2};
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    const int64_t k = n * 3 + b;
    const float xv = __ldg(x + k);
    const bool fixed = __ldg(bc + k) != 0;
    const float xs = fixed ? 0.0f : xv;
    const float v = __fadd_rn(acc[b], __fmul_rn(mm, xs));
    out[k] = fixed ? xv : v;
  }
}

}  // namespace

extern "C" int civi_assemble_csr(const float* rows, const int* csr_idx,
                                 const float* csr_weight, const float* mass,
                                 const float* x, const unsigned char* bc,
                                 float* out, int N, int D, float mf,
                                 void* stream) {
  if (N <= 0) return 0;
  if (D % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((N + threads - 1) / threads);
  assemble_csr_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, csr_idx, csr_weight, mass, x, bc, out, N, D, mf);
  return static_cast<int>(cudaGetLastError());
}
