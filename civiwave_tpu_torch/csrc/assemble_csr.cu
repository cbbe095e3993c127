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
// Bound on the H100: device memory.  Least traffic per node: csr_idx and
// csr_weight 8 D B (192 B at D = 24), mass 4, x 12, mask 3, out 12, plus
// every force row read once (12 B per incidence).  The PR 2 design had each
// thread read its own CSR row as int4 / float4 loads: a warp's load touched
// 32 rows 8 D B apart, so the CSR slots (~40 % of the least bytes) arrived
// uncoalesced, and with 72 scalar row loads per node at D = 24 the kernel
// was bound by L1 wavefronts and issue (20 % of the bound).  Now a block of
// T nodes first stages its contiguous slice csr_idx[n0 : n0 + T] and
// csr_weight[n0 : n0 + T] (2 T D 4 B) into shared memory with coalesced
// 16-byte cp.async copies, each node's row padded to an odd number S of
// 16-byte chunks so that eight threads reading chunk q of eight rows hit
// distinct bank groups; the several blocks resident on an SM overlap one
// block's staging with another's gathers, and the carveout keeps most of
// the SM's storage as L1 for the row gathers.  Each thread then reads its slots
// as int4 / float4 from shared memory and gathers each 12-byte force row as
// one 8-byte and one 4-byte load (8-byte aligned at 12 r or 12 r + 4 by the
// parity of r), not three.  Zero-weight pad slots point at row 0 and add
// exact zeros.
//
// f64 instance (civi_assemble_csr_f64, precision.vectors: fp64, where the
// reference runs XLA): rows, x and out double; csr_weight and the lumped
// mass stay f32 and are widened, mf * m is the f64 product with an f64 mf,
// as the plain form forms it; sums by __dmul_rn / __dadd_rn, bit-equal to
// the plain version.  A 24-byte force row is one 16-byte and one 8-byte load, as the
// f32 row's 8 + 4.  The staging is the same (it holds only the CSR).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

// a += rows[r] * w, one correctly rounded product and sum per component.
// Row r starts at float 3 r: an even r puts its first two floats on an
// 8-byte boundary, an odd r its last two.
__device__ __forceinline__ void add_row(const float* __restrict__ rows, int r,
                                        float w, float& a0, float& a1,
                                        float& a2) {
  const float* p = rows + static_cast<int64_t>(r) * 3;
  const bool odd = r & 1;
  const float2 pair = __ldg(reinterpret_cast<const float2*>(p + (odd ? 1 : 0)));
  const float single = __ldg(p + (odd ? 0 : 2));
  const float v0 = odd ? single : pair.x;
  const float v1 = odd ? pair.x : pair.y;
  const float v2 = odd ? pair.y : single;
  a0 = __fadd_rn(a0, __fmul_rn(v0, w));
  a1 = __fadd_rn(a1, __fmul_rn(v1, w));
  a2 = __fadd_rn(a2, __fmul_rn(v2, w));
}

// The same for a double row (24 bytes at 24 r: an even r puts its first
// two values on a 16-byte boundary, an odd r its last two) and the widened
// f32 weight.
__device__ __forceinline__ void add_row(const double* __restrict__ rows, int r,
                                        float w, double& a0, double& a1,
                                        double& a2) {
  const double* p = rows + static_cast<int64_t>(r) * 3;
  const bool odd = r & 1;
  const double2 pair =
      __ldg(reinterpret_cast<const double2*>(p + (odd ? 1 : 0)));
  const double single = __ldg(p + (odd ? 0 : 2));
  const double v0 = odd ? single : pair.x;
  const double v1 = odd ? pair.x : pair.y;
  const double v2 = odd ? pair.y : single;
  const double wd = w;
  a0 = __dadd_rn(a0, __dmul_rn(v0, wd));
  a1 = __dadd_rn(a1, __dmul_rn(v1, wd));
  a2 = __dadd_rn(a2, __dmul_rn(v2, wd));
}

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) assemble_csr_kernel(
    const T* __restrict__ rows, const int* __restrict__ csr_idx,
    const float* __restrict__ csr_weight, const float* __restrict__ mass,
    const T* __restrict__ x, const uint8_t* __restrict__ bc,
    T* __restrict__ out, int N, int D, int S, T mf) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = blockDim.x;
  const int C = D / 4;  // 16-byte chunks of one CSR row
  int4* sidx = reinterpret_cast<int4*>(smem);
  float4* sw = reinterpret_cast<float4*>(smem) + nt * S;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * nt;
  const int64_t left = N - n0;
  const int count = left < nt ? static_cast<int>(left) : nt;
  // the block's slice: consecutive threads copy consecutive chunks
  const int4* gi = reinterpret_cast<const int4*>(csr_idx + n0 * D);
  const float4* gw = reinterpret_cast<const float4*>(csr_weight + n0 * D);
  for (int i = threadIdx.x; i < count * C; i += nt) {
    const int t = i / C;
    const int s = t * S + i - t * C;
    cp_async16(sidx + s, gi + i);
    cp_async16(sw + s, gw + i);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= count) return;
  const int64_t n = n0 + t;
  const int4* ip = sidx + t * S;
  const float4* wp = sw + t * S;
  T a0 = T(0), a1 = T(0), a2 = T(0);
#pragma unroll 2
  for (int q = 0; q < C; ++q) {
    const int4 i = ip[q];
    const float4 w = wp[q];
    add_row(rows, i.x, w.x, a0, a1, a2);
    add_row(rows, i.y, w.y, a0, a1, a2);
    add_row(rows, i.z, w.z, a0, a1, a2);
    add_row(rows, i.w, w.w, a0, a1, a2);
  }
  const T mm = mul_rn(mf, static_cast<T>(__ldg(mass + n)));
  const T acc[3] = {a0, a1, a2};
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    const int64_t k = n * 3 + b;
    const T xv = __ldg(x + k);
    const bool fixed = __ldg(bc + k) != 0;
    const T xs = fixed ? T(0) : xv;
    const T v = add_rn(acc[b], mul_rn(mm, xs));
    out[k] = fixed ? xv : v;
  }
}

// threads (nodes per block), blocks, row_chunks (S) and smem as computed
// by ops/cuda/assemble_csr.staging_geometry, refused unless consistent: S
// is D / 4 made odd, smem = 2 * threads * S * 16 bytes.  csr_idx and
// csr_weight 16-byte aligned, rows 8-byte aligned.
template <typename T>
int launch(const T* rows, const int* csr_idx, const float* csr_weight,
           const float* mass, const T* x, const unsigned char* bc, T* out,
           int N, int D, T mf, int threads, int blocks, int row_chunks,
           int smem, void* stream) {
  if (N <= 0) return 0;
  if (D <= 0 || D % 4 != 0 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || blocks != (N + threads - 1) / threads ||
      row_chunks != ((D / 4) | 1) || smem != 2 * threads * row_chunks * 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int raised = 48 * 1024;  // the dynamic shared memory allowed so far
  if (smem > raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        assemble_csr_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    raised = smem;
  }
  // Leave most of the SM's unified L1 / shared storage to L1: neighbouring
  // nodes gather rows that share 32-byte sectors, and those hits are what a
  // large L1 buys.  Ask for room for two blocks (1 KB reserved each) and at
  // least a quarter of the SM's shared memory: the 64 KB configuration at
  // D = 8 and 24 on an H100 (the driver's default takes as much shared
  // memory as the block count allows).
  static int carved = -1;  // the carveout set last, in percent (per T)
  int device = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                               device);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t need = 2 * (static_cast<int64_t>(smem) + 1024);
  int percent = static_cast<int>((100 * need + per_sm - 1) / per_sm);
  percent = percent < 25 ? 25 : (percent > 100 ? 100 : percent);
  if (percent != carved) {
    e = cudaFuncSetAttribute(assemble_csr_kernel<T>,
                             cudaFuncAttributePreferredSharedMemoryCarveout, percent);
    if (e != cudaSuccess) return static_cast<int>(e);
    carved = percent;
  }
  assemble_csr_kernel<T><<<blocks, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      rows, csr_idx, csr_weight, mass, x, bc, out, N, D, row_chunks, mf);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int civi_assemble_csr(const float* rows, const int* csr_idx,
                                 const float* csr_weight, const float* mass,
                                 const float* x, const unsigned char* bc,
                                 float* out, int N, int D, float mf,
                                 int threads, int blocks, int row_chunks,
                                 int smem, void* stream) {
  return launch<float>(rows, csr_idx, csr_weight, mass, x, bc, out, N, D, mf,
                       threads, blocks, row_chunks, smem, stream);
}

// The f64 instance: rows, x and out double (rows 16-byte aligned).
extern "C" int civi_assemble_csr_f64(const double* rows, const int* csr_idx,
                                     const float* csr_weight,
                                     const float* mass, const double* x,
                                     const unsigned char* bc, double* out,
                                     int N, int D, double mf, int threads,
                                     int blocks, int row_chunks, int smem,
                                     void* stream) {
  return launch<double>(rows, csr_idx, csr_weight, mass, x, bc, out, N, D,
                        mf, threads, blocks, row_chunks, smem, stream);
}
