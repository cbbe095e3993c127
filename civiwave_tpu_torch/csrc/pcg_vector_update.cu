// cg_direction_update: the vector work of one Chronopoulos-Gear PCG
// iteration in one streaming pass, in place,
//
//   p = bc ? 0 : u + beta p        s = bc ? 0 : w + beta s
//   x = x + alpha p                r = r - alpha s
//
// with p = bc ? 0 : u and s = bc ? 0 : w (no beta) on a solve's first call.
// solver/pcg.py's fused loop calls it at the top of each iteration with the
// alpha and beta it kept from the iteration before.
//
// Replaces no Pallas kernel: the reference leaves these axpys to XLA, which
// fuses them inside its while_loop.  Eagerly they were ~16 torch ops an
// iteration (two scalar casts, eight elementwise passes, two masked_fill
// clones and fills), ~5.7 GB at 255^3.
//
// Bound on the H100: device memory.  One pass reads x, r, p, s, u, w (12 B a
// node each in f32) and the 1-byte mask per component and writes x, r, p, s:
// 123 B a node, 2.06 GB at 255^3 cells (16.8M nodes), 0.616 ms at 3.35 TB/s;
// 24 operations a node.  The design: one thread for each 16 bytes of every
// vector (a float4, two double2 in f64; the mask as a uchar4), one thread a
// value for the tail of a length that is not a multiple of 4 (the wrapper
// refuses vectors that are not 16-byte aligned and a mask that is not
// 4-byte aligned).  At 255^3 on the H100 that runs
// at 0.677 ms; a grid-stride loop over the same loads, with as many blocks
// as the card holds at once (or twice as many, or two groups a step), at
// 0.709-0.714 ms.  alpha and beta are read on the device from their 0-d
// tensors (f64, or f32 under precision.reductions: fp32), so the host reads
// nothing and launches no cast.
//
// Bit-equal to the torch composition it replaces: each product and sum is
// rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn: nvcc contracts none
// of them into an FMA), the scalars are rounded to the vector type with
// __double2float_rn as .to(float32) does, and constrained components are
// +0.0 by select, as masked_fill writes them.  The f64 instance
// (precision.vectors: fp64) keeps every value in double.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// A 0-d step scalar (f64, or f32 with scalars_f64 == 0) as .to(T) gives it.
__device__ __forceinline__ float step_scalar(const void* v, int scalars_f64,
                                             float) {
  return scalars_f64 ? __double2float_rn(*static_cast<const double*>(v))
                     : *static_cast<const float*>(v);
}

__device__ __forceinline__ double step_scalar(const void* v, int scalars_f64,
                                              double) {
  return scalars_f64 ? *static_cast<const double*>(v)
                     : static_cast<double>(*static_cast<const float*>(v));
}

template <typename T, bool FIRST>
__device__ __forceinline__ void update(bool fixed, T& x, T& r, T& p, T& s,
                                       T u, T w, T alpha, T beta) {
  if (FIRST) {
    p = fixed ? T(0) : u;
    s = fixed ? T(0) : w;
  } else {
    p = fixed ? T(0) : add_rn(u, mul_rn(beta, p));
    s = fixed ? T(0) : add_rn(w, mul_rn(beta, s));
  }
  x = add_rn(x, mul_rn(alpha, p));
  r = sub_rn(r, mul_rn(alpha, s));
}

// Four consecutive values at index 4 i as 16-byte accesses.
__device__ __forceinline__ void load4(const float* a, int64_t i, float (&v)[4]) {
  const float4 q = reinterpret_cast<const float4*>(a)[i];
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load4(const double* a, int64_t i, double (&v)[4]) {
  const double2 q0 = reinterpret_cast<const double2*>(a)[2 * i];
  const double2 q1 = reinterpret_cast<const double2*>(a)[2 * i + 1];
  v[0] = q0.x; v[1] = q0.y; v[2] = q1.x; v[3] = q1.y;
}

__device__ __forceinline__ void load4_ro(const float* a, int64_t i, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(a) + i);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load4_ro(const double* a, int64_t i, double (&v)[4]) {
  const double2 q0 = __ldg(reinterpret_cast<const double2*>(a) + 2 * i);
  const double2 q1 = __ldg(reinterpret_cast<const double2*>(a) + 2 * i + 1);
  v[0] = q0.x; v[1] = q0.y; v[2] = q1.x; v[3] = q1.y;
}

__device__ __forceinline__ void store4(float* a, int64_t i, const float (&v)[4]) {
  reinterpret_cast<float4*>(a)[i] = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(double* a, int64_t i, const double (&v)[4]) {
  reinterpret_cast<double2*>(a)[2 * i] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(a)[2 * i + 1] = make_double2(v[2], v[3]);
}

// Thread i < n / 4 updates values 4 i .. 4 i + 3 with 16-byte accesses
// (every vector 16-byte and the mask 4-byte aligned), the threads after
// them one value of the tail each.
template <typename T, bool FIRST>
__global__ void __launch_bounds__(kThreads) cg_direction_update_kernel(
    T* __restrict__ x, T* __restrict__ r, T* __restrict__ p,
    T* __restrict__ s, const T* __restrict__ u, const T* __restrict__ w,
    const uint8_t* __restrict__ bc, const void* alpha_v, const void* beta_v,
    int scalars_f64, int64_t n) {
  const T alpha = step_scalar(alpha_v, scalars_f64, T(0));
  const T beta = FIRST ? T(0) : step_scalar(beta_v, scalars_f64, T(0));
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t n4 = n / 4;
  if (i < n4) {
    T xv[4], rv[4], pv[4], sv[4], uv[4], wv[4];
    const uchar4 m = __ldg(reinterpret_cast<const uchar4*>(bc) + i);
    load4_ro(u, i, uv);
    load4_ro(w, i, wv);
    load4(x, i, xv);
    load4(r, i, rv);
    if (!FIRST) {
      load4(p, i, pv);
      load4(s, i, sv);
    }
    const bool fixed[4] = {m.x != 0, m.y != 0, m.z != 0, m.w != 0};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      update<T, FIRST>(fixed[k], xv[k], rv[k], pv[k], sv[k], uv[k], wv[k],
                       alpha, beta);
    }
    store4(x, i, xv);
    store4(r, i, rv);
    store4(p, i, pv);
    store4(s, i, sv);
    return;
  }
  const int64_t j = i + 3 * n4;  // thread n4 + k takes value 4 n4 + k
  if (j < n) {
    T xj = x[j], rj = r[j], pj = FIRST ? T(0) : p[j], sj = FIRST ? T(0) : s[j];
    update<T, FIRST>(bc[j] != 0, xj, rj, pj, sj, u[j], w[j], alpha, beta);
    x[j] = xj;
    r[j] = rj;
    p[j] = pj;
    s[j] = sj;
  }
}

template <typename T, bool FIRST>
void launch_instance(T* x, T* r, T* p, T* s, const T* u, const T* w,
                     const uint8_t* bc, const void* alpha, const void* beta,
                     int scalars_f64, int64_t n, cudaStream_t stream) {
  const int64_t threads = n / 4 + n % 4;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  cg_direction_update_kernel<T, FIRST><<<blocks, kThreads, 0, stream>>>(
      x, r, p, s, u, w, bc, alpha, beta, scalars_f64, n);
}

template <typename T>
int launch(T* x, T* r, T* p, T* s, const T* u, const T* w,
           const unsigned char* bc, const void* alpha, const void* beta,
           int scalars_f64, long long n, void* stream_v) {
  if (n <= 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  if (beta == nullptr) {
    launch_instance<T, true>(x, r, p, s, u, w, bc, alpha, beta, scalars_f64, n, stream);
  } else {
    launch_instance<T, false>(x, r, p, s, u, w, bc, alpha, beta, scalars_f64, n, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int civi_cg_direction_update(float* x, float* r, float* p, float* s,
                                        const float* u, const float* w,
                                        const unsigned char* bc,
                                        const void* alpha, const void* beta,
                                        int scalars_f64, long long n,
                                        void* stream) {
  return launch<float>(x, r, p, s, u, w, bc, alpha, beta, scalars_f64, n, stream);
}

extern "C" int civi_cg_direction_update_f64(double* x, double* r, double* p,
                                            double* s, const double* u,
                                            const double* w,
                                            const unsigned char* bc,
                                            const void* alpha, const void* beta,
                                            int scalars_f64, long long n,
                                            void* stream) {
  return launch<double>(x, r, p, s, u, w, bc, alpha, beta, scalars_f64, n, stream);
}
