// The Newmark stepper's vector work (solver/stepper.newmark_step) in three
// streaming passes over the frame's 3-vectors:
//
//   A  newmark_rhs_kernel: the predictor and the effective right-hand side
//      from the pre-step state u, v, a, the load f and the lumped mass m,
//        u_pred = (u + dt v) + c_pred a
//        d      = (a1 u + a4 v) + a5 a                    (damping_rhs)
//        rhs    = (f + m ((a0 u + a2 v) + a3 a)) + (alpha_r m) d
//   B  newmark_rhs_clamp_kernel: the Rayleigh-beta term beta_r K d and an
//      absorbing term C d where the model has them, then the Dirichlet
//      clamp, in place over A's rhs:
//        rhs = bc ? bc_value : (rhs + beta_r Kd) + Cd
//   C  newmark_update_kernel: the Newmark update from the solution x,
//        delta = x - u_pred       u = u_pred + delta
//        v = (v + c_vpred a) + c_v delta              a = c_a delta
//      and delta itself under the "delta" warm-start policy.
//
// Between A and B the stepper launches the stiffness-only operator on d
// (K1, G3 or K7 + G1) and the absorbing term; between B and C, the PCG.
// Replaces no Pallas kernel: the reference leaves these terms to XLA
// (civiwave_tpu/solver/stepper.py), which fuses them; eagerly they were ~35
// torch ops a frame, ~72 vector-sized reads and writes, ~14.4 GB at 255^3.
//
// Bound on the H100: device memory.  Least bytes a node for f32 3-vectors
// and a 1-byte mask per component: A reads u, v, a, f (48 B) and the mass
// (4 B) and writes u_pred, d, rhs (36 B): 88 B; B reads rhs, Kd (24 B) and
// the mask (3 B), bc_value only where the mask is set, and writes rhs
// (12 B): 39 B; C reads x, u_pred, v, a (48 B) and writes u, v, a (36 B):
// 84 B.  211 B a node, 3.54 GB at 255^3 cells (16.8M nodes), 1.057 ms at
// 3.35 TB/s.  v_pred = v + c_vpred a is not stored: C computes it again
// from the v and a it reads, with the same bits.
//
// The design: a thread takes one node, all three components of it, so
// the mass is read once a node; consecutive threads take consecutive
// nodes, so every access of a warp is coalesced.  The vectors come in two
// layouts, told apart by the mass's shape in the wrapper: the structured
// grid's (3, X, Y, Z), component planes of P = X Y Z nodes with a (1, X,
// Y, Z) mass (GRID), and the general path's (N, 3) node rows with an (N,
// 1) mass.  Component c of node n is at c P + n on the grid, at 3 n + c in
// rows; the mass of node n at n in both.
//
// Bit-equal to the torch composition it replaces: each product and sum is
// rounded on its own, in the composition's order (__fmul_rn, __fadd_rn,
// __fsub_rn: nvcc contracts none of them into an FMA), the scalars are the
// host's f64 values rounded once to the vector type, alpha_r m is rounded
// to f32 before it multiplies d (the composition's f32 mass times a
// scalar, in the f64 instance too), and constrained components are
// bc_value by select.  The f64 instances (precision.vectors: fp64) keep
// every other value in double; mass and bc_value are f32 in both.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// Index of component c of node n (``plane`` = P on the grid).
template <bool GRID>
__device__ __forceinline__ int64_t at(int64_t n, int c, int64_t plane) {
  return GRID ? c * plane + n : 3 * n + c;
}

template <typename T>
struct RhsArgs {
  const T* u;
  const T* v;
  const T* a;
  const T* f;
  const float* mass;
  T* u_pred;
  T* d;
  T* rhs;
  T dt, c_pred, a0, a2, a3, a1, a4, a5;
  float alpha_r;
  int64_t nodes, plane;
};

template <typename T>
struct ClampArgs {
  T* rhs;
  const T* kd;
  const T* absorb;
  const uint8_t* bc;
  const float* bc_value;
  T beta_r;
  int64_t nodes, plane;
};

template <typename T>
struct UpdateArgs {
  const T* x;
  const T* u_pred;
  const T* v;
  const T* a;
  T* u_out;
  T* v_out;
  T* a_out;
  T* delta;
  T c_vpred, c_v, c_a;
  int64_t nodes, plane;
};

__device__ __forceinline__ int64_t thread_index() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

// A thread loads all its inputs before it stores anything: a later
// component's loads are not moved above an earlier one's stores (the
// vectors could alias, as far as the compiler knows), and would each wait
// on the memory in turn.
template <typename T, bool GRID>
__global__ void __launch_bounds__(kThreads) newmark_rhs_kernel(RhsArgs<T> k) {
  const int64_t n = thread_index();
  if (n >= k.nodes) return;
  const float m = __ldg(k.mass + n);
  T u[3], v[3], a[3], f[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int64_t i = at<GRID>(n, c, k.plane);
    u[c] = __ldg(k.u + i);
    v[c] = __ldg(k.v + i);
    a[c] = __ldg(k.a + i);
    f[c] = __ldg(k.f + i);
  }
  const T mass = static_cast<T>(m);
  const T alpha_m = static_cast<T>(__fmul_rn(k.alpha_r, m));
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int64_t i = at<GRID>(n, c, k.plane);
    const T mass_term = mul_rn(mass, add_rn(add_rn(mul_rn(k.a0, u[c]), mul_rn(k.a2, v[c])),
                                            mul_rn(k.a3, a[c])));
    const T d = add_rn(add_rn(mul_rn(k.a1, u[c]), mul_rn(k.a4, v[c])), mul_rn(k.a5, a[c]));
    k.u_pred[i] = add_rn(add_rn(u[c], mul_rn(k.dt, v[c])), mul_rn(k.c_pred, a[c]));
    k.d[i] = d;
    k.rhs[i] = add_rn(add_rn(f[c], mass_term), mul_rn(alpha_m, d));
  }
}

// In place: rhs is read and written at the same indices.
template <typename T, bool GRID, bool KD, bool AB>
__global__ void __launch_bounds__(kThreads) newmark_rhs_clamp_kernel(ClampArgs<T> k) {
  const int64_t n = thread_index();
  if (n >= k.nodes) return;
  T rhs[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int64_t i = at<GRID>(n, c, k.plane);
    rhs[c] = k.rhs[i];
    if constexpr (KD) rhs[c] = add_rn(rhs[c], mul_rn(k.beta_r, __ldg(k.kd + i)));
    if constexpr (AB) rhs[c] = add_rn(rhs[c], __ldg(k.absorb + i));
    if (__ldg(k.bc + i) != 0) rhs[c] = static_cast<T>(__ldg(k.bc_value + i));
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) k.rhs[at<GRID>(n, c, k.plane)] = rhs[c];
}

template <typename T, bool GRID, bool DELTA>
__global__ void __launch_bounds__(kThreads) newmark_update_kernel(UpdateArgs<T> k) {
  const int64_t n = thread_index();
  if (n >= k.nodes) return;
  T x[3], up[3], v[3], a[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int64_t i = at<GRID>(n, c, k.plane);
    x[c] = __ldg(k.x + i);
    up[c] = __ldg(k.u_pred + i);
    v[c] = __ldg(k.v + i);
    a[c] = __ldg(k.a + i);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int64_t i = at<GRID>(n, c, k.plane);
    const T delta = sub_rn(x[c], up[c]);
    const T v_pred = add_rn(v[c], mul_rn(k.c_vpred, a[c]));
    k.u_out[i] = add_rn(up[c], delta);
    k.v_out[i] = add_rn(v_pred, mul_rn(k.c_v, delta));
    k.a_out[i] = mul_rn(k.c_a, delta);
    if constexpr (DELTA) k.delta[i] = delta;
  }
}

template <bool B>
using Flag = std::bool_constant<B>;

// Calls launch(grid, blocks) with GRID as a Flag value: the vectors are
// component planes where plane > 0.
template <typename Launch>
int dispatch(int64_t nodes, int64_t plane, Launch launch) {
  if (nodes <= 0) return 0;
  const auto blocks = static_cast<unsigned>((nodes + kThreads - 1) / kThreads);
  if (plane > 0) {
    launch(Flag<true>{}, blocks);
  } else {
    launch(Flag<false>{}, blocks);
  }
  return static_cast<int>(cudaGetLastError());
}

// launch(Flag<p != NULL>).
template <typename Launch>
int with_flag(const void* p, Launch launch) {
  return p != nullptr ? launch(Flag<true>{}) : launch(Flag<false>{});
}

template <typename T>
int rhs(const T* u, const T* v, const T* a, const T* f, const float* mass,
        T* u_pred, T* d, T* rhs_out, T dt, T c_pred, T a0, T a2, T a3, T a1,
        T a4, T a5, float alpha_r, long long nodes, long long plane,
        cudaStream_t s) {
  const RhsArgs<T> k{u, v, a, f, mass, u_pred, d, rhs_out, dt, c_pred, a0, a2,
                     a3, a1, a4, a5, alpha_r, nodes, plane};
  return dispatch(nodes, plane, [&](auto grid, unsigned blocks) {
    newmark_rhs_kernel<T, decltype(grid)::value><<<blocks, kThreads, 0, s>>>(k);
  });
}

template <typename T>
int clamp(T* rhs_io, const T* kd, const T* absorb, const unsigned char* bc,
          const float* bc_value, T beta_r, long long nodes, long long plane,
          cudaStream_t s) {
  const ClampArgs<T> k{rhs_io, kd, absorb, bc, bc_value, beta_r, nodes, plane};
  return with_flag(kd, [&](auto has_kd) {
    return with_flag(absorb, [&](auto has_ab) {
      return dispatch(nodes, plane, [&](auto grid, unsigned blocks) {
        newmark_rhs_clamp_kernel<T, decltype(grid)::value, decltype(has_kd)::value,
                                 decltype(has_ab)::value>
            <<<blocks, kThreads, 0, s>>>(k);
      });
    });
  });
}

template <typename T>
int update(const T* x, const T* u_pred, const T* v, const T* a, T* u_out,
           T* v_out, T* a_out, T* delta, T c_vpred, T c_v, T c_a,
           long long nodes, long long plane, cudaStream_t s) {
  const UpdateArgs<T> k{x, u_pred, v, a, u_out, v_out, a_out, delta,
                        c_vpred, c_v, c_a, nodes, plane};
  return with_flag(delta, [&](auto has_delta) {
    return dispatch(nodes, plane, [&](auto grid, unsigned blocks) {
      newmark_update_kernel<T, decltype(grid)::value, decltype(has_delta)::value>
          <<<blocks, kThreads, 0, s>>>(k);
    });
  });
}

}  // namespace

// plane: nodes per component plane of the grid layout (3, X, Y, Z), 0 for
// the rows layout (N, 3); nodes: X Y Z, or N.
extern "C" int civi_newmark_rhs(const float* u, const float* v, const float* a,
                                const float* f, const float* mass,
                                float* u_pred, float* d, float* rhs_out,
                                float dt, float c_pred, float a0, float a2,
                                float a3, float a1, float a4, float a5,
                                float alpha_r, long long nodes,
                                long long plane, void* stream) {
  return rhs<float>(u, v, a, f, mass, u_pred, d, rhs_out, dt, c_pred, a0, a2,
                    a3, a1, a4, a5, alpha_r, nodes, plane,
                    static_cast<cudaStream_t>(stream));
}

extern "C" int civi_newmark_rhs_f64(const double* u, const double* v,
                                    const double* a, const double* f,
                                    const float* mass, double* u_pred,
                                    double* d, double* rhs_out, double dt,
                                    double c_pred, double a0, double a2,
                                    double a3, double a1, double a4, double a5,
                                    float alpha_r, long long nodes,
                                    long long plane, void* stream) {
  return rhs<double>(u, v, a, f, mass, u_pred, d, rhs_out, dt, c_pred, a0, a2,
                     a3, a1, a4, a5, alpha_r, nodes, plane,
                     static_cast<cudaStream_t>(stream));
}

// kd and absorb may be NULL (no Rayleigh-beta term, no absorbing faces)
extern "C" int civi_newmark_rhs_clamp(float* rhs_io, const float* kd,
                                      const float* absorb,
                                      const unsigned char* bc,
                                      const float* bc_value, float beta_r,
                                      long long nodes, long long plane,
                                      void* stream) {
  return clamp<float>(rhs_io, kd, absorb, bc, bc_value, beta_r, nodes, plane,
                      static_cast<cudaStream_t>(stream));
}

extern "C" int civi_newmark_rhs_clamp_f64(double* rhs_io, const double* kd,
                                          const double* absorb,
                                          const unsigned char* bc,
                                          const float* bc_value, double beta_r,
                                          long long nodes, long long plane,
                                          void* stream) {
  return clamp<double>(rhs_io, kd, absorb, bc, bc_value, beta_r, nodes, plane,
                       static_cast<cudaStream_t>(stream));
}

// delta may be NULL (every warm-start policy but "delta")
extern "C" int civi_newmark_update(const float* x, const float* u_pred,
                                   const float* v, const float* a, float* u_out,
                                   float* v_out, float* a_out, float* delta,
                                   float c_vpred, float c_v, float c_a,
                                   long long nodes, long long plane,
                                   void* stream) {
  return update<float>(x, u_pred, v, a, u_out, v_out, a_out, delta, c_vpred,
                       c_v, c_a, nodes, plane, static_cast<cudaStream_t>(stream));
}

extern "C" int civi_newmark_update_f64(const double* x, const double* u_pred,
                                       const double* v, const double* a,
                                       double* u_out, double* v_out,
                                       double* a_out, double* delta,
                                       double c_vpred, double c_v, double c_a,
                                       long long nodes, long long plane,
                                       void* stream) {
  return update<double>(x, u_pred, v, a, u_out, v_out, a_out, delta, c_vpred,
                        c_v, c_a, nodes, plane, static_cast<cudaStream_t>(stream));
}
