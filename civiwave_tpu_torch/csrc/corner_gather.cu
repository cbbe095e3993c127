// G3 corner_gather: the complete effective-stiffness operator of a
// HETEROGENEOUS structured grid, out = bc ? x : ss * K(lam_c, mu_c) xs +
// mf * mass * xs with xs = bc ? 0 : x, in one launch.
//
// Replaces no Pallas kernel: the reference computes this operator in XLA,
// the corner-gather element loop _apply_heterogeneous_stiffness and the
// envelope of _apply_keff_structured_base
// (civiwave_tpu/ops/structured.py:503-552, :603-609).  Its plain version is
// ops.structured.heterogeneous_stiffness inside apply_keff_structured_plain.
//
// Gather, no atomics: one thread per node sums over its <= 8 incident cells
// c the node's 3 rows of that cell's element matrix times the cell's 8
// corner values.  The element matrix splits by material,
// K_e = lam_c A + mu_c B, with A and B constant (8, 3, 8, 3) tables
// [l][b][m][c] (output corner l, component b, input corner m, component c)
// built on the host from the f32-rounded Gauss gradients and volumes
// (ops/cuda/corner_gather.pair_tables) and passed by value as a kernel
// argument, so they sit in the launch's own parameter bank: every index is
// a compile-time constant after unrolling, so each multiply-add takes its
// table entry straight from the constant bank, the same address in every
// lane, and no copy to the card precedes a launch (nor can two launches
// with different spacings share one table).  The loop runs over the 27
// neighbours d outermost: each neighbour's 3 values are loaded and
// sanitized once, then fed to the cells l that hold it as corner m
// (CORNERS[m] = CORNERS[l] + d), into two accumulators per cell and
// component (48 in all); the cell's lam and mu multiply them at the end.
// A missing cell (outside [0, nx) x [0, ny) x [0, nz)) has lam = mu = 0; a
// neighbour outside the grid reads as 0, and every neighbour reached only
// through missing cells is outside the grid or a constrained pad node, so
// it is 0 either way.
// Fully constrained nodes (Dirichlet planes, the dead +X planes and +Y
// rows) skip the gather and write x.  Constrained outputs are written by
// select (+0.0 stays +0.0).  The mass is the stored mass_grid (not K1's
// synthesized one).
//
// f64 instance (precision.vectors: fp64): x, out, the tables (3,456 B of
// the 4,096 B parameter space), the accumulators, ss and mf in double;
// lam, mu and mass are the f32 grids, widened, and the tables the
// f32-rounded weights widened before their products are summed in f64, as
// the plain version computes.
//
// Bound on the H100 at 255^3 cells (16.8M nodes): operations.  The dense
// A/B form does 2 x 8 cells x 8 corners x 9 multiply-adds per node, 2,304
// flop, ~38.8 GFLOP: ~0.58 ms at 67 TFLOP/s in f32 and in f64 (each
// cell's 24 corner values times the 48 x 24 table [A; B] is a matrix
// product, which the f64 tensor cores run at 67 TFLOP/s); the bytes (x and
// out 12 B/node each, lam + mu 8 B/cell, mass 4 B/node, mask 3 B/node:
// ~0.65 GB) take ~0.19 ms.  The design keeps the arithmetic at one FMA
// per table entry with no load for the entry; x is read through L1/L2 (27
// neighbours per node, mostly cache hits).
#include <cstring>

#include "structured.cuh"

namespace {

constexpr int kTable = 8 * 3 * 8 * 3;  // one of A, B: [l][b][m][c]

// A then B, [l][b][m][c] each, by value (the parameter bank)
template <typename T>
struct Tables {
  T v[2 * kTable];
};

// CORNERS (Gmsh hex order): (0,0,0) (1,0,0) (1,1,0) (0,1,0) then z = 1
__host__ __device__ constexpr int corner_x(int l) {
  return ((l & 3) == 1 || (l & 3) == 2) ? 1 : 0;
}
__host__ __device__ constexpr int corner_y(int l) { return (l & 3) >= 2 ? 1 : 0; }
__host__ __device__ constexpr int corner_z(int l) { return l >= 4 ? 1 : 0; }

// index of corner (cx, cy, cz) in CORNERS, -1 off the cell
__host__ __device__ constexpr int corner_index(int cx, int cy, int cz) {
  return (cx < 0 || cx > 1 || cy < 0 || cy > 1 || cz < 0 || cz > 1)
             ? -1
             : cz * 4 + (cy ? (cx ? 2 : 3) : (cx ? 1 : 0));
}

template <typename T>
__global__ void __launch_bounds__(256) corner_gather_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ bc,
    const float* __restrict__ lam, const float* __restrict__ mu,
    const float* __restrict__ mass, T* __restrict__ out, int X, int Y, int Z,
    int nx, int ny, int nz, int cell_y, T ss, T mf, const Tables<T> tables) {
  const int64_t comp = static_cast<int64_t>(X) * Y * Z;
  const int64_t n = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= comp) return;
  const int k = static_cast<int>(n % Z);
  const int64_t row = n / Z;
  const int j = static_cast<int>(row % Y);
  const int i = static_cast<int>(row / Y);

  const bool f0 = bc[n], f1 = bc[n + comp], f2 = bc[n + 2 * comp];
  const T x0 = x[n], x1 = x[n + comp], x2 = x[n + 2 * comp];
  if (f0 && f1 && f2) {
    out[n] = x0;
    out[n + comp] = x1;
    out[n + 2 * comp] = x2;
    return;
  }

  // the incident cells' materials, slot l = the node's corner in the cell
  float cell_lam[8], cell_mu[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    const int ci = i - corner_x(l), cj = j - corner_y(l), ck = k - corner_z(l);
    cell_lam[l] = 0.0f;
    cell_mu[l] = 0.0f;
    if (ci >= 0 && ci < nx && cj >= 0 && cj < ny && ck >= 0 && ck < nz) {
      const int64_t c = (static_cast<int64_t>(ci) * cell_y + cj) * nz + ck;
      cell_lam[l] = __ldg(lam + c);
      cell_mu[l] = __ldg(mu + c);
    }
  }

  T acc_lam[8][3], acc_mu[8][3];
#pragma unroll
  for (int l = 0; l < 8; ++l) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      acc_lam[l][b] = T(0);
      acc_mu[l][b] = T(0);
    }
  }

#pragma unroll
  for (int d = 0; d < 27; ++d) {
    const int dx = d / 9 - 1, dy = (d / 3) % 3 - 1, dz = d % 3 - 1;
    const int ii = i + dx, jj = j + dy, kk = k + dz;
    T u[3] = {T(0), T(0), T(0)};
    if (ii >= 0 && ii < X && jj >= 0 && jj < Y && kk >= 0 && kk < Z) {
      const int64_t q = n + (static_cast<int64_t>(dx) * Y + dy) * Z + dz;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        u[c] = bc[q + c * comp] ? T(0) : x[q + c * comp];
      }
    }
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      const int m =
          corner_index(corner_x(l) + dx, corner_y(l) + dy, corner_z(l) + dz);
      if (m < 0) continue;
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const int base = ((l * 3 + b) * 8 + m) * 3;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          acc_lam[l][b] = fma(tables.v[base + c], u[c], acc_lam[l][b]);
          acc_mu[l][b] = fma(tables.v[kTable + base + c], u[c], acc_mu[l][b]);
        }
      }
    }
  }

  T stiff[3] = {T(0), T(0), T(0)};
#pragma unroll
  for (int l = 0; l < 8; ++l) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      stiff[b] = fma(static_cast<T>(cell_lam[l]), acc_lam[l][b], stiff[b]);
      stiff[b] = fma(static_cast<T>(cell_mu[l]), acc_mu[l][b], stiff[b]);
    }
  }
  const T mm = mf * static_cast<T>(mass[n]);
  out[n] = civi::keff_out(f0, x0, stiff[0], ss, mm);
  out[n + comp] = civi::keff_out(f1, x1, stiff[1], ss, mm);
  out[n + 2 * comp] = civi::keff_out(f2, x2, stiff[2], ss, mm);
}

template <typename T>
int launch(const T* x, const unsigned char* bc, const float* lam,
           const float* mu, const float* mass, const T* tables, T* out, int X,
           int Y, int Z, int nx, int ny, int nz, int cell_y, T ss, T mf,
           void* stream) {
  const int64_t nodes = static_cast<int64_t>(X) * Y * Z;
  if (nodes <= 0) return 0;
  const int64_t blocks = (nodes + 255) / 256;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  Tables<T> t;
  std::memcpy(t.v, tables, sizeof(t.v));
  corner_gather_kernel<T><<<static_cast<unsigned>(blocks), 256, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      x, bc, lam, mu, mass, out, X, Y, Z, nx, ny, nz, cell_y, ss, mf, t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int civi_corner_gather(const float* x, const unsigned char* bc,
                                  const float* lam, const float* mu,
                                  const float* mass, const float* tables,
                                  float* out, int X, int Y, int Z, int nx,
                                  int ny, int nz, int cell_y, float ss,
                                  float mf, void* stream) {
  return launch<float>(x, bc, lam, mu, mass, tables, out, X, Y, Z, nx, ny, nz,
                       cell_y, ss, mf, stream);
}

extern "C" int civi_corner_gather_f64(const double* x, const unsigned char* bc,
                                      const float* lam, const float* mu,
                                      const float* mass, const double* tables,
                                      double* out, int X, int Y, int Z, int nx,
                                      int ny, int nz, int cell_y, double ss,
                                      double mf, void* stream) {
  return launch<double>(x, bc, lam, mu, mass, tables, out, X, Y, Z, nx, ny,
                        nz, cell_y, ss, mf, stream);
}
