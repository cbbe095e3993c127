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
// an explicit zero plane of X padding.  The boundary corrections, scale,
// mass and identity rows are G2's (keff_boundary.cu).
//
// Bound on the H100: device memory.  The kernel must read xs and write out
// once, 24 B/node, against 454 f32 operations/node (227 nonzero taps):
// 0.017 ms for the 1024x48x48 soil column, 0.120 ms at 256^3 nodes, at
// 3.35 TB/s.  What paces a stencil of 243 FMAs per node is the issue of
// instructions, not bytes: one thread per node with 81 global loads and the
// 27-fold reuse left to L1/L2 reached 15 % of the bound on an H100.
//
// Design: the plane sweep of K1/K2/K6 (structured.cuh, civi::sweep) cut
// down to what K4 needs.  A block owns TY x TZ (y, z) columns over a
// chunk of X planes and walks them with one halo plane on each side; each
// plane's tile plus a one-node (y, z) halo of xs arrives by cp.async in a
// ring of three buffers, two planes ahead.  The input is sanitized
// already, so there is no mask, no class table and no transformed plane:
// the staged buffer is the operand.  Copies that fall outside the grid
// are zero-filling cp.async (source size 0), which is the zero padding on
// every side, n = 1 axes included.  Each staged value is read 27 times
// from shared memory, the 243 taps are a kernel parameter (constant bank),
// and three register accumulators per thread take the outputs at x = j - 1,
// j and j + 1 of plane j; a plane next to the chunk's ends feeds only the
// outputs the block owns.  The tile and the chunk follow the grid's shape
// (ops/cuda/plane_sweep.stencil_geometry, checked here): 8 x 32 where Z
// fills 32-wide rows, 16 x 16 where it fills 16-wide ones (Z = 48: the
// soil column), so few lanes idle.  Rows move as 16-byte copies where
// Z % 4 == 0 and xs is 16-byte aligned, as 4-byte copies otherwise.
#include <cstring>

#include "structured.cuh"

namespace {

struct Taps {
  float t[243];
};

constexpr int kStages = 3;

// Zero-filling asynchronous copies: with `bytes` = 0 nothing is read and
// the destination is written with zeros.
__device__ __forceinline__ void cp_async4_zfill(float* dst, const float* src,
                                                int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async16_zfill(float* dst, const float* src,
                                                 int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

// Waits until every group but the newest is complete.
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <int TY, int TZ>
struct Tile {
  static_assert((TY == 8 && TZ == 32) || (TY == 16 && TZ == 16),
                "tiles of ops/cuda/plane_sweep.STENCIL_TILES");
  static constexpr int kThreads = TY * TZ;
  static constexpr int kHaloY = TY + 2;
  static constexpr int kHaloZ = TZ + 2;
  // floats of one staged row: halo column h at h + 3, so z0 sits on a
  // 16-byte boundary; a 16-wide tile puts two rows in a warp, and a stride
  // of 16 mod 32 floats puts them in different banks
  static constexpr int kRow = TZ == 32 ? 40 : 48;
  static constexpr int kPlane = kHaloY * kRow;  // one component
  static constexpr int kStage = 3 * kPlane;     // one buffer of the ring
  static constexpr int kSmem = 4 * kStages * kStage;
  // the copies of one plane: per staged row TZ / 4 16-byte chunks and two
  // halo words (VEC), or kHaloZ words
  static constexpr int kRowCopies = TZ / 4 + 2;
  static constexpr int kCopies = 3 * kHaloY * kRowCopies;
  static constexpr int kCopies4 = 3 * kHaloY * kHaloZ;
};

// The copies one thread issues for every plane, worked out once: the
// source offset at plane 0 (-1: outside the grid, zero-filled) and the
// destination in a buffer, with the width of each.
template <int TY, int TZ, bool VEC>
struct Stager {
  using T = Tile<TY, TZ>;
  static constexpr int kTotal = VEC ? T::kCopies : T::kCopies4;
  static constexpr int kTasks = (kTotal + T::kThreads - 1) / T::kThreads;
  int64_t src[kTasks];
  int dst[kTasks];
  bool wide[kTasks];

  __device__ __forceinline__ Stager(int y0, int z0, int Y, int Z,
                                    int64_t comp) {
#pragma unroll
    for (int t = 0; t < kTasks; ++t) {
      const int q = t * T::kThreads + static_cast<int>(threadIdx.x);
      const int per_row = VEC ? T::kRowCopies : T::kHaloZ;
      const int r = q / per_row;  // staged row: component c, halo row hy
      const int k = q - r * per_row;
      const int c = r / T::kHaloY;
      const int hy = r - c * T::kHaloY;
      // halo column h of the first element, and whether it is a chunk
      int h;
      bool w = false;
      if (VEC) {
        w = k < TZ / 4;
        h = w ? 1 + 4 * k : (k == TZ / 4 ? 0 : TZ + 1);
      } else {
        h = k;
      }
      const int jy = y0 - 1 + hy;
      const int jz = z0 - 1 + h;
      const bool ok = q < kTotal && jy >= 0 && jy < Y && jz >= 0 && jz < Z;
      src[t] = ok ? c * comp + static_cast<int64_t>(jy) * Z + jz : -1;
      dst[t] = q < kTotal ? c * T::kPlane + hy * T::kRow + 3 + h : -1;
      wide[t] = w;
    }
  }

  // The copies of plane `plane` = jx * Y * Z elements in, into buffer st.
  __device__ __forceinline__ void issue(float* st, const float* xs,
                                        int64_t plane) const {
#pragma unroll
    for (int t = 0; t < kTasks; ++t) {
      if (dst[t] < 0) continue;
      const bool ok = src[t] >= 0;
      const float* g = ok ? xs + src[t] + plane : xs;
      if (VEC && wide[t]) {
        cp_async16_zfill(st + dst[t], g, ok ? 16 : 0);
      } else {
        cp_async4_zfill(st + dst[t], g, ok ? 4 : 0);
      }
    }
  }
};

// Adds staged plane j (s: [3][kHaloY][kRow]) to the thread's outputs: bit
// n of W set adds it to acc[n], the output at x = j - 1 + n, which sees
// plane j at dx = 1 - n.
template <int TY, int TZ, int W>
__device__ __forceinline__ void add_plane(const float* s, int h0,
                                          const Taps& taps,
                                          float (&acc)[3][3]) {
  using T = Tile<TY, TZ>;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dz = -1; dz <= 1; ++dz) {
      const int h = h0 + dy * T::kRow + dz;
      const float v[3] = {s[h], s[T::kPlane + h], s[2 * T::kPlane + h]};
      const int d = (dy + 1) * 3 + (dz + 1);
#pragma unroll
      for (int n = 0; n < 3; ++n) {
        if (!(W & (1 << n))) continue;
        const int k = ((2 - n) * 9 + d) * 9;
#pragma unroll
        for (int b = 0; b < 3; ++b) {
#pragma unroll
          for (int c = 0; c < 3; ++c) acc[n][b] += taps.t[k + 3 * b + c] * v[c];
        }
      }
    }
  }
}

template <int TY, int TZ, bool VEC>
__global__ void __launch_bounds__(TY * TZ) interior_sweep_kernel(
    const float* __restrict__ xs, const __grid_constant__ Taps taps,
    float* __restrict__ out, int X, int Y, int Z, int chunk) {
  using T = Tile<TY, TZ>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* st = reinterpret_cast<float*>(smem);

  const int tz = threadIdx.x % TZ;
  const int ty = threadIdx.x / TZ;
  const int z0 = blockIdx.x * TZ;
  const int y0 = blockIdx.y * TY;
  const int x_lo = blockIdx.z * chunk;
  const int x_hi = min(x_lo + chunk, X);
  const int iy = y0 + ty;
  const int iz = z0 + tz;
  const bool own = iy < Y && iz < Z;
  const int64_t comp = static_cast<int64_t>(X) * Y * Z;
  const int64_t plane_size = static_cast<int64_t>(Y) * Z;
  // the thread's node in a staged component plane
  const int h0 = (ty + 1) * T::kRow + 4 + tz;

  // the halo planes exist where the grid does (beyond it: zero, skipped)
  const int jlo = max(x_lo - 1, 0);
  const int jhi = min(x_hi, X - 1);
  const Stager<TY, TZ, VEC> stager(y0, z0, Y, Z, comp);
  stager.issue(st, xs, jlo * plane_size);
  civi::sweep::cp_async_commit();
  if (jlo + 1 <= jhi) stager.issue(st + T::kStage, xs, (jlo + 1) * plane_size);
  civi::sweep::cp_async_commit();

  float acc[3][3] = {};
  auto emit = [&](int xo) {
    const int64_t n0 = (static_cast<int64_t>(xo) * Y + iy) * Z + iz;
#pragma unroll
    for (int b = 0; b < 3; ++b) out[n0 + b * comp] = acc[0][b];
  };
  int buf = 0;  // (j - jlo) % kStages
  for (int j = jlo; j <= jhi; ++j) {
    cp_async_wait_all_but_one();
    // plane j is in for every thread, and every thread is done with plane
    // j - 1, whose buffer now takes plane j + 2
    __syncthreads();
    if (j + 2 <= jhi) {
      const int ahead = buf == 0 ? 2 : buf - 1;
      stager.issue(st + ahead * T::kStage, xs, (j + 2) * plane_size);
    }
    civi::sweep::cp_async_commit();
    if (own) {
      const float* s = st + buf * T::kStage;
      // the outputs j - 1, j, j + 1 that lie in [x_lo, x_hi)
      const int w = (j - 1 >= x_lo ? 1 : 0) | (j >= x_lo && j < x_hi ? 2 : 0) |
                    (j + 1 < x_hi ? 4 : 0);
      switch (w) {
        case 7: add_plane<TY, TZ, 7>(s, h0, taps, acc); break;
        case 6: add_plane<TY, TZ, 6>(s, h0, taps, acc); break;
        case 4: add_plane<TY, TZ, 4>(s, h0, taps, acc); break;
        case 3: add_plane<TY, TZ, 3>(s, h0, taps, acc); break;
        case 2: add_plane<TY, TZ, 2>(s, h0, taps, acc); break;
        case 1: add_plane<TY, TZ, 1>(s, h0, taps, acc); break;
        default: break;
      }
      if (j - 1 >= x_lo) emit(j - 1);
    }
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      acc[0][b] = acc[1][b];
      acc[1][b] = acc[2][b];
      acc[2][b] = 0.0f;
    }
    buf = buf == kStages - 1 ? 0 : buf + 1;
  }
  // the grid's last plane has no plane after it
  if (own && jhi == x_hi - 1) emit(jhi);
}

template <int TY, int TZ>
int launch(const float* xs, const Taps& taps, float* out, int X, int Y, int Z,
           int chunk, dim3 grid, bool vec, cudaStream_t stream) {
  constexpr int kSmem = Tile<TY, TZ>::kSmem;
  static_assert(kSmem <= 48 * 1024, "no opt-in shared memory needed");
  if (vec) {
    interior_sweep_kernel<TY, TZ, true><<<grid, TY * TZ, kSmem, stream>>>(
        xs, taps, out, X, Y, Z, chunk);
  } else {
    interior_sweep_kernel<TY, TZ, false><<<grid, TY * TZ, kSmem, stream>>>(
        xs, taps, out, X, Y, Z, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// taps: 243 host floats, copied into the launch's parameters; tile, chunk,
// grid and smem as ops/cuda/plane_sweep.stencil_geometry computes them,
// refused (cudaErrorInvalidValue) unless they match a tile of this build;
// vec: 16-byte copies (Z % 4 == 0 and xs 16-byte aligned)
extern "C" int civi_interior_stencil(const float* xs, const float* taps,
                                     float* out, int X, int Y, int Z,
                                     int tile_y, int tile_z, int chunk,
                                     int grid_x, int grid_y, int grid_z,
                                     int smem, int vec, void* stream) {
  if (X <= 0 || Y <= 0 || Z <= 0 || chunk <= 0 || (vec && Z % 4 != 0) ||
      grid_x != (Z + tile_z - 1) / tile_z ||
      grid_y != (Y + tile_y - 1) / tile_y ||
      grid_z != (X + chunk - 1) / chunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps t;
  std::memcpy(t.t, taps, sizeof(t.t));
  const dim3 grid(grid_x, grid_y, grid_z);
  const auto s = static_cast<cudaStream_t>(stream);
  if (tile_y == 8 && tile_z == 32 && smem == Tile<8, 32>::kSmem) {
    return launch<8, 32>(xs, t, out, X, Y, Z, chunk, grid, vec != 0, s);
  }
  if (tile_y == 16 && tile_z == 16 && smem == Tile<16, 16>::kSmem) {
    return launch<16, 16>(xs, t, out, X, Y, Z, chunk, grid, vec != 0, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
