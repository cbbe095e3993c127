// Device code shared by the structured-grid kernels (K1 and K5
// keff_structured_halo, K2 pc_keff_structured, K3 block_jacobi_apply, K4
// interior_stencil, K6 pcg_iteration_structured, G2 keff_boundary).
//
// Layout: every solver vector is component-separated, (3, X, Y, Z) f32
// (K1/K5 and K3 also have f64 instances), row-major with Z contiguous; the Dirichlet mask is (3, X, Y, Z) bytes
// (torch.bool).  K3 launches one block per (x, y) row of the node grid and
// lets the threads stride over z; K1/K5, K2 and K6 sweep tiles of (y, z)
// columns along X through shared memory (the plane sweep below), K4 a
// sweep of its own with a tile chosen by the grid's shape; G2 streams the
// nodes along z and stages tiles of its z faces.  Neighbouring threads
// touch neighbouring addresses.  Offsets into the vectors are 64-bit.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace civi {

// Boundary class of node index i along an axis of n cells: 0 on the low
// face, 2 on the high face and beyond it (the dead +X pad planes, which are
// constrained), 1 inside.  n == 1 has no interior class.
__device__ __forceinline__ int node_class(int i, int n) {
  return i == 0 ? 0 : (i >= n ? 2 : 1);
}

// Lumped-mass weight of one axis class: the stored mass is exactly
// m8 * wx * wy * wz with 0.5 per boundary axis (power-of-2 scaling, so the
// product reproduces the stored f32 grid bit for bit).
__device__ __forceinline__ float class_weight(int c) {
  return c == 1 ? 1.0f : 0.5f;
}

// mf times the lumped mass of a node of axis classes (cx, cy, cz).  The
// mass is the f32 grid value (exact: m8 times powers of 2); the f64
// instances widen it and multiply by an f64 mf, as the plain form does.
__device__ __forceinline__ float mass_scale(float mf, float m8, int cx, int cy,
                                            int cz) {
  return __fmul_rn(mf, m8 * class_weight(cx) * class_weight(cy) *
                           class_weight(cz));
}

__device__ __forceinline__ double mass_scale(double mf, float m8, int cx,
                                             int cy, int cz) {
  return __dmul_rn(mf, static_cast<double>(m8 * class_weight(cx) *
                                           class_weight(cy) * class_weight(cz)));
}

// One component of the effective-stiffness operator's output from its
// stencil sum acc: the input itself on a constrained component (identity
// row, by select), else ss * acc + mm * x as one FMA over one product.
// Spelled out, not left to contraction, so that K1/K5, K2 and K6 write the
// same bits for the same sanitized input.
__device__ __forceinline__ float keff_out(bool fixed, float x, float acc,
                                          float ss, float mm) {
  return fixed ? x : __fmaf_rn(ss, acc, __fmul_rn(mm, x));
}

__device__ __forceinline__ double keff_out(bool fixed, double x, double acc,
                                           double ss, double mm) {
  return fixed ? x : __fma_rn(ss, acc, __dmul_rn(mm, x));
}

// The six packed components 00, 11, 22, 01, 02, 12 of one class's
// symmetric 3x3 block-Jacobi inverse.
struct PcBlock {
  float c00, c11, c22, c01, c02, c12;
};

// One class of the (6, 3, 3, 3) block-Jacobi class table
// [m][x-class][y-class][z-class]; cls = (cx * 3 + cy) * 3 + cz.
__device__ __forceinline__ PcBlock load_pc_block(const float* __restrict__ table,
                                                 int cls) {
  return PcBlock{__ldg(table + 0 * 27 + cls), __ldg(table + 1 * 27 + cls),
                 __ldg(table + 2 * 27 + cls), __ldg(table + 3 * 27 + cls),
                 __ldg(table + 4 * 27 + cls), __ldg(table + 5 * 27 + cls)};
}

// T = double (K3's f64 instance) widens the f32 coefficients.
template <typename T>
__device__ __forceinline__ void apply_pc_block(const PcBlock& c, T r0, T r1,
                                               T r2, T& z0, T& z1, T& z2) {
  const T c00 = c.c00, c11 = c.c11, c22 = c.c22;
  const T c01 = c.c01, c02 = c.c02, c12 = c.c12;
  z0 = c00 * r0 + c01 * r1 + c02 * r2;
  z1 = c01 * r0 + c11 * r1 + c12 * r2;
  z2 = c02 * r0 + c12 * r1 + c22 * r2;
}

// z = M^-1 r for one node of class cls (K3).
template <typename T>
__device__ __forceinline__ void block_jacobi_node(
    const float* __restrict__ table, int cls, T r0, T r1, T r2, T& z0, T& z1,
    T& z2) {
  apply_pc_block(load_pc_block(table, cls), r0, r1, r2, z0, z1, z2);
}

// Threads per row block: Z rounded up to whole warps, at most 256.
inline unsigned row_threads(int z) {
  const int t = ((z + 31) / 32) * 32;
  return static_cast<unsigned>(t > 256 ? 256 : t);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sums three per-thread values over the block (at most 256 threads, whole
// warps) and has thread 0 write them to partials[k * count + index], k = 0,
// 1, 2.  Each block writes its own slots, so the sums need no atomics and
// are deterministic.  Every thread of the block must call it.
__device__ __forceinline__ void store_block_sums3(float s0, float s1, float s2,
                                                  float* __restrict__ partials,
                                                  int64_t count, int64_t index) {
  __shared__ float sh[3][8];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  s0 = warp_sum(s0);
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    sh[0][warp] = s0;
    sh[1][warp] = s1;
    sh[2][warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t0 = 0.0f, t1 = 0.0f, t2 = 0.0f;
    for (int i = 0; i < static_cast<int>(blockDim.x >> 5); ++i) {
      t0 += sh[0][i];
      t1 += sh[1][i];
      t2 += sh[2][i];
    }
    partials[index] = t0;
    partials[count + index] = t1;
    partials[2 * count + index] = t2;
  }
}

// ---------------------------------------------------------------------------
// The plane sweep of K1/K5, K2 and K6.
//
// A block owns a tile of kTileY x kTileZ (y, z) node columns (one warp per
// y row, one thread per column) over a chunk of X planes, and walks the
// planes of its chunk plus one halo plane on each side.  For each plane it
// holds the tile plus a one-node (y, z) halo in shared memory: the raw
// inputs arrive by cp.async into a ring of kStages staging buffers, the
// next kStages - 1 planes in flight while one plane is transformed and
// applied.  The geometry (tile, chunk, grid, shared-memory bytes,
// partials) is computed in Python (ops/cuda/plane_sweep.py) and checked
// against these constants at launch.  The copies are cp.async, not TMA: a
// TMA tensor map wants every stride a multiple of 16 bytes (Z % 4 == 0 for
// the f32 vectors, Z % 16 for the byte mask) and a driver entry point to
// encode it, while cp.async takes any Z in one code path (16-byte copies
// where Z % 4 == 0, one copy per element elsewhere).  K1/K5's f64 instance
// stages double rows in the same layout: every count below is in
// elements, and only the bytes double (smem_bytes' elem).

namespace sweep {

constexpr int kTileY = 8;
constexpr int kTileZ = 32;
constexpr int kThreads = kTileY * kTileZ;
constexpr int kWarps = kThreads / 32;
constexpr int kHaloY = kTileY + 2;
constexpr int kHaloZ = kTileZ + 2;
// bytes per staged mask row: the 4-byte words covering [z0 - 1, z0 + 33)
constexpr int kMaskWords = 10;
constexpr int kMaskRow = 4 * kMaskWords;
// halo-ring nodes of one plane (the tile's own nodes are the rest)
constexpr int kRing = 2 * kHaloZ + 2 * kTileY;
// elements of one transformed component plane (rows of kHaloZ)
constexpr int kPlane = kHaloY * kHaloZ;
// elements of one staged row: halo column h sits at h + 3, so z0 lands on
// a 16-byte boundary; and of one staged channel plane
constexpr int kStageRow = 40;
constexpr int kStagePlane = kHaloY * kStageRow;
// staging buffers in the ring
constexpr int kStages = 3;
// Blocks per SM that K1/K5 and K2 are compiled for (__launch_bounds__):
// 3 caps them at 80 registers.  With the factored interior stencil the
// sweep's staging, transforms and barriers set the pace, and a third
// resident block hides more of their latency: on an H100 at 255^3, K1 0.43
// -> 0.41 ms, its f64 instance 0.84 -> 0.74, K2 0.46 -> 0.45.  K6, which
// holds three vectors' state, slows at 3 (1.11 -> 1.24 ms) and keeps the
// default.
constexpr int kSweepBlocksPerSm = 3;

// Dynamic shared memory of a sweep over `vectors` staged vectors of
// `elem`-byte elements (4: f32, 8: f64): kStages staging buffers of
// 3 * vectors channels and of the 3 mask components, and one transformed
// plane (3 components) of the tile plus halo.
__host__ __device__ constexpr int smem_bytes(int vectors, int elem = 4) {
  return elem * (kStages * 3 * vectors * kStagePlane + 3 * kPlane) +
         kStages * 3 * kHaloY * kMaskRow;
}

// Taps passed by value (the constant bank).  The grid's interior stencil,
// class (1, 1, 1) of the class table, in its factored form
// (ops.structured.factored_taps): a homogeneous isotropic grid of
// rectangular cells is mirror-symmetric on each axis, so the diagonal
// blocks are even in dx, dy and dz, the b-c coupling (b != c) is odd along
// axes b and c and even along the third, and 30 coefficients hold the 153
// taps that are not zero.  Then the ghost taps (interior minus class) of
// the z-face classes (1, 1, 0) and (1, 1, 2) at dz = 0, as
// [side][dx+1][dy+1][b][c] — the only offsets where a z-face node's
// stencil differs from the interior one at an in-grid neighbour.  The f64
// instance of K1/K5 takes TapsT<double>: the same f32 coefficients
// widened, and ghost taps that are the exact f64 differences between the
// interior they give and the f32 z-face class rows, so that interior minus
// ghost is the class table's f32 tap at every z-face node, as the plain
// version reads it.
template <typename T>
struct Factored {
  T d[3][2][4];  // diagonal block b at |dx|: centre, +-y pair, +-z pair, corners
  T xy[2];       // x-y coupling at dx = dy = +1, by |dz|
  T xz[2];       // x-z coupling at dx = dz = +1, by |dy|
  T yz[2];       // y-z coupling at dy = dz = +1, by |dx|
};

template <typename T>
struct TapsT {
  Factored<T> f;
  T gz[2][81];
};
using Taps = TapsT<float>;
// the values of a TapsT (ops/cuda/plane_sweep.SWEEP_TAPS)
constexpr int kSweepTaps = 30 + 2 * 81;

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// One element (4 or 8 bytes) from global to shared memory.
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "f32 or f64 elements");
  if constexpr (sizeof(T) == 4) {
    cp_async4(dst, src);
  } else {
    cp_async8(dst, src);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until the oldest of the kStages groups in flight is complete: the
// kStages - 1 planes behind it stay pending.
__device__ __forceinline__ void cp_async_wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// Where the staged mask row of component c, row jy of plane jx starts: the
// byte of halo column h is at its row + (mask_shift(...) + h).  The shift
// is the offset of z0 - 1 within its aligned word, taken mod 2^32 (only
// the low two bits matter).
__device__ __forceinline__ int mask_shift(uint32_t comp, int c,
                                          uint32_t rowoff, int z0) {
  return static_cast<int>((c * comp + rowoff + z0 - 1) & 3u);
}

// Issues the cp.async copies of plane jx's tile plus halo, one warp per
// staged row: channels 3 * v + c of kVectors f32 vectors (s0, s1, s2) into
// st[ch][row][h + 3], a 4-byte copy per column (lanes 0-31, then 0-1), and
// the 3 mask components into mst[c][row][...] as whole aligned words, three
// rows per warp.  Rows and columns outside the grid are not copied (the
// transform reads them as zero).  The mask's base must be 4-byte aligned;
// a word that would run past the mask's end is read byte by byte.  The
// general path, for any Z; VecStager below is the fast one.
template <int kVectors>
__device__ __forceinline__ void stage_plane(
    const float* s0, const float* s1, const float* s2,
    const uint8_t* __restrict__ bc, float* st, uint8_t* mst, int jx, int y0,
    int z0, int Y, int Z, int64_t comp) {
  constexpr int kCh = 3 * kVectors;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t plane = static_cast<int64_t>(jx) * Y * Z;
  for (int p = warp; p < kCh * kHaloY; p += kWarps) {
    const int ch = p / kHaloY;
    const int row = p - ch * kHaloY;
    const int jy = y0 - 1 + row;
    if (jy < 0 || jy >= Y) continue;
    const int v = ch / 3;
    const float* g = (v == 0 ? s0 : (v == 1 ? s1 : s2)) +
                     (ch - 3 * v) * comp + plane +
                     static_cast<int64_t>(jy) * Z + z0 - 1;
    float* d = st + ch * kStagePlane + row * kStageRow + 3;  // column z0 - 1
    const int z = z0 - 1 + lane;
    if (z >= 0 && z < Z) cp_async4(d + lane, g + lane);
    if (lane < kHaloZ - 32 && z + 32 < Z) cp_async4(d + 32 + lane, g + 32 + lane);
  }
  constexpr int kRowsPerWarp = 32 / kMaskWords;
  const int64_t total = 3 * comp;
  for (int q0 = warp * kRowsPerWarp; q0 < 3 * kHaloY; q0 += kWarps * kRowsPerWarp) {
    const int q = q0 + lane / kMaskWords;
    const int k = lane % kMaskWords;
    if (lane >= kRowsPerWarp * kMaskWords || q >= 3 * kHaloY) continue;
    const int c = q / kHaloY;
    const int row = q - c * kHaloY;
    const int jy = y0 - 1 + row;
    if (jy < 0 || jy >= Y) continue;
    const int64_t first = c * comp + plane + static_cast<int64_t>(jy) * Z + z0 - 1;
    const int64_t addr = (first & ~int64_t{3}) + 4 * k;
    uint8_t* d = mst + (c * kHaloY + row) * kMaskRow + 4 * k;
    if (addr < 0 || addr >= total) continue;
    if (addr + 4 <= total) {
      cp_async4(d, bc + addr);
    } else {
      for (int b = 0; addr + b < total; ++b) d[b] = bc[addr + b];
    }
  }
}

// The fast staging path, for Z % 4 == 0 and 16-byte aligned vectors: each
// thread works out once which copies it issues for every plane (they move
// by the plane stride Y * Z from one plane to the next), so a plane costs
// it a few adds per copy.  A staged row's 32 own columns move as kWide
// 16-byte chunks (8 of f32, 16 of f64) and its two halo columns as single
// elements, on kLanes lanes (10 or 18): lane kLanes r + k copies chunk k
// (k < kWide), halo column z0 - 1 (k = kWide) or z0 + 32, kSub (3 or 1)
// staged rows per warp step.  The mask's 30 rows go three per warp as
// aligned words (with Z % 4 == 0 a row's words never straddle the mask's
// end), whatever the element type.
template <int kVectors, typename T = float>
struct VecStager {
  static constexpr int kPerChunk = 16 / static_cast<int>(sizeof(T));
  static constexpr int kWide = kTileZ / kPerChunk;
  static constexpr int kLanes = kWide + 2;
  static constexpr int kSub = 32 / kLanes;
  static constexpr int kRows = 3 * kVectors * kHaloY;
  static constexpr int kTasks = (kRows + kSub * kWarps - 1) / (kSub * kWarps);
  static constexpr int kMaskTasks = (3 * kHaloY + 3 * kWarps - 1) / (3 * kWarps);
  const T* g[kTasks];      // this lane's source at plane 0, or null
  int d[kTasks];           // and its element offset in a staging buffer
  int64_t m[kMaskTasks];   // its mask word's byte index at plane 0
  int md[kMaskTasks];      // and its byte offset in a mask buffer (-1: none)
  bool wide;               // 16-byte copies (k < kWide) or single elements

  __device__ __forceinline__ VecStager(const T* s0, const T* s1, const T* s2,
                                       int y0, int z0, int Y, int Z,
                                       int64_t comp) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int sub = lane / kLanes;
    const int k = lane - kLanes * sub;
    wide = k < kWide;
    const int dz = k < kWide ? kPerChunk * k : (k == kWide ? -1 : kTileZ);
#pragma unroll
    for (int t = 0; t < kTasks; ++t) {
      const int p = (t * kWarps + warp) * kSub + sub;
      const int ch = p / kHaloY;
      const int row = p - ch * kHaloY;
      const int jy = y0 - 1 + row;
      const int v = ch / 3;
      const bool ok = sub < kSub && p < kRows && jy >= 0 && jy < Y &&
                      z0 + dz >= 0 && z0 + dz < Z;
      g[t] = ok ? (v == 0 ? s0 : (v == 1 ? s1 : s2)) + (ch - 3 * v) * comp +
                      static_cast<int64_t>(jy) * Z + z0 + dz
                : nullptr;
      d[t] = ch * kStagePlane + row * kStageRow + 4 + dz;
    }
    const int msub = lane / kMaskWords;
    const int mk = lane - kMaskWords * msub;
#pragma unroll
    for (int t = 0; t < kMaskTasks; ++t) {
      const int q = (t * kWarps + warp) * 3 + msub;
      const int c = q / kHaloY;
      const int row = q - c * kHaloY;
      const int jy = y0 - 1 + row;
      const bool ok = msub < 3 && q < 3 * kHaloY && jy >= 0 && jy < Y;
      m[t] = ((c * comp + static_cast<int64_t>(jy) * Z + z0 - 1) &
              ~int64_t{3}) + 4 * mk;
      md[t] = ok ? (c * kHaloY + row) * kMaskRow + 4 * mk : -1;
    }
  }

  // The copies of the plane `plane` = jx * Y * Z elements in.
  __device__ __forceinline__ void issue(T* st, uint8_t* mst,
                                        const uint8_t* __restrict__ bc,
                                        int64_t plane, int64_t total) const {
#pragma unroll
    for (int t = 0; t < kTasks; ++t) {
      if (g[t] == nullptr) continue;
      if (wide) {
        cp_async16(st + d[t], g[t] + plane);
      } else {
        cp_async_elem(st + d[t], g[t] + plane);
      }
    }
#pragma unroll
    for (int t = 0; t < kMaskTasks; ++t) {
      const int64_t addr = m[t] + plane;
      if (md[t] >= 0 && addr >= 0 && addr < total) cp_async4(mst + md[t], bc + addr);
    }
  }
};

// The halo-ring node k (0 <= k < kRing) of a plane: rows 0 and kHaloY - 1
// in full, then columns 0 and kHaloZ - 1 of the rows between.
__device__ __forceinline__ void ring_node(int k, int& hy, int& hz) {
  if (k < 2 * kHaloZ) {
    hy = k < kHaloZ ? 0 : kHaloY - 1;
    hz = k < kHaloZ ? k : k - kHaloZ;
  } else {
    const int e = k - 2 * kHaloZ;
    hy = 1 + (e < kTileY ? e : e - kTileY);
    hz = e < kTileY ? 0 : kHaloZ - 1;
  }
}

// Tap i of k as the accumulator's type: a constant-bank tap (kConst, of
// the accumulator's type already) or a class-table row (f32, read through
// the read-only cache and widened for the f64 instance).
template <bool kConst, typename T, typename K>
__device__ __forceinline__ T tap(const K* k, int i) {
  if constexpr (kConst) {
    return k[i];
  } else {
    return static_cast<T>(__ldg(k + i));
  }
}

// acc += K v for one 3x3 tap block k, one FMA chain per component.
template <bool kConst, typename T, typename K>
__device__ __forceinline__ void fma_block(const K* k, T v0, T v1, T v2,
                                          T (&a)[3]) {
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    a[b] += tap<kConst, T>(k, 3 * b) * v0;
    a[b] += tap<kConst, T>(k, 3 * b + 1) * v1;
    a[b] += tap<kConst, T>(k, 3 * b + 2) * v2;
  }
}

// Adds one transformed plane j (ub: [3][kHaloY][kHaloZ]) to the thread's
// three outputs: acc[n] is the output at x = j - 1 + n, which sees plane j
// at offset dx = 1 - n, with its 27 x 9 taps at the class rows k0, k1, k2
// of the table.
template <typename T>
__device__ __forceinline__ void add_plane(const T* ub, int ty, int tz,
                                          const float* k0, const float* k1,
                                          const float* k2, T (&acc)[3][3]) {
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dz = -1; dz <= 1; ++dz) {
      const int h = (ty + 1 + dy) * kHaloZ + tz + 1 + dz;
      const T v0 = ub[h];
      const T v1 = ub[kPlane + h];
      const T v2 = ub[2 * kPlane + h];
      const int d = (dy + 1) * 3 + (dz + 1);
      fma_block<false>(k0 + (18 + d) * 9, v0, v1, v2, acc[0]);
      fma_block<false>(k1 + (9 + d) * 9, v0, v1, v2, acc[1]);
      fma_block<false>(k2 + d * 9, v0, v1, v2, acc[2]);
    }
  }
}

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// The sums over the symmetric groups of one component's 3 x 3 (dy, dz)
// neighbourhood in a transformed plane (p: the centre), as far as the
// component's taps need them: component 0 couples to 1 through terms odd
// in dy and to 2 through terms odd in dz, 1 to 2 through the corners odd
// in both.
template <int kC, typename T>
struct Groups {
  T c, ys, zs, cs;  // centre, +-y pair, +-z pair, four corners
  T yd, cyd;        // odd in dy: the pair's and the corners' (+y minus -y)
  T zd, czd;        // odd in dz: the pair's and the corners' (+z minus -z)
  T yz;             // odd in dy and dz: the corners with sign dy * dz

  __device__ __forceinline__ explicit Groups(const T* p) {
    const T mm = p[-kHaloZ - 1], m0 = p[-kHaloZ], mp = p[-kHaloZ + 1];
    const T cm = p[-1], cp = p[1];
    const T pm = p[kHaloZ - 1], p0 = p[kHaloZ], pp = p[kHaloZ + 1];
    c = p[0];
    ys = m0 + p0;
    zs = cm + cp;
    if constexpr (kC != 2) {  // by rows: dy = -1, +1
      const T lo = mm + mp, hi = pm + pp;
      cs = lo + hi;
      cyd = hi - lo;
      yd = p0 - m0;
    }
    if constexpr (kC != 1) {  // by columns: dz = -1, +1
      const T lo = mm + pm, hi = mp + pp;
      if constexpr (kC == 2) cs = lo + hi;
      czd = hi - lo;
      zd = cp - cm;
    }
    if constexpr (kC != 0) yz = (mm + pp) - (mp + pm);
  }
};

// sum over the diagonal group sums of component b's taps at |dx| = a,
// onto s (y-z coupling: the other component's signed corners yz)
template <int kC, typename T>
__device__ __forceinline__ T diagonal(const Factored<T>& k, int a,
                                      const Groups<kC, T>& g, T s) {
  s = fma_rn(k.d[kC][a][0], g.c, s);
  s = fma_rn(k.d[kC][a][1], g.ys, s);
  s = fma_rn(k.d[kC][a][2], g.zs, s);
  return fma_rn(k.d[kC][a][3], g.cs, s);
}

// Adds one transformed plane j to the three outputs with the factored
// interior stencil: the group sums of each component once, then per output
// component its dx = 0 terms into acc[1], and its |dx| = 1 terms (even e,
// odd o, at dx = +1) as e + o into acc[0] and e - o into acc[2].  The same
// taps as add_plane over the interior class row, with ~80 operations a
// node for 243 FMAs.
template <typename T>
__device__ __forceinline__ void add_plane_factored(const T* ub, int ty,
                                                   int tz,
                                                   const Factored<T>& k,
                                                   T (&acc)[3][3]) {
  const int h = (ty + 1) * kHaloZ + tz + 1;
  const Groups<0, T> g0(ub + h);
  const Groups<1, T> g1(ub + kPlane + h);
  const Groups<2, T> g2(ub + 2 * kPlane + h);
  // couplings odd in dx
  const T o0 = fma_rn(k.xz[1], g2.czd,
                      fma_rn(k.xz[0], g2.zd,
                             fma_rn(k.xy[1], g1.cyd, mul_rn(k.xy[0], g1.yd))));
  const T o1 = fma_rn(k.xy[1], g0.cyd, mul_rn(k.xy[0], g0.yd));
  const T o2 = fma_rn(k.xz[1], g0.czd, mul_rn(k.xz[0], g0.zd));
  // couplings even in dx: y-z, at dx = 0 and |dx| = 1
  const T e0 = diagonal(k, 1, g0, T(0));
  const T e1 = diagonal(k, 1, g1, mul_rn(k.yz[1], g2.yz));
  const T e2 = diagonal(k, 1, g2, mul_rn(k.yz[1], g1.yz));
  acc[1][0] = diagonal(k, 0, g0, acc[1][0]);
  acc[1][1] = diagonal(k, 0, g1, fma_rn(k.yz[0], g2.yz, acc[1][1]));
  acc[1][2] = diagonal(k, 0, g2, fma_rn(k.yz[0], g1.yz, acc[1][2]));
  acc[0][0] += e0 + o0;
  acc[2][0] += e0 - o0;
  acc[0][1] += e1 + o1;
  acc[2][1] += e1 - o1;
  acc[0][2] += e2 + o2;
  acc[2][2] += e2 - o2;
}

// acc -= G v over the three dz = 0 neighbours (dy = -1, 0, 1) of plane j,
// with g the [dx+1][dy+1][b][c] ghost taps of one z-face class: turns the
// interior stencil into the face node's own.
template <typename T>
__device__ __forceinline__ void subtract_z_ghosts(const T* ub, int ty, int tz,
                                                  const T* g, T (&acc)[3][3]) {
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
    const int h = (ty + 1 + dy) * kHaloZ + tz + 1;
    const T v0 = -ub[h];
    const T v1 = -ub[kPlane + h];
    const T v2 = -ub[2 * kPlane + h];
#pragma unroll
    for (int n = 0; n < 3; ++n) {
      fma_block<true>(g + ((2 - n) * 3 + (dy + 1)) * 9, v0, v1, v2, acc[n]);
    }
  }
}

// Adds plane j to the three outputs.  j is the plane's global x (a shard
// adds its offset) and ocy its row's global class, so which taps apply
// depends on global classes only.  Where the thread's row (y) and the
// three output planes (x) are of the interior class — every warp but those
// of a y face and every plane but the two next to an x face — the factored
// interior stencil from the constant bank, then at a z-face column the
// ghost taps at dz = 0 subtracted.  Elsewhere the class table.
template <typename T>
__device__ __forceinline__ void apply_plane(const T* ub, int ty, int tz,
                                            int j, int ocy, int ocz, int nx,
                                            const TapsT<T>& taps,
                                            const float* __restrict__ stencil,
                                            T (&acc)[3][3]) {
  const int cm = node_class(j - 1, nx);
  const int cc = node_class(j, nx);
  const int cp = node_class(j + 1, nx);
  if (ocy == 1 && cm == 1 && cc == 1 && cp == 1) {
    add_plane_factored(ub, ty, tz, taps.f, acc);
    if (ocz == 0) {
      subtract_z_ghosts(ub, ty, tz, taps.gz[0], acc);
    } else if (ocz == 2) {
      subtract_z_ghosts(ub, ty, tz, taps.gz[1], acc);
    }
  } else {
    const int yz = ocy * 3 + ocz;
    add_plane(ub, ty, tz, stencil + (cm * 9 + yz) * 243,
              stencil + (cc * 9 + yz) * 243, stencil + (cp * 9 + yz) * 243,
              acc);
  }
}

// Output x = j - 1 is complete: shift the window (acc[0] <- acc[1] <-
// acc[2] <- 0).
template <typename T>
__device__ __forceinline__ void shift_window(T (&acc)[3][3]) {
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    acc[0][b] = acc[1][b];
    acc[1][b] = acc[2][b];
    acc[2][b] = T(0);
  }
}

}  // namespace sweep
}  // namespace civi
