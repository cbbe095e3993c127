// G3 corner_gather: the complete effective-stiffness operator of a
// HETEROGENEOUS structured grid, out = bc ? x : ss * K(lam_c, mu_c) xs +
// mf * mass * xs with xs = bc ? 0 : x, in one launch.
//
// Replaces no Pallas kernel: the reference computes this operator in XLA,
// the corner-gather element loop _apply_heterogeneous_stiffness and the
// envelope of _apply_keff_structured_base
// (civiwave_tpu/ops/structured.py:504-552, :603-609).  Its plain version is
// ops.structured.heterogeneous_stiffness inside apply_keff_structured_plain.
//
// Semantics.  The element matrix splits by material, K_e = lam_c A +
// mu_c B, with A and B constant (8, 3, 8, 3) tables built on the host from
// the f32-rounded Gauss gradients and volumes, summed in f64
// (ops/cuda/corner_gather.pair_tables).  A missing cell (outside [0, nx) x
// [0, ny) x [0, nz)) has lam = mu = 0; a neighbour off the grid reads as
// 0.  The cell grids are (X, cell_y, nz): padded along +X and +Y, never
// along Z.  Fully constrained nodes (Dirichlet planes, the dead +X planes
// and +Y rows) write x; every constrained output is written by select
// (+0.0 stays +0.0).  The mass is the stored mass_grid (not K1's
// synthesized one).  ss and mf are launch arguments: a new dt rebuilds
// nothing.
//
// Bound on the H100 at 255^3 cells (16.8M nodes): operations.  Each cell's
// 24 corner values times the 48 x 24 table [A; B] is 1,152 multiply-adds,
// ~38 GFLOP per application: ~0.57 ms at 67 TFLOP/s (f32 outside the tensor
// cores; f64 on the tensor cores).  The bytes (x and out, the mask, the
// mass, lam and mu: 0.65 GB in f32, 1.06 GB in f64) take 0.19 / 0.32 ms.
//
// Design: the plane sweep of K1 (structured.cuh, civi::sweep), with the
// work split into an element stage and a gather stage inside the block,
// and no atomics.  A block owns 8 x 32 (y, z) node columns over a chunk
// of 32 X planes and walks node planes x_lo - 1 .. x_hi.  For each plane:
//
// * staging: x and the mask of the next node plane (tile plus a one-node
//   halo, 4- or 8-byte cp.async copies, any Z) and lam and mu of the next
//   cell plane (the 9 x 33 cell tile of the 8 x 32 nodes, 4-byte copies
//   that zero-fill a cell off the grid) land one plane ahead in a ring of
//   two; each node is sanitized once into a ring of two node planes;
// * element stage, for cell plane ci between node planes ci and ci + 1:
//   f_c = lam_c (A u_c) + mu_c (B u_c) for the 297 cells of the tile, u_c
//   the cell's 24 sanitized corner values read from the two node planes,
//   written as 24 corner forces per cell into shared memory;
//     - f32: FFMA, two cells per thread (149 threads), in two halves (the
//       corners on node plane ci, then on ci + 1) and one output component
//       at a time, 16 accumulators live.  The table sits in shared memory
//       and every lane reads the same float4 (a broadcast): one LDS.128
//       per 8 FFMA.  Taken from the parameter bank at compile-time
//       indices instead, each entry costs a ULDC into a uniform register
//       before its FFMA (sm_90's compiler does that for a by-value and a
//       __grid_constant__ table alike), and that form was slower than the
//       one-thread-per-node kernel it replaced; one cell per thread with
//       the shared table was slower than two.  No TF32: it keeps about
//       three digits against the 1e-5 of max|ref| the kernel is held to;
//     - f64: the tensor cores, mma.sync m8n8k4 f64 (DMMA): M = the 48 rows
//       of [A; B], K = the 24 corner values, N = 8 cells.  A warp takes
//       groups of 8 cells (38 groups over 8 warps); each lane's 36 table
//       fragments stay in registers for the whole block, its B fragment
//       is read straight from the sanitized node planes, and lam A u +
//       mu B u meet in the same lane (rows b * 8 + l of A and of B sit in
//       tiles b and b + 3);
// * gather stage: each node thread adds its <= 8 cells' corner forces
//   (the 4 on plane ci finish node plane ci, the 4 on plane ci + 1 are
//   carried to the next plane) and writes node plane ci through
//   civi::keff_out with the mass term and the identity rows.
//
// Shards and plane ranges (parallel/sharding.py, ops/structured_sharded.py).
// The block is a shard's (3, X, Y, Z) node block at offsets (x0, y0) in the
// global grid, and the launch writes its planes [p0, p1) (a whole grid:
// offsets 0, planes [0, X), no ghosts).  A node row of plane jx, row jy
// (local) comes from the block where both lie inside it; from an X ghost
// plane (3, Y + 2 gy, Z), row jy + gy, at jx = -1 or X; in the 2-D (X, Y)
// decomposition (gy = 1) from a Y ghost row (3, X, Z) at jy = -1 or Y;
// else it reads as zero (K5's routing, csrc/keff_structured_halo.cu).  A
// null ghost reads as zero, a null ghost mask as free.  Cell (ci, cj) has
// its low corner at node (ci, cj), so the block holds the cells of its
// nodes (X, cell_y, nz), and a node needs one more cell plane and row
// below it: lam and mu of cell plane -1 come from a ghost cell plane
// (cell_y + gy, nz) from row -gy (in 2-D it carries the corner cell
// (-1, -1)), of cell row -1 from a ghost cell row (X, nz).  A cell is live
// at its GLOBAL coordinate (x0 + ci < nx, y0 + cj < ny), so the dead +X
// planes, the dead +Y rows and the global ends read lam = mu = 0.  Each
// node's cells are computed from the same bits as on the whole grid and
// summed in the same order, so every cut, gathered, equals the whole grid
// bit for bit, and the overlap split's three launches equal one.
//
// Redundancy: a block computes the 9 x 33 cells its 8 x 32 nodes touch,
// 16 % more than it owns, and the chunk's first cell plane x_lo - 1 is
// computed by two blocks (f32: only its upper half here).  Shared memory:
// 58,272 B (f32) and 99,936 B (f64), so two blocks fit on an SM in both.
#include <cstring>

#include "structured.cuh"

namespace {

using civi::sweep::kHaloY;
using civi::sweep::kHaloZ;
using civi::sweep::kMaskRow;
using civi::sweep::kMaskWords;
using civi::sweep::kPlane;
using civi::sweep::kRing;
using civi::sweep::kThreads;
using civi::sweep::kTileY;
using civi::sweep::kTileZ;

// the cell tile of the node tile: cells (y0 - 1 + r, z0 - 1 + col)
constexpr int kCellY = kTileY + 1;
constexpr int kCellZ = kTileZ + 1;
constexpr int kCells = kCellY * kCellZ;  // 297
constexpr int kGroups = (kCells + 7) / 8;  // 38 DMMA column groups
// one force row (and one lam/mu plane) in shared memory: >= 8 * kGroups,
// and 8 mod 16 doubles, so a warp's f64 row stores spread over both halves
// of the banks
constexpr int kForceStride = 312;
// staging ring: the next plane in flight while one is worked
constexpr int kStages = 2;
// [A; B]: 48 rows (A/B, b, l) x 24 columns (c, m)
constexpr int kRows = 48;
constexpr int kCols = 24;

template <typename T>
struct Packed {
  T v[kRows * kCols];
};

// Dynamic shared memory, byte offsets: the staged x planes, the sanitized
// node planes and the corner forces (all T), lam and mu (f32), the mask,
// the f32 table
template <typename T>
struct Smem {
  static constexpr int kStage = 3 * kHaloY * kHaloZ;  // elements per plane
  static constexpr int kSan = 3 * kPlane;
  static constexpr int kCellStage = 2 * kForceStride;  // floats: lam, mu
  static constexpr int kMaskStage = 3 * kHaloY * kMaskRow;
  static constexpr int st = 0;
  static constexpr int san = st + kStages * kStage * int(sizeof(T));
  static constexpr int force = san + 2 * kSan * int(sizeof(T));
  static constexpr int cell = force + 24 * kForceStride * int(sizeof(T));
  static constexpr int mask = cell + kStages * kCellStage * 4;
  // the f32 table, [row][k]; the f64 instance stages its table through the
  // force rows before they are first written
  static constexpr int table =
      sizeof(T) == 4 ? mask + kStages * kMaskStage : force;
  static constexpr int bytes =
      mask + kStages * kMaskStage + (sizeof(T) == 4 ? kRows * kCols * 4 : 0);
};

// CORNERS (Gmsh hex order): (0,0,0) (1,0,0) (1,1,0) (0,1,0) then z = 1
__host__ __device__ constexpr int corner_x(int l) {
  return ((l & 3) == 1 || (l & 3) == 2) ? 1 : 0;
}
__host__ __device__ constexpr int corner_y(int l) { return (l & 3) >= 2 ? 1 : 0; }
__host__ __device__ constexpr int corner_z(int l) { return l >= 4 ? 1 : 0; }
// corner i (0-3) of the four with corner_x == h
__host__ __device__ constexpr int half_corner(int h, int i) {
  return h ? (i < 2 ? 1 + i : 3 + i) : (i < 2 ? 3 * i : 1 + 3 * (i - 1));
}

__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src,
                                                bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Waits until every group but the newest is complete.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <typename T>
struct Args {
  const T* x;
  const uint8_t* bc;
  // X ghost planes below plane 0 / above plane X - 1, (3, Y + 2 gy, Z);
  // in 2-D (gy = 1) Y ghost rows below row 0 / above row Y - 1, (3, X, Z)
  const T *gx_lo, *gx_hi, *gy_lo, *gy_hi;
  const uint8_t *bgx_lo, *bgx_hi, *bgy_lo, *bgy_hi;
  const float* lam;
  const float* mu;
  // lam and mu of cell plane -1, (cell_y + gy, nz) from cell row -gy, and
  // in 2-D of cell row -1, (X, nz)
  const float *lam_gx, *mu_gx, *lam_gy, *mu_gy;
  const float* mass;
  T* out;
  // the block's node extents, its global offsets, the global cells, the
  // block's cell rows, gy, the planes [p0, p1) written, the chunk
  int X, Y, Z, x0, y0, nx, ny, nz, cell_y, ghost_y, p0, p1, chunk;
  T ss, mf;
};

// A staged node row's source: component 0 of its z = 0 entry (null: the
// row reads as zero), its mask row (null: free), the start of the mask
// buffer that holds it (3 * cs bytes) and the stride between components.
template <typename T>
struct Src {
  const T* v;
  const uint8_t* m;
  const uint8_t* mbase;
  int64_t cs;
};

template <typename T>
__device__ __forceinline__ Src<T> row_source(const Args<T>& a, int jx, int jy) {
  const int gy = a.ghost_y;
  if (jx >= 0 && jx < a.X) {
    if (jy >= 0 && jy < a.Y) {  // the block
      const int64_t off = (static_cast<int64_t>(jx) * a.Y + jy) * a.Z;
      return {a.x + off, a.bc + off, a.bc, static_cast<int64_t>(a.X) * a.Y * a.Z};
    }
    if (!gy || jy < -1 || jy > a.Y) return {nullptr, nullptr, nullptr, 0};
    // a Y ghost row (selects, not an index: no local copy of the params)
    const T* g = jy < 0 ? a.gy_lo : a.gy_hi;
    const uint8_t* bg = jy < 0 ? a.bgy_lo : a.bgy_hi;
    if (g == nullptr) return {nullptr, nullptr, nullptr, 0};
    const int64_t off = static_cast<int64_t>(jx) * a.Z;
    return {g + off, bg == nullptr ? nullptr : bg + off, bg,
            static_cast<int64_t>(a.X) * a.Z};
  }
  if (jx < -1 || jx > a.X) return {nullptr, nullptr, nullptr, 0};
  const T* g = jx < 0 ? a.gx_lo : a.gx_hi;  // an X ghost plane
  const uint8_t* bg = jx < 0 ? a.bgx_lo : a.bgx_hi;
  const int rows = a.Y + 2 * gy;
  const int ry = jy + gy;
  if (g == nullptr || ry < 0 || ry >= rows) return {nullptr, nullptr, nullptr, 0};
  const int64_t off = static_cast<int64_t>(ry) * a.Z;
  return {g + off, bg == nullptr ? nullptr : bg + off, bg,
          static_cast<int64_t>(rows) * a.Z};
}

// Issues the copies of the staged rows [row0, row0 + nrows) of a node
// plane outside the block (an X ghost plane, a Y ghost row), each from its
// source (``source(jy)``, a Src), as stage_block_rows copies the block's;
// a word that runs past the end of its mask buffer is read byte by byte,
// a row with no source is not copied (the transform reads it as zero).
template <typename T, typename Source>
__device__ __forceinline__ void stage_rows(const Args<T>& a, T* st,
                                           uint8_t* mst, int y0, int z0,
                                           int row0, int nrows,
                                           const Source& source) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int p = warp; p < 3 * nrows; p += warps) {
    const int c = p / nrows;
    const int row = row0 + p - c * nrows;
    const Src<T> s = source(y0 - 1 + row);
    if (s.v == nullptr) continue;
    const T* g = s.v + c * s.cs + z0 - 1;
    T* d = st + (c * kHaloY + row) * kHaloZ;
    const int z = z0 - 1 + lane;
    if (z >= 0 && z < a.Z) civi::sweep::cp_async_elem(d + lane, g + lane);
    if (lane < kHaloZ - 32 && z + 32 < a.Z) {
      civi::sweep::cp_async_elem(d + 32 + lane, g + 32 + lane);
    }
  }
  constexpr int kRowsPerWarp = 32 / kMaskWords;
  for (int q0 = warp * kRowsPerWarp; q0 < 3 * nrows;
       q0 += warps * kRowsPerWarp) {
    const int q = q0 + lane / kMaskWords;
    const int k = lane % kMaskWords;
    if (lane >= kRowsPerWarp * kMaskWords || q >= 3 * nrows) continue;
    const int c = q / nrows;
    const int row = row0 + q - c * nrows;
    const Src<T> s = source(y0 - 1 + row);
    if (s.m == nullptr) continue;
    // the buffers are 4-byte aligned: a word at or past mbase is whole
    const uintptr_t lo = reinterpret_cast<uintptr_t>(s.mbase);
    const uintptr_t hi = lo + static_cast<uintptr_t>(3 * s.cs);
    const uintptr_t w =
        ((reinterpret_cast<uintptr_t>(s.m) + c * s.cs + z0 - 1) & ~uintptr_t{3}) +
        4 * k;
    uint8_t* d = mst + (c * kHaloY + row) * kMaskRow + 4 * k;
    if (w < lo || w >= hi) continue;
    const uint8_t* src = reinterpret_cast<const uint8_t*>(w);
    if (w + 4 <= hi) {
      civi::sweep::cp_async4(d, src);
    } else {
      for (int b = 0; w + b < hi; ++b) d[b] = src[b];
    }
  }
}

// Issues the copies of the staged rows of block plane jx that lie in the
// block: x into st[c][row][h] (one warp per row, an element per lane, then
// lanes 0-1 for the last two columns) and the mask into mst[c][row] as the
// aligned words covering [z0 - 1, z0 + 33), three rows per warp; a word
// that runs past the mask's end is read byte by byte.  civi::sweep::
// stage_plane does the same for f32 vectors only; made generic and inlined
// here it raised G3's spills and ran slower, so G3 keeps this rolled loop,
// and keeps it apart from stage_rows: routed through stage_rows' sources,
// the block's rows made the kernel slower.
template <typename T>
__device__ __forceinline__ void stage_block_rows(const Args<T>& a, T* st,
                                                 uint8_t* mst, int jx, int y0,
                                                 int z0, int64_t comp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int64_t plane = static_cast<int64_t>(jx) * a.Y * a.Z;
  for (int p = warp; p < 3 * kHaloY; p += warps) {
    const int c = p / kHaloY;
    const int jy = y0 - 1 + p - c * kHaloY;
    if (jy < 0 || jy >= a.Y) continue;  // a ghost row or none
    const T* g = a.x + c * comp + plane + static_cast<int64_t>(jy) * a.Z + z0 - 1;
    T* d = st + p * kHaloZ;
    const int z = z0 - 1 + lane;
    if (z >= 0 && z < a.Z) civi::sweep::cp_async_elem(d + lane, g + lane);
    if (lane < kHaloZ - 32 && z + 32 < a.Z) {
      civi::sweep::cp_async_elem(d + 32 + lane, g + 32 + lane);
    }
  }
  constexpr int kRowsPerWarp = 32 / kMaskWords;
  const int64_t total = 3 * comp;
  for (int q0 = warp * kRowsPerWarp; q0 < 3 * kHaloY;
       q0 += warps * kRowsPerWarp) {
    const int q = q0 + lane / kMaskWords;
    const int k = lane % kMaskWords;
    if (lane >= kRowsPerWarp * kMaskWords || q >= 3 * kHaloY) continue;
    const int c = q / kHaloY;
    const int jy = y0 - 1 + q - c * kHaloY;
    if (jy < 0 || jy >= a.Y) continue;  // a ghost row or none
    const int64_t first = c * comp + plane + static_cast<int64_t>(jy) * a.Z + z0 - 1;
    const int64_t addr = (first & ~int64_t{3}) + 4 * k;
    uint8_t* d = mst + q * kMaskRow + 4 * k;
    if (addr < 0 || addr >= total) continue;
    if (addr + 4 <= total) {
      civi::sweep::cp_async4(d, a.bc + addr);
    } else {
      for (int b = 0; addr + b < total; ++b) d[b] = a.bc[addr + b];
    }
  }
}

// Issues the copies of node plane jx, tile plus halo: a plane of the block
// from the block, then in 2-D the (at most two) Y ghost rows of the tile's
// halo; a plane outside the block from its X ghost plane.
template <typename T>
__device__ __forceinline__ void stage_nodes(const Args<T>& a, T* st,
                                            uint8_t* mst, int jx, int y0,
                                            int z0) {
  if (jx < 0 || jx >= a.X) {
    stage_rows(a, st, mst, y0, z0, 0, kHaloY,
               [&](int jy) { return row_source(a, jx, jy); });
    return;
  }
  stage_block_rows(a, st, mst, jx, y0, z0,
                   static_cast<int64_t>(a.X) * a.Y * a.Z);
  if (a.ghost_y) {  // the halo rows -1 and Y, where the tile reaches them
    const auto ghost = [&](int jy) { return row_source(a, jx, jy); };
    if (y0 == 0) stage_rows(a, st, mst, y0, z0, 0, 1, ghost);
    if (a.Y - y0 + 1 < kHaloY) stage_rows(a, st, mst, y0, z0, a.Y - y0 + 1, 1, ghost);
  }
}

// Issues the copies of lam and mu of cell plane ci over the cell tile into
// cl[0][n] and cl[kForceStride + n], n = r * kCellZ + col: from the block,
// the ghost cell plane (ci = -1) or the ghost cell row (cj = -1); a cell
// off the global grid, past the block's cell rows or with no source is
// zero-filled.
template <typename T>
__device__ __forceinline__ void stage_cells(const Args<T>& a, float* cl, int ci,
                                            int y0, int z0) {
  if (ci < 0) {  // the ghost cell plane, row cj + gy
    for (int e = threadIdx.x; e < 2 * kCells; e += blockDim.x) {
      const int m = e >= kCells;
      const int n = e - m * kCells;
      const int r = n / kCellZ;
      const int cj = y0 - 1 + r;
      const int ck = z0 - 1 + n - r * kCellZ;
      const int gj = a.y0 + cj;
      const float* g = m ? a.mu_gx : a.lam_gx;
      const bool live = gj >= 0 && gj < a.ny && cj < a.cell_y &&
                        cj >= -a.ghost_y && ck >= 0 && ck < a.nz;
      cp_async4_zfill(cl + m * kForceStride + n,
                      live ? g + static_cast<int64_t>(cj + a.ghost_y) * a.nz + ck
                           : a.lam,
                      live);
    }
    return;
  }
  for (int e = threadIdx.x; e < 2 * kCells; e += blockDim.x) {
    const int m = e >= kCells;
    const int n = e - m * kCells;
    const int r = n / kCellZ;
    const int cj = y0 - 1 + r;
    const int ck = z0 - 1 + n - r * kCellZ;
    const int gj = a.y0 + cj;
    bool live = gj >= 0 && gj < a.ny && cj < a.cell_y && ck >= 0 && ck < a.nz;
    const float* src = m ? a.mu : a.lam;
    if (cj >= 0) {
      src += (static_cast<int64_t>(ci) * a.cell_y + cj) * a.nz + ck;
    } else {  // the ghost cell row
      const float* g = m ? a.mu_gy : a.lam_gy;
      live = live && g != nullptr;
      src = live ? g + static_cast<int64_t>(ci) * a.nz + ck : src;
    }
    cp_async4_zfill(cl + m * kForceStride + n, live ? src : a.lam, live);
  }
}

// xs of halo node (hy, hz) of node plane jx into san ([3][kHaloY][kHaloZ]):
// the staged x, or +0.0 on a constrained component and where the row has
// no source.  Returns the node's constrained components as bits 0-2.
template <typename T>
__device__ __forceinline__ int transform(const Args<T>& a, const T* sp,
                                         const uint8_t* mp, T* san, int jx,
                                         int y0, int z0, int hy, int hz) {
  const int jy = y0 - 1 + hy;
  const int jz = z0 - 1 + hz;
  int fixed = 0;
  T q[3] = {T(0), T(0), T(0)};
  if (jz >= 0 && jz < a.Z) {
    if (jx >= 0 && jx < a.X && jy >= 0 && jy < a.Y) {  // the block
      const uint32_t comp = static_cast<uint32_t>(a.X) * a.Y * a.Z;
      const uint32_t rowoff = (static_cast<uint32_t>(jx) * a.Y + jy) * a.Z;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int shift = civi::sweep::mask_shift(comp, c, rowoff, z0);
        const bool f = mp[(c * kHaloY + hy) * kMaskRow + shift + hz] != 0;
        // select, not multiply: a constrained component is +0.0
        q[c] = f ? T(0) : sp[(c * kHaloY + hy) * kHaloZ + hz];
        fixed |= static_cast<int>(f) << c;
      }
    } else {
      const Src<T> s = row_source(a, jx, jy);
      if (s.v != nullptr) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int shift = static_cast<int>(
              (reinterpret_cast<uintptr_t>(s.m) + static_cast<uintptr_t>(c * s.cs) +
               z0 - 1) & 3u);
          const bool f = s.m != nullptr &&
                         mp[(c * kHaloY + hy) * kMaskRow + shift + hz] != 0;
          q[c] = f ? T(0) : sp[(c * kHaloY + hy) * kHaloZ + hz];
          fixed |= static_cast<int>(f) << c;
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) san[c * kPlane + hy * kHaloZ + hz] = q[c];
  return fixed;
}

// The element stage of one cell plane: the 24 corner forces of every cell
// of the tile into force[b * 8 + l][n] from the sanitized node planes
// s_lo (plane ci) and s_hi (ci + 1) and lam, mu in cl.  `lower`: the
// forces on node plane ci are needed (else only those on ci + 1).
template <typename T>
struct ElementStage;

template <>
struct ElementStage<float> {
  // [A; B] in shared memory as [row][k / 4] quads: every lane of a warp
  // reads the same quad (a broadcast)
  const float4* table;

  __device__ __forceinline__ ElementStage(const Packed<float>& tab,
                                          float* smem_table)
      : table(reinterpret_cast<const float4*>(smem_table)) {
    for (int i = threadIdx.x; i < kRows * kCols; i += blockDim.x) {
      smem_table[i] = tab.v[i];
    }
    __syncthreads();
  }

  // Two cells per thread, n and n + kPairs, so that each quad feeds 8 FFMA;
  // one output component b at a time (16 accumulators live).
  static constexpr int kPairs = (kCells + 1) / 2;

  __device__ __forceinline__ void corner_values(const float* s_lo,
                                                const float* s_hi, int n,
                                                float (&u)[kCols]) const {
    const int r = n / kCellZ;
    const int col = n - r * kCellZ;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const float* s = corner_x(m) ? s_hi : s_lo;
        u[c * 8 + m] =
            s[c * kPlane + (r + corner_y(m)) * kHaloZ + col + corner_z(m)];
      }
    }
  }

  __device__ __forceinline__ void run(const Packed<float>&, const float* s_lo,
                                      const float* s_hi, const float* cl,
                                      float* force, bool lower) const {
    const int n0 = threadIdx.x;
    if (n0 >= kPairs) return;
    const int n1 = n0 + kPairs;  // kCells when past the tile: not written
    const int n1c = min(n1, kCells - 1);
    float u0[kCols], u1[kCols];  // column c * 8 + m of [A; B]
    corner_values(s_lo, s_hi, n0, u0);
    corner_values(s_lo, s_hi, n1c, u1);
    const float lam0 = cl[n0], mu0 = cl[kForceStride + n0];
    const float lam1 = cl[n1c], mu1 = cl[kForceStride + n1c];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 0 && !lower) continue;
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        float fa0[4], fb0[4], fa1[4], fb1[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) fa0[i] = fb0[i] = fa1[i] = fb1[i] = 0.0f;
#pragma unroll
        for (int kq = 0; kq < kCols / 4; ++kq) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = b * 8 + half_corner(h, i);
            const float4 ta = table[row * (kCols / 4) + kq];
            const float4 tb = table[(24 + row) * (kCols / 4) + kq];
            const float* v0 = u0 + 4 * kq;
            const float* v1 = u1 + 4 * kq;
            fa0[i] = fmaf(ta.x, v0[0], fa0[i]);
            fa0[i] = fmaf(ta.y, v0[1], fa0[i]);
            fa0[i] = fmaf(ta.z, v0[2], fa0[i]);
            fa0[i] = fmaf(ta.w, v0[3], fa0[i]);
            fb0[i] = fmaf(tb.x, v0[0], fb0[i]);
            fb0[i] = fmaf(tb.y, v0[1], fb0[i]);
            fb0[i] = fmaf(tb.z, v0[2], fb0[i]);
            fb0[i] = fmaf(tb.w, v0[3], fb0[i]);
            fa1[i] = fmaf(ta.x, v1[0], fa1[i]);
            fa1[i] = fmaf(ta.y, v1[1], fa1[i]);
            fa1[i] = fmaf(ta.z, v1[2], fa1[i]);
            fa1[i] = fmaf(ta.w, v1[3], fa1[i]);
            fb1[i] = fmaf(tb.x, v1[0], fb1[i]);
            fb1[i] = fmaf(tb.y, v1[1], fb1[i]);
            fb1[i] = fmaf(tb.z, v1[2], fb1[i]);
            fb1[i] = fmaf(tb.w, v1[3], fb1[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* f = force + (b * 8 + half_corner(h, i)) * kForceStride;
          f[n0] = fmaf(mu0, fb0[i], lam0 * fa0[i]);
          if (n1 < kCells) f[n1] = fmaf(mu1, fb1[i], lam1 * fa1[i]);
        }
      }
    }
  }
};

// D (8 x 8) += A (8 x 4, row) B (4 x 8, col) in f64 on the tensor cores.
// Lane l holds A[l / 4][l % 4], B[l % 4][l / 4] and D[l / 4][2 (l % 4) + i].
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

template <>
struct ElementStage<double> {
  // this lane's A fragment of [A; B] for row tile mt and k step ks
  double frag[6][6];

  // The table arrives in fragment order, frag[mt][ks][lane]
  // (ops/cuda/corner_gather.kernel_tables): copied from the parameter bank
  // into scratch shared memory once, then into registers.
  __device__ __forceinline__ ElementStage(const Packed<double>& tab,
                                          double* scratch) {
    for (int i = threadIdx.x; i < kRows * kCols; i += blockDim.x) {
      scratch[i] = tab.v[i];
    }
    __syncthreads();
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int mt = 0; mt < 6; ++mt) {
#pragma unroll
      for (int ks = 0; ks < 6; ++ks) frag[mt][ks] = scratch[(mt * 6 + ks) * 32 + lane];
    }
    __syncthreads();
  }

  __device__ __forceinline__ void run(const Packed<double>&,
                                      const double* s_lo, const double* s_hi,
                                      const float* cl, double* force,
                                      bool) const {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int warps = blockDim.x >> 5;
    // this lane's B rows: column ks * 4 + mc = c * 8 + m of [A; B], i.e.
    // component c = ks / 2 of corner m = mc + 4 (ks % 2), whose x and y
    // offsets are those of mc and whose z offset is ks % 2
    const int mc = lane & 3;
    const double* sb = (corner_x(mc) ? s_hi : s_lo) + corner_y(mc) * kHaloZ;
    const int l = lane >> 2;
    for (int g = warp; g < kGroups; g += warps) {
      // the B column's cell (pad columns of the last group read the last
      // cell; their forces land in unused columns)
      const int nb = min(g * 8 + l, kCells - 1);
      const int rb = nb / kCellZ;
      const double* bp = sb + rb * kHaloZ + nb - rb * kCellZ;
      double d[6][2];
#pragma unroll
      for (int mt = 0; mt < 6; ++mt) d[mt][0] = d[mt][1] = 0.0;
#pragma unroll
      for (int ks = 0; ks < 6; ++ks) {
        const double b = bp[(ks >> 1) * kPlane + (ks & 1)];
#pragma unroll
        for (int mt = 0; mt < 6; ++mt) dmma(d[mt], frag[mt][ks], b);
      }
      const int nc = g * 8 + 2 * mc;
      const double lam0 = cl[nc], lam1 = cl[nc + 1];
      const double mu0 = cl[kForceStride + nc], mu1 = cl[kForceStride + nc + 1];
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        double2 f;
        f.x = fma(mu0, d[b + 3][0], lam0 * d[b][0]);
        f.y = fma(mu1, d[b + 3][1], lam1 * d[b][1]);
        *reinterpret_cast<double2*>(force + (b * 8 + l) * kForceStride + nc) = f;
      }
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) corner_gather_kernel(
    const __grid_constant__ Args<T> a, const __grid_constant__ Packed<T> tab) {
  using S = Smem<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* st = reinterpret_cast<T*>(smem + S::st);
  T* san = reinterpret_cast<T*>(smem + S::san);
  T* force = reinterpret_cast<T*>(smem + S::force);
  float* cl = reinterpret_cast<float*>(smem + S::cell);
  uint8_t* mst = smem + S::mask;

  const int t = threadIdx.x;
  const int tz = t % kTileZ;
  const int ty = t / kTileZ;
  const int z0 = blockIdx.x * kTileZ;
  const int y0 = blockIdx.y * kTileY;
  const int x_lo = a.p0 + blockIdx.z * a.chunk;
  const int x_hi = min(x_lo + a.chunk, a.p1);
  const int iy = y0 + ty;
  const int iz = z0 + tz;
  const bool own = iy < a.Y && iz < a.Z;
  const int64_t comp = static_cast<int64_t>(a.X) * a.Y * a.Z;
  const int own_h = (ty + 1) * kHaloZ + tz + 1;

  // the unused tail of every lam/mu row reads as zero
  for (int i = t; i < kStages * 2 * (kForceStride - kCells); i += blockDim.x) {
    const int row = i / (kForceStride - kCells);
    cl[row * kForceStride + kCells + i - row * (kForceStride - kCells)] = 0.0f;
  }
  const ElementStage<T> element(tab, reinterpret_cast<T*>(smem + S::table));

  // whether cell plane ci has cells here: inside the global grid, and
  // below the block only from a ghost cell plane (the same for the block)
  auto cells_live = [&](int ci) {
    const int g = a.x0 + ci;
    return g >= 0 && g < a.nx && (ci >= 0 || a.lam_gx != nullptr);
  };
  // node plane j and cell plane j - 1 into ring slot j & 1
  auto issue = [&](int j) {
    const int s = j & 1;
    stage_nodes(a, st + s * S::kStage, mst + s * S::kMaskStage, j, y0, z0);
    const int ci = j - 1;
    if (ci >= x_lo - 1 && cells_live(ci)) {
      stage_cells(a, cl + s * S::kCellStage, ci, y0, z0);
    }
  };

  const int jlo = x_lo - 1;
  const int jhi = x_hi;
  // the own node of plane j - 1: constrained components and the stiffness
  // its cell plane j - 2 contributed
  int fix_prev = 0;
  T carry[3] = {T(0), T(0), T(0)};
  issue(jlo);
  civi::sweep::cp_async_commit();
  for (int j = jlo; j <= jhi; ++j) {
    if (j < jhi) issue(j + 1);
    civi::sweep::cp_async_commit();
    cp_async_wait_one();
    const bool emit = own && j - 1 >= x_lo;
    const int64_t n0 = (static_cast<int64_t>(j - 1) * a.Y + iy) * a.Z + iz;
    const float mass = emit ? __ldg(a.mass + n0) : 0.0f;
    __syncthreads();
    // node plane j: the block's own nodes, then the halo ring
    T* s_hi = san + (j & 1) * S::kSan;
    const T* sp = st + (j & 1) * S::kStage;
    const uint8_t* mp = mst + (j & 1) * S::kMaskStage;
    const int fix_cur = transform(a, sp, mp, s_hi, j, y0, z0, ty + 1, tz + 1);
    if (t < kRing) {
      int hy, hz;
      civi::sweep::ring_node(t, hy, hz);
      transform(a, sp, mp, s_hi, j, y0, z0, hy, hz);
    }
    __syncthreads();
    if (j == jlo) {
      fix_prev = fix_cur;
      continue;
    }
    // cell plane ci = j - 1 between node planes j - 1 and j
    const int ci = j - 1;
    const T* s_lo = san + (ci & 1) * S::kSan;
    const bool lower = ci >= x_lo;
    T done[3] = {carry[0], carry[1], carry[2]};
    T next[3] = {T(0), T(0), T(0)};
    if (cells_live(ci)) {  // the same for the whole block
      element.run(tab, s_lo, s_hi, cl + (j & 1) * S::kCellStage, force, lower);
      __syncthreads();
      if (own) {
#pragma unroll
        for (int l = 0; l < 8; ++l) {
          if (!corner_x(l) && !lower) continue;
          const int n = (ty + 1 - corner_y(l)) * kCellZ + tz + 1 - corner_z(l);
#pragma unroll
          for (int b = 0; b < 3; ++b) {
            const T f = force[(b * 8 + l) * kForceStride + n];
            if (corner_x(l)) {
              next[b] += f;
            } else {
              done[b] += f;
            }
          }
        }
      }
    }
    if (emit) {
      const T mm = a.mf * static_cast<T>(mass);
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const bool f = (fix_prev >> b) & 1;
        // where free, x is the sanitized value still in the plane's slot
        const T xv = f ? __ldg(a.x + n0 + b * comp) : s_lo[b * kPlane + own_h];
        a.out[n0 + b * comp] = civi::keff_out(f, xv, done[b], a.ss, mm);
      }
    }
#pragma unroll
    for (int b = 0; b < 3; ++b) carry[b] = next[b];
    fix_prev = fix_cur;
  }
}

template <typename T>
int launch(const Args<T>& a, const T* tables, dim3 grid, cudaStream_t stream) {
  constexpr int smem = Smem<T>::bytes;
  static bool raised = false;  // once per process and instance
  if (!raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        corner_gather_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    raised = true;
  }
  Packed<T> p;
  std::memcpy(p.v, tables, sizeof(p.v));
  corner_gather_kernel<T><<<grid, kThreads, smem, stream>>>(a, p);
  return static_cast<int>(cudaGetLastError());
}

// Checks the geometry against this build and launches the instance of T.
template <typename T>
int launch_checked(Args<T> a, const T* tables, int tile_y, int tile_z,
                   int grid_x, int grid_y, int grid_z, int threads, int smem,
                   void* stream) {
  if (a.X <= 0 || a.Y <= 0 || a.Z <= 0 || a.nx <= 0 || a.ny <= 0 ||
      a.nz != a.Z - 1 || a.x0 < 0 || a.y0 < 0 || a.cell_y < 0 ||
      (a.ghost_y != 0 && a.ghost_y != 1) || a.p0 < 0 || a.p1 > a.X) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.p1 <= a.p0) return 0;
  if (tile_y != kTileY || tile_z != kTileZ || a.chunk <= 0 ||
      threads != kThreads || smem != Smem<T>::bytes ||
      grid_x != (a.Z + kTileZ - 1) / kTileZ ||
      grid_y != (a.Y + kTileY - 1) / kTileY ||
      grid_z != (a.p1 - a.p0 + a.chunk - 1) / a.chunk || grid_y > 65535 ||
      grid_z > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<T>(a, tables, dim3(grid_x, grid_y, grid_z),
                   static_cast<cudaStream_t>(stream));
}

template <typename T>
int entry(const T* x, const unsigned char* bc, const T* gx_lo,
          const unsigned char* bgx_lo, const T* gx_hi,
          const unsigned char* bgx_hi, const T* gy_lo,
          const unsigned char* bgy_lo, const T* gy_hi,
          const unsigned char* bgy_hi, const float* lam, const float* mu,
          const float* lam_gx, const float* mu_gx, const float* lam_gy,
          const float* mu_gy, const float* mass, const T* tables, T* out,
          int X, int Y, int Z, int ghost_y, int x0, int y0, int nx, int ny,
          int nz, int cell_y, int p0, int p1, T ss, T mf, int tile_y,
          int tile_z, int chunk, int grid_x, int grid_y, int grid_z,
          int threads, int smem, void* stream) {
  Args<T> a;
  a.x = x;
  a.bc = bc;
  a.gx_lo = gx_lo;
  a.gx_hi = gx_hi;
  a.gy_lo = gy_lo;
  a.gy_hi = gy_hi;
  a.bgx_lo = bgx_lo;
  a.bgx_hi = bgx_hi;
  a.bgy_lo = bgy_lo;
  a.bgy_hi = bgy_hi;
  a.lam = lam;
  a.mu = mu;
  a.lam_gx = lam_gx;
  a.mu_gx = mu_gx;
  a.lam_gy = lam_gy;
  a.mu_gy = mu_gy;
  a.mass = mass;
  a.out = out;
  a.X = X;
  a.Y = Y;
  a.Z = Z;
  a.x0 = x0;
  a.y0 = y0;
  a.nx = nx;
  a.ny = ny;
  a.nz = nz;
  a.cell_y = cell_y;
  a.ghost_y = ghost_y;
  a.p0 = p0;
  a.p1 = p1;
  a.chunk = chunk;
  a.ss = ss;
  a.mf = mf;
  return launch_checked<T>(a, tables, tile_y, tile_z, grid_x, grid_y, grid_z,
                           threads, smem, stream);
}

static_assert(Smem<float>::bytes == 58272, "f32 shared memory");
static_assert(Smem<double>::bytes == 99936, "f64 shared memory");

}  // namespace

// x, the mask and their ghosts (null: zero, free), lam, mu and their ghost
// cell plane and row (null: zero), the stored mass and out as the header
// says; tables: the 1,152 values of [A; B] the instance reads, in host
// memory (copied into the launch's parameters): f32 row-major (48, 24),
// f64 in DMMA fragment order (ops/cuda/corner_gather.kernel_tables); the
// block (X, Y, Z) at (x0, y0) of the global (nx, ny, nz) cells, its
// cell_y cell rows, gy and the planes [p0, p1); tile, chunk, grid,
// threads and smem as ops/cuda/plane_sweep.corner_gather_geometry
// computes them for that range, refused unless they match this build;
// every mask buffer 4-byte aligned
extern "C" int civi_corner_gather(
    const float* x, const unsigned char* bc, const float* gx_lo,
    const unsigned char* bgx_lo, const float* gx_hi,
    const unsigned char* bgx_hi, const float* gy_lo,
    const unsigned char* bgy_lo, const float* gy_hi,
    const unsigned char* bgy_hi, const float* lam, const float* mu,
    const float* lam_gx, const float* mu_gx, const float* lam_gy,
    const float* mu_gy, const float* mass, const float* tables, float* out,
    int X, int Y, int Z, int ghost_y, int x0, int y0, int nx, int ny, int nz,
    int cell_y, int p0, int p1, float ss, float mf, int tile_y, int tile_z,
    int chunk, int grid_x, int grid_y, int grid_z, int threads, int smem,
    void* stream) {
  return entry<float>(x, bc, gx_lo, bgx_lo, gx_hi, bgx_hi, gy_lo, bgy_lo,
                      gy_hi, bgy_hi, lam, mu, lam_gx, mu_gx, lam_gy, mu_gy,
                      mass, tables, out, X, Y, Z, ghost_y, x0, y0, nx, ny, nz,
                      cell_y, p0, p1, ss, mf, tile_y, tile_z, chunk, grid_x,
                      grid_y, grid_z, threads, smem, stream);
}

extern "C" int civi_corner_gather_f64(
    const double* x, const unsigned char* bc, const double* gx_lo,
    const unsigned char* bgx_lo, const double* gx_hi,
    const unsigned char* bgx_hi, const double* gy_lo,
    const unsigned char* bgy_lo, const double* gy_hi,
    const unsigned char* bgy_hi, const float* lam, const float* mu,
    const float* lam_gx, const float* mu_gx, const float* lam_gy,
    const float* mu_gy, const float* mass, const double* tables, double* out,
    int X, int Y, int Z, int ghost_y, int x0, int y0, int nx, int ny, int nz,
    int cell_y, int p0, int p1, double ss, double mf, int tile_y, int tile_z,
    int chunk, int grid_x, int grid_y, int grid_z, int threads, int smem,
    void* stream) {
  return entry<double>(x, bc, gx_lo, bgx_lo, gx_hi, bgx_hi, gy_lo, bgy_lo,
                       gy_hi, bgy_hi, lam, mu, lam_gx, mu_gx, lam_gy, mu_gy,
                       mass, tables, out, X, Y, Z, ghost_y, x0, y0, nx, ny,
                       nz, cell_y, p0, p1, ss, mf, tile_y, tile_z, chunk,
                       grid_x, grid_y, grid_z, threads, smem, stream);
}
