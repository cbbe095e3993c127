// keff_structured_halo: the complete effective-stiffness matvec of a
// homogeneous structured hex8 grid, or of one shard of it,
//
//   out = bc ? x : ss * K(xs) + mf * mass * xs,    xs = bc ? 0 : x,
//
// on a (3, Xl, Yl, Z) block, over its local planes [p0, p1), writing only
// those planes of out.  Two wrappers launch it, each with its own count:
//
// * K1 (ops/cuda/structured_stencil.apply_keff_fused): a whole grid, no
//   ghosts, offsets 0.  Replaces the Pallas kernel apply_keff_fused_pallas
//   (civiwave_tpu/ops/pallas/structured_stencil.py:931, pallas_call at
//   :1041/:1068).
// * K5 (ops/cuda/keff_halo.keff_structured_halo): one shard.  Replaces the
//   same function's sharded forms, apply_keff_fused_pallas_padded (:968,
//   driven from ops/structured_sharded.py): the exchanged ghost planes
//   with traced x_lo/x_hi face indices in 1-D, and the ghost_y mode with
//   y_rows and the oy_lo/oy_hi ownership scalars in 2-D.
//
// The Pallas kernel streams X planes through VMEM, rolls (Y, Z) planes in
// registers and subtracts inclusion-exclusion face/edge/corner corrections,
// switched per shard by the face indices and ownership scalars.  None of
// that carries over.  A node's taps and mass come from its boundary class at
// its GLOBAL coordinate (x0 + ix against nx, y0 + iy against ny; the dead
// +X planes and +Y rows land in class 2 and are constrained), so no
// correction pass exists.  ss, mf and m8 are launch arguments: a new dt
// rebuilds nothing.
//
// Bound on the H100: device memory.  Per matvec the kernel must read x
// (12 B/node) and the mask (3 B/node) once and write out (12 B/node): 27 B
// per node, plus 15 B per ghost node read (~0.45 GB at 255^3 cells, 0.135
// ms at 3.35 TB/s).  The PR 1/PR 5 design gave each thread one node and
// read its 27 neighbours' 3 values and 3 mask bytes from device memory and
// each neighbour's 9 taps from the class table: ~405 load instructions per
// node, the reuse left to L1/L2, 12 % of the bound, limited by issue.
//
// Now it is the plane sweep of K2 and K6 (structured.cuh, civi::sweep): a
// block of 256 threads owns 8 x 32 (y, z) columns over a chunk of 32 planes
// of [p0, p1).  Each plane's x and mask, tile plus a one-node halo, arrive
// by cp.async two planes ahead; each node is sanitized once (select) into
// shared memory, and three register accumulators per thread take the
// outputs at x = j + 1, j and j - 1.  The interior stencil's factored
// coefficients and the z-face ghost taps are a kernel parameter (constant
// bank); only y-face rows and the planes next to an x face read the class
// table.  The own x and mask stay in registers from one plane to the next
// for the mass term and the identity row.  The stencil stays f32 FMA: the tensor cores' TF32 keeps
// about three digits, far from the 1e-5 of max|ref| the kernel is held to.
//
// Ghosts and plane ranges.  A staged row of plane jx, row jy (local) comes
// from the block (3, Xl, Yl, Z) when both lie inside it; from an X ghost
// plane (3, Yl + 2 gy, Z), row jy + gy, at jx = -1 or Xl; in the 2-D
// (X, Y) decomposition (gy = 1) from a Y ghost row (3, Xl, Z), offset
// jx * Z, at jy = -1 or Yl; else it reads as zero.  The 2-D X ghost planes
// are Y-extended: their rows 0 and Yl + 1 carry the diagonal corners.  A
// null ghost buffer reads as zero, a null ghost mask as free.  So the
// halo planes p0 - 1 and p1 come from the block where they lie inside it
// (the overlap split's interior launch [1, Xl - 1) reads no X ghost), and a
// halo plane beyond the block with no ghost buffer is skipped.  Block rows
// move as VecStager's precomputed 16-byte copies where Z % 4 == 0 (the
// path of K2 and K6); ghost rows, and every row otherwise, as per-row
// 4-byte copies (values) and aligned words (mask) found per plane.
//
// Bits: each output receives its planes in the order dx = -1, 0, +1 and
// each plane in apply_plane's (dy, dz) order, with taps chosen by global
// classes; a zero plane or row adds exact zeros.  So every slab or tile
// cut, gathered, equals the whole grid, the overlap split's three launches
// equal one, and K2's w equals this kernel applied to K2's u, bit for bit.
//
// f64 instance (civi_keff_structured_halo_f64, precision.vectors: fp64;
// the reference sends f64 to its XLA forms, which its Pallas kernel
// declines).  The same sweep templated on the element type T: x, the
// ghosts, out, the staged planes, the transformed plane and the three
// accumulators are double; the taps, the class table and m8 stay the f32
// values the plain form reads, widened (the by-value taps on the host, so
// the DFMAs take them from the constant bank; the z-face ghost taps are
// the exact f64 differences of the f32 interior and class rows);
// ss and mf are f64 launch arguments, as the plain form's host scalars.
// Staged rows are 8-byte elements, 16-byte copies of two where Z % 4 == 0;
// the ring takes 40,560 bytes of shared memory (f32: 22,080).  Bound at
// 255^3: ~0.86 GB (x and out 8 B per value, the mask) ~0.26 ms at 3.35
// TB/s, and the factored stencil's ~80 f64 operations per node, ~0.08 ms
// at the published 34 TFLOP/s f64 rate outside the tensor cores.
#include <cstring>

#include "structured.cuh"

namespace {

using namespace civi::sweep;

template <typename T>
struct HaloArgs {
  const T* x;
  const uint8_t* bc;
  // X ghost planes below plane 0 / above plane Xl - 1, (3, Yl + 2 gy, Z)
  const T *gx_lo, *gx_hi;
  const uint8_t *bgx_lo, *bgx_hi;
  // Y ghost rows below row 0 / above row Yl - 1, (3, Xl, Z); gy = 1 only
  const T *gy_lo, *gy_hi;
  const uint8_t *bgy_lo, *bgy_hi;
  int Xl, Yl, Z, ghost_y, x0, y0, nx, ny, nz, p0, p1, chunk;
  T ss, mf;
  float m8;
};

// A staged row's source: component 0 of its z = 0 entry (null: zero), its
// mask (null: free) and the stride between components.
template <typename T>
struct Src {
  const T* v;
  const uint8_t* m;
  int64_t cs;
};

template <typename T>
__device__ __forceinline__ Src<T> row_source(const HaloArgs<T>& a, int jx,
                                             int jy) {
  const int gy = a.ghost_y;
  if (jx >= 0 && jx < a.Xl) {
    if (jy >= 0 && jy < a.Yl) {  // the shard's own block
      const int64_t off = (static_cast<int64_t>(jx) * a.Yl + jy) * a.Z;
      return {a.x + off, a.bc + off, static_cast<int64_t>(a.Xl) * a.Yl * a.Z};
    }
    if (!gy || jy < -1 || jy > a.Yl) return {nullptr, nullptr, 0};
    // a Y ghost row (selects, not an index: no local copy of the params)
    const T* g = jy < 0 ? a.gy_lo : a.gy_hi;
    const uint8_t* bg = jy < 0 ? a.bgy_lo : a.bgy_hi;
    if (g == nullptr) return {nullptr, nullptr, 0};
    const int64_t off = static_cast<int64_t>(jx) * a.Z;
    return {g + off, bg == nullptr ? nullptr : bg + off,
            static_cast<int64_t>(a.Xl) * a.Z};
  }
  if (jx < -1 || jx > a.Xl) return {nullptr, nullptr, 0};
  const T* g = jx < 0 ? a.gx_lo : a.gx_hi;  // an X ghost plane
  const uint8_t* bg = jx < 0 ? a.bgx_lo : a.bgx_hi;
  const int rows = a.Yl + 2 * gy;
  const int ry = jy + gy;
  if (g == nullptr || ry < 0 || ry >= rows) return {nullptr, nullptr, 0};
  const int64_t off = static_cast<int64_t>(ry) * a.Z;
  return {g + off, bg == nullptr ? nullptr : bg + off,
          static_cast<int64_t>(rows) * a.Z};
}

// Byte offset of halo column 0 (z0 - 1) of component c's staged mask row
// within its aligned first word: the row's address mod 4.
template <typename T>
__device__ __forceinline__ int src_shift(const Src<T>& s, int c, int z0) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(s.m) +
                           static_cast<uintptr_t>(c * s.cs) + z0 - 1) & 3u);
}

// Issues the copies of staged rows [row0, row0 + nrows) of plane jx from
// their sources, whatever they are: one warp per value row (channel c),
// one copy per in-row element; three mask rows per warp as aligned words,
// a word that reaches outside the row copied byte by byte.
template <typename T>
__device__ __forceinline__ void stage_rows(const HaloArgs<T>& a, T* st,
                                           uint8_t* mst, int jx, int y0,
                                           int z0, int row0, int nrows) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int p = warp; p < 3 * nrows; p += kWarps) {
    const int c = p / nrows;
    const int row = row0 + p - c * nrows;
    const Src<T> s = row_source(a, jx, y0 - 1 + row);
    if (s.v == nullptr) continue;
    const T* g = s.v + c * s.cs + z0 - 1;
    T* d = st + c * kStagePlane + row * kStageRow + 3;  // column z0 - 1
    const int z = z0 - 1 + lane;
    if (z >= 0 && z < a.Z) cp_async_elem(d + lane, g + lane);
    if (lane < kHaloZ - 32 && z + 32 < a.Z) {
      cp_async_elem(d + 32 + lane, g + 32 + lane);
    }
  }
  constexpr int kRowsPerWarp = 32 / kMaskWords;
  for (int q0 = warp * kRowsPerWarp; q0 < 3 * nrows; q0 += kWarps * kRowsPerWarp) {
    const int q = q0 + lane / kMaskWords;
    const int k = lane % kMaskWords;
    if (lane >= kRowsPerWarp * kMaskWords || q >= 3 * nrows) continue;
    const int c = q / nrows;
    const int row = row0 + q - c * nrows;
    const Src<T> s = row_source(a, jx, y0 - 1 + row);
    if (s.v == nullptr || s.m == nullptr) continue;
    const uintptr_t lo = reinterpret_cast<uintptr_t>(s.m + c * s.cs);
    const uintptr_t hi = lo + a.Z;
    const uintptr_t w = ((lo + z0 - 1) & ~uintptr_t{3}) + 4 * k;
    uint8_t* d = mst + (c * kHaloY + row) * kMaskRow + 4 * k;
    const uint8_t* src = reinterpret_cast<const uint8_t*>(w);
    if (w >= lo && w + 4 <= hi) {
      cp_async4(d, src);
    } else {
      for (int b = 0; b < 4; ++b) {
        if (w + b >= lo && w + b < hi) d[b] = src[b];
      }
    }
  }
}

// xs of halo node (hy, hz) of plane jx into ub; returns x and the mask
// there.  A row with no source reads as x = 0, free.
template <bool VEC, typename T>
__device__ __forceinline__ void transform(const HaloArgs<T>& a, const T* sp,
                                          const uint8_t* mp, T* ub, int jx,
                                          int y0, int z0, int hy, int hz,
                                          T (&xv)[3], bool (&fixed)[3]) {
  const int jy = y0 - 1 + hy;
  const int jz = z0 - 1 + hz;
  T q[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    xv[c] = T(0);
    q[c] = T(0);
    fixed[c] = false;
  }
  if (jz >= 0 && jz < a.Z) {
    // VEC: every row and buffer is word aligned and z0 - 1 = 3 mod 4
    int shift[3] = {3, 3, 3};
    bool valid = true, masked = true;
    if (jx >= 0 && jx < a.Xl && jy >= 0 && jy < a.Yl) {
      if constexpr (!VEC) {
        const uint32_t comp = static_cast<uint32_t>(a.Xl) * a.Yl * a.Z;
        const uint32_t rowoff = (static_cast<uint32_t>(jx) * a.Yl + jy) * a.Z;
#pragma unroll
        for (int c = 0; c < 3; ++c) shift[c] = mask_shift(comp, c, rowoff, z0);
      }
    } else {
      const Src<T> s = row_source(a, jx, jy);
      valid = s.v != nullptr;
      masked = s.m != nullptr;
      if constexpr (!VEC) {
#pragma unroll
        for (int c = 0; c < 3; ++c) shift[c] = src_shift(s, c, z0);
      }
    }
    if (valid) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        xv[c] = sp[c * kStagePlane + hy * kStageRow + 3 + hz];
        fixed[c] = masked && mp[(c * kHaloY + hy) * kMaskRow + shift[c] + hz] != 0;
        // select, not multiply: a constrained component is +0.0
        q[c] = fixed[c] ? T(0) : xv[c];
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) ub[c * kPlane + hy * kHaloZ + hz] = q[c];
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, kSweepBlocksPerSm)
    keff_sweep_kernel(
    const __grid_constant__ HaloArgs<T> a,
    const __grid_constant__ TapsT<T> taps, const float* __restrict__ stencil,
    T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kStage = 3 * kStagePlane;  // elements per staging buffer
  constexpr int kMaskStage = 3 * kHaloY * kMaskRow;
  T* st = reinterpret_cast<T*>(smem);
  T* ub = st + kStages * kStage;
  uint8_t* mst = reinterpret_cast<uint8_t*>(ub + 3 * kPlane);

  const int tz = threadIdx.x % kTileZ;
  const int ty = threadIdx.x / kTileZ;
  const int z0 = blockIdx.x * kTileZ;
  const int y0 = blockIdx.y * kTileY;
  const int x_lo = a.p0 + blockIdx.z * a.chunk;
  const int x_hi = min(x_lo + a.chunk, a.p1);
  const int iy = y0 + ty;
  const int iz = z0 + tz;
  const bool own = iy < a.Yl && iz < a.Z;
  const int64_t comp = static_cast<int64_t>(a.Xl) * a.Yl * a.Z;
  const int ocy = civi::node_class(a.y0 + iy, a.ny);
  const int ocz = civi::node_class(iz, a.nz);

  T acc[3][3] = {};
  T px[3] = {T(0), T(0), T(0)};  // own x and mask of the plane before
  bool pfix[3] = {false, false, false};

  // the output at local plane xo from acc[0] and the own x, mask there
  auto emit = [&](int xo) {
    const T mm =
        civi::mass_scale(a.mf, a.m8, civi::node_class(a.x0 + xo, a.nx), ocy, ocz);
    const int64_t n0 = (static_cast<int64_t>(xo) * a.Yl + iy) * a.Z + iz;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      out[n0 + b * comp] = civi::keff_out(pfix[b], px[b], acc[0][b], a.ss, mm);
    }
  };

  // the halo planes: in the block, or a ghost plane beyond it where the
  // caller gave one (none: nothing to add)
  const int jlo = (x_lo > 0 || a.gx_lo != nullptr) ? x_lo - 1 : x_lo;
  const int jhi = (x_hi < a.Xl || a.gx_hi != nullptr) ? x_hi : x_hi - 1;
  // 2-D: the staged rows that are Y ghost rows (-1: none in this tile)
  const int ghost_row_lo = a.ghost_y && y0 == 0 ? 0 : -1;
  const int ghost_row_hi =
      a.ghost_y && a.Yl - y0 + 1 < kHaloY ? a.Yl - y0 + 1 : -1;
  const VecStager<1, T> vs(a.x, a.x, a.x, y0, z0, a.Yl, a.Z, comp);
  // issues the copies of plane jx into staging buffer b
  auto stage = [&](int jx, int b) {
    T* sb = st + b * kStage;
    uint8_t* mb = mst + b * kMaskStage;
    if (VEC && jx >= 0 && jx < a.Xl) {
      // block rows by the precomputed copies; rows outside the block are
      // null there and come from the Y ghost rows
      vs.issue(sb, mb, a.bc, static_cast<int64_t>(jx) * a.Yl * a.Z, 3 * comp);
      if (ghost_row_lo >= 0) stage_rows(a, sb, mb, jx, y0, z0, ghost_row_lo, 1);
      if (ghost_row_hi >= 0) stage_rows(a, sb, mb, jx, y0, z0, ghost_row_hi, 1);
    } else {
      stage_rows(a, sb, mb, jx, y0, z0, 0, kHaloY);
    }
  };
  // planes jlo .. jlo + kStages - 2 in flight, one commit group each
  for (int k = 0; k < kStages - 1; ++k) {
    if (jlo + k <= jhi) stage(jlo + k, k);
    cp_async_commit();
  }
  for (int j = jlo; j <= jhi; ++j) {
    const int buf = (j - jlo) % kStages;
    // the buffer of plane j + kStages - 1 held plane j - 1, which every
    // thread finished transforming before the last barrier
    const int ahead = j + kStages - 1;
    if (ahead <= jhi) stage(ahead, (ahead - jlo) % kStages);
    cp_async_commit();
    cp_async_wait_oldest();
    __syncthreads();
    const T* sp = st + buf * kStage;
    const uint8_t* mp = mst + buf * kMaskStage;
    T cx[3];
    bool cfix[3];
    transform<VEC>(a, sp, mp, ub, j, y0, z0, ty + 1, tz + 1, cx, cfix);
    if (threadIdx.x < kRing) {
      int hy, hz;
      ring_node(threadIdx.x, hy, hz);
      T xv[3];
      bool fx[3];
      transform<VEC>(a, sp, mp, ub, j, y0, z0, hy, hz, xv, fx);
    }
    __syncthreads();
    apply_plane(ub, ty, tz, a.x0 + j, ocy, ocz, a.nx, taps, stencil, acc);
    if (own && j - 1 >= x_lo) emit(j - 1);
    shift_window(acc);
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      px[b] = cx[b];
      pfix[b] = cfix[b];
    }
  }
  // the chunk's last plane has no plane after it
  if (own && jhi == x_hi - 1) emit(jhi);
}

template <typename T, bool VEC>
int launch(const HaloArgs<T>& a, const TapsT<T>& taps, const float* stencil,
           T* out, dim3 grid, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    static bool raised = false;  // once per process and instance
    if (!raised) {
      const cudaError_t e = cudaFuncSetAttribute(
          keff_sweep_kernel<T, VEC>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      raised = true;
    }
  }
  keff_sweep_kernel<T, VEC>
      <<<grid, kThreads, smem, stream>>>(a, taps, stencil, out);
  return static_cast<int>(cudaGetLastError());
}

// Checks the geometry against this build and launches the instance of T.
template <typename T>
int launch_checked(const T* x, const unsigned char* bc, const T* gx_lo,
                   const unsigned char* bgx_lo, const T* gx_hi,
                   const unsigned char* bgx_hi, const T* gy_lo,
                   const unsigned char* bgy_lo, const T* gy_hi,
                   const unsigned char* bgy_hi, const float* stencil,
                   const T* taps, T* out, int Xl, int Yl, int Z, int ghost_y,
                   int x0, int y0, int nx, int ny, int nz, int p0, int p1,
                   T ss, T mf, float m8, int tile_y, int tile_z, int chunk,
                   int grid_x, int grid_y, int grid_z, int smem, int vec,
                   void* stream) {
  if (Xl <= 0 || Yl <= 0 || Z <= 0 || p0 < 0 || p1 > Xl) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p1 <= p0) return 0;
  if (tile_y != kTileY || tile_z != kTileZ || chunk <= 0 ||
      smem != smem_bytes(1, static_cast<int>(sizeof(T))) ||
      grid_x != (Z + kTileZ - 1) / kTileZ ||
      grid_y != (Yl + kTileY - 1) / kTileY ||
      grid_z != (p1 - p0 + chunk - 1) / chunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  HaloArgs<T> a;
  a.x = x;
  a.bc = bc;
  a.gx_lo = gx_lo;
  a.gx_hi = gx_hi;
  a.bgx_lo = bgx_lo;
  a.bgx_hi = bgx_hi;
  a.gy_lo = gy_lo;
  a.gy_hi = gy_hi;
  a.bgy_lo = bgy_lo;
  a.bgy_hi = bgy_hi;
  a.Xl = Xl;
  a.Yl = Yl;
  a.Z = Z;
  a.ghost_y = ghost_y;
  a.x0 = x0;
  a.y0 = y0;
  a.nx = nx;
  a.ny = ny;
  a.nz = nz;
  a.p0 = p0;
  a.p1 = p1;
  a.chunk = chunk;
  a.ss = ss;
  a.mf = mf;
  a.m8 = m8;
  TapsT<T> t;
  static_assert(sizeof(TapsT<T>) == kSweepTaps * sizeof(T), "Taps size");
  std::memcpy(&t, taps, sizeof(TapsT<T>));
  const dim3 grid(grid_x, grid_y, grid_z);
  const auto s = static_cast<cudaStream_t>(stream);
  return vec ? launch<T, true>(a, t, stencil, out, grid, smem, s)
             : launch<T, false>(a, t, stencil, out, grid, smem, s);
}

}  // namespace

// taps: the kSweepTaps floats of Taps (host memory, copied into the launch's
// parameters); tile, chunk, grid and smem as computed by
// ops/cuda/plane_sweep.py for planes [p0, p1), refused unless they match
// this build; vec: 16-byte copies of the block's rows (Z % 4 == 0, x
// 16-byte aligned), every mask buffer 4-byte aligned either way
extern "C" int civi_keff_structured_halo(
    const float* x, const unsigned char* bc, const float* gx_lo,
    const unsigned char* bgx_lo, const float* gx_hi,
    const unsigned char* bgx_hi, const float* gy_lo,
    const unsigned char* bgy_lo, const float* gy_hi,
    const unsigned char* bgy_hi, const float* stencil, const float* taps,
    float* out, int Xl, int Yl, int Z, int ghost_y, int x0, int y0, int nx,
    int ny, int nz, int p0, int p1, float ss, float mf, float m8, int tile_y,
    int tile_z, int chunk, int grid_x, int grid_y, int grid_z, int smem,
    int vec, void* stream) {
  return launch_checked<float>(
      x, bc, gx_lo, bgx_lo, gx_hi, bgx_hi, gy_lo, bgy_lo, gy_hi, bgy_hi,
      stencil, taps, out, Xl, Yl, Z, ghost_y, x0, y0, nx, ny, nz, p0, p1, ss,
      mf, m8, tile_y, tile_z, chunk, grid_x, grid_y, grid_z, smem, vec, stream);
}

// The f64 instance: x, the ghosts and out double, taps the doubles of
// TapsT<double> (ops.cuda.plane_sweep.sweep_taps64), ss and mf double, the
// class table f32; smem as sweep_geometry computes it for 8-byte elements;
// vec: 16-byte copies (Z % 4 == 0, x 16-byte aligned).
extern "C" int civi_keff_structured_halo_f64(
    const double* x, const unsigned char* bc, const double* gx_lo,
    const unsigned char* bgx_lo, const double* gx_hi,
    const unsigned char* bgx_hi, const double* gy_lo,
    const unsigned char* bgy_lo, const double* gy_hi,
    const unsigned char* bgy_hi, const float* stencil, const double* taps,
    double* out, int Xl, int Yl, int Z, int ghost_y, int x0, int y0, int nx,
    int ny, int nz, int p0, int p1, double ss, double mf, float m8,
    int tile_y, int tile_z, int chunk, int grid_x, int grid_y, int grid_z,
    int smem, int vec, void* stream) {
  return launch_checked<double>(
      x, bc, gx_lo, bgx_lo, gx_hi, bgx_hi, gy_lo, bgy_lo, gy_hi, bgy_hi,
      stencil, taps, out, Xl, Yl, Z, ghost_y, x0, y0, nx, ny, nz, p0, p1, ss,
      mf, m8, tile_y, tile_z, chunk, grid_x, grid_y, grid_z, smem, vec, stream);
}

extern "C" const char* civi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
