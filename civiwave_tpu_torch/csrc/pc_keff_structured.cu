// K2 pc_keff_structured: one launch computes
//
//   u = M^-1 r              (block-Jacobi class table, +0.0 on constrained)
//   w = bc ? u : ss * K(u) + mf * mass * u
//
// and, when `partials` is not null, each block's f32 partials of (r, u),
// (r, r) and (w, u) over its nodes, into partials[3][blocks] (the caller
// sums them in the reduction dtype).
//
// Replaces the Pallas TPU kernel apply_pc_keff_fused_pallas
// (civiwave_tpu/ops/pallas/structured_stencil.py:820, pallas_call at :895),
// which transforms each delivered residual plane to u once, in VMEM, and
// feeds a rolling plane window.  The idea carries over, the block shapes do
// not: this is the plane sweep of structured.cuh.  A block owns 8 x 32
// (y, z) columns over a chunk of 32 X planes.  For each plane it stages r
// and the mask of the tile plus a one-node halo by cp.async (two more
// planes' copies in flight while this one is worked), transforms them to u
// once into shared memory, and adds the plane's 3 x 3 (y, z) neighbourhood
// to three register accumulators per thread: its outputs at x = j + 1, j
// and j - 1.  After plane j the output at j - 1 is complete and is written
// with its mass term and identity row.
//
// Bound on the H100: device memory — r and the mask in (15 B/node), u and
// w out (24 B/node): 0.654 GB at 255^3 cells, 0.195 ms at 3.35 TB/s.  The
// PR 1 design (one block per (x, y) row, each thread recomputing u at its
// 27 neighbours from device memory) issued ~567 load instructions per node
// (3 of r, 3 of the mask, 6 class coefficients and 9 taps per neighbour) and
// ran at 11 % of that bound, limited by instruction issue, not bytes.  Here
// a node costs ~1.3 transforms (the y and z halo), 27 shared-memory reads
// and, in the interior, the factored stencil (structured.cuh
// add_plane_factored: ~80 adds and FMAs where the 243 taps one by one took
// 243 FMAs, which set the pace), and a few cp.async per plane precomputed
// once per thread; its 30 coefficients are a kernel parameter (constant
// bank) and the interior class's six pc coefficients are loaded once per
// thread.  Only rows on a y face, and the planes next to an x face, read
// taps from the class table; a z-face column adds its class's ghost taps
// at dz = 0.  A chunk of 32
// planes re-reads 2 halo planes (6 %) and gives 2,048 blocks at 255^3.  The
// stencil stays f32 FMA: the tensor cores' TF32 keeps about three digits,
// far from the 1e-5 of max|ref| the kernel is held to.
#include <cstring>

#include "structured.cuh"

namespace {

using namespace civi::sweep;

struct Args {
  int X, Y, Z, nx, ny, nz, chunk;
  float ss, mf, m8;
};

// u of halo node (hy, hz) of plane jx (class cx) into ub; returns r and
// the mask there.  Outside the grid u, r are 0 and the mask is free.
__device__ __forceinline__ void transform(
    const Args a, const float* sp, const uint8_t* mp, float* ub,
    const float* __restrict__ pc_table, const civi::PcBlock& interior,
    int jx, int cx, int y0, int z0, int hy, int hz, float (&rv)[3],
    float (&q)[3], bool (&fixed)[3]) {
  const int jy = y0 - 1 + hy;
  const int jz = z0 - 1 + hz;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    rv[c] = 0.0f;
    q[c] = 0.0f;
    fixed[c] = false;
  }
  if (jy >= 0 && jy < a.Y && jz >= 0 && jz < a.Z) {
    const uint32_t comp = static_cast<uint32_t>(a.X) * a.Y * a.Z;
    const uint32_t rowoff = (static_cast<uint32_t>(jx) * a.Y + jy) * a.Z;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      rv[c] = sp[c * kStagePlane + hy * kStageRow + 3 + hz];
      const int shift = mask_shift(comp, c, rowoff, z0);
      fixed[c] = mp[(c * kHaloY + hy) * kMaskRow + shift + hz] != 0;
    }
    const int cls = (cx * 3 + civi::node_class(jy, a.ny)) * 3 +
                    civi::node_class(jz, a.nz);
    const civi::PcBlock pc =
        cls == 13 ? interior : civi::load_pc_block(pc_table, cls);
    civi::apply_pc_block(pc, rv[0], rv[1], rv[2], q[0], q[1], q[2]);
    // select, not multiply: a constrained component is +0.0
#pragma unroll
    for (int c = 0; c < 3; ++c) q[c] = fixed[c] ? 0.0f : q[c];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) ub[c * kPlane + hy * kHaloZ + hz] = q[c];
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, kSweepBlocksPerSm)
    pc_keff_sweep_kernel(
    const __grid_constant__ Args a, const __grid_constant__ Taps taps,
    const float* __restrict__ pc_table,
    const float* __restrict__ stencil, const float* __restrict__ r,
    const uint8_t* __restrict__ bc, float* __restrict__ u,
    float* __restrict__ w, float* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kStage = 3 * kStagePlane;  // floats per staging buffer
  constexpr int kMaskStage = 3 * kHaloY * kMaskRow;
  float* st = reinterpret_cast<float*>(smem);
  float* ub = st + kStages * kStage;
  uint8_t* mst = reinterpret_cast<uint8_t*>(ub + 3 * kPlane);

  const int tz = threadIdx.x % kTileZ;
  const int ty = threadIdx.x / kTileZ;
  const int z0 = blockIdx.x * kTileZ;
  const int y0 = blockIdx.y * kTileY;
  const int x_lo = blockIdx.z * a.chunk;
  const int x_hi = min(x_lo + a.chunk, a.X);
  const int iy = y0 + ty;
  const int iz = z0 + tz;
  const bool own = iy < a.Y && iz < a.Z;
  const int64_t comp = static_cast<int64_t>(a.X) * a.Y * a.Z;
  const int ocy = civi::node_class(iy, a.ny);
  const int ocz = civi::node_class(iz, a.nz);
  const civi::PcBlock interior = civi::load_pc_block(pc_table, 13);

  float acc[3][3] = {};
  float pu[3] = {0.0f, 0.0f, 0.0f};  // own u and mask of the plane before
  bool pfix[3] = {false, false, false};
  float ru = 0.0f, rr = 0.0f, wu = 0.0f;

  // the output at x (class cx) from acc[0] and the own u, mask there
  auto emit = [&](int x, int cx) {
    const float mm = civi::mass_scale(a.mf, a.m8, cx, ocy, ocz);
    const int64_t n0 = (static_cast<int64_t>(x) * a.Y + iy) * a.Z + iz;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      // identity row: the operator input u is already +0.0 there
      const float wb = civi::keff_out(pfix[b], pu[b], acc[0][b], a.ss, mm);
      w[n0 + b * comp] = wb;
      wu += wb * pu[b];
    }
  };

  const int jlo = max(x_lo - 1, 0);
  const int jhi = min(x_hi, a.X - 1);
  const VecStager<1> vs(r, r, r, y0, z0, a.Y, a.Z, comp);
  // issues the copies of plane jx into staging buffer b
  auto stage = [&](int jx, int b) {
    if constexpr (VEC) {
      vs.issue(st + b * kStage, mst + b * kMaskStage, bc,
               static_cast<int64_t>(jx) * a.Y * a.Z, 3 * comp);
    } else {
      stage_plane<1>(r, r, r, bc, st + b * kStage, mst + b * kMaskStage, jx,
                     y0, z0, a.Y, a.Z, comp);
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
    const float* sp = st + buf * kStage;
    const uint8_t* mp = mst + buf * kMaskStage;
    const int cx = civi::node_class(j, a.nx);
    float cr[3], cu[3];
    bool cfix[3];
    transform(a, sp, mp, ub, pc_table, interior, j, cx, y0, z0, ty + 1, tz + 1,
              cr, cu, cfix);
    if (own && j >= x_lo && j < x_hi) {
      const int64_t n0 = (static_cast<int64_t>(j) * a.Y + iy) * a.Z + iz;
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        u[n0 + b * comp] = cu[b];
        ru += cr[b] * cu[b];
        rr += cr[b] * cr[b];
      }
    }
    if (threadIdx.x < kRing) {
      int hy, hz;
      ring_node(threadIdx.x, hy, hz);
      float rv[3], q[3];
      bool fx[3];
      transform(a, sp, mp, ub, pc_table, interior, j, cx, y0, z0, hy, hz, rv,
                q, fx);
    }
    __syncthreads();
    apply_plane(ub, ty, tz, j, ocy, ocz, a.nx, taps, stencil, acc);
    if (own && j - 1 >= x_lo) emit(j - 1, civi::node_class(j - 1, a.nx));
    shift_window(acc);
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      pu[b] = cu[b];
      pfix[b] = cfix[b];
    }
  }
  // the grid's last plane has no plane after it; only the chunk that owns
  // it emits it (the chunk before also sweeps it when it is the last
  // chunk's only plane, and would count its (w, u) partial twice)
  if (own && jhi == x_hi - 1) emit(jhi, civi::node_class(jhi, a.nx));

  if (partials == nullptr) return;  // uniform across the block
  const int64_t blocks =
      static_cast<int64_t>(gridDim.x) * gridDim.y * gridDim.z;
  const int64_t block =
      (static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y) * gridDim.x +
      blockIdx.x;
  civi::store_block_sums3(ru, rr, wu, partials, blocks, block);
}

template <bool VEC>
int launch(const Args& a, const Taps& taps, const float* pc_table,
           const float* stencil, const float* r, const uint8_t* bc, float* u,
           float* w, float* partials, dim3 grid, int smem,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    static bool raised = false;  // once per process
    if (!raised) {
      const cudaError_t e = cudaFuncSetAttribute(
          pc_keff_sweep_kernel<VEC>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      raised = true;
    }
  }
  pc_keff_sweep_kernel<VEC><<<grid, kThreads, smem, stream>>>(
      a, taps, pc_table, stencil, r, bc, u, w, partials);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// taps: the kSweepTaps floats of Taps (host memory, copied into the launch's
// parameters); tile, chunk, grid and smem as computed by
// ops/cuda/plane_sweep.py, refused unless they match this build
extern "C" int civi_pc_keff_structured(
    const float* pc_table, const float* stencil, const float* taps,
    const float* r, const unsigned char* bc, float* u, float* w,
    float* partials, int X, int Y, int Z, int nx, int ny, int nz, float ss,
    float mf, float m8, int tile_y, int tile_z, int chunk, int grid_x,
    int grid_y, int grid_z, int smem, int vec, void* stream) {
  if (X <= 0 || Y <= 0 || Z <= 0) return 0;
  if (tile_y != kTileY || tile_z != kTileZ || chunk <= 0 ||
      smem != smem_bytes(1) || grid_x != (Z + kTileZ - 1) / kTileZ ||
      grid_y != (Y + kTileY - 1) / kTileY ||
      grid_z != (X + chunk - 1) / chunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{X, Y, Z, nx, ny, nz, chunk, ss, mf, m8};
  Taps t;
  static_assert(sizeof(Taps) == kSweepTaps * sizeof(float), "Taps size");
  std::memcpy(&t, taps, sizeof(Taps));
  const dim3 grid(grid_x, grid_y, grid_z);
  const auto s = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(a, t, pc_table, stencil, r, bc, u, w, partials,
                            grid, smem, s)
             : launch<false>(a, t, pc_table, stencil, r, bc, u, w, partials,
                             grid, smem, s);
}
