// K6 pcg_iteration_structured: one whole Chronopoulos-Gear PCG iteration on
// a homogeneous structured grid in one launch.  Per node n and component b,
// with free = !bc and the step scalars alpha, beta read from the device:
//
//   p' = free ? u + beta p : 0        s' = free ? w + beta s : 0
//   x' = x + alpha p'                 r' = r - alpha s'
//   u' = M^-1 r'                      (block-Jacobi class table, +0.0 on bc)
//   w' = bc ? u' : ss * K(u') + mf * mass * u'
//
// and each block's f32 partials of (r', u'), (r', r') and (w', u') over its
// nodes, into partials[3][blocks] (the caller sums them in the reduction
// dtype).
//
// Replaces the Pallas TPU kernel pcg_iteration_fused_pallas
// (civiwave_tpu/ops/pallas/structured_stencil.py:1226, pallas_call at :1285,
// body _make_pcg_iter_kernel :1096), which streams x_ext-padded carries
// through VMEM and transforms each plane to u' once, lagging the stencil
// one block behind the recurrence.  What carries over is the idea; the
// design is K2's plane sweep (structured.cuh): a block owns 8 x 32 (y, z)
// columns over a chunk of 32 X planes, stages r, w, s and the mask of each
// plane's tile plus a one-node halo by cp.async two planes ahead, computes
// s', r' and u' once per node into shared memory (u') and registers (the
// own node's r', s'), and adds each plane to three register accumulators
// per thread (outputs at x = j + 1, j, j - 1).  The own node's x, u and p
// are loaded one plane ahead; x, u, p, r' and s' are written when its
// plane is transformed, w' when the plane after it has been added.
//
// Buffers: other blocks read r, w and s in their halos, so r', w' and s' go
// to separate output buffers (the caller swaps them each iteration); x, u
// and p are read only at the node's own position and are updated IN
// PLACE.  The carries therefore take nine vectors, not twelve.
//
// Bound on the H100: device memory.  Least traffic per node is the six
// carries in (72 B) and out (72 B) and the mask (3 B): 147 B, 2.466 GB at
// 255^3 cells (0.736 ms at 3.35 TB/s).  The PR 3 design (one block per
// (x, y) row, each thread recomputing s', r' and u' at its 27 neighbours
// from r, w, s and the mask in device memory) issued ~730 load
// instructions per node and ran at 27 % of that bound, limited by
// instruction issue.  Here a node costs ~1.3 transforms (the y and z
// halo), 27 shared-memory reads and K2's factored interior stencil, a few
// cp.async per plane precomputed once per thread, and its own x, u, p
// loads: the interior taps are a kernel parameter as in K2, and the
// interior class's six pc coefficients are loaded once per thread.  The
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

// s' and r' of one component at one node.
__device__ __forceinline__ float next_residual(float r, float w, float s,
                                               bool fixed, float alpha,
                                               float beta, float& s_new) {
  s_new = fixed ? 0.0f : w + beta * s;
  return r - alpha * s_new;
}

// s', r' and u' of halo node (hy, hz) of plane jx (class cx); u' into ub.
// Outside the grid all are 0 and the mask is free.
__device__ __forceinline__ void transform(
    const Args a, const float* sp, const uint8_t* mp, float* ub,
    const float* __restrict__ pc_table, const civi::PcBlock& interior,
    float alpha, float beta, int jx, int cx, int y0, int z0, int hy, int hz,
    float (&rn)[3], float (&sn)[3], float (&q)[3], bool (&fixed)[3]) {
  const int jy = y0 - 1 + hy;
  const int jz = z0 - 1 + hz;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    rn[c] = 0.0f;
    sn[c] = 0.0f;
    q[c] = 0.0f;
    fixed[c] = false;
  }
  if (jy >= 0 && jy < a.Y && jz >= 0 && jz < a.Z) {
    const uint32_t comp = static_cast<uint32_t>(a.X) * a.Y * a.Z;
    const uint32_t rowoff = (static_cast<uint32_t>(jx) * a.Y + jy) * a.Z;
    const int h = hy * kStageRow + 3 + hz;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int shift = mask_shift(comp, c, rowoff, z0);
      fixed[c] = mp[(c * kHaloY + hy) * kMaskRow + shift + hz] != 0;
      rn[c] = next_residual(sp[c * kStagePlane + h],
                            sp[(3 + c) * kStagePlane + h],
                            sp[(6 + c) * kStagePlane + h], fixed[c], alpha,
                            beta, sn[c]);
    }
    const int cls = (cx * 3 + civi::node_class(jy, a.ny)) * 3 +
                    civi::node_class(jz, a.nz);
    const civi::PcBlock pc =
        cls == 13 ? interior : civi::load_pc_block(pc_table, cls);
    civi::apply_pc_block(pc, rn[0], rn[1], rn[2], q[0], q[1], q[2]);
    // select, not multiply: a constrained component is +0.0
#pragma unroll
    for (int c = 0; c < 3; ++c) q[c] = fixed[c] ? 0.0f : q[c];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) ub[c * kPlane + hy * kHaloZ + hz] = q[c];
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads) pcg_iteration_sweep_kernel(
    const __grid_constant__ Args a, const __grid_constant__ Taps taps,
    const float* __restrict__ pc_table, const float* __restrict__ stencil,
    const float* __restrict__ alpha_beta, float* __restrict__ x,
    const float* __restrict__ r, float* __restrict__ u,
    const float* __restrict__ w, float* __restrict__ p,
    const float* __restrict__ s, const uint8_t* __restrict__ bc,
    float* __restrict__ r_out, float* __restrict__ w_out,
    float* __restrict__ s_out, float* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kStage = 9 * kStagePlane;  // floats per staging buffer
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
  const float alpha = __ldg(alpha_beta);
  const float beta = __ldg(alpha_beta + 1);

  float acc[3][3] = {};
  float pu[3] = {0.0f, 0.0f, 0.0f};  // own u' and mask of the plane before
  bool pfix[3] = {false, false, false};
  float ru = 0.0f, rr = 0.0f, wu = 0.0f;
  // x, u and p of the own node at the plane about to be transformed,
  // loaded one plane ahead so that their latency hides behind a plane
  float ox[3], ou[3], op[3];
  auto load_own = [&](int jj) {
    if (!own || jj < x_lo || jj >= x_hi) return;
    const int64_t n0 = (static_cast<int64_t>(jj) * a.Y + iy) * a.Z + iz;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      ox[b] = x[n0 + b * comp];
      ou[b] = u[n0 + b * comp];
      op[b] = p[n0 + b * comp];
    }
  };

  // w' at x (class cx) from acc[0] and the own u', mask there
  auto emit = [&](int xo, int cx) {
    const float mm = civi::mass_scale(a.mf, a.m8, cx, ocy, ocz);
    const int64_t n0 = (static_cast<int64_t>(xo) * a.Y + iy) * a.Z + iz;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      // identity row: the operator input u' is already +0.0 there
      const float wb = civi::keff_out(pfix[b], pu[b], acc[0][b], a.ss, mm);
      w_out[n0 + b * comp] = wb;
      wu += wb * pu[b];
    }
  };

  const int jlo = max(x_lo - 1, 0);
  const int jhi = min(x_hi, a.X - 1);
  const VecStager<3> vs(r, w, s, y0, z0, a.Y, a.Z, comp);
  // issues the copies of plane jx into staging buffer b
  auto stage = [&](int jx, int b) {
    if constexpr (VEC) {
      vs.issue(st + b * kStage, mst + b * kMaskStage, bc,
               static_cast<int64_t>(jx) * a.Y * a.Z, 3 * comp);
    } else {
      stage_plane<3>(r, w, s, bc, st + b * kStage, mst + b * kMaskStage, jx,
                     y0, z0, a.Y, a.Z, comp);
    }
  };
  // planes jlo .. jlo + kStages - 2 in flight, one commit group each
  for (int k = 0; k < kStages - 1; ++k) {
    if (jlo + k <= jhi) stage(jlo + k, k);
    cp_async_commit();
  }
  load_own(jlo);
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
    float rn[3], sn[3], cu[3];
    bool cfix[3];
    transform(a, sp, mp, ub, pc_table, interior, alpha, beta, j, cx, y0, z0,
              ty + 1, tz + 1, rn, sn, cu, cfix);
    if (own && j >= x_lo && j < x_hi) {
      const int64_t n0 = (static_cast<int64_t>(j) * a.Y + iy) * a.Z + iz;
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const int64_t nb = n0 + b * comp;
        // the deferred direction update, then the x axpy (own node only)
        const float pb = cfix[b] ? 0.0f : ou[b] + beta * op[b];
        x[nb] = ox[b] + alpha * pb;
        p[nb] = pb;
        u[nb] = cu[b];
        r_out[nb] = rn[b];
        s_out[nb] = sn[b];
        ru += rn[b] * cu[b];
        rr += rn[b] * rn[b];
      }
    }
    load_own(j + 1);
    if (threadIdx.x < kRing) {
      int hy, hz;
      ring_node(threadIdx.x, hy, hz);
      float r2[3], s2[3], q[3];
      bool fx[3];
      transform(a, sp, mp, ub, pc_table, interior, alpha, beta, j, cx, y0, z0,
                hy, hz, r2, s2, q, fx);
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

  const int64_t blocks =
      static_cast<int64_t>(gridDim.x) * gridDim.y * gridDim.z;
  const int64_t block =
      (static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y) * gridDim.x +
      blockIdx.x;
  civi::store_block_sums3(ru, rr, wu, partials, blocks, block);
}

template <bool VEC>
int launch(const Args& a, const Taps& taps, const float* pc_table,
           const float* stencil, const float* alpha_beta, float* x,
           const float* r, float* u, const float* w, float* p, const float* s,
           const uint8_t* bc, float* r_out, float* w_out, float* s_out,
           float* partials, dim3 grid, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    static bool raised = false;  // once per process
    if (!raised) {
      const cudaError_t e = cudaFuncSetAttribute(
          pcg_iteration_sweep_kernel<VEC>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      raised = true;
    }
  }
  pcg_iteration_sweep_kernel<VEC><<<grid, kThreads, smem, stream>>>(
      a, taps, pc_table, stencil, alpha_beta, x, r, u, w, p, s, bc, r_out,
      w_out, s_out, partials);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// taps: the kSweepTaps floats of Taps (host memory, copied into the launch's
// parameters); tile, chunk, grid and smem as computed by
// ops/cuda/plane_sweep.py, refused unless they match this build
extern "C" int civi_pcg_iteration_structured(
    const float* pc_table, const float* stencil, const float* taps,
    const float* alpha_beta, float* x, const float* r, float* u,
    const float* w, float* p, const float* s, const unsigned char* bc,
    float* r_out, float* w_out, float* s_out, float* partials, int X, int Y,
    int Z, int nx, int ny, int nz, float ss, float mf, float m8, int tile_y,
    int tile_z, int chunk, int grid_x, int grid_y, int grid_z, int smem,
    int vec, void* stream) {
  if (X <= 0 || Y <= 0 || Z <= 0) return 0;
  if (tile_y != kTileY || tile_z != kTileZ || chunk <= 0 ||
      smem != smem_bytes(3) || grid_x != (Z + kTileZ - 1) / kTileZ ||
      grid_y != (Y + kTileY - 1) / kTileY ||
      grid_z != (X + chunk - 1) / chunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{X, Y, Z, nx, ny, nz, chunk, ss, mf, m8};
  Taps t;
  static_assert(sizeof(Taps) == kSweepTaps * sizeof(float), "Taps size");
  std::memcpy(&t, taps, sizeof(Taps));
  const dim3 grid(grid_x, grid_y, grid_z);
  const auto st = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(a, t, pc_table, stencil, alpha_beta, x, r, u, w,
                            p, s, bc, r_out, w_out, s_out, partials, grid,
                            smem, st)
             : launch<false>(a, t, pc_table, stencil, alpha_beta, x, r, u, w,
                             p, s, bc, r_out, w_out, s_out, partials, grid,
                             smem, st);
}
