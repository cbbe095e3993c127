// keff_structured_halo: the complete effective-stiffness matvec of a
// homogeneous structured hex8 grid, or of one shard of it,
//
//   out = bc ? x : ss * K(xs) + mf * mass * xs,    xs = bc ? 0 : x,
//
// on a (3, Xl, Yl, Z) block, over its local planes [p0, p1).  Two wrappers
// launch it, each with its own launch count:
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
// that carries over.  Here one thread computes the 3 components of one
// node, z fastest: it reads its 27 neighbours, sanitizes them by their
// constraint masks and applies the node's own per-boundary-class stencil
// from a (27 classes, 27 offsets, 3, 3) f32 table (ops/structured.py
// class_stencil_table, 26 KB, read through the read-only cache).  The class
// is taken at the node's GLOBAL coordinate (x0 + ix against nx, y0 + iy
// against ny; the dead +X planes and +Y rows land in class 2 and are
// constrained), so the table already holds each node's exact taps and no
// correction pass exists.  The lumped mass is m8 * 2^-k from the class;
// identity rows are written by select.  ss, mf and m8 are launch
// arguments: a new dt rebuilds nothing.
//
// Neighbours outside the block come from ghost buffers exchanged with the
// neighbouring shards: the X ghost planes (3, Yl + 2 gy, Z) below plane 0
// and above plane Xl - 1 and, in the 2-D (X, Y) decomposition (gy = 1), the
// Y ghost rows (3, Xl, Z) below row 0 and above row Yl - 1.  In 2-D the X
// planes are Y-extended: their rows 0 and Yl + 1 carry the diagonal
// neighbours' corner values (relayed through the Y exchange).  A missing
// ghost buffer (null) reads as zero: the zero fill a shard at a global end
// receives, and the outside of a whole grid.  Each ghost value is sanitized
// by its own ghost mask (null: free).  The ghosts are read from their own
// buffers, so no ghost-padded copy of the block is made per matvec.  A
// neighbour row is looked up once per (dx, dy) and reused over dz.
//
// Bound on the H100: device memory.  Per matvec the kernel must read x
// (12 B/node) and the mask (3 B/node) once and write out (12 B/node), plus
// the ghost planes and rows (15 B per ghost node): ~0.45 GB at 255^3 cells
// (16.8M nodes), ~0.13 ms at 3.35 TB/s.  The 27-fold neighbour reuse is
// left to L1/L2 in this first version; shared-memory 2.5-D blocking is
// later work.
#include "structured.cuh"

namespace {

struct HaloArgs {
  const float* x;
  const uint8_t* bc;
  // X ghost planes below plane 0 / above plane Xl - 1, (3, Yl + 2 gy, Z)
  const float *gx_lo, *gx_hi;
  const uint8_t *bgx_lo, *bgx_hi;
  // Y ghost rows below row 0 / above row Yl - 1, (3, Xl, Z); gy = 1 only
  const float *gy_lo, *gy_hi;
  const uint8_t *bgy_lo, *bgy_hi;
  int Xl, Yl, Z, ghost_y, x0, y0, nx, ny, nz, p0;
};

// A Z-row of the shard's neighbourhood: component 0 of its z = 0 entry, the
// stride between components, and its mask (null: free).  False where the
// row lies outside the grid or its ghost buffer is missing (zero).
struct Row {
  const float* x;
  const uint8_t* b;
  int64_t cs;
};

__device__ __forceinline__ bool find_row(const HaloArgs& a, int jx, int jy,
                                         Row& r) {
  const int gy = a.ghost_y;
  if (jx >= 0 && jx < a.Xl) {
    if (jy >= 0 && jy < a.Yl) {  // the shard's own block
      const int64_t off = (static_cast<int64_t>(jx) * a.Yl + jy) * a.Z;
      r.x = a.x + off;
      r.b = a.bc + off;
      r.cs = static_cast<int64_t>(a.Xl) * a.Yl * a.Z;
      return true;
    }
    if (!gy || jy < -1 || jy > a.Yl) return false;
    // a Y ghost row (selects, not an index: no local copy of the params)
    const float* g = jy < 0 ? a.gy_lo : a.gy_hi;
    const uint8_t* bg = jy < 0 ? a.bgy_lo : a.bgy_hi;
    if (g == nullptr) return false;
    const int64_t off = static_cast<int64_t>(jx) * a.Z;
    r.x = g + off;
    r.b = bg == nullptr ? nullptr : bg + off;
    r.cs = static_cast<int64_t>(a.Xl) * a.Z;
    return true;
  }
  const float* g = jx < 0 ? a.gx_lo : a.gx_hi;  // an X ghost plane
  const uint8_t* bg = jx < 0 ? a.bgx_lo : a.bgx_hi;
  const int rows = a.Yl + 2 * gy;
  const int ry = jy + gy;
  if (g == nullptr || ry < 0 || ry >= rows) return false;
  const int64_t off = static_cast<int64_t>(ry) * a.Z;
  r.x = g + off;
  r.b = bg == nullptr ? nullptr : bg + off;
  r.cs = static_cast<int64_t>(rows) * a.Z;
  return true;
}

__global__ void __launch_bounds__(256) keff_structured_halo_kernel(
    const HaloArgs a, const float* __restrict__ stencil,
    float* __restrict__ out, float ss, float mf, float m8) {
  const int ix = a.p0 + static_cast<int>(blockIdx.x) / a.Yl;
  const int iy = static_cast<int>(blockIdx.x) % a.Yl;
  const int64_t comp = static_cast<int64_t>(a.Xl) * a.Yl * a.Z;
  const int cx = civi::node_class(a.x0 + ix, a.nx);
  const int cy = civi::node_class(a.y0 + iy, a.ny);
  for (int iz = threadIdx.x; iz < a.Z; iz += blockDim.x) {
    const int cz = civi::node_class(iz, a.nz);
    const float* tab = stencil + ((cx * 3 + cy) * 3 + cz) * 27 * 9;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
    for (int dx = -1; dx <= 1; ++dx) {
      for (int dy = -1; dy <= 1; ++dy) {
        Row r;
        if (!find_row(a, ix + dx, iy + dy, r)) continue;
        for (int dz = -1; dz <= 1; ++dz) {
          const int jz = iz + dz;
          if (jz < 0 || jz >= a.Z) continue;
          const float* px = r.x + jz;
          float v0 = __ldg(px), v1 = __ldg(px + r.cs), v2 = __ldg(px + 2 * r.cs);
          if (r.b != nullptr) {
            const uint8_t* pb = r.b + jz;
            v0 = pb[0] ? 0.0f : v0;
            v1 = pb[r.cs] ? 0.0f : v1;
            v2 = pb[2 * r.cs] ? 0.0f : v2;
          }
          civi::add_taps(tab + (((dx + 1) * 3 + (dy + 1)) * 3 + (dz + 1)) * 9,
                         v0, v1, v2, a0, a1, a2);
        }
      }
    }
    const int64_t n0 = (static_cast<int64_t>(ix) * a.Yl + iy) * a.Z + iz;
    const float mass = m8 * civi::class_weight(cx) * civi::class_weight(cy) *
                       civi::class_weight(cz);
    const float mm = mf * mass;
    const float acc[3] = {a0, a1, a2};
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const int64_t nb = n0 + b * comp;
      const float xb = a.x[nb];
      // identity row by select: a constrained output is the input itself
      out[nb] = a.bc[nb] ? xb : ss * acc[b] + mm * xb;
    }
  }
}

}  // namespace

extern "C" int civi_keff_structured_halo(
    const float* x, const unsigned char* bc, const float* gx_lo,
    const unsigned char* bgx_lo, const float* gx_hi,
    const unsigned char* bgx_hi, const float* gy_lo,
    const unsigned char* bgy_lo, const float* gy_hi,
    const unsigned char* bgy_hi, const float* stencil, float* out, int Xl,
    int Yl, int Z, int ghost_y, int x0, int y0, int nx, int ny, int nz,
    int p0, int p1, float ss, float mf, float m8, void* stream) {
  if (Xl <= 0 || Yl <= 0 || Z <= 0 || p1 <= p0) return 0;
  HaloArgs a;
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
  keff_structured_halo_kernel<<<static_cast<unsigned>((p1 - p0) * Yl),
                                civi::row_threads(Z), 0,
                                static_cast<cudaStream_t>(stream)>>>(
      a, stencil, out, ss, mf, m8);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* civi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
