// G2 keff_boundary: the boundary corrections and the envelope around the
// interior stencil K4, which together give the effective-stiffness matvec
// of a homogeneous structured hex8 grid on the slender route,
//
//   out = bc ? x : ss * (interior - corr) + mf * mass * xs,
//   corr[b][n] = sum_d sum_c G[cls(n)][d][b][c] * xs[c][n + d],
//
// with xs = bc ? 0 : x and interior = K4(xs).  No Pallas kernel: it stands
// for the XLA code the reference runs around interior_stencil_pallas
// (civiwave_tpu/ops/structured.py:449-471, the face/edge/corner
// corrections of _apply_homogeneous_stiffness, and :607-609, scale, mass
// term and identity rows).  The reference subtracts inclusion-exclusion
// face, edge and corner stencils; here G = interior - class_stencil_table
// [cls] (ops/structured.py ghost_stencil_table) holds each boundary class's
// ghost taps, so corr agrees with the reference to rounding, not bit for
// bit.  The lumped mass is synthesized from m8 and the node's class,
// bit-equal to the stored grid; constrained outputs are written by select
// (+-0.0 kept).  ss, mf and m8 are launch arguments.
//
// Bound on the H100: device memory.  Per matvec it must read interior
// (12 B/node), x (12) and the mask (3) and write out (12): 39 B/node,
// 0.028 ms for the 1024x48x48 soil column at 3.35 TB/s.  A thread per node
// over the flat index runs the 27-neighbour ghost loop in nearly every warp
// of a slender grid (each warp of 32 z holds z = 0 or z = nz), with 9 table
// loads per neighbour and the zeros loaded too: 18 % of the bound on an
// H100.
//
// Design: one launch, two kinds of block, and every output element written
// by exactly one thread (no atomics, deterministic):
//
// * envelope blocks stream over all nodes, four consecutive z per thread
//   as float4 loads and stores of interior, x and out and one aligned mask
//   word per component (Z % 4 == 0 and aligned buffers; one node per
//   thread otherwise).  They write every component of an interior-class
//   node (13: no ghost taps) and every constrained component (the select).
// * face blocks own the free components of the boundary nodes, face by
//   face: the x faces own their whole planes (x = 0 and x >= nx, the dead
//   pad planes included) and the y faces their rows with x interior (y = 0
//   and y >= ny, dead +Y rows included), one thread per node along z; the
//   z faces own the rest (z = 0 and z = nz with x and y interior), a block
//   per 16 x 16 (x, y) tile of one z face.  A node takes its own class's
//   ghost row (edges and corners too, never a sum of face rows) over only
//   the neighbours with nonzero in-grid ghost taps: 9 for a face or an
//   edge, 7 for a corner (the neighbours on one of the node's boundary
//   planes; one inward on every boundary axis couples through cells that
//   exist).  A neighbour off the model reads zero in K4 and is constrained
//   (pad) or absent, so it needs no correction.  x- and y-face nodes read
//   a compact (27, 9, 9) table of their class's rows through the
//   read-only cache.  A node with every component constrained is left to
//   the envelope.
// * the z faces have no contiguous axis: a z-face node's 9 neighbours lie
//   in its z plane, Z floats apart along y.  Read by each thread, that is
//   54 loads of 32 different sectors per warp instruction, where most of a
//   thread-per-node form's excess time went on an H100.  A z-face block
//   stages its tile plus a one-node halo, xs and the mask, once each into
//   shared memory, and applies the two z-face classes' 2 x 81 taps by
//   value (constant bank) in a fully unrolled loop.  The blocks of the x range [16 s, 16 s + 16)
//   follow the envelope blocks of the same slab of planes, so their reads
//   find the slab's rows in L2.
//
// Block order: the x- and y-face blocks, then slab by slab the slab's
// envelope blocks and its z-face blocks.  The counts and the tables come
// from ops/cuda/keff_boundary.py (boundary_geometry, ghost_tap_rows) and
// are checked here.
#include <cstring>

#include "structured.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSlab = 16;  // X planes per slab; a z-face tile is 16 x 16
constexpr int kTile = 16;
constexpr int kHalo = kTile + 2;

struct Args {
  const float* interior;
  const float* x;
  const uint8_t* bc;
  const int* codes;  // (27, 10): count, then up to 9 offset codes
  const float* rows;  // (27, 9, 9): the class's ghost taps at those offsets
  float* out;
  int X, Y, Z, nx, ny, nz;
  int y_rows;  // face rows per interior x plane
  uint32_t face_a, face_b;  // ends of the x- and y-face threads
  int xy_blocks;  // blocks of x- and y-face threads
  int slab_envelope, slab_z;  // envelope and z-face blocks per slab
  int z_tiles_y;  // z-face tiles along y
  float ss, mf, m8;
};

// Ghost taps of the z-face classes (1, 1, 0) and (1, 1, 2) at their dz = 0
// neighbours, [side][dx+1][dy+1][b][c].
struct ZTaps {
  float g[2][81];
};

// xs at element m: x and the mask read together (neither waits on the
// other), then the select.
__device__ __forceinline__ float sanitized(const Args& a, int64_t m) {
  const float v = __ldg(a.x + m);
  return a.bc[m] ? 0.0f : v;
}

// corr of any other boundary node, from its class's row of the table.
__device__ __forceinline__ void table_corr(const Args& a, int cls, int64_t n,
                                           int64_t comp, int64_t yz,
                                           float (&corr)[3]) {
  const int* code = a.codes + cls * 10;
  const int count = __ldg(code);
  // unrolled and predicated, so that every neighbour's loads are in flight
  // at once; the rows past the count are not read
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (k >= count) break;
    const int d = __ldg(code + 1 + k);
    const int dx = d / 9 - 1;
    const int dy = (d / 3) % 3 - 1;
    const int dz = d % 3 - 1;
    const int64_t m = n + dx * yz + dy * a.Z + dz;
    const float v[3] = {sanitized(a, m), sanitized(a, m + comp),
                        sanitized(a, m + 2 * comp)};
    const float* g = a.rows + (cls * 9 + k) * 9;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
#pragma unroll
      for (int c = 0; c < 3; ++c) corr[b] += __ldg(g + 3 * b + c) * v[c];
    }
  }
}

// x- or y-face thread t: its boundary node, the ghost correction there,
// and the node's free outputs.
__device__ __forceinline__ void face_node(const Args& a, uint32_t t) {
  const uint32_t Z = a.Z;
  const uint32_t yz = static_cast<uint32_t>(a.Y) * Z;
  int ix, iy, iz;
  if (t < a.face_a) {  // an x-face plane, whole
    const uint32_t p = t / yz;
    const uint32_t r = t - p * yz;
    ix = p == 0 ? 0 : a.nx + static_cast<int>(p) - 1;
    iy = static_cast<int>(r / Z);
    iz = static_cast<int>(r - static_cast<uint32_t>(iy) * Z);
  } else {  // a y-face row of an interior x plane
    const uint32_t u = t - a.face_a;
    const uint32_t row = u / Z;
    iz = static_cast<int>(u - row * Z);
    const uint32_t px = row / a.y_rows;
    const int q = static_cast<int>(row - px * a.y_rows);
    ix = 1 + static_cast<int>(px);
    iy = q == 0 ? 0 : a.ny + q - 1;
  }
  const int64_t comp = static_cast<int64_t>(a.X) * yz;
  const int64_t n = static_cast<int64_t>(ix) * yz + static_cast<int64_t>(iy) * Z + iz;
  bool fixed[3];
#pragma unroll
  for (int b = 0; b < 3; ++b) fixed[b] = a.bc[n + b * comp] != 0;
  if (fixed[0] && fixed[1] && fixed[2]) return;  // the envelope's
  float corr[3] = {0.0f, 0.0f, 0.0f};
  const int cx = civi::node_class(ix, a.nx);
  const int cy = civi::node_class(iy, a.ny);
  const int cz = civi::node_class(iz, a.nz);
  table_corr(a, (cx * 3 + cy) * 3 + cz, n, comp, yz, corr);
  const float mm = civi::mass_scale(a.mf, a.m8, cx, cy, cz);
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    if (fixed[b]) continue;
    const int64_t nb = n + b * comp;
    a.out[nb] = civi::keff_out(false, __ldg(a.x + nb),
                               __ldg(a.interior + nb) - corr[b], a.ss, mm);
  }
}

// corr of z-face node (i, j) of a staged tile: its 9 dz = 0 neighbours.
template <int S>
__device__ __forceinline__ void z_tile_corr(const ZTaps& zt,
                                            const float (&sx)[3][kHalo][kHalo],
                                            int i, int j, float (&corr)[3]) {
#pragma unroll
  for (int dx = -1; dx <= 1; ++dx) {
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
      const float v[3] = {sx[0][i + 1 + dx][j + 1 + dy],
                          sx[1][i + 1 + dx][j + 1 + dy],
                          sx[2][i + 1 + dx][j + 1 + dy]};
      const int k = ((dx + 1) * 3 + (dy + 1)) * 9;
#pragma unroll
      for (int b = 0; b < 3; ++b) {
#pragma unroll
        for (int c = 0; c < 3; ++c) corr[b] += zt.g[S][k + 3 * b + c] * v[c];
      }
    }
  }
}

// z-face block q of slab s: side q / z_tiles_y (z = 0 or nz), the 16 x 16
// (x, y) tile at x0 = 16 s, y0 = 1 + 16 (q % z_tiles_y); its nodes with x
// in [1, nx) and y in [1, ny), thread (i, j) at (x0 + i, y0 + j).
__device__ __forceinline__ void z_face_tile(const Args& a, const ZTaps& zt,
                                            int s, int q) {
  __shared__ float sx[3][kHalo][kHalo];  // xs of the tile plus halo
  __shared__ uint8_t sf[3][kTile][kTile];  // the tile's own mask
  const int side = q / a.z_tiles_y;
  const int x0 = kSlab * s;
  const int y0 = 1 + kTile * (q - side * a.z_tiles_y);
  const int iz = side == 0 ? 0 : a.nz;
  const int64_t yz = static_cast<int64_t>(a.Y) * a.Z;
  const int64_t comp = a.X * yz;
  for (int e = threadIdx.x; e < 3 * kHalo * kHalo; e += kThreads) {
    const int c = e / (kHalo * kHalo);
    const int h = e - c * kHalo * kHalo;
    const int hx = h / kHalo;
    const int hy = h - hx * kHalo;
    const int jx = x0 - 1 + hx;
    const int jy = y0 - 1 + hy;
    float v = 0.0f;
    if (jx >= 0 && jx < a.X && jy < a.Y) {
      const int64_t m = c * comp + jx * yz + static_cast<int64_t>(jy) * a.Z + iz;
      const float xv = __ldg(a.x + m);
      const uint8_t f = a.bc[m];
      v = f ? 0.0f : xv;
      if (hx >= 1 && hx <= kTile && hy >= 1 && hy <= kTile) sf[c][hx - 1][hy - 1] = f;
    }
    sx[c][hx][hy] = v;
  }
  __syncthreads();
  const int i = threadIdx.x / kTile;
  const int j = threadIdx.x - i * kTile;
  const int ix = x0 + i;
  const int iy = y0 + j;
  if (ix < 1 || ix >= a.nx || iy >= a.ny) return;
  const bool fixed[3] = {sf[0][i][j] != 0, sf[1][i][j] != 0, sf[2][i][j] != 0};
  if (fixed[0] && fixed[1] && fixed[2]) return;  // the envelope's
  float corr[3] = {0.0f, 0.0f, 0.0f};
  if (side == 0) {
    z_tile_corr<0>(zt, sx, i, j, corr);
  } else {
    z_tile_corr<1>(zt, sx, i, j, corr);
  }
  const float mm = civi::mass_scale(a.mf, a.m8, 1, 1, side == 0 ? 0 : 2);
  const int64_t n = ix * yz + static_cast<int64_t>(iy) * a.Z + iz;
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    if (fixed[b]) continue;
    const int64_t nb = n + b * comp;
    // a free component: xs is x
    a.out[nb] = civi::keff_out(false, sx[b][i + 1][j + 1],
                               __ldg(a.interior + nb) - corr[b], a.ss, mm);
  }
}

// Envelope, 16-byte path: nodes n .. n + 3 of one (x, y) row (n < end).
__device__ __forceinline__ void envelope4(const Args& a, uint32_t n,
                                          uint32_t end) {
  const uint32_t Z = a.Z;
  const uint32_t yz = static_cast<uint32_t>(a.Y) * Z;
  const int64_t comp = static_cast<int64_t>(a.X) * yz;
  if (n >= end) return;
  const uint32_t row = n / Z;
  const int iz0 = static_cast<int>(n - row * Z);
  const int ix = static_cast<int>(row / a.Y);
  const int iy = static_cast<int>(row - static_cast<uint32_t>(ix) * a.Y);
  const bool inner_row =
      civi::node_class(ix, a.nx) == 1 && civi::node_class(iy, a.ny) == 1;
  int interior_nodes = 0;  // bit k: node n + k is of the interior class
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (inner_row && civi::node_class(iz0 + k, a.nz) == 1) interior_nodes |= 1 << k;
  }
  // the mask, x and interior of every component in flight at once (a
  // group that is all the face threads' is rare: its loads are wasted)
  uint32_t word[3];
  float4 xv4[3], iv4[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    word[c] = __ldg(reinterpret_cast<const unsigned int*>(a.bc + c * comp + n));
    xv4[c] = __ldg(reinterpret_cast<const float4*>(a.x + c * comp + n));
    iv4[c] = __ldg(reinterpret_cast<const float4*>(a.interior + c * comp + n));
  }
  int owned[3];
  int any = 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    owned[c] = interior_nodes;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if ((word[c] >> (8 * k)) & 0xffu) owned[c] |= 1 << k;
    }
    any |= owned[c];
  }
  if (!any) return;  // every output here is a face thread's
  const float mm = civi::mass_scale(a.mf, a.m8, 1, 1, 1);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (!owned[c]) continue;
    const int64_t nc = c * comp + n;
    const float4 xv = xv4[c];
    const float4 iv = iv4[c];
    const float xk[4] = {xv.x, xv.y, xv.z, xv.w};
    const float ik[4] = {iv.x, iv.y, iv.z, iv.w};
    float o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool fixed = (word[c] >> (8 * k)) & 0xffu;
      o[k] = civi::keff_out(fixed, xk[k], ik[k], a.ss, mm);
    }
    if (owned[c] == 0xf) {
      *reinterpret_cast<float4*>(a.out + nc) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (owned[c] & (1 << k)) a.out[nc + k] = o[k];
      }
    }
  }
}

// Envelope, any Z: node n (n < end).
__device__ __forceinline__ void envelope1(const Args& a, uint32_t n,
                                          uint32_t end) {
  const uint32_t Z = a.Z;
  const uint32_t yz = static_cast<uint32_t>(a.Y) * Z;
  const int64_t comp = static_cast<int64_t>(a.X) * yz;
  if (n >= end) return;
  const uint32_t row = n / Z;
  const int iz = static_cast<int>(n - row * Z);
  const int ix = static_cast<int>(row / a.Y);
  const int iy = static_cast<int>(row - static_cast<uint32_t>(ix) * a.Y);
  const bool interior_node = civi::node_class(ix, a.nx) == 1 &&
                             civi::node_class(iy, a.ny) == 1 &&
                             civi::node_class(iz, a.nz) == 1;
  const float mm = civi::mass_scale(a.mf, a.m8, 1, 1, 1);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int64_t nc = c * comp + n;
    const bool fixed = a.bc[nc] != 0;
    if (!fixed && !interior_node) continue;  // a face thread's
    a.out[nc] = civi::keff_out(fixed, __ldg(a.x + nc), __ldg(a.interior + nc),
                               a.ss, mm);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads) keff_boundary_kernel(
    const __grid_constant__ Args a, const __grid_constant__ ZTaps zt) {
  const int b = blockIdx.x;
  if (b < a.xy_blocks) {
    const uint32_t t = b * kThreads + threadIdx.x;
    if (t < a.face_b) face_node(a, t);
    return;
  }
  const int per_slab = a.slab_envelope + a.slab_z;
  const int s = (b - a.xy_blocks) / per_slab;
  const int r = b - a.xy_blocks - s * per_slab;
  if (r >= a.slab_envelope) {
    z_face_tile(a, zt, s, r - a.slab_envelope);
    return;
  }
  const uint32_t yz = static_cast<uint32_t>(a.Y) * a.Z;
  const uint32_t first = static_cast<uint32_t>(s) * kSlab * yz;
  const uint32_t last = min(first + kSlab * yz, static_cast<uint32_t>(a.X) * yz);
  const uint32_t g = static_cast<uint32_t>(r) * kThreads + threadIdx.x;
  if (VEC) {
    envelope4(a, first + 4 * g, last);
  } else {
    envelope1(a, first + g, last);
  }
}

}  // namespace

// codes, rows: the device tables of ops/cuda/keff_boundary.ghost_tap_rows;
// ztaps: the 162 host floats of ZTaps (copied into the launch's
// parameters); x_planes .. vec as boundary_geometry computes them, refused
// (cudaErrorInvalidValue) unless they match this grid; vec: the 16-byte
// envelope (Z % 4 == 0, interior, x and out 16-byte aligned, bc 4-byte)
extern "C" int civi_keff_boundary(
    const float* interior, const float* x, const unsigned char* bc,
    const int* codes, const float* rows, const float* ztaps, float* out,
    int X, int Y, int Z, int nx, int ny, int nz, float ss, float mf, float m8,
    int x_planes, int y_rows, int xy_nodes, int xy_blocks, int slabs,
    int slab_envelope, int slab_z, int vec, void* stream) {
  if (X <= 0 || Y <= 0 || Z <= 0 || nx < 1 || ny < 1 || nz < 1 ||
      X <= nx || Y <= ny || Z != nz + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t comp = static_cast<int64_t>(X) * Y * Z;
  const int64_t face_a = static_cast<int64_t>(X - nx + 1) * Y * Z;
  const int64_t face_b = face_a + static_cast<int64_t>(nx - 1) * (Y - ny + 1) * Z;
  const int64_t per_block = (vec ? 4 : 1) * kThreads;
  const int tiles_y = nx > 1 ? (ny - 1 + kTile - 1) / kTile : 0;
  if (comp >= (int64_t{1} << 31) || x_planes != X - nx + 1 ||
      y_rows != Y - ny + 1 || xy_nodes != face_b ||
      xy_blocks != (face_b + kThreads - 1) / kThreads ||
      slabs != (X + kSlab - 1) / kSlab ||
      slab_envelope != (int64_t{kSlab} * Y * Z + per_block - 1) / per_block ||
      slab_z != 2 * tiles_y || (vec && Z % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.interior = interior;
  a.x = x;
  a.bc = bc;
  a.codes = codes;
  a.rows = rows;
  a.out = out;
  a.X = X;
  a.Y = Y;
  a.Z = Z;
  a.nx = nx;
  a.ny = ny;
  a.nz = nz;
  a.y_rows = y_rows;
  a.face_a = static_cast<uint32_t>(face_a);
  a.face_b = static_cast<uint32_t>(face_b);
  a.xy_blocks = xy_blocks;
  a.slab_envelope = slab_envelope;
  a.slab_z = slab_z;
  a.z_tiles_y = tiles_y;
  a.ss = ss;
  a.mf = mf;
  a.m8 = m8;
  ZTaps zt;
  std::memcpy(zt.g, ztaps, sizeof(zt.g));
  const auto blocks = static_cast<unsigned>(
      xy_blocks + int64_t{slabs} * (slab_envelope + slab_z));
  const auto st = static_cast<cudaStream_t>(stream);
  if (vec) {
    keff_boundary_kernel<true><<<blocks, kThreads, 0, st>>>(a, zt);
  } else {
    keff_boundary_kernel<false><<<blocks, kThreads, 0, st>>>(a, zt);
  }
  return static_cast<int>(cudaGetLastError());
}
