// K6a, K6b and K6c: the trilinear 3-D warp, the positions' cotangent and the
// volume's cotangent, written by hand for Hopper (sm_90a).
//
// K6a replaces the TPU kernel tpureg/ops/warp3d_pallas.py::_kernel3 (:210-253)
// with with_taps=False (via _grid_call :291 <- _dispatch :426 <- warp3d_pallas
// :438), reached from tpureg/ops/warp.py::sample3d (:177-205); here it is the
// forward of every sample, differentiated or not. K6b replaces the same kernel
// with with_taps=True (via _vjp_fwd :451) together with the product that the
// TPU path's backward takes of its bases (:456-463): it returns
// dp = sum over c of g_c * d out_c / d p for p = px, py, pz, the question the
// backward asks, and no per-channel basis ever reaches device memory. K6c is
// the volume cotangent, which the TPU path leaves to an XLA scatter (the
// transpose of _gather_taps :375, in _vjp_bwd :456-463).
//
// Semantics: x0 = floor(px), y0 = floor(py), z0 = floor(pz), fx = px - x0
// (and fy, fz); the 8 corners (x0|x0+1, y0|y0+1, z0|z0+1) carry the weight
// cx * cy * cz with cx = fx at x0+1 and 1 - fx at x0 (and so on), and each
// corner outside the volume contributes zero on its own (grid_sample's zeros
// padding). Math and outputs in fp32; the volume may be fp32 or bf16, with any
// number of channels C and any (D, H, W).
//
// Order of rounded operations. K6a follows the plain version
// (tpureg_torch/ops/warp.py::sample3d_gather, tpureg's warp.py:208-245):
// wgt = (cx * cy) * cz, term = value * wgt, summed over (dz, dy, dx) in that
// nesting, each product and sum rounded on its own (__fmul_rn / __fadd_rn, so
// that nvcc contracts nothing into fused multiply-adds). The fp32 sample is
// then the plain version's bit for bit. K6b's bases take the form of tpureg's
// _gather_taps (:406-420): d/dpx = sum of ((v * sx) * cy) * cz with sx = +1 at
// x0+1 and -1 at x0, and likewise for y and z; the contraction is
// g_0 * base_0 + g_1 * base_1 + ... in channel order, so that for C = 1 it is
// the product g * base bit for bit. K6c adds value-free products g * wgt
// into an fp32 sum with atomics, first in shared memory and then into the
// zeroed fp32 output; the order of those additions changes from run to run,
// so it agrees with the plain version to fp32 rounding of the sums, not bit
// for bit.
//
// What bounds them on the H100: bytes. On the VoxelMorph3D path (B=2,
// 176x256x256, C=1, fp32, P = 11.5 M positions a volume) K6a reads 4 B of
// volume and 12 B of positions and writes 4 B a position: 0.46 GB, 0.14 ms at
// 3.35 TB/s; K6b reads the volume, the positions and the cotangent g and
// writes three fp32 outputs: 0.74 GB, 0.22 ms. The scaling-and-squaring
// compositions warp a 3-channel field at 88x128x128 (P = 1.44 M): K6b 0.14 GB
// (41 us), K6c 0.10 GB (31 us). What held K6c back was not bytes but the
// atomic unit: one global atomic per in-volume corner and channel, 69 M at a
// composition, each its own L2 operation at about 140 G/s.
//
// Design of K6a and K6b: one thread per (b, position), the batch on the
// grid's y axis; positions, cotangents and outputs are read and written
// coalesced; the 8 corners are gathered from global memory through L1/L2
// (one 176x256x256 fp32 volume is 46 MB and fits the 50 MB L2; registration
// flows are smooth, so neighbouring threads read neighbouring voxels); the
// loop over C reuses the corner indices and weights. K6b gathers the corners
// that K6a gathered in the forward once more rather than save bases for the
// backward: three [B, C, P] bases would cost 12 C bytes a position to write
// and as much to read back, where the second gathers mostly hit L2. The TPU
// kernel's VMEM slab, data-adaptive (z, y) window, one-hot MXU column selects
// with the bf16 hi/lo split and the traced guard with its gather fallback
// (warp3d_pallas.py:142-180, :215-227, :267-288, :335-372) exist because the
// TPU has no fast gather; none is needed here, and the kernels take every
// shape.
//
// Design of K6c: fewer atomics, merged in registers and, where positions
// scatter, privatised in shared memory. On every 3-D path the positions are
// the voxel grid plus a smooth displacement, so neighbouring positions share
// corners: each voxel takes about 8 contributions from its 8 nearest
// positions. A block takes a brick of 8 x 8 x 32 positions (z, y, x); a
// warp holds 32 neighbours along x and each thread walks 8 along z.
// - Merging. A thread carries the far corner plane (z0 + 1) of a position
//   to the next one along z, whose near plane it is when the field is
//   smooth; a lane hands its x0 + 1 corners to the lane above when those
//   are that lane's x0 corners (warp shuffles). On a smooth field a position
//   then issues about 2 atomics a channel instead of 8.
// - Where the brick's corners stay within a voxel of the brick (every
//   displacement under a voxel, as in the step's compositions), the merged
//   sums go straight to global atomics.
// - Otherwise (N(0, 0.5^2) displacements and wider) the block sums each
//   channel in a shared-memory window over the box of its corners and adds
//   the window to the output once, row by row, with float4 global atomics
//   that skip entries left at zero. Shared fp32 atomicAdd is a
//   compare-and-swap loop on sm_90a (ATOMS.CAST.SPIN), no cheaper per add
//   than a global reduction, so the window pays only where it replaces
//   many scattered global adds. A box larger than the 32 KB window falls
//   back to a fixed window around the brick, with the corners outside it
//   sent to global atomics; positions that do not lie on the volume's grid
//   take bricks of consecutive positions.
// The TPU path has no kernel here to follow: it leaves the scatter to XLA.

#include <climits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// The corner geometry of one position: the base corner (clamped before the
// conversion, so that far-away or non-finite positions stay defined; every
// clamped corner is outside the volume either way), the fractions and their
// complements, and which of the two rows on each axis lies inside.
struct Corners {
  int x0, y0, z0;
  float c[3][2];      // c[axis][0] = 1 - f, c[axis][1] = f; axis 0 = x
  bool in[3][2];      // in[axis][k]: corner row k of the axis is inside
};

__device__ __forceinline__ int base_index(float p, float& frac, int n) {
  const float p0 = floorf(p);
  frac = __fsub_rn(p, p0);
  return (int)fminf(fmaxf(p0, -2.f), (float)n);
}

__device__ __forceinline__ Corners corners_at(float x, float y, float z, int D, int H,
                                              int W) {
  Corners t;
  float fx, fy, fz;
  t.x0 = base_index(x, fx, W);
  t.y0 = base_index(y, fy, H);
  t.z0 = base_index(z, fz, D);
  t.c[0][0] = __fsub_rn(1.f, fx);
  t.c[0][1] = fx;
  t.c[1][0] = __fsub_rn(1.f, fy);
  t.c[1][1] = fy;
  t.c[2][0] = __fsub_rn(1.f, fz);
  t.c[2][1] = fz;
  t.in[0][0] = t.x0 >= 0 && t.x0 < W;
  t.in[0][1] = t.x0 + 1 >= 0 && t.x0 + 1 < W;
  t.in[1][0] = t.y0 >= 0 && t.y0 < H;
  t.in[1][1] = t.y0 + 1 >= 0 && t.y0 + 1 < H;
  t.in[2][0] = t.z0 >= 0 && t.z0 < D;
  t.in[2][1] = t.z0 + 1 >= 0 && t.z0 + 1 < D;
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp3d_fwd_kernel(const T* __restrict__ vol, const float* __restrict__ px,
                  const float* __restrict__ py, const float* __restrict__ pz,
                  float* __restrict__ out, int C, int D, int H, int W, long long P) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const long long b = blockIdx.y;
  const long long i = b * P + p;
  const Corners t = corners_at(px[i], py[i], pz[i], D, H, W);
  const long long HW = (long long)H * W;
  const long long vox = (long long)D * HW;
  long long idx[8];
  float wgt[8];
  bool ok[8];
#pragma unroll
  for (int dz = 0; dz < 2; ++dz)
#pragma unroll
    for (int dy = 0; dy < 2; ++dy)
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int k = dz * 4 + dy * 2 + dx;
        ok[k] = t.in[2][dz] && t.in[1][dy] && t.in[0][dx];
        idx[k] = (long long)(t.z0 + dz) * HW + (long long)(t.y0 + dy) * W + (t.x0 + dx);
        wgt[k] = __fmul_rn(__fmul_rn(t.c[0][dx], t.c[1][dy]), t.c[2][dz]);
      }
  const T* src = vol + b * C * vox;
  float* dst = out + b * C * P + p;
  for (int c = 0; c < C; ++c, src += vox, dst += P) {
    float acc = ok[0] ? __fmul_rn(to_f32(src[idx[0]]), wgt[0]) : 0.f;
#pragma unroll
    for (int k = 1; k < 8; ++k)
      acc = __fadd_rn(acc, ok[k] ? __fmul_rn(to_f32(src[idx[k]]), wgt[k]) : 0.f);
    *dst = acc;
  }
}

// K6b: dpx, dpy, dpz = sum over c of g_c * d out_c / d p. The corner
// offsets (in the volume's index type I) and predicates are formed once per
// position; each channel's 8 corners are gathered again (the volume is as
// L2-hot as in K6a), its three bases formed in registers in _gather_taps'
// order and contracted with g_c at once, channel 0 first. A corner outside
// the volume is skipped, not multiplied by zero, so that a non-finite
// position (whose fractions are NaN) gives zero.
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
warp3d_dpos_kernel(const T* __restrict__ vol, const float* __restrict__ px,
                   const float* __restrict__ py, const float* __restrict__ pz,
                   const float* __restrict__ g, float* __restrict__ dpx,
                   float* __restrict__ dpy, float* __restrict__ dpz, int C, int D, int H,
                   int W, long long P) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const long long b = blockIdx.y;
  const long long i = b * P + p;
  const Corners t = corners_at(px[i], py[i], pz[i], D, H, W);
  const I HW = (I)H * W;
  const I vox = (I)D * HW;
  I idx[8];
  bool ok[8];
#pragma unroll
  for (int dz = 0; dz < 2; ++dz)
#pragma unroll
    for (int dy = 0; dy < 2; ++dy)
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int k = dz * 4 + dy * 2 + dx;
        ok[k] = t.in[2][dz] && t.in[1][dy] && t.in[0][dx];
        // only an inside corner's offset is formed: it is below D * H * W
        idx[k] = ok[k] ? (I)(t.z0 + dz) * HW + (I)(t.y0 + dy) * W + (I)(t.x0 + dx) : 0;
      }
  const T* src = vol + b * C * (long long)vox;
  const float* gp = g + b * C * P + p;
  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int c = 0; c < C; ++c, src += vox, gp += P) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = ok[k] ? to_f32(src[idx[k]]) : 0.f;
    float gx = 0.f, gy = 0.f, gz = 0.f;
#pragma unroll
    for (int dz = 0; dz < 2; ++dz)
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const int k = dz * 4 + dy * 2 + dx;
          if (!ok[k]) continue;
          const float cx = t.c[0][dx], cy = t.c[1][dy], cz = t.c[2][dz];
          // _gather_taps' bases: ((v * s) * c) * c, the sign exact
          const float vx = dx ? v[k] : -v[k];
          const float vy = __fmul_rn(v[k], cx);
          gx = __fadd_rn(gx, __fmul_rn(__fmul_rn(vx, cy), cz));
          gy = __fadd_rn(gy, __fmul_rn(dy ? vy : -vy, cz));
          const float vz = __fmul_rn(vy, cy);
          gz = __fadd_rn(gz, dz ? vz : -vz);
        }
    const float gc = *gp;
    if (c == 0) {
      ax = __fmul_rn(gc, gx);
      ay = __fmul_rn(gc, gy);
      az = __fmul_rn(gc, gz);
    } else {
      ax = __fadd_rn(ax, __fmul_rn(gc, gx));
      ay = __fadd_rn(ay, __fmul_rn(gc, gy));
      az = __fadd_rn(az, __fmul_rn(gc, gz));
    }
  }
  dpx[i] = ax;
  dpy[i] = ay;
  dpz[i] = az;
}

// K6c's geometry. A block takes a brick of kBZ x kBY x kBX positions of the
// positions' grid [gd, gh, gw] (P = gd * gh * gw in raster order, padded at
// the far edges); thread (tx, ty) holds the kBZ positions at x = tx, y = ty.
constexpr int kBX = 32, kBY = 8, kBZ = 8;
constexpr int kBrick = kBX * kBY * kBZ;
static_assert(kBX * kBY == kThreads, "one thread per (x, y) of a brick");
// fp32 entries of the shared-memory window that one channel is summed in
// (32 KB; with the brick's positions, 56 KB a block, four blocks an SM)
constexpr int kWindow = 8192;
constexpr size_t kDvolSmem = (kWindow + 3 * kBrick) * sizeof(float);
// the fixed window of a brick whose corners span more than kWindow: the
// brick's own voxels and kMargin more on each side (x widened to whole
// float4s), which holds every displacement under kMargin voxels
constexpr int kMargin = 2;
static_assert((kBZ + 2 * kMargin + 1) * (kBY + 2 * kMargin + 1) *
                      (kBX + 2 * kMargin + 8) <= kWindow,
              "the fixed window fits the shared-memory budget");

__device__ __forceinline__ bool nonzero(float v) { return v != 0.f; }
__device__ __forceinline__ bool nonzero(float4 v) {
  return v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f;
}

__device__ __forceinline__ bool any_inside(const Corners& t) {
  return (t.in[0][0] || t.in[0][1]) && (t.in[1][0] || t.in[1][1]) &&
         (t.in[2][0] || t.in[2][1]);
}

// K6c: dvol[b, c, corner] += g[b, c, p] * w(p, corner) over every position p
// and each of its in-volume corners (design above). The block stages its
// positions in shared memory and takes the bounding box of their in-volume
// corners, which chooses among: no window (a tight box: merged sums to
// global atomics), the box as the window (it fits kWindow), the brick's
// fixed window (on the volume's grid, `on_grid`), or none. V = float4 when
// W % 4 == 0, which aligns every row of a window for vector atomics.
template <typename V>
__global__ void __launch_bounds__(kThreads, 4)
warp3d_dvol_kernel(const float* __restrict__ px, const float* __restrict__ py,
                   const float* __restrict__ pz, const float* __restrict__ g,
                   float* __restrict__ dvol, int C, int D, int H, int W, long long P,
                   int gd, int gh, int gw, bool on_grid) {
  constexpr int kVec = sizeof(V) / sizeof(float);
  extern __shared__ __align__(16) float smem[];
  float* win = smem;                  // [kWindow]: one channel's window
  float* sx = smem + kWindow;         // [kBrick] each: the brick's positions
  float* sy = sx + kBrick;
  float* sz = sy + kBrick;
  __shared__ int lim[6];   // min x, y, z, then -max x, y, z of the corners
  const int nbx = (gw + kBX - 1) / kBX, nby = (gh + kBY - 1) / kBY;
  const int bx = blockIdx.x % nbx;
  const int by = (blockIdx.x / nbx) % nby;
  const int bz = blockIdx.x / (nbx * nby);
  const int tid = threadIdx.x;
  const int gx = bx * kBX + tid % kBX, gy = by * kBY + tid / kBX;
  const long long b = blockIdx.y;
  const bool col_ok = gx < gw && gy < gh;
  // the position index of the thread's j-th position, or -1 past the grid
  auto index = [&](int j) -> long long {
    const int gz = bz * kBZ + j;
    const long long p = ((long long)gz * gh + gy) * gw + gx;
    return (col_ok && gz < gd && p < P) ? p : -1;
  };

  // stage the positions (NaN past the grid: no corner) and take the box
  int lo[3] = {INT_MAX, INT_MAX, INT_MAX}, hi[3] = {INT_MIN, INT_MIN, INT_MIN};
  {
    const float nan = __int_as_float(0x7fc00000);
    float x[kBZ], y[kBZ], z[kBZ];
#pragma unroll
    for (int j = 0; j < kBZ; ++j) {
      const long long p = index(j);
      x[j] = p >= 0 ? px[b * P + p] : nan;
      y[j] = p >= 0 ? py[b * P + p] : nan;
      z[j] = p >= 0 ? pz[b * P + p] : nan;
    }
#pragma unroll
    for (int j = 0; j < kBZ; ++j) {
      sx[j * kThreads + tid] = x[j];
      sy[j * kThreads + tid] = y[j];
      sz[j * kThreads + tid] = z[j];
      const Corners t = corners_at(x[j], y[j], z[j], D, H, W);
      if (any_inside(t)) {
        const int c0[3] = {t.x0, t.y0, t.z0};
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          lo[a] = min(lo[a], t.in[a][0] ? c0[a] : c0[a] + 1);
          hi[a] = max(hi[a], t.in[a][1] ? c0[a] + 1 : c0[a]);
        }
      }
    }
  }
  if (tid < 6) lim[tid] = INT_MAX;
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int l = __reduce_min_sync(0xffffffffu, lo[a]);
    const int h = __reduce_min_sync(0xffffffffu, hi[a] == INT_MIN ? INT_MAX : -hi[a]);
    if (tid % 32 == 0) {
      atomicMin(&lim[a], l);
      atomicMin(&lim[3 + a], h);
    }
  }
  __syncthreads();
  if (lim[0] == INT_MAX) return;   // no in-volume corner in the brick

  // the window: origin (w0) and extents (e), x in whole vectors
  int w0[3], e[3];
  {
    int l[3] = {lim[0], lim[1], lim[2]}, h[3] = {-lim[3], -lim[4], -lim[5]};
    // a brick whose corners stay within a voxel of it (every displacement
    // under a voxel: the compositions' smooth fields) sends its sums, merged
    // in registers, straight to global atomics: no window to zero and flush
    const bool tight = on_grid && h[0] - l[0] <= kBX + 1 && h[1] - l[1] <= kBY + 1 &&
                       h[2] - l[2] <= kBZ + 1;
    l[0] -= l[0] % kVec;
    h[0] += kVec - 1 - h[0] % kVec;
    long long n = 1;
    for (int a = 0; a < 3; ++a) n *= h[a] - l[a] + 1;
    if (tight) {
      h[0] = l[0] - 1;
    } else if (n > kWindow) {
      if (on_grid) {
        const int o[3] = {bx * kBX, by * kBY, bz * kBZ};
        const int s[3] = {kBX, kBY, kBZ};
        const int dim[3] = {W, H, D};
        for (int a = 0; a < 3; ++a) {
          l[a] = max(o[a] - kMargin, 0);
          h[a] = min(o[a] + s[a] + kMargin, dim[a] - 1);
        }
        l[0] -= l[0] % kVec;
        h[0] += kVec - 1 - h[0] % kVec;
      } else {
        h[0] = l[0] - 1;   // empty: every corner goes global
      }
    }
    for (int a = 0; a < 3; ++a) {
      w0[a] = l[a];
      e[a] = max(h[a] - l[a] + 1, 0);
    }
  }
  const int nwin = e[0] * e[1] * e[2];
  const long long HW = (long long)H * W;
  const long long vox = (long long)D * HW;

  const int lane = tid % 32;
  for (int c = 0; c < C; ++c) {
    float* dst = dvol + (b * C + c) * vox;
    const float* gp = g + (b * C + c) * P;
    float gv[kBZ];
#pragma unroll
    for (int j = 0; j < kBZ; ++j) {
      const long long p = index(j);
      gv[j] = p >= 0 ? gp[p] : 0.f;
    }
    if (c > 0) __syncthreads();          // the last channel's flush is done
    for (int i = tid; i < nwin; i += kThreads) win[i] = 0.f;
    __syncthreads();

    // one product into voxel (x, y, z): skipped outside the volume and when
    // it is exactly zero (it would change no sum); the window's atomics if
    // the voxel lies in it, else a global one
    auto emit = [&](int x, int y, int z, float v) {
      if (v == 0.f || (unsigned)x >= (unsigned)W || (unsigned)y >= (unsigned)H ||
          (unsigned)z >= (unsigned)D)
        return;
      const int lx = x - w0[0], ly = y - w0[1], lz = z - w0[2];
      if ((unsigned)lx < (unsigned)e[0] && (unsigned)ly < (unsigned)e[1] &&
          (unsigned)lz < (unsigned)e[2])
        atomicAdd(&win[(lz * e[1] + ly) * e[0] + lx], v);
      else
        atomicAdd(dst + (long long)z * HW + (long long)y * W + x, v);
    };
    // a plane of corners (x|x+1, y|y+1) at depth z, v[dy][dx]; called by
    // the whole warp at once: where the lane below's x+1 column is this
    // lane's x column (neighbouring positions of a smooth field), its two
    // products join this lane's, and one atomic adds both
    auto emit_plane = [&](int x, int y, int z, const float (&v)[2][2]) {
      const int bxp = __shfl_up_sync(0xffffffffu, x, 1);
      const int byp = __shfl_up_sync(0xffffffffu, y, 1);
      const int bzp = __shfl_up_sync(0xffffffffu, z, 1);
      const int axp = __shfl_down_sync(0xffffffffu, x, 1);
      const int ayp = __shfl_down_sync(0xffffffffu, y, 1);
      const int azp = __shfl_down_sync(0xffffffffu, z, 1);
      const bool take = lane > 0 && bxp + 1 == x && byp == y && bzp == z;
      const bool given = lane < 31 && axp == x + 1 && ayp == y && azp == z;
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const float below = __shfl_up_sync(0xffffffffu, v[dy][1], 1);
        emit(x, y + dy, z, take ? __fadd_rn(below, v[dy][0]) : v[dy][0]);
        if (!given) emit(x + 1, y + dy, z, v[dy][1]);
      }
    };

    // each thread walks its positions along z and carries the far plane
    // (z0 + 1) of one position to the next, whose near plane it is when
    // both lie on the same voxels
    float carry[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    int kx = 0, ky = 0, kz = INT_MIN;    // the carried plane's corner (x, y, z)
#pragma unroll 1
    for (int j = 0; j < kBZ; ++j) {
      const Corners t =
          corners_at(sx[j * kThreads + tid], sy[j * kThreads + tid],
                     sz[j * kThreads + tid], D, H, W);
      float v[2][2][2];
#pragma unroll
      for (int dz = 0; dz < 2; ++dz)
#pragma unroll
        for (int dy = 0; dy < 2; ++dy)
#pragma unroll
          for (int dx = 0; dx < 2; ++dx)
            v[dz][dy][dx] = __fmul_rn(
                gv[j], __fmul_rn(__fmul_rn(t.c[0][dx], t.c[1][dy]), t.c[2][dz]));
      if (kx == t.x0 && ky == t.y0 && kz == t.z0) {
#pragma unroll
        for (int dy = 0; dy < 2; ++dy)
#pragma unroll
          for (int dx = 0; dx < 2; ++dx)
            v[0][dy][dx] = __fadd_rn(carry[dy][dx], v[0][dy][dx]);
      } else if (kz != INT_MIN) {
#pragma unroll
        for (int dy = 0; dy < 2; ++dy)
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) emit(kx + dx, ky + dy, kz, carry[dy][dx]);
      }
      emit_plane(t.x0, t.y0, t.z0, v[0]);
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) carry[dy][dx] = v[1][dy][dx];
      kx = t.x0;
      ky = t.y0;
      kz = t.z0 + 1;
    }
    emit_plane(kx, ky, kz, carry);
    __syncthreads();
    // flush: consecutive threads take consecutive vectors of a row
    const int rowv = e[0] / kVec;
    const V* wv = reinterpret_cast<const V*>(win);
    for (int i = tid; i < nwin / kVec; i += kThreads) {
      const V v = wv[i];
      if (!nonzero(v)) continue;
      const int r = i / rowv, q = i - r * rowv;
      const int ly = r % e[1], lz = r / e[1];
      atomicAdd(reinterpret_cast<V*>(dst + (long long)(w0[2] + lz) * HW +
                                     (long long)(w0[1] + ly) * W + w0[0] + q * kVec),
                v);
    }
  }
}

bool bad_shape(int B, int C, int D, int H, int W, long long P) {
  return B <= 0 || C <= 0 || D <= 0 || H <= 0 || W <= 0 || P < 0;
}

bool bad_grid(int B, long long P) {
  return (P + kThreads - 1) / kThreads > 2147483647LL || B > 65535;
}

dim3 grid_of(int B, long long P) {
  return dim3((unsigned)((P + kThreads - 1) / kThreads), (unsigned)B);
}

template <typename T, typename I>
void launch_dpos(const void* vol, const float* x, const float* y, const float* z,
                 const float* g, float* ox, float* oy, float* oz, int B, int C, int D, int H,
                 int W, long long P, cudaStream_t s) {
  warp3d_dpos_kernel<T, I><<<grid_of(B, P), kThreads, 0, s>>>(
      static_cast<const T*>(vol), x, y, z, g, ox, oy, oz, C, D, H, W, P);
}

}  // namespace

// K6a. dtype: 0 = float32, 1 = bfloat16 volume. vol: [B, C, D, H, W]
// contiguous; px, py, pz: [B, P] fp32 contiguous; out: [B, C, P] fp32
// contiguous. Launches on `stream`; allocates nothing and does not
// synchronise. Returns cudaGetLastError().
extern "C" int tpureg_warp3d_fwd(const void* vol, const void* px, const void* py,
                                 const void* pz, void* out, int dtype, int B, int C, int D,
                                 int H, int W, long long P, void* stream) {
  if (bad_shape(B, C, D, H, W, P)) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  if (bad_grid(B, P)) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(px);
  const float* y = static_cast<const float*>(py);
  const float* z = static_cast<const float*>(pz);
  float* o = static_cast<float*>(out);
  if (dtype == 0) {
    warp3d_fwd_kernel<float><<<grid_of(B, P), kThreads, 0, s>>>(
        static_cast<const float*>(vol), x, y, z, o, C, D, H, W, P);
  } else if (dtype == 1) {
    warp3d_fwd_kernel<__nv_bfloat16><<<grid_of(B, P), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(vol), x, y, z, o, C, D, H, W, P);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K6b. vol: [B, C, D, H, W] (dtype as K6a's); px, py, pz: [B, P] fp32;
// g: [B, C, P] fp32; dpx, dpy, dpz: [B, P] fp32; all contiguous. In-volume
// offsets are 32-bit when D * H * W < 2^31, else 64-bit. Launches on
// `stream`; allocates nothing and does not synchronise. Returns
// cudaGetLastError().
extern "C" int tpureg_warp3d_dpos(const void* vol, const void* px, const void* py,
                                  const void* pz, const void* g, void* dpx, void* dpy,
                                  void* dpz, int dtype, int B, int C, int D, int H, int W,
                                  long long P, void* stream) {
  if (bad_shape(B, C, D, H, W, P)) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  if (bad_grid(B, P)) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(px);
  const float* y = static_cast<const float*>(py);
  const float* z = static_cast<const float*>(pz);
  const float* gr = static_cast<const float*>(g);
  float* ox = static_cast<float*>(dpx);
  float* oy = static_cast<float*>(dpy);
  float* oz = static_cast<float*>(dpz);
  const bool narrow = (long long)D * H * W < 2147483648LL;
  if (dtype == 0 && narrow) {
    launch_dpos<float, int>(vol, x, y, z, gr, ox, oy, oz, B, C, D, H, W, P, s);
  } else if (dtype == 0) {
    launch_dpos<float, long long>(vol, x, y, z, gr, ox, oy, oz, B, C, D, H, W, P, s);
  } else if (dtype == 1 && narrow) {
    launch_dpos<__nv_bfloat16, int>(vol, x, y, z, gr, ox, oy, oz, B, C, D, H, W, P, s);
  } else if (dtype == 1) {
    launch_dpos<__nv_bfloat16, long long>(vol, x, y, z, gr, ox, oy, oz, B, C, D, H, W, P,
                                          s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K6c. px, py, pz: [B, P] fp32; g: [B, C, P] fp32; dvol: [B, C, D, H, W]
// fp32, zeroed by the caller; all contiguous. When P = D * H * W the
// positions are taken to lie on the volume's grid in raster order (every
// 3-D path builds them from voxel_grid) and blocks take bricks of that
// grid; otherwise bricks of 2,048 consecutive positions. Either way any
// positions give the right sums. Launches on `stream`; allocates nothing and
// does not synchronise. Returns cudaGetLastError().
extern "C" int tpureg_warp3d_dvol(const void* px, const void* py, const void* pz,
                                  const void* g, void* dvol, int B, int C, int D, int H,
                                  int W, long long P, void* stream) {
  if (bad_shape(B, C, D, H, W, P)) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  const bool on_grid = P == (long long)D * H * W;
  const long long gd = on_grid ? D : (P + kBX * kBY - 1) / (kBX * kBY);
  const int gh = on_grid ? H : kBY, gw = on_grid ? W : kBX;
  const long long blocks =
      ((gd + kBZ - 1) / kBZ) * ((gh + kBY - 1) / kBY) * ((gw + kBX - 1) / kBX);
  if (gd > INT_MAX || blocks > INT_MAX || B > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, (unsigned)B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(px);
  const float* y = static_cast<const float*>(py);
  const float* z = static_cast<const float*>(pz);
  const float* gr = static_cast<const float*>(g);
  float* o = static_cast<float*>(dvol);
  // every row of a window starts on a 16-byte boundary when W % 4 == 0
  auto kernel = W % 4 == 0 ? warp3d_dvol_kernel<float4> : warp3d_dvol_kernel<float>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDvolSmem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, kDvolSmem, s>>>(x, y, z, gr, o, C, D, H, W, P, (int)gd, gh, gw,
                                           on_grid);
  return (int)cudaGetLastError();
}
