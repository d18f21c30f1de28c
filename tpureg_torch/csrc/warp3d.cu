// K6a, K6b and K6c: the trilinear 3-D warp, its position-derivative bases and
// its volume cotangent, written by hand for Hopper (sm_90a).
//
// K6a replaces the TPU kernel tpureg/ops/warp3d_pallas.py::_kernel3 (:210-253)
// with with_taps=False (via _grid_call :291 <- _dispatch :426 <- warp3d_pallas
// :438), reached from tpureg/ops/warp.py::sample3d (:177-205). K6b replaces
// the same kernel with with_taps=True (via _vjp_fwd :451): the sample and,
// beside it, d out / d px, d out / d py and d out / d pz, so that the backward
// to the positions is an elementwise product with the cotangent (:456-463).
// K6c is the volume cotangent, which the TPU path leaves to an XLA scatter
// (the transpose of _gather_taps :375, in _vjp_bwd :456-463).
//
// Semantics: x0 = floor(px), y0 = floor(py), z0 = floor(pz), fx = px - x0
// (and fy, fz); the 8 corners (x0|x0+1, y0|y0+1, z0|z0+1) carry the weight
// cx * cy * cz with cx = fx at x0+1 and 1 - fx at x0 (and so on), and each
// corner outside the volume contributes zero on its own (grid_sample's zeros
// padding). Math and outputs in fp32; the volume may be fp32 or bf16, with any
// number of channels C and any (D, H, W).
//
// Order of rounded operations. K6a and K6b's sample follow the plain version
// (tpureg_torch/ops/warp.py::sample3d_gather, tpureg's warp.py:208-245):
// wgt = (cx * cy) * cz, term = value * wgt, summed over (dz, dy, dx) in that
// nesting, each product and sum rounded on its own (__fmul_rn / __fadd_rn, so
// that nvcc contracts nothing into fused multiply-adds). The fp32 sample is
// then the plain version's bit for bit, and K6b's sample equals K6a's. K6b's
// bases take the form of tpureg's _gather_taps (:406-420):
// d/dpx = sum of ((v * sx) * cy) * cz with sx = +1 at x0+1 and -1 at x0, and
// likewise for y and z. K6c adds value-free products g * wgt with fp32
// atomicAdd into a zeroed fp32 buffer; the order of those additions changes
// from run to run, so it agrees with the plain version to fp32 rounding of the
// sums, not bit for bit.
//
// What bounds them on the H100: bytes. On the VoxelMorph3D path (B=2,
// 176x256x256, C=1, fp32, P = 11.5 M positions a volume) K6a reads 4 B of
// volume and 12 B of positions and writes 4 B a position: 0.46 GB, 0.14 ms at
// 3.35 TB/s; K6b writes three more fp32 outputs: 0.74 GB, 0.22 ms. The
// scaling-and-squaring compositions warp a 3-channel field at 88x128x128
// (P = 1.44 M): K6b 0.21 GB (62 us), K6c 0.10 GB (31 us) before the zeroing
// and the atomics' read-modify-write traffic, which stays in L2 where it can.
//
// Design: one thread per (b, position), the batch on the grid's y axis;
// positions, cotangents and outputs are read and written coalesced; the 8
// corners are gathered from global memory through L1/L2 (one 176x256x256
// fp32 volume is 46 MB and fits the 50 MB L2; registration flows are smooth,
// so neighbouring threads read neighbouring voxels); the loop over C reuses
// the corner indices and weights. The TPU kernel's VMEM slab, data-adaptive
// (z, y) window, one-hot MXU column selects with the bf16 hi/lo split and the
// traced guard with its gather fallback (warp3d_pallas.py:142-180, :215-227,
// :267-288, :335-372) exist because the TPU has no fast gather; none is needed
// here, and the kernels take every shape. Shared-memory staging of z-slabs is
// left to a later change.

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp3d_taps_kernel(const T* __restrict__ vol, const float* __restrict__ px,
                   const float* __restrict__ py, const float* __restrict__ pz,
                   float* __restrict__ out, float* __restrict__ dpx,
                   float* __restrict__ dpy, float* __restrict__ dpz, int C, int D, int H,
                   int W, long long P) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const long long b = blockIdx.y;
  const long long i = b * P + p;
  const Corners t = corners_at(px[i], py[i], pz[i], D, H, W);
  const long long HW = (long long)H * W;
  const long long vox = (long long)D * HW;
  const T* src = vol + b * C * vox;
  const long long o = b * C * P + p;
  for (int c = 0; c < C; ++c, src += vox) {
    float acc = 0.f, gx = 0.f, gy = 0.f, gz = 0.f;
#pragma unroll
    for (int dz = 0; dz < 2; ++dz)
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const bool ok = t.in[2][dz] && t.in[1][dy] && t.in[0][dx];
          const long long idx =
              (long long)(t.z0 + dz) * HW + (long long)(t.y0 + dy) * W + (t.x0 + dx);
          const float v = ok ? to_f32(src[idx]) : 0.f;
          const float cx = t.c[0][dx], cy = t.c[1][dy], cz = t.c[2][dz];
          // K6a's term, and the running sum in its order
          const float wgt = __fmul_rn(__fmul_rn(cx, cy), cz);
          const float term = ok ? __fmul_rn(v, wgt) : 0.f;
          acc = (dz | dy | dx) ? __fadd_rn(acc, term) : term;
          // _gather_taps' bases: ((v * s) * c) * c, the sign exact
          const float vx = dx ? v : -v;
          const float vy = __fmul_rn(v, cx);
          gx = __fadd_rn(gx, __fmul_rn(__fmul_rn(vx, cy), cz));
          gy = __fadd_rn(gy, __fmul_rn(dy ? vy : -vy, cz));
          const float vz = __fmul_rn(vy, cy);
          gz = __fadd_rn(gz, dz ? vz : -vz);
        }
    const long long oc = o + (long long)c * P;
    out[oc] = acc;
    dpx[oc] = gx;
    dpy[oc] = gy;
    dpz[oc] = gz;
  }
}

__global__ void __launch_bounds__(kThreads)
warp3d_dvol_kernel(const float* __restrict__ px, const float* __restrict__ py,
                   const float* __restrict__ pz, const float* __restrict__ g,
                   float* __restrict__ dvol, int C, int D, int H, int W, long long P) {
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
  bool any = false;
#pragma unroll
  for (int dz = 0; dz < 2; ++dz)
#pragma unroll
    for (int dy = 0; dy < 2; ++dy)
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int k = dz * 4 + dy * 2 + dx;
        ok[k] = t.in[2][dz] && t.in[1][dy] && t.in[0][dx];
        any |= ok[k];
        idx[k] = (long long)(t.z0 + dz) * HW + (long long)(t.y0 + dy) * W + (t.x0 + dx);
        wgt[k] = __fmul_rn(__fmul_rn(t.c[0][dx], t.c[1][dy]), t.c[2][dz]);
      }
  if (!any) return;
  float* dst = dvol + b * C * vox;
  const float* gp = g + b * C * P + p;
  for (int c = 0; c < C; ++c, dst += vox, gp += P) {
    const float gv = *gp;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (ok[k]) atomicAdd(dst + idx[k], __fmul_rn(gv, wgt[k]));
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

// K6b. As K6a, plus dpx, dpy, dpz: [B, C, P] fp32 contiguous.
extern "C" int tpureg_warp3d_taps(const void* vol, const void* px, const void* py,
                                  const void* pz, void* out, void* dpx, void* dpy,
                                  void* dpz, int dtype, int B, int C, int D, int H, int W,
                                  long long P, void* stream) {
  if (bad_shape(B, C, D, H, W, P)) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  if (bad_grid(B, P)) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(px);
  const float* y = static_cast<const float*>(py);
  const float* z = static_cast<const float*>(pz);
  float* o = static_cast<float*>(out);
  float* ox = static_cast<float*>(dpx);
  float* oy = static_cast<float*>(dpy);
  float* oz = static_cast<float*>(dpz);
  if (dtype == 0) {
    warp3d_taps_kernel<float><<<grid_of(B, P), kThreads, 0, s>>>(
        static_cast<const float*>(vol), x, y, z, o, ox, oy, oz, C, D, H, W, P);
  } else if (dtype == 1) {
    warp3d_taps_kernel<__nv_bfloat16><<<grid_of(B, P), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(vol), x, y, z, o, ox, oy, oz, C, D, H, W, P);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K6c. px, py, pz: [B, P] fp32; g: [B, C, P] fp32; dvol: [B, C, D, H, W]
// fp32, zeroed by the caller; all contiguous. Launches on `stream`;
// allocates nothing and does not synchronise. Returns cudaGetLastError().
extern "C" int tpureg_warp3d_dvol(const void* px, const void* py, const void* pz,
                                  const void* g, void* dvol, int B, int C, int D, int H,
                                  int W, long long P, void* stream) {
  if (bad_shape(B, C, D, H, W, P)) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  if (bad_grid(B, P)) return (int)cudaErrorInvalidConfiguration;
  warp3d_dvol_kernel<<<grid_of(B, P), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(px), static_cast<const float*>(py),
      static_cast<const float*>(pz), static_cast<const float*>(g),
      static_cast<float*>(dvol), C, D, H, W, P);
  return (int)cudaGetLastError();
}
