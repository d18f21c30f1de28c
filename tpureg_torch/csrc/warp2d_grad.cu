// K4 and K5: the two kernels of the bilinear warp's gradient, written by hand
// for Hopper (sm_90a).
//
// K4, forward with position-derivative bases, replaces
// tpureg/ops/warp_pallas.py::_fwd_taps_kernel (:197, via _fwd_with_taps :399
// <- _vjp_fwd :425). It computes what K3 (warp2d.cu) computes and, beside it,
// d out / d px and d out / d py at every position and channel, so that the
// backward to the positions is an elementwise product with the cotangent
// (warp_pallas.py:451-453). The sample is written in K3's order of rounded
// operations, so the fp32 sample equals K3's bit for bit.
//
// K5, the image cotangent, replaces warp_pallas.py::_dimg_kernel (:230, call
// :441): the transposed bilinear scatter of the cotangent g[b, c, p] into
// dimg[b, c, H, W]. The TPU kernel forms it as one-hot matrix products with
// bf16 operands; here each position adds its four weighted taps with fp32
// atomicAdd into a zeroed fp32 buffer. The order of those additions changes
// from run to run, so results agree with the plain version to fp32 rounding
// of the sums, not bit for bit.
//
// Semantics: x0 = floor(px), y0 = floor(py), fx = px - x0, fy = py - y0,
// weights w00 = (1-fx)(1-fy), w10 = fx(1-fy), w01 = (1-fx)fy, w11 = fx fy on
// taps (x0,y0), (x0+1,y0), (x0,y0+1), (x0+1,y0+1); a tap outside the image
// contributes nothing (zeros padding, each tap on its own). The floor has no
// derivative, so
//   d out/d px = (1-fy)(v10 - v00) + fy (v11 - v01)
//   d out/d py = (1-fx)(v01 - v00) + fx (v11 - v10)
// with out-of-image tap values v taken as zero.
//
// What bounds them on the H100: bytes. K4 on the FlowNet2 path (B=8,
// 256x256, C=1, fp32) reads 2.1 MB of image and 4.2 MB of positions and
// writes 3 x 2.1 MB: 12.6 MB, 3.8 us at 3.35 TB/s. K5 reads 6.3 MB of
// positions and cotangent and writes the 2.1 MB image: 2.5 us, before the
// atomics' read-modify-write traffic, which stays in L2.
//
// Design: one thread per (b, position), the batch on the grid's y axis, as
// in K3; positions, cotangents and the three outputs are read and written
// coalesced; the loop over C reuses the tap indices and weights.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Taps {
  int x0, y0;
  bool v00, v10, v01, v11;
  float fx, fy, gx, gy;
};

// The tap geometry of one position, as K3 computes it: clamp before
// converting so that far-away or non-finite positions stay defined; every
// clamped tap is out of bounds either way.
__device__ __forceinline__ Taps taps_at(float x, float y, int H, int W) {
  Taps t;
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  t.fx = x - x0f;
  t.fy = y - y0f;
  t.gx = 1.f - t.fx;
  t.gy = 1.f - t.fy;
  t.x0 = (int)fminf(fmaxf(x0f, -2.f), (float)W);
  t.y0 = (int)fminf(fmaxf(y0f, -2.f), (float)H);
  const bool vx0 = t.x0 >= 0 && t.x0 < W;
  const bool vx1 = t.x0 + 1 >= 0 && t.x0 + 1 < W;
  const bool vy0 = t.y0 >= 0 && t.y0 < H;
  const bool vy1 = t.y0 + 1 >= 0 && t.y0 + 1 < H;
  t.v00 = vx0 && vy0;
  t.v10 = vx1 && vy0;
  t.v01 = vx0 && vy1;
  t.v11 = vx1 && vy1;
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp2d_taps_kernel(const T* __restrict__ img, const float* __restrict__ px,
                   const float* __restrict__ py, float* __restrict__ out,
                   float* __restrict__ dpx, float* __restrict__ dpy, int C, int H, int W,
                   long long P) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const long long b = blockIdx.y;
  const long long i = b * P + p;
  const Taps t = taps_at(px[i], py[i], H, W);
  const float w00 = __fmul_rn(t.gx, t.gy);
  const float w10 = __fmul_rn(t.fx, t.gy);
  const float w01 = __fmul_rn(t.gx, t.fy);
  const float w11 = __fmul_rn(t.fx, t.fy);
  const long long plane = (long long)H * W;
  const long long r0 = (long long)t.y0 * W;
  const long long r1 = r0 + W;
  const T* src = img + b * C * plane;
  const long long o = b * C * P + p;
  for (int c = 0; c < C; ++c, src += plane) {
    const float v00 = t.v00 ? to_f32(src[r0 + t.x0]) : 0.f;
    const float v10 = t.v10 ? to_f32(src[r0 + t.x0 + 1]) : 0.f;
    const float v01 = t.v01 ? to_f32(src[r1 + t.x0]) : 0.f;
    const float v11 = t.v11 ? to_f32(src[r1 + t.x0 + 1]) : 0.f;
    // K3's sum: each product and partial sum rounded on its own, in order
    const float t00 = t.v00 ? __fmul_rn(v00, w00) : 0.f;
    const float t10 = t.v10 ? __fmul_rn(v10, w10) : 0.f;
    const float t01 = t.v01 ? __fmul_rn(v01, w01) : 0.f;
    const float t11 = t.v11 ? __fmul_rn(v11, w11) : 0.f;
    const long long oc = o + (long long)c * P;
    out[oc] = __fadd_rn(__fadd_rn(__fadd_rn(t00, t10), t01), t11);
    dpx[oc] = t.gy * (v10 - v00) + t.fy * (v11 - v01);
    dpy[oc] = t.gx * (v01 - v00) + t.fx * (v11 - v10);
  }
}

__global__ void __launch_bounds__(kThreads)
warp2d_dimg_kernel(const float* __restrict__ px, const float* __restrict__ py,
                   const float* __restrict__ g, float* __restrict__ dimg, int C, int H,
                   int W, long long P) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const long long b = blockIdx.y;
  const long long i = b * P + p;
  const Taps t = taps_at(px[i], py[i], H, W);
  if (!(t.v00 || t.v10 || t.v01 || t.v11)) return;
  const float w00 = __fmul_rn(t.gx, t.gy);
  const float w10 = __fmul_rn(t.fx, t.gy);
  const float w01 = __fmul_rn(t.gx, t.fy);
  const float w11 = __fmul_rn(t.fx, t.fy);
  const long long plane = (long long)H * W;
  const long long r0 = (long long)t.y0 * W + t.x0;
  const long long r1 = r0 + W;
  float* dst = dimg + b * C * plane;
  const float* gp = g + b * C * P + p;
  for (int c = 0; c < C; ++c, dst += plane, gp += P) {
    const float gv = *gp;
    if (t.v00) atomicAdd(dst + r0, __fmul_rn(gv, w00));
    if (t.v10) atomicAdd(dst + r0 + 1, __fmul_rn(gv, w10));
    if (t.v01) atomicAdd(dst + r1, __fmul_rn(gv, w01));
    if (t.v11) atomicAdd(dst + r1 + 1, __fmul_rn(gv, w11));
  }
}

bool bad_shape(int B, int C, int H, int W, long long P) {
  return B <= 0 || C <= 0 || H <= 0 || W <= 0 || P < 0;
}

bool bad_grid(int B, long long P) {
  return (P + kThreads - 1) / kThreads > 2147483647LL || B > 65535;
}

}  // namespace

// K4. dtype: 0 = float32, 1 = bfloat16 image. img: [B, C, H, W] contiguous;
// px, py: [B, P] fp32 contiguous; out, dpx, dpy: [B, C, P] fp32 contiguous.
// Launches on `stream`; allocates nothing and does not synchronise. Returns
// cudaGetLastError().
extern "C" int tpureg_warp2d_taps(const void* img, const void* px, const void* py,
                                  void* out, void* dpx, void* dpy, int dtype, int B,
                                  int C, int H, int W, long long P, void* stream) {
  if (bad_shape(B, C, H, W, P)) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  if (bad_grid(B, P)) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)((P + kThreads - 1) / kThreads), (unsigned)B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fx = static_cast<const float*>(px);
  const float* fy = static_cast<const float*>(py);
  float* o = static_cast<float*>(out);
  float* ox = static_cast<float*>(dpx);
  float* oy = static_cast<float*>(dpy);
  if (dtype == 0) {
    warp2d_taps_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(img), fx, fy, o, ox, oy, C, H, W, P);
  } else if (dtype == 1) {
    warp2d_taps_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(img), fx, fy, o, ox, oy, C, H, W, P);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K5. px, py: [B, P] fp32; g: [B, C, P] fp32; dimg: [B, C, H, W] fp32,
// zeroed by the caller; all contiguous. Launches on `stream`; allocates
// nothing and does not synchronise. Returns cudaGetLastError().
extern "C" int tpureg_warp2d_dimg(const void* px, const void* py, const void* g,
                                  void* dimg, int B, int C, int H, int W, long long P,
                                  void* stream) {
  if (bad_shape(B, C, H, W, P)) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  if (bad_grid(B, P)) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)((P + kThreads - 1) / kThreads), (unsigned)B);
  warp2d_dimg_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(px), static_cast<const float*>(py),
      static_cast<const float*>(g), static_cast<float*>(dimg), C, H, W, P);
  return (int)cudaGetLastError();
}
