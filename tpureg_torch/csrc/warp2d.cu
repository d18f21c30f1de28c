// K3: bilinear sample of [B, C, H, W] images at absolute positions, forward,
// written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel tpureg/ops/warp_pallas.py::_fwd_kernel (:183, full
// and banded forms, via _grid_call :299 -> _fwd :356 -> warp2d_pallas :389),
// reached from tpureg/ops/warp.py::sample2d (:47-77).
//
// Semantics: out[b, c, p] = sum over the 4 taps (x0|x0+1, y0|y0+1) of
// img[b, c, ty, tx] * weight, with x0 = floor(px[b, p]), y0 = floor(py[b, p]),
// the usual bilinear weights, and each tap zeroed on its own when it falls
// outside the image (grid_sample's zeros padding). Math and output in fp32;
// the image may be fp32 or bf16. Products and sums are rounded one at a time
// (no fused multiply-add) and added in the plain version's order, so the
// fp32 result is the plain version's bit for bit.
//
// What bounds it on the H100: bytes. Per launch on the FlowNet2 path (B=8,
// 256x256, C=1, fp32) it reads 2.1 MB of image and 4.2 MB of positions and
// writes 2.1 MB, about 2.5 us at 3.35 TB/s, for 13 FLOP per sample.
//
// Design: one thread per (b, position), the batch on the grid's y axis;
// positions and outputs are read and written coalesced; the 4 taps are
// gathered through L1/L2 (a warp's taps sit on neighbouring rows for smooth
// flows); the loop over C reuses the tap
// indices and weights, so any C costs only its image and output bytes. The
// TPU kernel's one-hot MXU selection, bf16 hi/lo split, row band and shape
// limits (warp_pallas.py:105-121, :271-281, :336-353) are not needed here:
// this kernel takes every shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp2d_fwd_kernel(const T* __restrict__ img, const float* __restrict__ px,
                  const float* __restrict__ py, float* __restrict__ out, int C, int H,
                  int W, long long P) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  const long long b = blockIdx.y;
  const long long i = b * P + p;
  const float x = px[i];
  const float y = py[i];
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float fx = x - x0f;
  const float fy = y - y0f;
  // clamp before converting so that far-away or non-finite positions stay
  // defined; every clamped tap is out of bounds either way
  const int x0 = (int)fminf(fmaxf(x0f, -2.f), (float)W);
  const int y0 = (int)fminf(fmaxf(y0f, -2.f), (float)H);
  const bool vx0 = x0 >= 0 && x0 < W;
  const bool vx1 = x0 + 1 >= 0 && x0 + 1 < W;
  const bool vy0 = y0 >= 0 && y0 < H;
  const bool vy1 = y0 + 1 >= 0 && y0 + 1 < H;
  const float gx = 1.f - fx;
  const float gy = 1.f - fy;
  const float w00 = __fmul_rn(gx, gy);
  const float w10 = __fmul_rn(fx, gy);
  const float w01 = __fmul_rn(gx, fy);
  const float w11 = __fmul_rn(fx, fy);
  const long long plane = (long long)H * W;
  const long long r0 = (long long)y0 * W;
  const long long r1 = r0 + W;
  const T* src = img + b * C * plane;
  float* dst = out + b * C * P + p;
  for (int c = 0; c < C; ++c, src += plane, dst += P) {
    const float t00 = (vx0 && vy0) ? __fmul_rn(to_f32(src[r0 + x0]), w00) : 0.f;
    const float t10 = (vx1 && vy0) ? __fmul_rn(to_f32(src[r0 + x0 + 1]), w10) : 0.f;
    const float t01 = (vx0 && vy1) ? __fmul_rn(to_f32(src[r1 + x0]), w01) : 0.f;
    const float t11 = (vx1 && vy1) ? __fmul_rn(to_f32(src[r1 + x0 + 1]), w11) : 0.f;
    *dst = __fadd_rn(__fadd_rn(__fadd_rn(t00, t10), t01), t11);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 image. img: [B, C, H, W] contiguous;
// px, py: [B, P] fp32 contiguous; out: [B, C, P] fp32 contiguous. Launches on
// `stream`; allocates nothing and does not synchronise. Returns
// cudaGetLastError().
extern "C" int tpureg_warp2d_fwd(const void* img, const void* px, const void* py, void* out,
                                 int dtype, int B, int C, int H, int W, long long P,
                                 void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || P < 0) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  const long long blocks = (P + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL || B > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, (unsigned)B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fx = static_cast<const float*>(px);
  const float* fy = static_cast<const float*>(py);
  float* o = static_cast<float*>(out);
  if (dtype == 0) {
    warp2d_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(img), fx, fy, o, C, H, W, P);
  } else if (dtype == 1) {
    warp2d_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(img), fx, fy, o, C, H, W, P);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
