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
// What holds it back is latency and occupancy, not HBM: the inputs sit in
// L2, and each position's taps wait on its loads of px and py.
//
// Design: each thread takes kPer (2) consecutive positions of one batch row,
// the batch on the grid's y axis (a batch of more than 65535 rows, the axis's
// limit, is launched in chunks of at most that many rows on the same stream,
// each chunk's pointers offset to its first row; a row's result does not
// depend on the chunk it falls in); it loads px and py as one float2 each,
// keeps the 2 x 4 tap gathers of a channel in flight together (through
// L1/L2: a warp's taps sit on neighbouring rows for smooth flows) and stores
// one float2 a channel. A grid-stride loop over the row keeps the grid at
// about one wave of resident blocks. Tap offsets within a plane are 32-bit
// (the entry point refuses H * W >= 2^31); the batch's base is 64-bit. Where
// the rows are not 8-byte aligned (odd P, or positions that start at an odd
// offset in their storage), the same thread loads and stores its positions
// one at a time. The loop over C reuses the tap offsets and weights, so any
// C costs only its image and output bytes. The TPU kernel's one-hot MXU
// selection, bf16 hi/lo split, row band and shape limits
// (warp_pallas.py:105-121, :271-281, :336-353) are not needed here: this
// kernel takes every shape.
//
// Two positions a thread and the one-wave grid were chosen by timing 1, 2
// and 4 a thread on the H100 at the eval step's own positions (ab_warp2d.py
// at the repository's root; the times are in PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 2;  // positions a thread
constexpr int kMaxGridY = 65535;  // batch rows a launch (the grid's y limit)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// two consecutive floats from p: one float2 load where `vec`, else the
// first n one at a time (the rest 0)
__device__ __forceinline__ void load_row(const float* __restrict__ p, bool vec, int n,
                                         float (&v)[kPer]) {
  if (vec) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = p[0];
    v[1] = n > 1 ? p[1] : 0.f;
  }
}

__device__ __forceinline__ void store_row(float* __restrict__ p, bool vec, int n,
                                          const float (&v)[kPer]) {
  if (vec) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
    if (n > 1) p[1] = v[1];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp2d_fwd_kernel(const T* __restrict__ img, const float* __restrict__ px,
                  const float* __restrict__ py, float* __restrict__ out, int C, int H,
                  int W, int P, bool vec) {
  const long long b = blockIdx.y;
  const int plane = H * W;
  const T* base = img + b * C * plane;
  const int groups = (P + kPer - 1) / kPer;
  for (int gi = blockIdx.x * kThreads + threadIdx.x; gi < groups;
       gi += gridDim.x * kThreads) {
    const int p0 = gi * kPer;
    const int n = min(kPer, P - p0);
    const long long i = b * P + p0;
    float x[kPer], y[kPer];
    load_row(px + i, vec, n, x);
    load_row(py + i, vec, n, y);
    int off[kPer][4];
    float wgt[kPer][4];
    bool ok[kPer][4];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const float x0f = floorf(x[k]);
      const float y0f = floorf(y[k]);
      const float fx = x[k] - x0f;
      const float fy = y[k] - y0f;
      // clamp before converting so that far-away or non-finite positions
      // stay defined; every clamped tap is out of bounds either way
      const int x0 = (int)fminf(fmaxf(x0f, -2.f), (float)W);
      const int y0 = (int)fminf(fmaxf(y0f, -2.f), (float)H);
      const bool vx0 = x0 >= 0 && x0 < W;
      const bool vx1 = x0 + 1 >= 0 && x0 + 1 < W;
      const bool vy0 = y0 >= 0 && y0 < H;
      const bool vy1 = y0 + 1 >= 0 && y0 + 1 < H;
      const float gx = 1.f - fx;
      const float gy = 1.f - fy;
      wgt[k][0] = __fmul_rn(gx, gy);
      wgt[k][1] = __fmul_rn(fx, gy);
      wgt[k][2] = __fmul_rn(gx, fy);
      wgt[k][3] = __fmul_rn(fx, fy);
      ok[k][0] = vx0 && vy0;
      ok[k][1] = vx1 && vy0;
      ok[k][2] = vx0 && vy1;
      ok[k][3] = vx1 && vy1;
      // only an inside tap's offset is formed: it is below H * W
      off[k][0] = ok[k][0] ? y0 * W + x0 : 0;
      off[k][1] = ok[k][1] ? y0 * W + x0 + 1 : 0;
      off[k][2] = ok[k][2] ? (y0 + 1) * W + x0 : 0;
      off[k][3] = ok[k][3] ? (y0 + 1) * W + x0 + 1 : 0;
    }
    const T* src = base;
    float* dst = out + b * C * P + p0;
    for (int c = 0; c < C; ++c, src += plane, dst += P) {
      float v[kPer][4];
#pragma unroll
      for (int k = 0; k < kPer; ++k)
#pragma unroll
        for (int t = 0; t < 4; ++t) v[k][t] = ok[k][t] ? to_f32(src[off[k][t]]) : 0.f;
      float o[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const float t00 = ok[k][0] ? __fmul_rn(v[k][0], wgt[k][0]) : 0.f;
        const float t10 = ok[k][1] ? __fmul_rn(v[k][1], wgt[k][1]) : 0.f;
        const float t01 = ok[k][2] ? __fmul_rn(v[k][2], wgt[k][2]) : 0.f;
        const float t11 = ok[k][3] ? __fmul_rn(v[k][3], wgt[k][3]) : 0.f;
        o[k] = __fadd_rn(__fadd_rn(__fadd_rn(t00, t10), t01), t11);
      }
      store_row(dst, vec, n, o);
    }
  }
}

// how many blocks of the kernel the card holds at once (one wave)
template <typename T>
int wave_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, warp2d_fwd_kernel<T>, kThreads, 0);
    blocks = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  return blocks;
}

template <typename T>
cudaError_t launch(const void* img, const float* x, const float* y, float* o, int B, int C,
                   int H, int W, int P, bool vec, cudaStream_t s) {
  const int groups = (P + kPer - 1) / kPer;
  const int per_row = (groups + kThreads - 1) / kThreads;
  const long long plane = (long long)H * W;
  for (int b0 = 0; b0 < B; b0 += kMaxGridY) {
    const int nb = B - b0 < kMaxGridY ? B - b0 : kMaxGridY;
    const int cap = (wave_blocks<T>() + nb - 1) / nb;  // about one wave
    const dim3 grid((unsigned)(per_row < cap ? per_row : cap), (unsigned)nb);
    warp2d_fwd_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(img) + (long long)b0 * C * plane, x + (long long)b0 * P,
        y + (long long)b0 * P, o + (long long)b0 * C * P, C, H, W, P, vec);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 image. img: [B, C, H, W] contiguous, with
// H * W < 2^31 and any B; px, py: [B, P] fp32 contiguous, P < 2^31; out:
// [B, C, P] fp32 contiguous. Launches on `stream` (one launch for each 65535
// batch rows); allocates nothing and does not synchronise. Returns the first
// launch error, else cudaSuccess.
extern "C" int tpureg_warp2d_fwd(const void* img, const void* px, const void* py, void* out,
                                 int dtype, int B, int C, int H, int W, long long P,
                                 void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || P < 0) return (int)cudaErrorInvalidValue;
  if ((long long)H * W >= 2147483648LL || P >= 2147483648LL - kPer)
    return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fx = static_cast<const float*>(px);
  const float* fy = static_cast<const float*>(py);
  float* o = static_cast<float*>(out);
  // every row starts aligned to kPer floats when the arrays do and P % kPer == 0
  const unsigned align = 4u * kPer;
  const bool vec = P % kPer == 0 && reinterpret_cast<uintptr_t>(fx) % align == 0 &&
                   reinterpret_cast<uintptr_t>(fy) % align == 0 &&
                   reinterpret_cast<uintptr_t>(o) % align == 0;
  if (dtype == 0) return (int)launch<float>(img, fx, fy, o, B, C, H, W, (int)P, vec, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(img, fx, fy, o, B, C, H, W, (int)P, vec, s);
  return (int)cudaErrorInvalidValue;
}
