// K1: correlation cost volume, forward, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernels in tpureg/ops/correlation_pallas.py:
//   _corr_kernel        (:54, fp32 VPU tap sweep, via _corr_fwd_pallas :75)
//   _fwd_banded_kernel  (:130, bf16 banded MXU form, via _corr_fwd_banded :201)
// One kernel covers both: fp32 or bf16 operands, fp32 accumulation, output in
// the operand type.
//
// Semantics (NCHW, K = 2*(md/s2) + 1):
//   out[b, iy*K + ix, y, x] = (1/C) * sum_c f1[b,c,y,x] * f2[b,c,y+iy*s2-md,x+ix*s2-md]
// with zero contribution where the f2 tap falls outside the image. The output
// channel order is row-major over (dy, dx), as FlowNetC's conv3_1 expects.
//
// What bounds it on the H100: at FlowNetC's shape (B=8, C=256, 32x32, md 20,
// s2 2) the in-image work is 0.84 GFLOP of fp32 multiply-adds against 31 MB of
// unique bytes, about 27 FLOP/byte, so it sits on the fp32 (non-tensor-core)
// pipes: about 12.5 us at 67 TFLOP/s, against 9.3 us for the bytes.
//
// Design, simple first:
// - one block per (output row y, displacement row iy, batch b, tile of 32
//   columns, tile of up to 32 horizontal displacements); a displacement row
//   that lands outside the image writes its zeros and returns without work;
// - f1's row and the one f2 row it meets are staged in shared memory a chunk
//   of channels at a time, with no padded copy of f2 in device memory (the TPU
//   path pads f2 by md in HBM, correlation_pallas.py:101);
// - each thread owns one column and all horizontal displacements of the tile,
//   keeps their sums in registers, and skips the taps that land outside the
//   image instead of multiplying by a padded zero;
// - the 8 warps split the channels; their partial sums are added in a fixed
//   order, so the result does not change from run to run.
// Each f1 row is read once per displacement row (from L2, which holds both
// inputs), and every multiply-add reads one operand from shared memory, so the
// kernel is held by shared-memory and L2 traffic well above its bound. A
// register-blocked or tensor-core form is work for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;   // output columns per block: one warp wide
constexpr int NY = 8;    // warps per block, each summing a share of the channels
constexpr int IXT = 32;  // horizontal displacements per block
constexpr int CC = 32;   // channels staged per chunk
constexpr size_t kMaxSmem = 48 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(TX * NY)
corr_fwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2, T* __restrict__ out,
                int C, int H, int W, int md, int s2, int K, int n_ixt) {
  const int x0 = blockIdx.x * TX;
  const int y = blockIdx.y;
  int z = blockIdx.z;
  const int ixt = z % n_ixt;
  z /= n_ixt;
  const int iy = z % K;
  const int b = z / K;
  const int ix0 = ixt * IXT;
  const int nix = min(IXT, K - ix0);
  const int y2 = y + iy * s2 - md;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int x = x0 + tx;
  const size_t plane = (size_t)H * W;
  T* outp = out + ((size_t)b * K * K + (size_t)iy * K + ix0) * plane + (size_t)y * W;

  if (y2 < 0 || y2 >= H) {  // the whole displacement row falls outside the image
    if (x < W)
      for (int j = ty; j < nix; j += NY) outp[j * plane + x] = from_f32<T>(0.f);
    return;
  }

  extern __shared__ float smem[];
  const int ww = TX + (nix - 1) * s2;  // f2 columns this block reads
  const int xs = x0 + ix0 * s2 - md;   // first of them
  float* f1s = smem;                   // [CC][TX]
  float* f2s = smem + CC * TX;         // [CC][ww]

  // bit j: displacement ix0 + j of this column lands inside the image
  unsigned valid = 0u;
  for (int j = 0; j < nix; ++j) {
    const int xx = x + (ix0 + j) * s2 - md;
    if (x < W && xx >= 0 && xx < W) valid |= 1u << j;
  }

  float acc[IXT];
#pragma unroll
  for (int j = 0; j < IXT; ++j) acc[j] = 0.f;

  const T* f1p = f1 + (size_t)b * C * plane + (size_t)y * W;
  const T* f2p = f2 + (size_t)b * C * plane + (size_t)y2 * W;
  for (int c0 = 0; c0 < C; c0 += CC) {
    const int cc = min(CC, C - c0);
    for (int i = tid; i < cc * TX; i += TX * NY) {
      const int c = i / TX;
      const int xx = x0 + i % TX;
      f1s[i] = xx < W ? to_f32(f1p[(size_t)(c0 + c) * plane + xx]) : 0.f;
    }
    for (int i = tid; i < cc * ww; i += TX * NY) {
      const int c = i / ww;
      const int xx = xs + i % ww;
      f2s[i] = (xx >= 0 && xx < W) ? to_f32(f2p[(size_t)(c0 + c) * plane + xx]) : 0.f;
    }
    __syncthreads();
    for (int c = ty; c < cc; c += NY) {
      const float a = f1s[c * TX + tx];
      const float* row = f2s + c * ww + tx;
#pragma unroll
      for (int j = 0; j < IXT; ++j)
        if (valid & (1u << j)) acc[j] = fmaf(a, row[j * s2], acc[j]);
    }
    __syncthreads();
  }

  // add the NY channel shares in a fixed order (shared memory reused)
  float* red = smem;  // [NY][IXT][TX]
#pragma unroll
  for (int j = 0; j < IXT; ++j) red[(ty * IXT + j) * TX + tx] = acc[j];
  __syncthreads();
  if (x < W) {
    for (int j = ty; j < nix; j += NY) {
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < NY; ++t) s += red[(t * IXT + j) * TX + tx];
      outp[j * plane + x] = from_f32<T>(s / (float)C);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. f1, f2: [B, C, H, W] contiguous; out:
// [B, K*K, H, W] contiguous, same type. Launches on `stream`; allocates
// nothing and does not synchronise. Returns cudaGetLastError().
extern "C" int tpureg_correlation_fwd(const void* f1, const void* f2, void* out, int dtype,
                                      int B, int C, int H, int W, int md, int s2,
                                      void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || md < 0 || s2 <= 0 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const int K = 2 * (md / s2) + 1;
  const int n_ixt = (K + IXT - 1) / IXT;
  const int nix_max = K < IXT ? K : IXT;
  const int ww = TX + (nix_max - 1) * s2;
  const size_t chunk = (size_t)CC * (TX + ww);
  const size_t red = (size_t)NY * IXT * TX;
  const size_t smem = (chunk > red ? chunk : red) * sizeof(float);
  const long long nz = (long long)B * K * n_ixt;
  if (smem > kMaxSmem || nz > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((W + TX - 1) / TX, H, (unsigned)nz);
  const dim3 block(TX, NY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    corr_fwd_kernel<float><<<grid, block, smem, s>>>(
        static_cast<const float*>(f1), static_cast<const float*>(f2),
        static_cast<float*>(out), C, H, W, md, s2, K, n_ixt);
  } else if (dtype == 1) {
    corr_fwd_kernel<__nv_bfloat16><<<grid, block, smem, s>>>(
        static_cast<const __nv_bfloat16*>(f1), static_cast<const __nv_bfloat16*>(f2),
        static_cast<__nv_bfloat16*>(out), C, H, W, md, s2, K, n_ixt);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* tpureg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
