// K2: correlation cost volume, backward, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernels in tpureg/ops/correlation_pallas.py:
//   _bwd_banded_kernel (:335, banded MXU form, via _corr_bwd_banded :426; the
//                       TPU default in _bwd :572-586)
//   _bwd_fused_kernel  (:300, VPU form, via _corr_bwd_pallas :473)
//   _df1_kernel (:249) and _df2_kernel (:275), the split form of the same.
// One kernel, one launch, computes both cotangents: fp32 or bf16 operands,
// an fp32 or bf16 output cotangent g, fp32 accumulation, outputs in the
// operand type (one rounding).
//
// Semantics (NCHW, K = 2*(md/s2) + 1, d = iy*K + ix, dy = iy*s2 - md,
// dx = ix*s2 - md):
//   df1[b,c,y,x] = (1/C) sum_d g[b,d,y,x]       * f2[b,c,y+dy,x+dx]
//   df2[b,c,y,x] = (1/C) sum_d g[b,d,y-dy,x-dx] * f1[b,c,y-dy,x-dx]
// with every term whose f2 tap (df1) or source pixel (df2) falls outside the
// image left out.
//
// The TPU kernels build df2 by adding into a padded VMEM buffer as their
// sequential grid steps run (correlation_pallas.py:291-297, :394-400). On the
// card blocks run in no order, so df2 is written as a gather instead: each
// (b, c, y, x) sums over its K^2 source pixels. Neither output needs atomics,
// and both are deterministic.
//
// What bounds it on the H100: at FlowNetC's shape (B=8, C=256, 32x32, md 20,
// s2 2) the in-image work is 2 x 0.42 G multiply-adds (1.7 GFLOP) of fp32
// against 29 MB of unique bytes (f1, f2, g read once, df1, df2 written
// once): about 25 us on the fp32 pipes at 67 TFLOP/s, against 8.7 us for
// the bytes.
//
// Design, simple first:
// - one block per (output row y, batch b, tile of 32 columns, chunk of 64
//   channels); 8 warps, each thread owns one column and 8 channels of both
//   outputs and keeps their 16 sums in registers;
// - a loop over the K displacement rows stages, per row, the f2 row y+dy and
//   the K g channels of row y (for df1), and the f1 row y-dy and the K g
//   channels of that row (for df2), each over the columns the tile's
//   displacements reach, with zeros outside the image; a displacement row
//   whose rows both fall outside the image is skipped;
// - every shared-memory read is one warp reading 32 neighbouring floats.
// Each g row is staged once per channel chunk (4 times at C = 256), so the
// kernel reads ~5x its unique bytes from L2. A tensor-core (banded) form
// is work for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;          // output columns per block: one warp wide
constexpr int NC = 8;           // warps per block, each a lane of channels
constexpr int CC = 64;          // channels per block
constexpr int CPT = CC / NC;    // channels per thread
constexpr size_t kMaxSmem = 227 * 1024;

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

template <typename T, typename G>
__global__ void __launch_bounds__(TX * NC)
corr_bwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                const G* __restrict__ g, T* __restrict__ df1, T* __restrict__ df2,
                int C, int H, int W, int md, int s2, int K, int n_cc) {
  const int x0 = blockIdx.x * TX;
  const int y = blockIdx.y;
  const int c0 = (blockIdx.z % n_cc) * CC;
  const int b = blockIdx.z / n_cc;
  const int cc = min(CC, C - c0);
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int x = x0 + tx;
  const int span = (K - 1) * s2;
  const int ww = TX + span;          // staged columns per row
  const int xs1 = x0 - md;           // first f2 column df1 reads
  const int xs2 = x0 + md - span;    // first source column df2 reads
  const size_t plane = (size_t)H * W;
  const T* f1b = f1 + ((size_t)b * C + c0) * plane;
  const T* f2b = f2 + ((size_t)b * C + c0) * plane;
  const G* gb = g + (size_t)b * K * K * plane;

  extern __shared__ float smem[];
  float* f2s = smem;                 // [CC][ww]: f2 row y+dy
  float* f1s = f2s + CC * ww;        // [CC][ww]: f1 row y-dy
  float* g1s = f1s + CC * ww;        // [K][TX]:  g row y, the row's K channels
  float* g2s = g1s + K * TX;         // [K][ww]:  g row y-dy, the row's K channels

  float a1[CPT], a2[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) a1[j] = a2[j] = 0.f;

  for (int iy = 0; iy < K; ++iy) {
    const int dy = iy * s2 - md;
    const int y2 = y + dy;           // df1's f2 row
    const int y1 = y - dy;           // df2's source row
    const bool v1 = y2 >= 0 && y2 < H;
    const bool v2 = y1 >= 0 && y1 < H;
    if (!v1 && !v2) continue;        // the same for the whole block
    __syncthreads();                 // the previous row's reads are done
    if (v1) {
      for (int i = tid; i < CC * ww; i += TX * NC) {
        const int c = i / ww;
        const int xx = xs1 + i % ww;
        f2s[i] = (c < cc && xx >= 0 && xx < W)
                     ? to_f32(f2b[(size_t)c * plane + (size_t)y2 * W + xx]) : 0.f;
      }
      for (int i = tid; i < K * TX; i += TX * NC) {
        const int ix = i / TX;
        const int xx = x0 + i % TX;
        g1s[i] = xx < W ? to_f32(gb[(size_t)(iy * K + ix) * plane + (size_t)y * W + xx])
                        : 0.f;
      }
    }
    if (v2) {
      for (int i = tid; i < CC * ww; i += TX * NC) {
        const int c = i / ww;
        const int xx = xs2 + i % ww;
        f1s[i] = (c < cc && xx >= 0 && xx < W)
                     ? to_f32(f1b[(size_t)c * plane + (size_t)y1 * W + xx]) : 0.f;
      }
      for (int i = tid; i < K * ww; i += TX * NC) {
        const int ix = i / ww;
        const int xx = xs2 + i % ww;
        g2s[i] = (xx >= 0 && xx < W)
                     ? to_f32(gb[(size_t)(iy * K + ix) * plane + (size_t)y1 * W + xx])
                     : 0.f;
      }
    }
    __syncthreads();
    if (v1) {
      for (int ix = 0; ix < K; ++ix) {
        const float gv = g1s[ix * TX + tx];
        const float* row = f2s + tx + ix * s2;
#pragma unroll
        for (int j = 0; j < CPT; ++j) a1[j] = fmaf(gv, row[(ty + j * NC) * ww], a1[j]);
      }
    }
    if (v2) {
      for (int ix = 0; ix < K; ++ix) {
        // source column x - dx sits at tx + (K-1-ix)*s2 in the staged window
        const int col = tx + (K - 1 - ix) * s2;
        const float gv = g2s[ix * ww + col];
        const float* row = f1s + col;
#pragma unroll
        for (int j = 0; j < CPT; ++j) a2[j] = fmaf(gv, row[(ty + j * NC) * ww], a2[j]);
      }
    }
  }

  if (x < W) {
    const float fc = (float)C;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = ty + j * NC;
      if (c < cc) {
        const size_t o = ((size_t)b * C + c0 + c) * plane + (size_t)y * W + x;
        df1[o] = from_f32<T>(a1[j] / fc);
        df2[o] = from_f32<T>(a2[j] / fc);
      }
    }
  }
}

template <typename T, typename G>
int launch(const void* f1, const void* f2, const void* g, void* df1, void* df2, int B,
           int C, int H, int W, int md, int s2, int K, size_t smem, cudaStream_t s) {
  auto kernel = corr_bwd_kernel<T, G>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_cc = (C + CC - 1) / CC;
  const dim3 grid((W + TX - 1) / TX, H, (unsigned)(B * n_cc));
  const dim3 block(TX, NC);
  kernel<<<grid, block, smem, s>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2), static_cast<const G*>(g),
      static_cast<T*>(df1), static_cast<T*>(df2), C, H, W, md, s2, K, n_cc);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: operand type of f1, f2, df1, df2; gdtype: type of g (0 = float32,
// 1 = bfloat16). f1, f2, df1, df2: [B, C, H, W] contiguous; g: [B, K*K, H, W]
// contiguous. Launches on `stream`; allocates nothing and does not
// synchronise. Returns cudaGetLastError().
extern "C" int tpureg_correlation_bwd(const void* f1, const void* f2, const void* g,
                                      void* df1, void* df2, int dtype, int gdtype,
                                      int B, int C, int H, int W, int md, int s2,
                                      void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || md < 0 || s2 <= 0 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const int K = 2 * (md / s2) + 1;
  const int ww = TX + (K - 1) * s2;
  const size_t smem = ((size_t)2 * CC * ww + (size_t)K * TX + (size_t)K * ww) * sizeof(float);
  const long long nz = (long long)B * ((C + CC - 1) / CC);
  if (smem > kMaxSmem || nz > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && gdtype == 0)
    return launch<float, float>(f1, f2, g, df1, df2, B, C, H, W, md, s2, K, smem, s);
  if (dtype == 0 && gdtype == 1)
    return launch<float, __nv_bfloat16>(f1, f2, g, df1, df2, B, C, H, W, md, s2, K, smem, s);
  if (dtype == 1 && gdtype == 0)
    return launch<__nv_bfloat16, float>(f1, f2, g, df1, df2, B, C, H, W, md, s2, K, smem, s);
  if (dtype == 1 && gdtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(f1, f2, g, df1, df2, B, C, H, W, md, s2, K,
                                                smem, s);
  return (int)cudaErrorInvalidValue;
}
