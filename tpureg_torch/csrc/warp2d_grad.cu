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
// bf16 operands; here it is a scatter with fp32 atomicAdd into a zeroed fp32
// buffer, with neighbouring positions' products merged in registers first
// (design below). The order of the additions changes from run to run, so
// results agree with the plain version to fp32 rounding of the sums, not bit
// for bit.
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
// positions and cotangent and writes the 2.1 MB image: 2.5 us. What K5
// spends beyond that is its atomics, one global fp32 atomic per in-image tap
// and channel (2.1 M at that shape) before merging, and the zero fill (and
// for a bf16 image the cast) that its wrapper adds around the launch.
//
// Design of K4: one thread per (b, position), the batch on the grid's y
// axis, as in K3; positions, cotangents and the three outputs are read and
// written coalesced; the loop over C reuses the tap indices and weights.
//
// Design of K5: fewer atomics, merged in registers. On every 2-D path the
// positions are the pixel grid plus a smooth displacement (SyN's
// compositions, the head's and PWC's feature warps), so neighbouring
// positions share taps: each pixel takes about 4 products from its 4
// nearest positions. A warp holds 32 neighbouring positions along x and
// each lane walks kRW of them along y.
// - A lane carries the lower tap row (y0 + 1) of a position to the next one
//   along y, whose upper row it is when the field is smooth; a lane hands
//   its x0 + 1 taps to the lane above when they are that lane's x0 taps
//   (warp shuffles). On a smooth field a position then issues about 1.3
//   atomics a channel (kRW + 1 rows for kRW positions, 33 columns for 32)
//   instead of four, and the merged sums go straight to
//   global atomics. A shared-memory window, as K6c has for scattered
//   bricks, is left out: a shared fp32 atomicAdd is a compare-and-swap loop
//   on sm_90a, and no 2-D path scatters its positions.
// - The tap geometry (base pixel and the four weights) of the lane's kRW
//   positions is formed once and kept in registers for the block's
//   channels. Blocks split the channels when the positions alone give too
//   few blocks to fill the card (C = 32-128 at PWC's small maps).
// - When P = H * W the positions are taken to lie on the image's grid in
//   raster order; otherwise lanes take consecutive positions in rows of 32.
//   Merging only ever joins products bound for the same pixel, so any
//   positions give the right sums.

#include <climits>

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

// K5's geometry: a block of kDimgWarps warps; warp w holds 32 neighbouring
// positions along x of the positions' grid [gh, gw] and walks kRW rows
constexpr int kDimgWarps = 8, kRW = 4;
// blocks to aim for when splitting the channels: about four an SM
constexpr long long kDimgBlocksTarget = 528;

// K5: dimg[b, c, pixel] += g[b, c, p] * w(p, pixel) over every position p
// and each of its in-image taps (design above).
__global__ void __launch_bounds__(kDimgWarps * 32)
warp2d_dimg_kernel(const float* __restrict__ px, const float* __restrict__ py,
                   const float* __restrict__ g, float* __restrict__ dimg, int C, int H,
                   int W, long long P, int gh, int gw, int nxt, int cg) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gx = (blockIdx.x % nxt) * 32 + lane;
  const long long gy0 = ((long long)(blockIdx.x / nxt) * kDimgWarps + warp) * kRW;
  const long long b = blockIdx.y;
  const int c0 = blockIdx.z * cg, c1 = min(C, c0 + cg);

  // the lane's positions: base tap (x0, y0) and the weights of its four
  // taps, w[0] = (x0,y0), w[1] = (x0+1,y0), w[2] = (x0,y0+1), w[3] =
  // (x0+1,y0+1); past the grid, a base off the image and no weight. All
  // the loads are issued before any value is used.
  long long idx[kRW];
  float xs[kRW], ys[kRW];
#pragma unroll
  for (int j = 0; j < kRW; ++j) {
    const long long gy = gy0 + j;
    const long long p = gy * gw + gx;
    idx[j] = gx < gw && gy < gh && p < P ? p : -1;
    xs[j] = ys[j] = -4.f;
    if (idx[j] >= 0) {
      xs[j] = px[b * P + p];
      ys[j] = py[b * P + p];
    }
  }
  int tx[kRW], ty[kRW];
  float w[kRW][4];
#pragma unroll
  for (int j = 0; j < kRW; ++j) {
    const Taps t = taps_at(xs[j], ys[j], H, W);
    const bool in = idx[j] >= 0;
    tx[j] = t.x0;
    ty[j] = t.y0;
    w[j][0] = in ? __fmul_rn(t.gx, t.gy) : 0.f;
    w[j][1] = in ? __fmul_rn(t.fx, t.gy) : 0.f;
    w[j][2] = in ? __fmul_rn(t.gx, t.fy) : 0.f;
    w[j][3] = in ? __fmul_rn(t.fx, t.fy) : 0.f;
  }

  for (int c = c0; c < c1; ++c) {
    const float* gp = g + (b * C + c) * P;
    float* dst = dimg + (b * C + c) * (long long)H * W;
    float gv[kRW];
#pragma unroll
    for (int j = 0; j < kRW; ++j) {
      gv[j] = 0.f;
      if (idx[j] >= 0) gv[j] = gp[idx[j]];
    }

    // one product into pixel (x, y): skipped outside the image and when it
    // is exactly zero (it would change no sum)
    auto emit = [&](int x, int y, float v) {
      if (v != 0.f && (unsigned)x < (unsigned)W && (unsigned)y < (unsigned)H)
        atomicAdd(dst + (long long)y * W + x, v);
    };
    // a row of taps (x|x+1) at y, v[dx]; called by the whole warp at once:
    // where the lane below's x+1 tap is this lane's x tap (neighbouring
    // positions of a smooth field), its product joins this lane's, and one
    // atomic adds both
    auto emit_row = [&](int x, int y, const float (&v)[2]) {
      const int bx = __shfl_up_sync(0xffffffffu, x, 1);
      const int by = __shfl_up_sync(0xffffffffu, y, 1);
      const int ax = __shfl_down_sync(0xffffffffu, x, 1);
      const int ay = __shfl_down_sync(0xffffffffu, y, 1);
      const float below = __shfl_up_sync(0xffffffffu, v[1], 1);
      const bool take = lane > 0 && bx + 1 == x && by == y;
      const bool given = lane < 31 && ax == x + 1 && ay == y;
      emit(x, y, take ? __fadd_rn(below, v[0]) : v[0]);
      if (!given) emit(x + 1, y, v[1]);
    };

    // each lane walks its positions along y and carries the lower tap row
    // (y0 + 1) of one position to the next, whose upper row it is when both
    // lie on the same pixels
    float carry[2] = {0.f, 0.f};
    int kx = 0, ky = INT_MIN;          // the carried row's base tap
#pragma unroll
    for (int j = 0; j < kRW; ++j) {
      float v[2][2];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q >> 1][q & 1] = __fmul_rn(gv[j], w[j][q]);
      if (kx == tx[j] && ky == ty[j]) {
        v[0][0] = __fadd_rn(carry[0], v[0][0]);
        v[0][1] = __fadd_rn(carry[1], v[0][1]);
      } else if (ky != INT_MIN) {
        emit(kx, ky, carry[0]);
        emit(kx + 1, ky, carry[1]);
      }
      emit_row(tx[j], ty[j], v[0]);
      carry[0] = v[1][0];
      carry[1] = v[1][1];
      kx = tx[j];
      ky = ty[j] + 1;
    }
    emit_row(kx, ky, carry);
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
// zeroed by the caller; all contiguous. When P = H * W the positions are
// taken to lie on the image's grid in raster order (every 2-D path builds
// them from the pixel grid) and a warp takes 32 neighbours of a row;
// otherwise 32 consecutive positions. Either way any positions give the
// right sums. Launches on `stream`; allocates nothing and does not
// synchronise. Returns cudaGetLastError().
extern "C" int tpureg_warp2d_dimg(const void* px, const void* py, const void* g,
                                  void* dimg, int B, int C, int H, int W, long long P,
                                  void* stream) {
  if (bad_shape(B, C, H, W, P)) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  const bool on_grid = P == (long long)H * W;
  const long long gw = on_grid ? W : 32;
  const long long gh = on_grid ? H : (P + 31) / 32;
  const long long nxt = (gw + 31) / 32;
  const long long nyt = (gh + kDimgWarps * kRW - 1) / (kDimgWarps * kRW);
  const long long blocks = nxt * nyt;
  // split the channels into groups when the positions give too few blocks
  long long groups = (kDimgBlocksTarget + blocks * B - 1) / (blocks * B);
  if (groups > C) groups = C;
  const int cg = (int)((C + groups - 1) / groups);
  groups = (C + cg - 1) / cg;
  if (blocks > 2147483647LL || gh > 2147483647LL || B > 65535 || groups > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, (unsigned)B, (unsigned)groups);
  warp2d_dimg_kernel<<<grid, kDimgWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(px), static_cast<const float*>(py),
      static_cast<const float*>(g), static_cast<float*>(dimg), C, H, W, P, (int)gh,
      (int)gw, (int)nxt, cg);
  return (int)cudaGetLastError();
}
