// K4 and K5: the two kernels of the bilinear warp's gradient, written by hand
// for Hopper (sm_90a). The sample itself is K3's (warp2d.cu) in every
// forward.
//
// K4, the positions' cotangent (the warp's VJP to px and py), replaces
// tpureg/ops/warp_pallas.py::_fwd_taps_kernel (:197, via _fwd_with_taps :399
// <- _vjp_fwd :425) together with the product that _vjp_bwd (:430, :452-453)
// takes of its bases: from the image, the positions and the sample's
// cotangent g[b, c, p] it computes
//   dpx[b, p] = sum_c g[b,c,p] ((1-fy)(v10 - v00) + fy (v11 - v01))
//   dpy[b, p] = sum_c g[b,c,p] ((1-fx)(v01 - v00) + fx (v11 - v10))
// with the tap values v in fp32 (a bf16 image is read in fp32), so no
// per-channel basis is written or kept between the forward and the backward.
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
// with out-of-image tap values v taken as zero. A position with no tap in
// the image (far away, or not finite) gets a zero cotangent.
//
// What bounds them on the H100: bytes. K4 reads the image, g [B, C, P] and
// the positions once and writes dpx and dpy [B, P]: on the FlowNet2 path
// (B=8, 256x256, C=1, fp32) 12.6 MB, 3.8 us at 3.35 TB/s; at PWC's feature
// warps (C = 32-128 on 8x8-64x64 maps, B=8) 0.5-8.9 MB, 0.16-2.66 us. K5
// reads 6.3 MB of positions and cotangent and writes the 2.1 MB image:
// 2.5 us. What K5 spends beyond that is its atomics, one global fp32 atomic
// per in-image tap and channel (2.1 M at that shape) before merging, and the
// zero fill (and for a bf16 image the cast) that its wrapper adds around the
// launch.
//
// Design of K4: what would hold it back is parallelism, then latency.
// PWC's maps hold few positions (B * P = 512 at 8x8) and many channels, so
// one thread a position walking C would leave the card empty.
// - Lanes take 32 consecutive positions of one batch row (coalesced loads
//   of px, py and g, coalesced stores of dpx and dpy). A block holds npg
//   such position groups and nwc warps for each; the nwc warps of a group
//   split C, warp w taking channels w, w + nwc, .... Each lane forms its tap
//   geometry once and keeps it in registers for all its channels.
// - A lane issues the taps and g of kDposU channels before it uses any of
//   them (raw bits under a predicate, converted after), so those loads are
//   in flight together.
// - The warps' partial sums meet in shared memory and the first warp of the
//   group adds them in warp order: no atomics, so dpx and dpy are the same
//   from run to run.
// - The host doubles nwc from 1 while the grid holds fewer than
//   kDposWarpsPerSM warps a streaming multiprocessor, up to C and to 32
//   warps a block, and fills a block with npg = max(1, 8 / nwc) groups. So
//   C <= 2 (FlowNet2, SyN) runs one warp a group, 8 groups a block, and
//   PWC's 8x8 level splits its 128 channels over 32 warps.
// - A warp of at most two channels (in a block of 8 warps) takes them one
//   at a time, in an instance held to 32 registers so that 8 blocks fill
//   an SM; the others keep 4 channels in flight (56 registers).
// - Tap offsets within a plane are 32-bit (the wrapper refuses H * W >=
//   2^31); batch and channel bases are 64-bit.
// Chosen by timing on the H100 (ab_warp2d_dpos.py with variant trees;
// NVIDIA H100 80GB HBM3, 700 W; medians of six, us). One call, at PWC's
// levels 5 / 3 / 2: a split target of 16 warps an SM 4.55 / 4.48 / 5.91,
// of 32 4.63 / 7.31 / 6.64 (level 3 in two waves), of 8 4.62 / 4.33 / 5.84
// (within 3%); 8 channels in flight 5.93 / 5.88 / 6.22. Another, with this
// kernel's loads: 2 channels in flight 4.86 / 4.82 / 6.72 against 4.69 /
// 4.62 / 6.23. At FlowNet2's (8, 1, 256^2): 4 channels in flight at C = 1
// (54 registers, 4 blocks an SM) 9.68; the one-channel instance with plain
// loads, which spilled under its cap, 10.35; with __ldg loads (no spill)
// 6.70; without the cap (40 registers) 6.53. Level 2 waits on three
// dependent rounds of loads (positions, then two batches of four channels)
// in one wave of 512 blocks, four resident an SM.
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
//   few blocks to fill the card (C = 32-128 at PWC's small maps); the
//   channel groups ride on the grid's z axis, so there may be at most 65535
//   of them (the entry point refuses more; no path comes near).
// - When P = H * W the positions are taken to lie on the image's grid in
//   raster order; otherwise lanes take consecutive positions in rows of 32.
//   Merging only ever joins products bound for the same pixel, so any
//   positions give the right sums.

#include <climits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// K4's geometry: at most kDposMaxWarps warps a block; kDposU channels'
// loads in flight a lane where a warp walks more than two channels, else
// one; the host aims for kDposWarpsPerSM warps a streaming multiprocessor
// before it stops splitting C
constexpr int kDposMaxWarps = 32, kDposU = 4, kDposWarpsPerSM = 16;
// batch rows a launch (the grid's y limit): a larger batch is launched in
// chunks of rows on the same stream, each chunk's pointers offset to its
// first row; a row's result does not depend on the chunk it falls in
constexpr int kMaxGridY = 65535;

// an image element as raw bits, widened to fp32 after the loads
template <typename T>
struct Raw;
template <>
struct Raw<float> {
  using type = unsigned int;
  static __device__ __forceinline__ float f32(unsigned int v) { return __uint_as_float(v); }
};
template <>
struct Raw<__nv_bfloat16> {
  using type = unsigned short;
  static __device__ __forceinline__ float f32(unsigned short v) {
    return __uint_as_float((unsigned int)v << 16);
  }
};

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

// K4: dpx[b, p] and dpy[b, p] = sum_c g[b, c, p] d out[b, c, p] / d (px, py)
// (design above). Block: npg position groups of nwc warps each; U channels
// a lane loads before it uses any. With U = 1 a block has 8 warps and a
// lane at most 32 registers, so that 8 blocks fill an SM.
template <typename T, int U>
__global__ void __launch_bounds__(U == 1 ? 256 : kDposMaxWarps * 32, U == 1 ? 8 : 1)
warp2d_dpos_kernel(const T* __restrict__ img, const float* __restrict__ px,
                   const float* __restrict__ py, const float* __restrict__ g,
                   float* __restrict__ dpx, float* __restrict__ dpy, int C, int H, int W,
                   int P, int nwc, int npg) {
  using R = typename Raw<T>::type;
  __shared__ float part[2][kDposMaxWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wc = warp % nwc, pg = warp / nwc;
  const long long b = blockIdx.y;
  const int p = (blockIdx.x * npg + pg) * 32 + lane;
  const bool active = p < P;
  float x = -4.f, y = -4.f;  // past the row: no tap in the image
  if (active) {
    x = __ldg(px + b * P + p);
    y = __ldg(py + b * P + p);
  }
  Taps t = taps_at(x, y, H, W);
  if (!(t.v00 || t.v10 || t.v01 || t.v11)) {
    // no tap in the image (far away, not finite, or past the row): every
    // tap value is 0, and zeroed fractions keep a NaN out of the sums
    t.fx = t.fy = t.gx = t.gy = 0.f;
  }
  // only an inside tap's offset is formed: it is below H * W
  const int o00 = t.v00 ? t.y0 * W + t.x0 : 0;
  const int o10 = t.v10 ? t.y0 * W + t.x0 + 1 : 0;
  const int o01 = t.v01 ? (t.y0 + 1) * W + t.x0 : 0;
  const int o11 = t.v11 ? (t.y0 + 1) * W + t.x0 + 1 : 0;
  const long long plane = (long long)H * W;
  const R* src = reinterpret_cast<const R*>(img) + b * C * plane;
  const float* gp = g + b * C * (long long)P + p;

  float sx = 0.f, sy = 0.f;
  for (int c0 = wc; c0 < C; c0 += U * nwc) {
    // every load of U channels is issued before any value is used
    R v[U][4];
    float gv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u * nwc;
      const bool ok = active && c < C;
      const R* s = src + (long long)c * plane;
      v[u][0] = ok && t.v00 ? __ldg(s + o00) : R(0);
      v[u][1] = ok && t.v10 ? __ldg(s + o10) : R(0);
      v[u][2] = ok && t.v01 ? __ldg(s + o01) : R(0);
      v[u][3] = ok && t.v11 ? __ldg(s + o11) : R(0);
      gv[u] = ok ? __ldg(gp + (long long)c * P) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float v00 = Raw<T>::f32(v[u][0]), v10 = Raw<T>::f32(v[u][1]);
      const float v01 = Raw<T>::f32(v[u][2]), v11 = Raw<T>::f32(v[u][3]);
      const float bx = t.gy * (v10 - v00) + t.fy * (v11 - v01);
      const float by = t.gx * (v01 - v00) + t.fx * (v11 - v10);
      sx += gv[u] * bx;
      sy += gv[u] * by;
    }
  }

  if (nwc > 1) {
    // the group's warps meet in shared memory; its first warp adds their
    // sums in warp order
    part[0][warp][lane] = sx;
    part[1][warp][lane] = sy;
    __syncthreads();
    if (wc != 0) return;
    sx = part[0][warp][lane];
    sy = part[1][warp][lane];
    for (int w = 1; w < nwc; ++w) {
      sx += part[0][warp + w][lane];
      sy += part[1][warp + w][lane];
    }
  }
  if (active) {
    dpx[b * P + p] = sx;
    dpy[b * P + p] = sy;
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

// the card's streaming multiprocessors
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

}  // namespace

// K4. dtype: 0 = float32, 1 = bfloat16 image. img: [B, C, H, W] contiguous,
// with H * W < 2^31 and any B; px, py: [B, P] fp32 contiguous, P < 2^31; g:
// [B, C, P] fp32 contiguous; dpx, dpy: [B, P] fp32 contiguous. Launches on
// `stream`, one launch for each kMaxGridY batch rows; allocates nothing and
// does not synchronise. Returns the first launch error, else cudaSuccess.
extern "C" int tpureg_warp2d_dpos(const void* img, const void* px, const void* py,
                                  const void* g, void* dpx, void* dpy, int dtype, int B,
                                  int C, int H, int W, long long P, void* stream) {
  if (bad_shape(B, C, H, W, P)) return (int)cudaErrorInvalidValue;
  if ((long long)H * W >= 2147483648LL || P >= 2147483648LL - 32)
    return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long groups = (P + 31) / 32;
  const long long target = (long long)kDposWarpsPerSM * sm_count();
  const long long plane = (long long)H * W;
  const size_t elem = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  for (int b0 = 0; b0 < B; b0 += kMaxGridY) {
    const int nb = B - b0 < kMaxGridY ? B - b0 : kMaxGridY;
    // split C over more warps while the grid is short of kDposWarpsPerSM
    // warps an SM; then fill a block up to 8 warps with position groups
    int nwc = 1;
    while (2 * nwc <= kDposMaxWarps && 2 * nwc <= C && groups * nb * nwc < target) nwc *= 2;
    const int npg = nwc < 8 ? 8 / nwc : 1;
    const dim3 grid((unsigned)((groups + npg - 1) / npg), (unsigned)nb);
    const int threads = nwc * npg * 32;
    // a warp of at most two channels in an 8-warp block takes them one at a
    // time, in the kernel that fills an SM with 8 blocks
    const bool one = nwc <= 8 && (C + nwc - 1) / nwc <= 2;
    const long long rows = (long long)b0 * P, cols = (long long)b0 * C;
    const void* im = static_cast<const char*>(img) + cols * plane * elem;
    const float* fx = static_cast<const float*>(px) + rows;
    const float* fy = static_cast<const float*>(py) + rows;
    const float* fg = static_cast<const float*>(g) + cols * P;
    float* ox = static_cast<float*>(dpx) + rows;
    float* oy = static_cast<float*>(dpy) + rows;
    const int p32 = (int)P;
    if (dtype == 0) {
      const float* t = static_cast<const float*>(im);
      if (one)
        warp2d_dpos_kernel<float, 1><<<grid, threads, 0, s>>>(t, fx, fy, fg, ox, oy, C, H, W,
                                                                p32, nwc, npg);
      else
        warp2d_dpos_kernel<float, kDposU><<<grid, threads, 0, s>>>(t, fx, fy, fg, ox, oy, C,
                                                                     H, W, p32, nwc, npg);
    } else {
      const __nv_bfloat16* t = static_cast<const __nv_bfloat16*>(im);
      if (one)
        warp2d_dpos_kernel<__nv_bfloat16, 1><<<grid, threads, 0, s>>>(
            t, fx, fy, fg, ox, oy, C, H, W, p32, nwc, npg);
      else
        warp2d_dpos_kernel<__nv_bfloat16, kDposU><<<grid, threads, 0, s>>>(
            t, fx, fy, fg, ox, oy, C, H, W, p32, nwc, npg);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

// K5. px, py: [B, P] fp32; g: [B, C, P] fp32; dimg: [B, C, H, W] fp32,
// zeroed by the caller; all contiguous; any B. When P = H * W the positions
// are taken to lie on the image's grid in raster order (every 2-D path
// builds them from the pixel grid) and a warp takes 32 neighbours of a row;
// otherwise 32 consecutive positions. Either way any positions give the
// right sums. The channel groups ride on the grid's z axis, so at most 65535
// of them; no path comes near (PWC's 128 channels split into at most 128).
// Launches on `stream`, one launch for each kMaxGridY batch rows; allocates
// nothing and does not synchronise. Returns the first launch error, else
// cudaSuccess.
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
  if (blocks > 2147483647LL || gh > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const long long plane = (long long)H * W;
  for (int b0 = 0; b0 < B; b0 += kMaxGridY) {
    const int nb = B - b0 < kMaxGridY ? B - b0 : kMaxGridY;
    // split the channels into groups when the positions give too few blocks
    long long groups = (kDimgBlocksTarget + blocks * nb - 1) / (blocks * nb);
    if (groups > C) groups = C;
    const int cg = (int)((C + groups - 1) / groups);
    groups = (C + cg - 1) / cg;
    if (groups > 65535) return (int)cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned)blocks, (unsigned)nb, (unsigned)groups);
    const long long rows = (long long)b0 * P, cols = (long long)b0 * C;
    warp2d_dimg_kernel<<<grid, kDimgWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(px) + rows, static_cast<const float*>(py) + rows,
        static_cast<const float*>(g) + cols * P, static_cast<float*>(dimg) + cols * plane,
        C, H, W, P, (int)gh, (int)gw, (int)nxt, cg);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}
