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
// Design: banded products on the tensor cores, as the TPU's default kernel
// runs them on its MXU (correlation_pallas.py:368-396). For an output row
// y, a tile of TX columns [x0, x0+TX) and a tile of CT channels, each
// displacement row iy contributes
//   df1[c, x]  += sum_xx F2[c, xx] * T1[xx, x],  F2 = f2 row y+dy,
//                 T1[xx, x] = g[iy*K+ix, y, x]    where xx = x + dx;
//   df2[c, x'] += sum_x  F1[c, x]  * T2[x, x'],  F1 = f1 row y-dy,
//                 T2[x, x'] = g[iy*K+ix, y-dy, x] where x' = x + dx.
// - The contracted columns run over the window [x0-md, x0+TX+md) clipped
//   to the image (at W = 32 the row itself): no product touches a column
//   outside it.
// - Each band entry is exactly one g value, so building a band rounds
//   nothing. The bands' non-zero pattern depends only on (ix, column), so
//   they are zeroed once and their entries overwritten at each step.
// - A block takes RY output rows of one residue mod s2 and walks the source
//   rows once (K + RY - 1 steps): each staged f2 and f1 row serves every
//   output row that reaches it, which cuts the feature rows read from L2 by
//   RY K / (K + RY - 1), 3.5x at FlowNetC's K = 21 with RY = 4. Its CT
//   channels (128 at FlowNetC) share each band. Windows too wide for that
//   tile's shared memory (md 20 from W = 72 on, in fp32) take 2 rows and
//   64 channels, or 1 row and 32.
// - Where s2 is even and divides md, a column meets only columns of its
//   own parity; rows and bands are stored parity by parity (Cls) and the
//   products skip the zero off-diagonal blocks.
// - Displacement rows outside the image are skipped by the whole block.
// - Each block owns its output tile and gathers (the TPU kernel
//   accumulates df2 in a VMEM buffer across its sequential grid steps,
//   :394-400): no atomics, and the sums are deterministic.
//
// Precision (one rule per (operand, g) type pair, so that the products are
// exact or, for fp32 operands, as good as fp32 FMAs):
// - fp32 operands: 3-pass TF32 on mma.sync m16n8k8, a*b = a_lo*b_hi +
//   a_hi*b_lo + a_hi*b_hi with hi = tf32(v), lo = tf32(v - hi), the
//   counterpart of the TPU's precision=HIGHEST; the band is split once when
//   it is built (a bf16 g is exact in TF32: two passes);
// - bf16 operands, bf16 g: bf16 mma.sync m16n8k16, products exact, fp32
//   sums;
// - bf16 operands, fp32 g: g split exactly into three bf16 pieces
//   (hi + mid + lo carry its 24 bits), three bf16 products, all exact.
//
// What bounds it on the H100: at FlowNetC's shape (B=8, C=256, 32x32, md 20,
// s2 2) the in-image work is 2 x 0.42 G multiply-adds against 48 MB of
// unique bytes in fp32, 24 MB in bf16 (f1, f2, g read once, df1, df2
// written once). On the fp32 pipes (67 TFLOP/s) that is 25 us; on the
// tensor cores the 3-pass TF32 form does three times the products at
// 495 TFLOP/s (10 us) and the bf16 form one pass at 989 TFLOP/s, both
// under the bytes: 14.3 us (fp32) and 7.2 us (bf16). What the kernel
// itself spends is the staging between two barriers a step: per block and
// step, two feature rows (CT x window) and K g values for each column of
// 2 x RY bands, read from L2, with the index arithmetic that places them;
// each g value is read twice for each tile of CT channels.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;          // output columns per block: a band column per lane
constexpr size_t kMaxSmem = 227 * 1024;
static_assert(TX == 32, "a band column per lane");

// A block's tile: RY output rows and CT channels, with one warp for each
// m16 tile of channels and cotangent (warps [0, CT/16) df1, the rest df2).
template <int RY_, int CT_>
struct Tile {
  static constexpr int RY = RY_, CT = CT_;
  static constexpr int kWarps = CT / 8;
  static constexpr int kThreads = 32 * kWarps;
};
// the tiles the launcher chooses from, largest first: rows and channels
// give way to shared memory as the window widens (md, W)
using Wide = Tile<4, 128>;
using Mid = Tile<2, 64>;
using Narrow = Tile<1, 32>;

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

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo to about 2^-22 of v, both TF32
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t word(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Shared-memory layout for operand type T: the contracted dimension (window
// slot k) is contiguous, rows `ks` elements apart, ks chosen so that the
// fragment loads of a warp hit 32 different banks.
template <typename T>
struct Layout {
  static constexpr bool k16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kstep = k16 ? 16 : 8;   // mma depth
  static constexpr int pad = k16 ? 8 : 4;      // ks = 4 words mod 8 words
};

// Pieces a band entry is stored in: fp32 operands take g as TF32 hi + lo
// (a bf16 g is exact in TF32: one piece); bf16 operands take a bf16 g as it
// is and an fp32 g as three exact bf16 pieces.
template <typename T, typename G>
struct Pieces {
  static constexpr int value = std::is_same<G, float>::value ? (Layout<T>::k16 ? 3 : 2) : 1;
};

// Columns in S classes of equal residue mod S. Where S divides md and s2
// (and x0, a multiple of TX), window column k (image column klo + k) and
// output column n (image column x0 + n) meet in a band entry only if
// k = n mod S, for every displacement ix*s2 - md is then a multiple of S.
// Both are stored class by class, k at slot (k % S) * kcls + k / S and n at
// slot (n % S) * (TX / S) + n / S, so that each band is block diagonal and
// the products skip its zero blocks: half the work at FlowNetC's s2 = 2.
template <int S>
struct Cls {
  int kcls;   // slots of a class, a multiple of the mma depth
  __device__ __forceinline__ int k_at(int k) const { return (k % S) * kcls + k / S; }
  static __device__ __forceinline__ int n_at(int n) { return (n % S) * (TX / S) + n / S; }
  static __device__ __forceinline__ int n_of(int slot) {
    return (slot % (TX / S)) * S + slot / (TX / S);
  }
};

// One g value into a band entry, as its pieces (Pieces above).
template <typename T, int NP>
__device__ __forceinline__ void put_band(T* band, int i, int piece, float v) {
  if constexpr (!Layout<T>::k16) {
    if constexpr (NP == 1) {
      band[i] = v;                          // a bf16 value: exact in TF32
    } else {
      uint32_t hi, lo;
      split_tf32(v, hi, lo);
      band[i] = __uint_as_float(hi);
      band[i + piece] = __uint_as_float(lo);
    }
  } else if constexpr (NP == 1) {
    band[i] = __float2bfloat16_rn(v);       // v came from a bf16: exact
  } else {
    const __nv_bfloat16 hi = __float2bfloat16_rn(v);
    const float r = v - __bfloat162float(hi);
    const __nv_bfloat16 mid = __float2bfloat16_rn(r);
    band[i] = hi;
    band[i + piece] = mid;
    band[i + 2 * piece] = __float2bfloat16_rn(r - __bfloat162float(mid));
  }
}

// One warp's m16 x TX products for the block's output rows j in [jlo, jhi],
// summed into acc[j]: A [16 rows][slots] from `a` (rows ks apart) against
// row j's band B [TX column slots][slots] in `bands` ([RY][NP][TX][ks]),
// class by class. Each A fragment is loaded (and split) once for all rows.
template <class Q, typename T, int NP, int S>
__device__ __forceinline__ void band_product(float (&acc)[Q::RY][TX / 8][4], const T* a,
                                             const T* bands, int jlo, int jhi, int ks,
                                             int kcls, int lane) {
  constexpr int tiles = TX / 8 / S;   // n8 tiles of a class
  const int gq = lane >> 2, tq = lane & 3;
  const T* a0 = a + gq * ks;
  const T* a8 = a0 + 8 * ks;
  const int piece = TX * ks;
#pragma unroll
  for (int p = 0; p < S; ++p) {
    for (int kk = p * kcls; kk < (p + 1) * kcls; kk += Layout<T>::kstep) {
      if constexpr (Layout<T>::k16) {
        const uint32_t af[4] = {word(a0 + kk + 2 * tq), word(a8 + kk + 2 * tq),
                                word(a0 + kk + 2 * tq + 8), word(a8 + kk + 2 * tq + 8)};
#pragma unroll
        for (int j = 0; j < Q::RY; ++j) {
          if (j < jlo || j > jhi) continue;
#pragma unroll
          for (int t = 0; t < tiles; ++t) {
            const int nt = p * tiles + t;
#pragma unroll
            for (int q = NP - 1; q >= 0; --q) {   // the smallest piece first
              const T* br = bands + (j * NP + q) * piece + (nt * 8 + gq) * ks + kk;
              const uint32_t bf[2] = {word(br + 2 * tq), word(br + 2 * tq + 8)};
              mma_bf16(acc[j][nt], af, bf);
            }
          }
        }
      } else {
        uint32_t ah[4], al[4];
        split_tf32(a0[kk + tq], ah[0], al[0]);
        split_tf32(a8[kk + tq], ah[1], al[1]);
        split_tf32(a0[kk + tq + 4], ah[2], al[2]);
        split_tf32(a8[kk + tq + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < Q::RY; ++j) {
          if (j < jlo || j > jhi) continue;
#pragma unroll
          for (int t = 0; t < tiles; ++t) {
            const int nt = p * tiles + t;
            const T* br = bands + j * NP * piece + (nt * 8 + gq) * ks + kk;
            const uint32_t bh[2] = {__float_as_uint(br[tq]), __float_as_uint(br[tq + 4])};
            mma_tf32(acc[j][nt], al, bh);
            if constexpr (NP == 2) {
              const uint32_t bl[2] = {__float_as_uint(br[piece + tq]),
                                      __float_as_uint(br[piece + tq + 4])};
              mma_tf32(acc[j][nt], ah, bl);
            }
            mma_tf32(acc[j][nt], ah, bh);
          }
        }
      }
    }
  }
}

// Row r2 of f2 (when v1) and row r1 of f1 (when v2), channels [c0, c0+cc),
// window columns [klo, klo+kw) at their class slots, zero in the slots past
// them, into f2s and f1s [CT][ks]. Each warp loads all of its rows of 32
// slots before it stores any, so that its loads are in flight together.
template <class Q, typename T, int S>
__device__ __forceinline__ void stage_rows(T* f2s, T* f1s, const T* f2b, const T* f1b,
                                           bool v1, bool v2, int r2, int r1, size_t plane,
                                           int W, int klo, int kw, int kcls, int cc, int ks,
                                           int warp, int lane) {
  constexpr int kRows = Q::CT / Q::kWarps;
  const T zero = from_f32<T>(0.f);
  const T* row2 = f2b + (size_t)(v1 ? r2 : 0) * W + klo;
  const T* row1 = f1b + (size_t)(v2 ? r1 : 0) * W + klo;
  for (int s0 = 0; s0 < S * kcls; s0 += 32) {
    const int slot = s0 + lane;
    int p = 0;                            // the slot's class
#pragma unroll
    for (int q = 1; q < S; ++q) p += slot >= q * kcls;
    const int k = (slot - p * kcls) * S + p;   // its window column
    T a[kRows], b[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int c = warp + r * Q::kWarps;
      const bool ok = c < cc && k < kw;
      a[r] = v1 && ok ? row2[(size_t)c * plane + k] : zero;
      b[r] = v2 && ok ? row1[(size_t)c * plane + k] : zero;
    }
    if (slot < S * kcls) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int c = warp + r * Q::kWarps;
        if (v1) f2s[c * ks + slot] = a[r];
        if (v2) f1s[c * ks + slot] = b[r];
      }
    }
  }
}

// The bands of step m for every active output row j (jlo <= j <= jhi):
// T1 of displacement row m - j from g row y0 + j*s2 (when v1) and T2 of
// displacement row j + K - 1 - m from g row r1 (when v2). Column n of each
// is lane n; a warp takes displacements ix = warp + u*kWarps and loads them
// for every row before it stores any (one round trip to L2 for K <= 32).
// Offsets into the batch's g are 32-bit (the launcher checks (K+RY)*K*H*W).
template <class Q, typename T, typename G, int NP, int S>
__device__ __forceinline__ void stage_bands(T* b1s, T* b2s, const G* gb, int m, bool v1,
                                            bool v2, int y0, int jlo, int jhi, int r1,
                                            int plane, int W, int x0, int klo, int kw,
                                            int md, int s2, int K, int kcls, int ks,
                                            int warp, int lane) {
  constexpr int kU = 2;
  const Cls<S> cls{kcls};
  const int piece = TX * ks;
  const int x = x0 + lane;                   // df1's output column
  const int nslot = Cls<S>::n_at(lane) * ks;
  const int kp = K * plane;                  // one displacement row of g
  // g offsets of row j's entries: base + j * step, plus ix * plane + column
  const int base1 = m * kp + y0 * W, step1 = s2 * W - kp;
  const int base2 = (K - 1 - m) * kp + r1 * W, step2 = kp;
  for (int ix0 = warp; ix0 < K; ix0 += kU * Q::kWarps) {
    float g1[Q::RY][kU], g2[Q::RY][kU];
    int i1[kU], i2[kU];                      // band slots, or -1
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int ix = ix0 + u * Q::kWarps;
      const int k1 = x + ix * s2 - md - klo;          // df1: its f2 tap
      const int k2 = x0 + lane - ix * s2 + md - klo;  // df2: output x0+lane's source
      const bool ok1 = v1 && ix < K && x < W && k1 >= 0 && k1 < kw;
      const bool ok2 = v2 && ix < K && k2 >= 0 && k2 < kw;
      i1[u] = ok1 ? nslot + cls.k_at(k1) : -1;
      i2[u] = ok2 ? nslot + cls.k_at(k2) : -1;
      const int o1 = base1 + ix * plane + x;
      const int o2 = base2 + ix * plane + klo + k2;
#pragma unroll
      for (int j = 0; j < Q::RY; ++j) {
        const bool row = j >= jlo && j <= jhi;
        g1[j][u] = ok1 && row ? to_f32(gb[o1 + j * step1]) : 0.f;
        g2[j][u] = ok2 && row ? to_f32(gb[o2 + j * step2]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
#pragma unroll
      for (int j = 0; j < Q::RY; ++j) {
        if (j < jlo || j > jhi) continue;
        if (i1[u] >= 0) put_band<T, NP>(b1s + j * NP * piece, i1[u], piece, g1[j][u]);
        if (i2[u] >= 0) put_band<T, NP>(b2s + j * NP * piece, i2[u], piece, g2[j][u]);
      }
    }
  }
}

// A block: RY output rows y0 + j*s2 (one residue of y mod s2), TX columns
// from x0, CT channels from c0. Step m stages f2 row r2 = y0 - md + m*s2
// and f1 row r1 = y0 + md - (K-1)*s2 + m*s2 once for all the rows: output
// row j takes r2 at displacement row m - j (df1) and r1 at displacement row
// j + K - 1 - m (df2), both when 0 <= m - j < K.
template <class Q, typename T, typename G, int S>
__global__ void __launch_bounds__(Q::kThreads, 512 / Q::kThreads)
corr_bwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                const G* __restrict__ g, T* __restrict__ df1, T* __restrict__ df2,
                int C, int H, int W, int md, int s2, int K, int n_ct, int ks) {
  constexpr int NP = Pieces<T, G>::value;
  constexpr int kstep = Layout<T>::kstep;
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y % s2 + (blockIdx.y / s2) * Q::RY * s2;
  const int c0 = (blockIdx.z % n_ct) * Q::CT;
  const int b = blockIdx.z / n_ct;
  const int cc = min(Q::CT, C - c0);
  const int rows = y0 < H ? min(Q::RY, (H - 1 - y0) / s2 + 1) : 0;
  const int klo = max(0, x0 - md);                 // the window [klo, klo+kw)
  const int kw = min(W, x0 + TX + md) - klo;
  const int kcls = ((kw + S - 1) / S + kstep - 1) / kstep * kstep;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t plane = (size_t)H * W;
  const T* f1b = f1 + ((size_t)b * C + c0) * plane;
  const T* f2b = f2 + ((size_t)b * C + c0) * plane;
  const G* gb = g + (size_t)b * K * K * plane;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* f2s = reinterpret_cast<T*>(smem_raw);   // [CT][ks]: f2 row r2
  T* f1s = f2s + Q::CT * ks;                    // [CT][ks]: f1 row r1
  T* b1s = f1s + Q::CT * ks;                    // [RY][NP][TX][ks]: T1
  T* b2s = b1s + Q::RY * NP * TX * ks;          // [RY][NP][TX][ks]: T2
  {
    const T zero = from_f32<T>(0.f);
    for (int i = tid; i < 2 * Q::RY * NP * TX * ks; i += Q::kThreads) b1s[i] = zero;
  }

  const int out = warp / (Q::CT / 16);        // 0: df1, 1: df2
  const int mt = warp % (Q::CT / 16);        // the warp's 16 channels
  const bool mine = mt * 16 < cc;
  float acc[Q::RY][TX / 8][4];
#pragma unroll
  for (int j = 0; j < Q::RY; ++j)
#pragma unroll
    for (int nt = 0; nt < TX / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][nt][i] = 0.f;

  for (int m = 0; m < K + Q::RY - 1; ++m) {
    const int r2 = y0 - md + m * s2;                 // df1's f2 row
    const int r1 = y0 + md - (K - 1) * s2 + m * s2;  // df2's f1 row
    const bool v1 = r2 >= 0 && r2 < H;
    const bool v2 = r1 >= 0 && r1 < H;
    const int jlo = max(0, m - K + 1), jhi = min(rows - 1, m);
    if (jlo > jhi || (!v1 && !v2)) continue;   // the same for the whole block
    __syncthreads();                 // the previous step's products are done
    stage_rows<Q, T, S>(f2s, f1s, f2b, f1b, v1, v2, r2, r1, plane, W, klo, kw, kcls, cc, ks,
                     warp, lane);
    stage_bands<Q, T, G, NP, S>(b1s, b2s, gb, m, v1, v2, y0, jlo, jhi, r1, (int)plane, W, x0,
                             klo, kw, md, s2, K, kcls, ks, warp, lane);
    __syncthreads();
    if (mine && (out == 0 ? v1 : v2))
      band_product<Q, T, NP, S>(acc, (out == 0 ? f2s : f1s) + mt * 16 * ks,
                             out == 0 ? b1s : b2s, jlo, jhi, ks, kcls, lane);
  }

  if (mine) {
    const int gq = lane >> 2, tq = lane & 3;
    const float fc = (float)C;
#pragma unroll
    for (int j = 0; j < Q::RY; ++j) {
      if (j >= rows) continue;
      T* dst = (out == 0 ? df1 : df2) + ((size_t)b * C + c0) * plane +
               (size_t)(y0 + j * s2) * W;
#pragma unroll
      for (int nt = 0; nt < TX / 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = mt * 16 + gq + (i >> 1) * 8;
          const int x = x0 + Cls<S>::n_of(nt * 8 + 2 * tq + (i & 1));
          if (c < cc && x < W)
            dst[(size_t)c * plane + x] = from_f32<T>(acc[j][nt][i] / fc);
        }
    }
  }
}

template <class Q, typename T, typename G>
size_t smem_of(int ks) {
  return (size_t)(2 * Q::CT + 2 * Q::RY * Pieces<T, G>::value * TX) * ks * sizeof(T);
}

template <class Q, typename T, typename G, int S>
int launch(const void* f1, const void* f2, const void* g, void* df1, void* df2, int B,
           int C, int H, int W, int md, int s2, int K, int ks, cudaStream_t s) {
  const size_t smem = smem_of<Q, T, G>(ks);
  const int n_ct = (C + Q::CT - 1) / Q::CT;
  // RY rows of one residue mod s2 a block; residue 0 has the most rows
  const long long n_rg = (long long)s2 * (((H + s2 - 1) / s2 + Q::RY - 1) / Q::RY);
  if ((long long)B * n_ct > 65535 || n_rg > 65535 ||
      (long long)(K + Q::RY) * K * H * W > 2147483647LL)
    return (int)cudaErrorInvalidConfiguration;
  auto kernel = corr_bwd_kernel<Q, T, G, S>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + TX - 1) / TX, (unsigned)n_rg, (unsigned)(B * n_ct));
  kernel<<<grid, Q::kThreads, smem, s>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2), static_cast<const G*>(g),
      static_cast<T*>(df1), static_cast<T*>(df2), C, H, W, md, s2, K, n_ct, ks);
  return (int)cudaGetLastError();
}

// The largest tile whose shared memory fits the window, with column
// classes (Cls): two where s2 is even and divides md, else one.
template <typename T, typename G, int S>
int launch_tile(const void* f1, const void* f2, const void* g, void* df1, void* df2, int B,
                int C, int H, int W, int md, int s2, int K, cudaStream_t s) {
  constexpr int kstep = Layout<T>::kstep;
  const int kw_max = W < TX + 2 * md ? W : TX + 2 * md;   // the widest window
  const int ks = S * (((kw_max + S - 1) / S + kstep - 1) / kstep * kstep) + Layout<T>::pad;
  if (smem_of<Wide, T, G>(ks) <= kMaxSmem)
    return launch<Wide, T, G, S>(f1, f2, g, df1, df2, B, C, H, W, md, s2, K, ks, s);
  if (smem_of<Mid, T, G>(ks) <= kMaxSmem)
    return launch<Mid, T, G, S>(f1, f2, g, df1, df2, B, C, H, W, md, s2, K, ks, s);
  if (smem_of<Narrow, T, G>(ks) <= kMaxSmem)
    return launch<Narrow, T, G, S>(f1, f2, g, df1, df2, B, C, H, W, md, s2, K, ks, s);
  return (int)cudaErrorInvalidConfiguration;
}

template <typename T, typename G>
int launch_classes(const void* f1, const void* f2, const void* g, void* df1, void* df2,
                   int B, int C, int H, int W, int md, int s2, int K, cudaStream_t s) {
  if (s2 % 2 == 0 && md % 2 == 0)
    return launch_tile<T, G, 2>(f1, f2, g, df1, df2, B, C, H, W, md, s2, K, s);
  return launch_tile<T, G, 1>(f1, f2, g, df1, df2, B, C, H, W, md, s2, K, s);
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
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || md < 0 || s2 <= 0)
    return (int)cudaErrorInvalidValue;
  const int K = 2 * (md / s2) + 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && gdtype == 0)
    return launch_classes<float, float>(f1, f2, g, df1, df2, B, C, H, W, md, s2, K, s);
  if (dtype == 0 && gdtype == 1)
    return launch_classes<float, __nv_bfloat16>(f1, f2, g, df1, df2, B, C, H, W, md, s2,
                                                K, s);
  if (dtype == 1 && gdtype == 0)
    return launch_classes<__nv_bfloat16, float>(f1, f2, g, df1, df2, B, C, H, W, md, s2,
                                                K, s);
  if (dtype == 1 && gdtype == 1)
    return launch_classes<__nv_bfloat16, __nv_bfloat16>(f1, f2, g, df1, df2, B, C, H, W,
                                                        md, s2, K, s);
  return (int)cudaErrorInvalidValue;
}
