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
// with zero wherever the f2 tap falls outside the image. The output channel
// order is row-major over (dy, dx), as FlowNetC's conv3_1 expects.
//
// Design: banded products on the tensor cores, the form of the TPU's
// _fwd_banded_kernel. For an output row y and a displacement row iy (f2 row
// r = y + iy*s2 - md) the channel sum is one matrix product
//   M[x, xx] = sum_c f1[c, y, x] * f2[c, r, xx]
// over a tile of TX output columns [x0, x0+TX) and the window of f2 columns
// [x0-md, x0+TX+md) clipped to the image (at FlowNetC's W = 32 the row
// itself), and the K taps of the row are M's band, out[iy*K+ix, y, x] =
// M[x, x + ix*s2 - md] / C. The TPU extracts the band with a second, one-hot
// product; here each accumulator fragment knows its (x, xx), so the band is
// picked out of the registers.
// - mma.sync on the tensor cores, with the channels as the contracted
//   dimension: m16n8k8 TF32 in three passes for fp32 operands (a*b =
//   a_hi*b_hi + a_lo*b_hi + a_hi*b_lo, hi = v with the 13 bits a TF32
//   product ignores cleared, lo = the exact rest, cleared the same way;
//   split as the fragments are loaded, three masks and a subtraction; the
//   counterpart of the TPU's precision=HIGHEST), m16n8k16 bf16 for bf16
//   operands (products exact); fp32 sums.
// - A block takes RY output rows y0 + j*s2 of one residue mod s2 and walks
//   the f2 rows they meet once (steps m, f2 row y0 - md + m*s2; row j takes
//   it at displacement row m - j), so each f2 row staged in shared memory
//   serves every output row that reaches it, and the block's f1 rows are
//   staged once for all its steps. This is what cuts the L2 traffic of the
//   CUDA-core kernel (each (y, iy) pair read its own f1 and f2 rows).
//   Blocks split a row group's steps to fill the card.
// - The steps are a pipeline: consumer warps multiply a stage's staged f2
//   rows while producer warps load the next stage's into the other buffer,
//   one barrier a stage. A stage holds as many steps as shared memory
//   allows (up to 8: every step of a small-C PWC level; one at FlowNetC's
//   fp32 shape), since each stage costs the producers a round trip to L2 of
//   a few microseconds. Without the pipeline the kernel waited on its
//   loads and its products in turn (ablations on the card, PERF.md).
// - Where s2 is even and divides md, a column meets only columns of its own
//   parity: output and window columns are stored parity class by class and
//   each class is its own 16-row product, which skips the zero off-diagonal
//   blocks. Each consumer warp owns one m16 tile of output columns, one
//   output row and NTW n8 tiles of the window, the tiles that hold its
//   band; its inner loop has no branch.
// - Shared memory holds 32-bit words (one fp32 channel, or two bf16
//   channels, the lower one in the low half, as the fragments want them),
//   channel-major with an XOR swizzle of the column, so every fragment load
//   of a warp hits 32 banks.
// - The band goes through shared memory (a tile for each of two steps)
//   and leaves as K rows of TX coalesced values per output row; a tap
//   outside the image, and a whole displacement row outside it, is written
//   as zero. No atomics: each block owns its output rows, and the sums are
//   deterministic.
// - A window too wide for shared memory with all channels resident takes
//   fewer rows, then channel chunks (f1 then goes through the pipeline too).
//   Displacements wider than 8 consumer warps can cover (md > 20 at s2 = 1)
//   are refused.
//
// What bounds it on the H100: at FlowNetC's shape (B=8, C=256, 32x32, md 20,
// s2 2) the in-image work is 0.84 GFLOP of multiply-adds against 31 MB of
// unique bytes in fp32 (16 MB in bf16). On the fp32 pipes that would be
// 12.5 us; the parity-blocked product is about 0.95 GFLOP a pass, 2.8 GFLOP
// in three TF32 passes, 5.7 us at 495 TFLOP/s, so on the tensor cores the
// bound is the bytes: 9.3 us (fp32), 4.7 us (bf16).

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;           // output columns per block: two m16 tiles
constexpr int NTW = 2;           // n8 window tiles a consumer warp holds
constexpr int kWarps = 16;       // a block: consumer and producer warps
constexpr int kMaxConsumers = 8;
constexpr int kPB = 16;          // words a staging lane loads before it stores any
constexpr size_t kMaxSmem = 227 * 1024;
// the launcher's choices: RY output rows a block (fewer when the window
// needs more warps or shared memory), and blocks enough, by splitting a row
// group's steps, for about one an SM
constexpr int kRowsPreferred = 4;
constexpr int kBlocksTarget = 128;
constexpr int kMaxStepsPerStage = 8;

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// fp32 operands (TF32 products) or bf16 ones, and the channels a 32-bit
// word of shared memory holds
template <typename T>
struct Op {
  static constexpr bool f32 = std::is_same<T, float>::value;
  static constexpr int per_word = f32 ? 1 : 2;
};

// Staging loads the word of channels [c, c + per_word) at offset `off` of
// a column (channels `plane` apart): zero past C or when !in. The raw
// values land in zeroed registers under a predicate, and are packed into a
// word only when they are stored, so that a lane's loads are all in flight
// before any of them is waited for. Offsets are 32-bit within one batch
// element (the launcher checks C * H * W < 2^31).
template <typename T>
struct Raw {
  uint32_t lo = 0u, hi = 0u;
  __device__ __forceinline__ void load(const T* base, int off, int c, int plane, int C,
                                       bool in) {
    if constexpr (Op<T>::f32) {
      if (in && c < C) lo = __float_as_uint(base[off + c * plane]);
    } else {
      const unsigned short* q = reinterpret_cast<const unsigned short*>(base);
      if (in && c < C) lo = q[off + c * plane];
      if (in && c + 1 < C) hi = q[off + (c + 1) * plane];
    }
  }
  __device__ __forceinline__ uint32_t word() const {
    return Op<T>::f32 ? lo : lo | (hi << 16);
  }
};

// A lane's items i = q * cw + r, nwarps apart: (q, r) of the next one.
struct Walk {
  int dq, dr, cw;
  __device__ __forceinline__ Walk(int nwarps, int cw_) : dq(nwarps / cw_), dr(nwarps % cw_),
                                                         cw(cw_) {}
  __device__ __forceinline__ void next(int& q, int& r) const {
    r += dr;
    q += dq;
    if (r >= cw) {
      r -= cw;
      ++q;
    }
  }
};

// column s of word row r in a row of shared memory (rows a multiple of 32
// words long): the XOR spreads a fragment's 4 word rows over 4 bank octets
__device__ __forceinline__ int sw(int r, int s) { return s ^ ((r & 3) << 3); }

// an fp32 word as two TF32 pieces: hi, v with the 13 low bits of its
// mantissa cleared (the bits a TF32 product reads), and lo, the exact rest
// cleared the same way; hi*b_hi + hi*b_lo + lo*b_hi is the product to about
// 2^-20 of its size
__device__ __forceinline__ void split_tf32(uint32_t w, uint32_t& hi, uint32_t& lo) {
  hi = w & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(w) - __uint_as_float(hi)) & 0xffffe000u;
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

// A launch's geometry, the same for all its threads.
struct Geo {
  int C, H, W, md, s2, K;
  int cw;      // word rows staged at a time (a multiple of 8)
  int nchunk;  // chunks of cw word rows that cover the channels
  int kcls;    // window slots of a parity class (a multiple of 8)
  int ks2;     // words of a staged f2 row (a multiple of 32)
  int ry, ng;  // output rows a block; groups of NTW window tiles
  int nc;      // consumer warps, 2 * ry * ng; the rest of kWarps produce
  int gs;      // steps a stage (1 when the channels come in chunks)
};

// Word rows [w0, w0+cw) of the f2 rows `row`, row + s2*W, ... (nrows of
// them, consecutive steps) at the window's column slots into
// dst[q][r][ks2], by warps [wfirst, wfirst+nwarps): one warp a word row,
// lane l at slot l + 32 * group. Each lane issues its kPB loads before it
// stores any of them.
template <typename T, int S>
__device__ __forceinline__ void stage_f2(uint32_t* dst, const T* row, int nrows,
                                         const Geo& g, int w0, int klo, int kw, int wfirst,
                                         int nwarps, int warp, int lane) {
  constexpr int per = Op<T>::per_word;
  const int pw = warp - wfirst;
  const int plane = g.H * g.W, rstep = g.s2 * g.W;
  const int total = nrows * g.cw;
  const Walk walk(nwarps, g.cw);
  for (int s0 = 0; s0 < S * g.kcls; s0 += 32) {
    const int slot = s0 + lane;
    const int p = S == 2 ? (slot >= g.kcls) : 0;   // the slot's class
    const int k = (slot - p * g.kcls) * S + p;     // its window column
    const bool ok = slot < S * g.kcls && k < kw;
    const int col = klo + (ok ? k : 0);
    for (int i0 = pw; i0 < total; i0 += kPB * nwarps) {
      const int q0 = i0 / g.cw, r0 = i0 - q0 * g.cw;
      Raw<T> v[kPB];
      int q = q0, r = r0;
#pragma unroll
      for (int u = 0; u < kPB; ++u) {
        v[u].load(row, q * rstep + col, (w0 + r) * per, plane, g.C, ok && q < nrows);
        walk.next(q, r);
      }
      q = q0;
      r = r0;
#pragma unroll
      for (int u = 0; u < kPB; ++u) {
        if (q < nrows) dst[(q * g.cw + r) * g.ks2 + sw(r, slot)] = v[u].word();
        walk.next(q, r);
      }
    }
  }
}

// The block's f1 rows y0 + j*s2 (j < rows), word rows [w0, w0+cw), columns
// [x0, x0+TX) into dst[j][r][TX], by warps [wfirst, wfirst+nwarps); column
// x0 + n at its class slot: with two classes, even columns in slots [0, 16)
// and odd ones in [16, 32).
template <typename T, int S>
__device__ __forceinline__ void stage_f1(uint32_t* dst, const T* f1b, const Geo& g, int w0,
                                         int y0, int rows, int x0, int wfirst, int nwarps,
                                         int warp, int lane) {
  constexpr int per = Op<T>::per_word;
  const int pw = warp - wfirst;
  const int x = x0 + lane;
  const bool ok = x < g.W;
  const int plane = g.H * g.W, rstep = g.s2 * g.W;
  const int col = y0 * g.W + (ok ? x : 0);
  const int slot = S == 2 ? ((lane & 1) << 4) | (lane >> 1) : lane;
  const int total = rows * g.cw;
  const Walk walk(nwarps, g.cw);
  for (int i0 = pw; i0 < total; i0 += kPB * nwarps) {
    const int j0 = i0 / g.cw, r0 = i0 - j0 * g.cw;
    Raw<T> v[kPB];
    int j = j0, r = r0;
#pragma unroll
    for (int u = 0; u < kPB; ++u) {
      v[u].load(f1b, j * rstep + col, (w0 + r) * per, plane, g.C, ok && j < rows);
      walk.next(j, r);
    }
    j = j0;
    r = r0;
#pragma unroll
    for (int u = 0; u < kPB; ++u) {
      if (j < rows) dst[(j * g.cw + r) * TX + sw(r, slot)] = v[u].word();
      walk.next(j, r);
    }
  }
}

// Grid: (column tiles, row groups, batch x step splits). Row group q holds
// rows y0 + j*s2, j < RY, y0 = q % s2 + (q / s2) * RY * s2; split z % nsplit
// of the group's steps. Warps [0, nc) consume: warp (t, j, grp)
// multiplies m16 tile t of the output columns of row j by its band's window
// tiles [grp*NTW, grp*NTW + NTW). Warps [nc, kWarps) produce: they stage the
// next stage's rows into the other buffer while the consumers multiply.
template <typename T, int S>
__global__ void __launch_bounds__(kWarps * 32, 1)
corr_fwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2, T* __restrict__ out,
                Geo g, int nsplit) {
  const int C = g.C, H = g.H, W = g.W, md = g.md, s2 = g.s2, K = g.K, RY = g.ry;
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y % s2 + (blockIdx.y / s2) * RY * s2;
  const int b = blockIdx.z / nsplit;
  const int split = blockIdx.z % nsplit;
  const int rows = y0 < H ? min(RY, (H - 1 - y0) / s2 + 1) : 0;
  if (rows == 0) return;
  const int nsteps = K + rows - 1;                 // steps with an output row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t plane = (size_t)H * W;
  const size_t kplane = (size_t)K * plane;         // one displacement row of out
  const int x = x0 + lane;

  // a step's output rows: K rows of TX values for each of its rows j, zero
  // where the tap lies outside the image or the whole f2 row does
  auto flush = [&](int m, const float* o, bool zero) {
    if (x >= W) return;
    const int jlo = max(0, m - K + 1), jhi = min(rows - 1, m);
    for (int jj = jlo; jj <= jhi; ++jj) {
      T* dst = out + (size_t)b * K * kplane + (size_t)(m - jj) * kplane +
               (size_t)(y0 + jj * s2) * W + x;
      for (int ix = warp; ix < K; ix += kWarps) {
        const int xx = x + ix * s2 - md;
        const float v = zero || xx < 0 || xx >= W ? 0.f : o[(jj * K + ix) * TX + lane];
        dst[(size_t)ix * plane] = from_f32<T>(v);
      }
    }
  };

  // the steps whose f2 row r2 = y0 - md + m*s2 lies in the image, [v_lo,
  // v_hi), are split evenly among the group's blocks, and so are the others,
  // whose rows are zero
  const int v_lo = min(nsteps, md > y0 ? (md - y0 + s2 - 1) / s2 : 0);
  const int v_hi = max(v_lo, min(nsteps, (H - 1 - y0 + md) / s2 + 1));
  const int nz = nsteps - (v_hi - v_lo);
  for (int q = split * nz / nsplit; q < (split + 1) * nz / nsplit; ++q)
    flush(q < v_lo ? q : q - v_lo + v_hi, nullptr, true);
  const int mv_lo = v_lo + split * (v_hi - v_lo) / nsplit;
  const int mv_hi = v_lo + (split + 1) * (v_hi - v_lo) / nsplit;
  if (mv_lo >= mv_hi) return;                      // the same for the whole block

  const T* f1b = f1 + (size_t)b * C * plane;
  const T* f2b = f2 + (size_t)b * C * plane;
  const int klo = max(0, x0 - md);                 // the window [klo, klo+kw)
  const int kw = min(W, x0 + TX + md) - klo;
  const int nb1 = g.nchunk > 1 ? 2 : 1;            // f1 buffers
  const int G = g.gs;
  const int f2buf = G * g.cw * g.ks2, obuf = G * RY * K * TX;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* f1s = smem;                            // [nb1][RY][cw][TX]
  uint32_t* f2s = f1s + nb1 * RY * g.cw * TX;      // [2][G][cw][ks2]
  float* outs = reinterpret_cast<float*>(f2s + 2 * f2buf);   // [2][G][RY][K][TX]

  // the consumer's unit: output slot n of tile t is column x0 + (i0 + n)*S + p,
  // window slot k' of class p is column klo + k'*S + p
  const bool consumer = warp < g.nc;
  const int gq = lane >> 2, tq = lane & 3;
  const int t = warp & 1, j = (warp >> 1) % RY, grp = (warp >> 1) / RY;
  const int p = S == 2 ? t : 0, i0 = S == 2 ? 0 : 16 * t;
  const int off = (x0 - klo) / S;                  // output i meets slot i + off + d
  const int dlo = -md / S, dhi = ((K - 1) * s2 - md) / S;
  const int ncls = (kw - p + S - 1) / S;           // window columns of class p
  const int lo = max(0, i0 + off + dlo), hi = min(ncls, i0 + 15 + off + dhi + 1);
  const int base = lo & ~7;
  const int nt = hi > lo ? (hi - base + 7) / 8 : 0;
  const int nt0 = grp * NTW;
  const bool unit = consumer && j < rows && nt0 < nt;
  // fragment columns, swizzled (rows kk + tq and kk + tq + 4 have r & 3 =
  // tq); a tile past the band reads the first one's (its products are not
  // used), so that the loop has no branch
  const int xr = tq << 3;
  const int sa0 = (16 * t + gq) ^ xr, sa1 = (16 * t + gq + 8) ^ xr;
  int sb[NTW];
  // where each fragment entry goes in the band tile, or -1: entry (row
  // gq + 8*(i>>1), column 2tq + (i&1)) is output slot i0 + row and window
  // slot base + 8*tile + column
  int bt[NTW][4];
#pragma unroll
  for (int u = 0; u < NTW; ++u) {
    const bool in = nt0 + u < nt;
    sb[u] = (p * g.kcls + base + (nt0 + (in ? u : 0)) * 8 + gq) ^ xr;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kc = base + (nt0 + u) * 8 + 2 * tq + (i & 1);
      const int xo = (i0 + gq + 8 * (i >> 1)) * S + p;   // x - x0
      const int d = klo + kc * S + p - x0 - xo + md;     // dx + md
      bt[u][i] = in && kc < ncls && d >= 0 && d % s2 == 0 && d / s2 < K
                     ? (j * K + d / s2) * TX + xo
                     : -1;
    }
  }
  const float fc = (float)C;
  float acc[NTW][4], c1[NTW][4], c2[NTW][4];
#pragma unroll
  for (int u = 0; u < NTW; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[u][i] = c1[u][i] = c2[u][i] = 0.f;

  // stage s: steps [m0, m0 + nm) at channel chunk ch; G steps a stage, or
  // one step a chunk when the channels come in chunks. The prologue stages
  // stage 0 with every warp.
  auto stage_of = [&](int st, int& m0, int& nm, int& ch) {
    if (g.nchunk == 1) {
      m0 = mv_lo + st * G;
      nm = min(G, mv_hi - m0);
      ch = 0;
    } else {
      m0 = mv_lo + st / g.nchunk;
      nm = 1;
      ch = st % g.nchunk;
    }
  };
  const int nstage = g.nchunk == 1 ? (mv_hi - mv_lo + G - 1) / G : (mv_hi - mv_lo) * g.nchunk;
  {
    int m0, nm, ch;
    stage_of(0, m0, nm, ch);
    stage_f1<T, S>(f1s, f1b, g, 0, y0, rows, x0, 0, kWarps, warp, lane);
    stage_f2<T, S>(f2s, f2b + (size_t)(y0 - md + m0 * s2) * W, nm, g, 0, klo, kw, 0, kWarps,
                   warp, lane);
  }
  __syncthreads();
  for (int st = 0; st < nstage; ++st) {
    int m0, nm, ch;
    stage_of(st, m0, nm, ch);
    const bool last = ch == g.nchunk - 1;
    if (!consumer) {
      if (st + 1 < nstage) {
        int m1, nm1, ch1;
        stage_of(st + 1, m1, nm1, ch1);
        stage_f2<T, S>(f2s + ((st + 1) & 1) * f2buf, f2b + (size_t)(y0 - md + m1 * s2) * W,
                       nm1, g, ch1 * g.cw, klo, kw, g.nc, kWarps - g.nc, warp, lane);
        if (g.nchunk > 1)
          stage_f1<T, S>(f1s + ((st + 1) & 1) * RY * g.cw * TX, f1b, g, ch1 * g.cw, y0, rows,
                         x0, g.nc, kWarps - g.nc, warp, lane);
      }
    } else if (unit) {
      const uint32_t* a = f1s + ((nb1 > 1 ? (st & 1) : 0) * RY + j) * g.cw * TX;
      for (int q = 0; q < nm; ++q) {
        const int m = m0 + q;
        if (j < m - K + 1 || j > m) continue;        // row j has no tap at step m
        const uint32_t* bm = f2s + (st & 1) * f2buf + q * g.cw * g.ks2;
#pragma unroll 4
        for (int kk = 0; kk < g.cw; kk += 8) {
          const uint32_t* ar0 = a + (kk + tq) * TX;
          const uint32_t* ar1 = ar0 + 4 * TX;
          const uint32_t aw[4] = {ar0[sa0], ar0[sa1], ar1[sa0], ar1[sa1]};
          const uint32_t* br0 = bm + (kk + tq) * g.ks2;
          const uint32_t* br1 = br0 + 4 * g.ks2;
          if constexpr (Op<T>::f32) {
            uint32_t ah[4], al[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) split_tf32(aw[i], ah[i], al[i]);
#pragma unroll
            for (int u = 0; u < NTW; ++u) {
              uint32_t bh[2], bl[2];
              split_tf32(br0[sb[u]], bh[0], bl[0]);
              split_tf32(br1[sb[u]], bh[1], bl[1]);
              mma_tf32(acc[u], ah, bh);
              mma_tf32(c1[u], al, bh);
              mma_tf32(c2[u], ah, bl);
            }
          } else {
#pragma unroll
            for (int u = 0; u < NTW; ++u) {
              const uint32_t bw[2] = {br0[sb[u]], br1[sb[u]]};
              mma_bf16(acc[u], aw, bw);
            }
          }
        }
        if (last) {
          float* o = outs + (st & 1) * obuf + q * RY * K * TX;
#pragma unroll
          for (int u = 0; u < NTW; ++u)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (bt[u][i] >= 0) o[bt[u][i]] = (acc[u][i] + (c1[u][i] + c2[u][i])) / fc;
              acc[u][i] = c1[u][i] = c2[u][i] = 0.f;
            }
        }
      }
    }
    __syncthreads();
    // the band tiles are double-buffered by stage, so the next stage's
    // products may start while this stage's rows are written
    if (last)
      for (int q = 0; q < nm; ++q)
        flush(m0 + q, outs + (st & 1) * obuf + q * RY * K * TX, false);
  }
}

size_t smem_words(int ry, int cw, int nb1, int ks2, int K, int gs) {
  return (size_t)nb1 * ry * cw * TX +
         (size_t)gs * (2 * (size_t)cw * ks2 + 2 * (size_t)ry * K * TX);
}

// Rows and channel chunk: the most rows (up to kRowsPreferred) whose
// consumers fit and that hold every channel in shared memory, else one row
// and the largest chunk that fits (f1 then double-buffered too).
template <typename T, int S>
int launch(const void* f1, const void* f2, void* out, int B, int C, int H, int W, int md,
           int s2, int K, cudaStream_t s) {
  Geo g;
  g.C = C; g.H = H; g.W = W; g.md = md; g.s2 = s2; g.K = K;
  const int kw_max = W < TX + 2 * md ? W : TX + 2 * md;   // the widest window
  g.kcls = ((kw_max + S - 1) / S + 7) / 8 * 8;
  g.ks2 = (S * g.kcls + 31) / 32 * 32;
  // n8 tiles of a tile's band: 16 outputs, the displacements' span, and
  // one more where its first slot is not on a tile boundary
  const int span = ((K - 1) * s2) / S;
  int nt_max = (16 + span + 7) / 8 + 1;
  if (nt_max > g.kcls / 8) nt_max = g.kcls / 8;
  g.ng = (nt_max + NTW - 1) / NTW;
  if (2 * g.ng > kMaxConsumers) return (int)cudaErrorInvalidConfiguration;
  const int words = (C + Op<T>::per_word - 1) / Op<T>::per_word;
  const int cw_all = (words + 7) / 8 * 8;
  const size_t budget = kMaxSmem / 4;
  g.ry = 0;
  for (int ry = kRowsPreferred; ry >= 1; ry /= 2) {
    if (2 * ry * g.ng <= kMaxConsumers && smem_words(ry, cw_all, 1, g.ks2, K, 1) <= budget) {
      g.ry = ry;
      g.cw = cw_all;
      break;
    }
  }
  int nb1 = 1;
  if (g.ry == 0) {
    g.ry = 1;
    nb1 = 2;
    const size_t fixed = 2 * (size_t)K * TX;
    g.cw = budget > fixed ? (int)((budget - fixed) / (2 * TX + 2 * g.ks2)) / 8 * 8 : 0;
    if (g.cw < 8) return (int)cudaErrorInvalidConfiguration;
  }
  g.nchunk = (cw_all + g.cw - 1) / g.cw;
  g.nc = 2 * g.ry * g.ng;
  // as many steps a stage as shared memory holds, each stage one round
  // trip to L2 for the producers (up to kMaxStepsPerStage)
  g.gs = 1;
  if (g.nchunk == 1) {
    while (g.gs < kMaxStepsPerStage &&
           smem_words(g.ry, g.cw, nb1, g.ks2, K, g.gs + 1) <= budget)
      ++g.gs;
  }
  const long long n_rg = (long long)s2 * (((H + s2 - 1) / s2 + g.ry - 1) / g.ry);
  const long long n_ct = (W + TX - 1) / TX;
  const long long blocks = n_ct * n_rg * B;
  int nsplit = (int)((kBlocksTarget + blocks - 1) / blocks);
  const int nsteps = K + g.ry - 1;
  if (nsplit > nsteps) nsplit = nsteps;
  if (nsplit < 1) nsplit = 1;
  if (n_rg > 65535 || (long long)B * nsplit > 65535 || n_ct > 2147483647LL ||
      (long long)C * H * W > 2147483647LL)
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem = smem_words(g.ry, g.cw, nb1, g.ks2, K, g.gs) * 4;
  auto kernel = corr_fwd_kernel<T, S>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)n_ct, (unsigned)n_rg, (unsigned)(B * nsplit));
  kernel<<<grid, kWarps * 32, smem, s>>>(static_cast<const T*>(f1),
                                         static_cast<const T*>(f2), static_cast<T*>(out), g,
                                         nsplit);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_classes(const void* f1, const void* f2, void* out, int B, int C, int H, int W,
                   int md, int s2, int K, cudaStream_t s) {
  if (s2 % 2 == 0 && md % 2 == 0)
    return launch<T, 2>(f1, f2, out, B, C, H, W, md, s2, K, s);
  return launch<T, 1>(f1, f2, out, B, C, H, W, md, s2, K, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. f1, f2: [B, C, H, W] contiguous; out:
// [B, K*K, H, W] contiguous, same type. Launches on `stream`; allocates
// nothing and does not synchronise. Returns cudaGetLastError().
extern "C" int tpureg_correlation_fwd(const void* f1, const void* f2, void* out, int dtype,
                                      int B, int C, int H, int W, int md, int s2,
                                      void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || md < 0 || s2 <= 0)
    return (int)cudaErrorInvalidValue;
  const int K = 2 * (md / s2) + 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_classes<float>(f1, f2, out, B, C, H, W, md, s2, K, s);
  if (dtype == 1)
    return launch_classes<__nv_bfloat16>(f1, f2, out, B, C, H, W, md, s2, K, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tpureg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
