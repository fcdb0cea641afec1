// Fused LayerNorm + 1x1 head on [V, C] rows: out = LN(x) @ W + b, C -> N.
//
// Replaces skoots_tpu/kernels/lnhead.py::_ln_head_call (body `_kernel`).
// Same numerics: LN statistics in f32 (eps 1e-6), the affine result rounded
// to the storage type T, the matmul accumulated in f32 and rounded to T, then
// the bias added and rounded once more. The LayerNorm runs in the plain
// version's order with IEEE-rounded, unfused steps, so its rounded result
// equals kernels/lnhead.py::ln_head_ref's bit for bit, and so does every
// kernel's output.
//
// What bounds it on the H100: read C and write N values per voxel (128 B at
// C = N = 32 in bf16: 0.24 ms for the 6.3 M rows of a 256^2 x 96 tile)
// against C*N products -- a memory-bound pass, as long as the products do
// not run on the FP32 pipe: 2*C*N FP32 instructions a row (12.9 G at the
// main shape, 0.39 ms) would already exceed the bytes' time.
//
// Widths: JAX's fused head takes every C % 8 == 0 up to 256 and any N, and
// so does every kernel here; `skoots_ln_head_route` names the one a launch
// takes.
//
// bf16, C = 16, 32, 64, 128 with N <= 128 (the main path,
// `ln_head_tc_kernel<C, NT>`): the products on the tensor cores (mma.sync
// m16n8k16, bf16 operands, f32 accumulation; the products of bf16 values
// are exact in f32, so only the order of the f32 sum differs from the plain
// version's in-order dot, and the sums whose bf16 rounding that order could
// change are recomputed in order: the kernel equals the plain version bit
// for bit; see ln_head_tc_kernel). A persistent grid of 8-warp blocks (4 at
// C = 128); each warp walks 32-row tiles on its own, the next one loading by
// 16-byte cp.async into the other slot of its ring, normalises a tile in
// place a lane a row (layer_norm_row: warp_layer_norm_any's arithmetic
// without its shuffles) and takes the A fragments of each 16-row half from
// there by ldmatrix. W, zero-padded to whole n16 column groups, is loaded
// into padded shared memory once a block and read by ldmatrix.trans (C = N
// = 32: four x4 loads a half; held in registers it took the registers the
// recompute's bound needs). The epilogue rounds, adds the bias, rounds,
// stages the rows through shared memory and stores 16-byte rows.
//
// bf16, everything else (`ln_head_class_kernel<CMAX, 8>`): the same design
// with C a run-time value in a width class C <= CMAX = 32, 64, 128, 256 and
// N in chunks of 64 columns: a row of the grid a chunk, whose blocks load
// its W (and W^T) once and walk the row tiles, so shared memory holds C x
// 64 of W at any N (C = N = 256: 4 chunks, 225 KB with 4 warps). The k-steps cover
// C padded to 16 with zeros in the rows' and W's padding (exact: zero
// products); the LayerNorm divides by the true C. Its recompute test is
// exact at every C (below).
//
// The recompute's bound, re-derived for every C. The in-order f32 sum of C
// exact products errs by at most (C - 1) u sum|p| (u = 2^-24); one m16n8k16
// (16 exact products and the accumulator aligned and truncated to >= 24
// bits, then rounded) by at most 35 u of the magnitudes so far, and the
// tensor cores take KS = ceil(C / 16) of them. So the two sums differ by at
// most (C - 1 + 35 KS) u |h| @ |W|; ERR = (C + 36 KS) u covers that and the
// rounding of |h| @ |W| itself and of ERR * mag (C = 8: 44 u -- the
// templates' 4 C u, 32 u there, holds only from C = 16 -- C = 48: 156 u,
// C = 256: 832 u). The in-order sum lies within err = ERR |h| @ |W| of the
// tensor cores' sum. The output y(s) = bf16(bf16(s) + b) is monotonic in
// the sum s, so where y(sum - err), rounded down, equals y(sum + err),
// rounded up, both orders give the same output; any other sum is
// recomputed in ln_head_ref's order (the bound grows with C, and so does
// the share: below 2% + C / 640 of the sums with unit-scale rows and
// weights in the CPU statement, tests/test_torch_wide.py).
//
// f32 (`ln_head_f32_kernel`, only the card-vs-CPU f32 check runs it): C a
// run-time value, 32 rows a block normalised a warp a row
// (common.cuh::warp_layer_norm_any), W in shared memory as f32 in chunks of
// at most 128 KB of columns, a thread 4 rows x 4 columns: 16 independent dot
// products as unfused FP32 steps in the plain version's order (a chunk
// splits no output's sum; the rows read 4 k at a time), so it equals
// ln_head_ref bit for bit. The tensor
// cores would round f32 operands to TF32, which is not the function.
#include <stdio.h>
#include <string.h>

#include <type_traits>

#include "common.cuh"

namespace {

// ---- bf16 on the tensor cores ----------------------------------------------

using bf16 = __nv_bfloat16;

// C input channels; NT n8 output tiles (N <= 8 NT)
template <int C, int NT>
struct Head {
  static constexpr int WARPS = C == 128 ? 4 : 8;  // C = N = 128: 171 KB
  static constexpr int THREADS = WARPS * 32;
  static constexpr int STAGES = 2;         // 32-row tiles in a warp's ring
  static constexpr int KS = C / 16;        // k-steps
  static constexpr int NG = (NT + 1) / 2;  // n16 groups (one ldmatrix.x4.trans)
  // a lane's 4 NT sums of a 16-row half as bits
  using Flags = std::conditional_t<NT <= 8, uint32_t, unsigned long long>;
  // |tensor-core sum - in-order sum| <= ERR * (|h| @ |W|): the in-order
  // f32 sum errs by at most (C - 1) u sum|p| (u = 2^-24), one m16n8k16
  // (products exact, the 16 and the accumulator aligned and truncated to
  // >= 24 bits, then rounded) by at most 35 u of the sums so far, C / 16 of
  // them; 4 C u covers both with a margin (C = 32: 101 u of 128 u)
  static constexpr float ERR = 4.0f * C / 16777216.0f;
  // padded row strides (elements): 16-byte rows at an odd multiple of 16
  // bytes apart, so the 8 rows of an ldmatrix, or 8 lanes' rows, fall in
  // distinct banks
  static constexpr int WS = NG * 16 + 8;   // W [C][WS]
  static constexpr int TS = C + 8;         // W^T [8 NT][TS] (the recompute's rows)
  static constexpr int XS = C + 8;         // a 32-row tile of x, then of LN(x)
  static constexpr int OS = 8 * NT + 8;    // a warp's output rows [16][OS]
  static constexpr int SLOT = 32 * XS * 2;
  static constexpr int OFF_T = C * WS * 2;
  static constexpr int OFF_V = OFF_T + 8 * NT * TS * 2;          // ls, lb [C], b [8 NT]
  static constexpr int OFF_X = OFF_V + (2 * C + 8 * NT) * 4;     // [WARPS][STAGES] slots
  static constexpr int OFF_O = OFF_X + WARPS * STAGES * SLOT;    // [WARPS][16][OS]
  static constexpr int OFF_L = OFF_O + WARPS * 16 * OS * 2;      // [WARPS][16 * 8 NT]
  static constexpr int SMEM = OFF_L + WARPS * 16 * 8 * NT * 2;
};

__device__ __forceinline__ int popcount(uint32_t v) { return __popc(v); }
__device__ __forceinline__ int popcount(unsigned long long v) { return __popcll(v); }
__device__ __forceinline__ int lowest_bit(uint32_t v) { return __ffs(v) - 1; }
__device__ __forceinline__ int lowest_bit(unsigned long long v) { return __ffsll(v) - 1; }

// rows row0 ... row0 + 31 of x into a warp's slot (zeros past V)
template <int C, int XS>
__device__ __forceinline__ void load32(bf16* xs, const bf16* x, long long row0, long long V) {
  for (int i = threadIdx.x & 31; i < 32 * (C / 8); i += 32) {
    const int r = i / (C / 8), j = i % (C / 8);
    const long long g = row0 + r;
    cp_async16(xs + r * XS + j * 8, x + (g < V ? g : 0) * C + j * 8, g < V ? 16 : 0);
  }
}

// 8 bf16 values from 16 bytes of shared memory
__device__ __forceinline__ void load8_bf16(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[2 * e] = __uint_as_float(w[e] << 16);
    v[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}

// common.cuh::warp_fold_sum's tree over the 32 partial sums s[l] (l the lane
// there) in one thread: s[i] + s[i + 16], then + 8, ... -- the same
// additions in the same order
template <int W>
__device__ __forceinline__ void fold_step(float (&s)[32]) {
#pragma unroll
  for (int i = 0; i < W; ++i) s[i] = __fadd_rn(s[i], s[i + W]);
}
__device__ __forceinline__ float fold32(float (&s)[32]) {
  fold_step<16>(s);
  fold_step<8>(s);
  fold_step<4>(s);
  fold_step<2>(s);
  fold_step<1>(s);
  return s[0];
}

// common.cuh::warp_layer_norm_any of one row held by one thread, in place (C
// bf16 values): the partial sums of column i, i + 32, ... in the same order,
// the same fold, the same IEEE steps, so the result is that function's bit
// for bit -- with none of the warp-wide form's shuffles and selects (one
// of each a row and fold level, and a shuffle a row for each statistic)
template <int C>
__device__ __forceinline__ void layer_norm_row(bf16* row, const float* ls, const float* lb,
                                               float eps) {
  float s[32];
  // C = 16: the partial sums of columns 16-31 are the plain fold's zero pad
#pragma unroll
  for (int i = C; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int j = 0; j < C / 8; ++j) {
    float v[8];
    load8_bf16(row + 8 * j, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = (8 * j + e) & 31;
      s[i] = j < 4 ? v[e] : __fadd_rn(s[i], v[e]);
    }
  }
  const float mu = __fdiv_rn(fold32(s), (float)C);
#pragma unroll
  for (int i = C; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int j = 0; j < C / 8; ++j) {
    float v[8];
    load8_bf16(row + 8 * j, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = (8 * j + e) & 31;
      const float d = __fsub_rn(v[e], mu);
      s[i] = j < 4 ? __fmul_rn(d, d) : __fadd_rn(s[i], __fmul_rn(d, d));
    }
  }
  const float var = __fdiv_rn(fold32(s), (float)C);
  const float inv = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
#pragma unroll
  for (int j = 0; j < C / 8; ++j) {
    float v[8];
    load8_bf16(row + 8 * j, v);
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + 2 * e;
      o[e] = pack_bf16x2(
          __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[2 * e], mu), inv), ls[c]), lb[c]),
          __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[2 * e + 1], mu), inv), ls[c + 1]), lb[c + 1]));
    }
    *reinterpret_cast<uint4*>(row + 8 * j) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// The products run on the tensor cores, which sum them in another order
// than ln_head_ref's in-order f32 dot; rounding that sum to bf16 and adding
// the bias can then differ by a bf16 ulp of the sum, two of an output whose
// bias add crossed into a lower binade. So the kernel stays exact: a second
// product |h| @ |W| bounds both sums' rounding errors (Head::ERR), and a sum
// with a bf16 rounding midpoint within that bound of it, or zero within
// 1024 times it (beyond, the bound is below a quarter of the sum's bf16
// ulp), is recomputed in ln_head_ref's order from the rows and W^T in
// shared memory: about 1 in 20 at C = 32, shared among the warp's lanes.
// Warps walk their 32-row tiles independently (a ring of STAGES slots
// each, filled by cp.async), so no warp waits for another's recomputes.
template <int C, int NT>
__global__ void __launch_bounds__(Head<C, NT>::THREADS)
ln_head_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ ls,
                  const float* __restrict__ lb, const bf16* __restrict__ w,
                  const float* __restrict__ b, bf16* __restrict__ out, long long V,
                  int N, float eps) {
  using K = Head<C, NT>;
  using Flags = typename K::Flags;
  constexpr uint32_t ABS2 = 0x7fff7fffu;  // |.| of a bf16 pair
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem);
  bf16* wts = reinterpret_cast<bf16*>(smem + K::OFF_T);
  float* lss = reinterpret_cast<float*>(smem + K::OFF_V);
  float* lbs = lss + C;
  float* bs = lbs + C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const long long tiles = (V + 31) / 32;               // 32-row tiles
  const long long step = (long long)gridDim.x * K::WARPS;
  long long tile = (long long)blockIdx.x * K::WARPS + warp;
  bf16* ring = reinterpret_cast<bf16*>(smem + K::OFF_X) + warp * K::STAGES * 32 * K::XS;
  for (int s = 0; s < K::STAGES - 1; ++s) {
    const long long t = tile + s * step;
    if (t < tiles) load32<C, K::XS>(ring + s * 32 * K::XS, x, t * 32, V);
    cp_async_commit();
  }
  // W zero-padded to NG * 16 columns, W^T; the parameters rounded to bf16,
  // as the Pallas kernel receives them
  for (int i = tid; i < C * K::NG * 16; i += K::THREADS) {
    const int k = i / (K::NG * 16), n = i % (K::NG * 16);
    const bf16 v = n < N ? w[k * N + n] : __float2bfloat16_rn(0.f);
    ws[k * K::WS + n] = v;
    if (n < 8 * NT) wts[n * K::TS + k] = v;
  }
  for (int i = tid; i < C; i += K::THREADS) {
    lss[i] = rnd<bf16>(ls[i]);
    lbs[i] = rnd<bf16>(lb[i]);
  }
  for (int i = tid; i < 8 * NT; i += K::THREADS) bs[i] = i < N ? rnd<bf16>(b[i]) : 0.f;
  __syncthreads();

  // ldmatrix.trans lane addresses: row (k) lane % 8 (+8 for matrices 1 and
  // 3), column (n) +8 for matrices 2 and 3
  const int kr = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int nc = (lane >> 4) * 8;
  // this lane's sums of a 16-row half (bit 4 n + i: row g + 8 (i / 2),
  // column 8 n + 2 q + i % 2) that lie in the first N columns
  Flags in_n = 0;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (n * 8 + 2 * q + (i & 1) < N) in_n |= (Flags)1 << (4 * n + i);
  constexpr Flags LO_ROWS = (Flags)0x3333333333333333ull;  // i < 2: row g

  bf16* os = reinterpret_cast<bf16*>(smem + K::OFF_O) + warp * 16 * K::OS;
  unsigned short* flagged = reinterpret_cast<unsigned short*>(smem + K::OFF_L) + warp * 16 * 8 * NT;
  for (int it = 0; tile < tiles; ++it, tile += step) {
    // this tile has landed, and every lane is done with the slot the
    // prefetch below overwrites (the previous tile's)
    cp_async_wait_group<K::STAGES - 2>();
    __syncwarp();
    const long long pre = tile + (K::STAGES - 1) * step;
    if (pre < tiles)
      load32<C, K::XS>(ring + ((it + K::STAGES - 1) % K::STAGES) * 32 * K::XS, x, pre * 32, V);
    cp_async_commit();
    bf16* xs = ring + (it % K::STAGES) * 32 * K::XS;
    // a lane a row (rows past V are cp.async's zeros: finite, never stored)
    layer_norm_row<C>(xs + lane * K::XS, lss, lbs, eps);
    __syncwarp();

#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      const bf16* hs = xs + 16 * half * K::XS;
      const long long row0 = tile * 32 + 16 * half;
      uint32_t a[K::KS][4];
#pragma unroll
      for (int ks = 0; ks < K::KS; ++ks)
        ldmatrix_x4(a[ks], hs + (lane & 15) * K::XS + ks * 16 + (lane >> 4) * 8);
      // acc = h @ W, mag = |h| @ |W|
      float acc[NT][4], mag[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][i] = mag[n][i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < K::KS; ++ks) {
        const uint32_t aa[4] = {a[ks][0] & ABS2, a[ks][1] & ABS2, a[ks][2] & ABS2,
                                a[ks][3] & ABS2};
#pragma unroll
        for (int p = 0; p < K::NG; ++p) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, ws + (ks * 16 + kr) * K::WS + p * 16 + nc);
          mma_bf16_16816(acc[2 * p], a[ks], bb[0], bb[1]);
          mma_bf16_16816(mag[2 * p], aa, bb[0] & ABS2, bb[1] & ABS2);
          if (2 * p + 1 < NT) {
            mma_bf16_16816(acc[2 * p + 1], a[ks], bb[2], bb[3]);
            mma_bf16_16816(mag[2 * p + 1], aa, bb[2] & ABS2, bb[3] & ABS2);
          }
        }
      }

      // y = round(round(acc) + b) -> os; flag the sums to recompute
      Flags flags = 0;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int c = n * 8 + 2 * q;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(os + (g + 8 * h) * K::OS + c) = pack_bf16x2(
              rnd<bf16>(acc[n][2 * h]) + bs[c], rnd<bf16>(acc[n][2 * h + 1]) + bs[c + 1]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float sum = acc[n][i], err = K::ERR * mag[n][i];
          // the bf16 rounding midpoint above sum's truncation to bf16
          const float mid = __uint_as_float((__float_as_uint(sum) & 0xffff0000u) | 0x8000u);
          if (fabsf(sum - mid) <= err || fabsf(sum) <= 1024.f * err)
            flags |= (Flags)1 << (4 * n + i);
        }
      }
      flags &= in_n & ((row0 + g < V ? LO_ROWS : 0) | (row0 + g + 8 < V ? ~LO_ROWS : 0));
      // the warp's flagged sums as one list: an exclusive scan of the counts
      const int cnt = popcount(flags);
      int incl = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const int total = __shfl_sync(0xffffffffu, incl, 31);
      if (total > 0) {
        for (int pos = incl - cnt; flags; flags &= flags - 1, ++pos) {
          const int bit = lowest_bit(flags);
          const int r = g + 8 * ((bit & 3) >> 1), c = (bit >> 2) * 8 + 2 * q + (bit & 1);
          flagged[pos] = (unsigned short)(r << 8 | c);
        }
        __syncwarp();  // the list and every lane's os values are in place
        for (int t = lane; t < total; t += 32) {
          const int r = flagged[t] >> 8, c = flagged[t] & 0xff;
          float sum = 0.f;  // + the first product: exact
#pragma unroll
          for (int j = 0; j < C / 8; ++j) {
            float hv[8], wv[8];
            load8_bf16(hs + r * K::XS + 8 * j, hv);
            load8_bf16(wts + c * K::TS + 8 * j, wv);
#pragma unroll
            for (int e = 0; e < 8; ++e) sum = __fadd_rn(sum, __fmul_rn(hv[e], wv[e]));
          }
          os[r * K::OS + c] = __float2bfloat16_rn(rnd<bf16>(sum) + bs[c]);
        }
      }
      __syncwarp();
      // 16-byte rows where N is a multiple of 8, else single values
      for (int i = lane; i < 16 * NT; i += 32) {
        const int r = i / NT, j = i % NT;
        const long long row = row0 + r;
        if (row >= V || j * 8 >= N) continue;
        const bf16* src = os + r * K::OS + j * 8;
        bf16* dst = out + row * N + j * 8;
        if (N % 8 == 0) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e = 0; e < 8 && j * 8 + e < N; ++e) dst[e] = src[e];
        }
      }
      __syncwarp();  // os and the list serve the next half
    }
  }
}

template <int C, int NT>
int launch_tc(const void* x, const float* ls, const float* lb, const void* w,
              const float* b, void* out, long long V, int N, float eps, cudaStream_t s) {
  using K = Head<C, NT>;
  long long grid = 0;
  const int e = persistent_grid(ln_head_tc_kernel<C, NT>, K::THREADS, K::SMEM,
                                ((V + 31) / 32 + K::WARPS - 1) / K::WARPS, &grid);
  if (e) return e;
  ln_head_tc_kernel<C, NT><<<(unsigned)grid, K::THREADS, K::SMEM, s>>>(
      static_cast<const bf16*>(x), ls, lb, static_cast<const bf16*>(w), b,
      static_cast<bf16*>(out), V, N, eps);
  return (int)cudaGetLastError();
}

// the templates' n8 tiles for N outputs (0: N > 128, past the templates)
int nt_of(int N) {
  return N <= 8 ? 1 : N <= 16 ? 2 : N <= 32 ? 4 : N <= 64 ? 8 : N <= 128 ? 16 : 0;
}

template <int C>
int dispatch_n(const void* x, const float* ls, const float* lb, const void* w,
               const float* b, void* out, long long V, int N, float eps, cudaStream_t s) {
  switch (nt_of(N)) {
    case 1: return launch_tc<C, 1>(x, ls, lb, w, b, out, V, N, eps, s);
    case 2: return launch_tc<C, 2>(x, ls, lb, w, b, out, V, N, eps, s);
    case 4: return launch_tc<C, 4>(x, ls, lb, w, b, out, V, N, eps, s);
    case 8: return launch_tc<C, 8>(x, ls, lb, w, b, out, V, N, eps, s);
    case 16: return launch_tc<C, 16>(x, ls, lb, w, b, out, V, N, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ---- bf16, every other width and N on the tensor cores -------------------------

// The run-time layout of `ln_head_class_kernel` (bytes; strides in elements)
struct HeadLayout {
  int C, Cp, N;
  int xs, ws, ts, os;  // x / LN rows [32][xs], W chunk [Cp][ws], W^T [64][ts], out [16][os]
  int off_t, off_v, off_x, off_o, off_l, smem;
  float err;  // ERR of the recompute's bound
};

template <int CMAX, int NT>
struct HeadClass {
  static constexpr int WARPS = CMAX >= 128 ? 4 : 8;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int STAGES = 2;      // 32-row tiles in a warp's ring
  static constexpr int NG = NT / 2;     // n16 groups of a chunk
  static constexpr int NW = 8 * NT;     // columns a chunk
  static constexpr int KSM = CMAX / 16; // k-steps, at most
  using Flags = std::conditional_t<NT <= 8, uint32_t, unsigned long long>;

  static HeadLayout layout(int C, int N) {
    HeadLayout L;
    L.C = C;
    L.Cp = (C + 15) / 16 * 16;
    L.N = N;
    // 16-byte rows an odd multiple of 16 bytes apart
    L.xs = L.Cp + 8;
    L.ws = NW + 8;
    L.ts = L.Cp + 8;
    L.os = NW + 8;
    L.off_t = L.Cp * L.ws * 2;
    L.off_v = L.off_t + NW * L.ts * 2;              // ls, lb [Cp], b [NW]
    L.off_x = L.off_v + (2 * L.Cp + NW) * 4;        // [WARPS][STAGES] 32-row slots
    L.off_o = L.off_x + WARPS * STAGES * 32 * L.xs * 2;
    L.off_l = L.off_o + WARPS * 16 * L.os * 2;      // a warp's flagged sums
    L.smem = L.off_l + WARPS * 16 * NW * 2;
    L.err = (float)(C + 36 * (L.Cp / 16)) / 16777216.0f;
    return L;
  }
};

// rows row0 ... row0 + 31 of x into a warp's slot, Cp / 8 16-byte pieces a
// row: zeros past V and in columns C ... Cp - 1
__device__ __forceinline__ void load32_rt(bf16* xs, const bf16* x, long long row0, long long V,
                                          int C, int Cp, int XS) {
  const int p = Cp / 8;
  for (int i = threadIdx.x & 31; i < 32 * p; i += 32) {
    const int r = i / p, j = i - r * p;
    const long long g = row0 + r;
    const bool in = g < V && 8 * j < C;
    cp_async16(xs + r * XS + j * 8, x + (in ? g * C + j * 8 : 0), in ? 16 : 0);
  }
}

// layer_norm_row at a run-time C <= CMAX: the 32-column blocks past C are
// the plain fold's zero pad, added as it adds them
template <int CMAX>
__device__ __forceinline__ void layer_norm_row_rt(bf16* row, const float* ls, const float* lb,
                                                  float eps, int C) {
  const int C32 = (C + 31) / 32 * 32;
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int j = 0; j < CMAX / 8; ++j) {
    if (8 * j < C32) {
      float v[8];
      if (8 * j < C) {
        load8_bf16(row + 8 * j, v);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = (8 * j + e) & 31;
        s[i] = j < 4 ? v[e] : __fadd_rn(s[i], v[e]);
      }
    }
  }
  const float mu = __fdiv_rn(fold32(s), (float)C);
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int j = 0; j < CMAX / 8; ++j) {
    if (8 * j < C32) {
      float v[8];
      if (8 * j < C) {
        load8_bf16(row + 8 * j, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = __fsub_rn(v[e], mu);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = (8 * j + e) & 31;
        s[i] = j < 4 ? __fmul_rn(v[e], v[e]) : __fadd_rn(s[i], __fmul_rn(v[e], v[e]));
      }
    }
  }
  const float var = __fdiv_rn(fold32(s), (float)C);
  const float inv = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
#pragma unroll
  for (int j = 0; j < CMAX / 8; ++j) {
    if (8 * j < C) {
      float v[8];
      load8_bf16(row + 8 * j, v);
      uint32_t o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * e;
        o[e] = pack_bf16x2(
            __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[2 * e], mu), inv), ls[c]), lb[c]),
            __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[2 * e + 1], mu), inv), ls[c + 1]),
                      lb[c + 1]));
      }
      *reinterpret_cast<uint4*>(row + 8 * j) = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

__device__ __forceinline__ unsigned short bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// ln_head_tc_kernel's design at a run-time C and any N, N in chunks of
// 8 NT columns (see the source header for the recompute's test)
template <int CMAX, int NT>
__global__ void __launch_bounds__(HeadClass<CMAX, NT>::THREADS)
ln_head_class_kernel(const bf16* __restrict__ x, const float* __restrict__ ls,
                     const float* __restrict__ lb, const bf16* __restrict__ w,
                     const float* __restrict__ b, bf16* __restrict__ out, long long V,
                     float eps, const HeadLayout L) {
  using K = HeadClass<CMAX, NT>;
  using Flags = typename K::Flags;
  constexpr uint32_t ABS2 = 0x7fff7fffu;  // |.| of a bf16 pair
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = L.C, N = L.N, KS = L.Cp / 16;
  bf16* ws = reinterpret_cast<bf16*>(smem);
  bf16* wts = reinterpret_cast<bf16*>(smem + L.off_t);
  float* lss = reinterpret_cast<float*>(smem + L.off_v);
  float* lbs = lss + L.Cp;
  float* bs = lbs + L.Cp;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const long long tiles = (V + 31) / 32;  // 32-row tiles
  const long long step = (long long)gridDim.x * K::WARPS;
  bf16* ring = reinterpret_cast<bf16*>(smem + L.off_x) + warp * K::STAGES * 32 * L.xs;
  bf16* os = reinterpret_cast<bf16*>(smem + L.off_o) + warp * 16 * L.os;
  unsigned short* flagged = reinterpret_cast<unsigned short*>(smem + L.off_l) + warp * 16 * K::NW;
  // the parameters rounded to bf16, as the Pallas kernel receives them
  for (int i = tid; i < C; i += K::THREADS) {
    lss[i] = rnd<bf16>(ls[i]);
    lbs[i] = rnd<bf16>(lb[i]);
  }
  const int kr = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int nc = (lane >> 4) * 8;
  constexpr Flags LO_ROWS = (Flags)0x3333333333333333ull;  // i < 2: row g

  {
    const int n0 = blockIdx.y * K::NW;   // the block's chunk of the N columns
    const int ncw = min(K::NW, N - n0);  // its columns
    const int ntv = (ncw + 7) / 8;       // its n8 tiles
    // the chunk of W zero-padded to Cp rows and NW columns, and W^T
    for (int i = tid; i < L.Cp * K::NW; i += K::THREADS) {
      const int k = i / K::NW, n = i - k * K::NW;
      const bf16 v = k < C && n < ncw ? w[(long long)k * N + n0 + n] : __float2bfloat16_rn(0.f);
      ws[k * L.ws + n] = v;
      wts[n * L.ts + k] = v;
    }
    for (int i = tid; i < K::NW; i += K::THREADS) bs[i] = i < ncw ? rnd<bf16>(b[n0 + i]) : 0.f;
    __syncthreads();

    long long tile = (long long)blockIdx.x * K::WARPS + warp;
    for (int s = 0; s < K::STAGES - 1; ++s) {
      const long long t = tile + s * step;
      if (t < tiles) load32_rt(ring + s * 32 * L.xs, x, t * 32, V, C, L.Cp, L.xs);
      cp_async_commit();
    }
    // this lane's sums of a 16-row half (bit 4 n + i: row g + 8 (i / 2),
    // column 8 n + 2 q + i % 2) that lie in the chunk's columns
    Flags in_n = 0;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (n * 8 + 2 * q + (i & 1) < ncw) in_n |= (Flags)1 << (4 * n + i);

    for (int it = 0; tile < tiles; ++it, tile += step) {
      // this tile has landed, and every lane is done with the slot the
      // prefetch below overwrites (the previous tile's)
      cp_async_wait_group<K::STAGES - 2>();
      __syncwarp();
      const long long pre = tile + (K::STAGES - 1) * step;
      if (pre < tiles)
        load32_rt(ring + ((it + K::STAGES - 1) % K::STAGES) * 32 * L.xs, x, pre * 32, V, C,
                  L.Cp, L.xs);
      cp_async_commit();
      bf16* xs = ring + (it % K::STAGES) * 32 * L.xs;
      // a lane a row (rows past V are cp.async's zeros: finite, never stored)
      layer_norm_row_rt<CMAX>(xs + lane * L.xs, lss, lbs, eps, C);
      __syncwarp();

#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        const bf16* hs = xs + 16 * half * L.xs;
        const long long row0 = tile * 32 + 16 * half;
        // acc = h @ W, mag = |h| @ |W|
        float acc[NT][4], mag[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[n][i] = mag[n][i] = 0.f;
#pragma unroll
        for (int ks = 0; ks < K::KSM; ++ks) {
          if (ks < KS) {
            uint32_t a[4];
            ldmatrix_x4(a, hs + (lane & 15) * L.xs + ks * 16 + (lane >> 4) * 8);
            const uint32_t aa[4] = {a[0] & ABS2, a[1] & ABS2, a[2] & ABS2, a[3] & ABS2};
#pragma unroll
            for (int p = 0; p < K::NG; ++p) {
              if (2 * p < ntv) {
                uint32_t bb[4];
                ldmatrix_x4_trans(bb, ws + (ks * 16 + kr) * L.ws + p * 16 + nc);
                mma_bf16_16816(acc[2 * p], a, bb[0], bb[1]);
                mma_bf16_16816(mag[2 * p], aa, bb[0] & ABS2, bb[1] & ABS2);
                if (2 * p + 1 < ntv) {
                  mma_bf16_16816(acc[2 * p + 1], a, bb[2], bb[3]);
                  mma_bf16_16816(mag[2 * p + 1], aa, bb[2] & ABS2, bb[3] & ABS2);
                }
              }
            }
          }
        }

        // y = round(round(acc) + b) -> os; flag the sums to recompute
        Flags flags = 0;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (n < ntv) {
            const int c = n * 8 + 2 * q;
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<uint32_t*>(os + (g + 8 * h) * L.os + c) = pack_bf16x2(
                  rnd<bf16>(acc[n][2 * h]) + bs[c], rnd<bf16>(acc[n][2 * h + 1]) + bs[c + 1]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float sum = acc[n][i], err = L.err * mag[n][i], bc = bs[c + (i & 1)];
              if (bf16_bits(rnd<bf16>(__fsub_rd(sum, err)) + bc) !=
                  bf16_bits(rnd<bf16>(__fadd_ru(sum, err)) + bc))
                flags |= (Flags)1 << (4 * n + i);
            }
          }
        }
        flags &= in_n & ((row0 + g < V ? LO_ROWS : 0) | (row0 + g + 8 < V ? ~LO_ROWS : 0));
        // the warp's flagged sums as one list: an exclusive scan of the counts
        const int cnt = popcount(flags);
        int incl = cnt;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += v;
        }
        const int total = __shfl_sync(0xffffffffu, incl, 31);
        if (total > 0) {
          for (int pos = incl - cnt; flags; flags &= flags - 1, ++pos) {
            const int bit = lowest_bit(flags);
            const int r = g + 8 * ((bit & 3) >> 1), c = (bit >> 2) * 8 + 2 * q + (bit & 1);
            flagged[pos] = (unsigned short)(r << 8 | c);
          }
          __syncwarp();  // the list and every lane's os values are in place
          for (int t = lane; t < total; t += 32) {
            const int r = flagged[t] >> 8, c = flagged[t] & 0xff;
            float sum = 0.f;  // + the first product: exact
            for (int j = 0; j < C / 8; ++j) {
              float hv[8], wv[8];
              load8_bf16(hs + r * L.xs + 8 * j, hv);
              load8_bf16(wts + c * L.ts + 8 * j, wv);
#pragma unroll
              for (int e = 0; e < 8; ++e) sum = __fadd_rn(sum, __fmul_rn(hv[e], wv[e]));
            }
            os[r * L.os + c] = __float2bfloat16_rn(rnd<bf16>(sum) + bs[c]);
          }
        }
        __syncwarp();
        // 16-byte rows where N is a multiple of 8, else single values
        for (int i = lane; i < 16 * ntv; i += 32) {
          const int r = i / ntv, j = i - r * ntv;
          const long long row = row0 + r;
          if (row >= V) continue;
          const bf16* src = os + r * L.os + j * 8;
          bf16* dst = out + row * N + n0 + j * 8;
          if (N % 8 == 0) {
            *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
          } else {
            for (int e = 0; e < 8 && j * 8 + e < ncw; ++e) dst[e] = src[e];
          }
        }
        __syncwarp();  // os and the list serve the next half
      }
    }
  }
}

template <int CMAX>
int launch_class(const void* x, const float* ls, const float* lb, const void* w,
                 const float* b, void* out, long long V, int C, int N, float eps,
                 cudaStream_t s) {
  using K = HeadClass<CMAX, 8>;
  const HeadLayout L = K::layout(C, N);
  if (L.smem > SMEM_OPTIN) return (int)cudaErrorInvalidValue;
  // a grid row of persistent blocks a chunk, the rows shared out so the
  // card holds all of them at once
  const int chunks = (N + K::NW - 1) / K::NW;
  long long cap = 0;
  const int e = persistent_grid(ln_head_class_kernel<CMAX, 8>, K::THREADS, L.smem,
                                1LL << 40, &cap);
  if (e) return e;
  const long long blocks = ((V + 31) / 32 + K::WARPS - 1) / K::WARPS;
  const long long per_chunk = cap / chunks > 1 ? cap / chunks : 1;
  const dim3 grid((unsigned)(blocks < per_chunk ? blocks : per_chunk), (unsigned)chunks);
  ln_head_class_kernel<CMAX, 8><<<grid, K::THREADS, L.smem, s>>>(
      static_cast<const bf16*>(x), ls, lb, static_cast<const bf16*>(w), b,
      static_cast<bf16*>(out), V, eps, L);
  return (int)cudaGetLastError();
}

// ---- f32: FP32 steps in the plain order ------------------------------------------

constexpr int F_ROWS = 32;          // rows a block
constexpr int F_THREADS = 256;
constexpr int F_W_BYTES = 131072;   // W's chunk in shared memory, at most

// the columns of W's chunk: all N where C x N f32 fit, else the most that
// do, a multiple of 4
int f32_chunk(int C, int N) {
  const int most = F_W_BYTES / (4 * C) / 4 * 4;
  const int n4 = (N + 3) / 4 * 4;
  return n4 < most ? n4 : most;
}

__global__ void __launch_bounds__(F_THREADS)
ln_head_f32_kernel(const float* __restrict__ x, const float* __restrict__ ls,
                   const float* __restrict__ lb, const float* __restrict__ w,
                   const float* __restrict__ b, float* __restrict__ out, long long V, int C,
                   int N, int NC, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);  // [C][NC]
  float* hs = ws + C * NC;                     // [F_ROWS][C]
  const long long row0 = (long long)blockIdx.x * F_ROWS;
  const int tid = threadIdx.x;
  for (int r = tid >> 5; r < F_ROWS; r += F_THREADS / 32) {
    const long long g = row0 + r;
    warp_layer_norm_any<float>(x + (g < V ? g : 0) * C, g < V, ls, lb, eps, C, hs + r * C);
  }
  for (int n0 = 0; n0 < N; n0 += NC) {
    const int ncw = min(NC, N - n0);
    __syncthreads();  // the rows are in place; every thread is done with W's last chunk
    for (int i = tid; i < C * NC; i += F_THREADS) {
      const int k = i / NC, n = i - k * NC;
      ws[i] = n < ncw ? w[(long long)k * N + n0 + n] : 0.f;
    }
    __syncthreads();
    // a thread 4 rows x 4 columns: 16 dot products, each in k order
    const int groups = (ncw + 3) / 4;
    for (int item = tid; item < (F_ROWS / 4) * groups; item += F_THREADS) {
      const int r0 = item / groups * 4, c0 = item % groups * 4;
      float acc[4][4];  // the first products: exact
      const float4 w0 = *reinterpret_cast<const float4*>(ws + c0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float h = hs[(r0 + i) * C];
        acc[i][0] = __fmul_rn(h, w0.x);
        acc[i][1] = __fmul_rn(h, w0.y);
        acc[i][2] = __fmul_rn(h, w0.z);
        acc[i][3] = __fmul_rn(h, w0.w);
      }
      // k = 1 ... C - 1 in order; the rows' values 4 k at a time
      // (float4s, broadcast across the warp), W's a row at a time
      auto step = [&](int k, const float (&h)[4]) {
        const float4 wv = *reinterpret_cast<const float4*>(ws + k * NC + c0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = __fadd_rn(acc[i][0], __fmul_rn(h[i], wv.x));
          acc[i][1] = __fadd_rn(acc[i][1], __fmul_rn(h[i], wv.y));
          acc[i][2] = __fadd_rn(acc[i][2], __fmul_rn(h[i], wv.z));
          acc[i][3] = __fadd_rn(acc[i][3], __fmul_rn(h[i], wv.w));
        }
      };
      for (int k = 1; k < 4; ++k) {
        const float h[4] = {hs[r0 * C + k], hs[(r0 + 1) * C + k], hs[(r0 + 2) * C + k],
                            hs[(r0 + 3) * C + k]};
        step(k, h);
      }
#pragma unroll 2
      for (int k = 4; k < C; k += 4) {
        float4 h4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) h4[i] = *reinterpret_cast<const float4*>(hs + (r0 + i) * C + k);
        const float h0[4] = {h4[0].x, h4[1].x, h4[2].x, h4[3].x};
        const float h1[4] = {h4[0].y, h4[1].y, h4[2].y, h4[3].y};
        const float h2[4] = {h4[0].z, h4[1].z, h4[2].z, h4[3].z};
        const float h3[4] = {h4[0].w, h4[1].w, h4[2].w, h4[3].w};
        step(k, h0);
        step(k + 1, h1);
        step(k + 2, h2);
        step(k + 3, h3);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long g = row0 + r0 + i;
        if (g >= V) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + j < ncw) out[g * N + n0 + c0 + j] = __fadd_rn(acc[i][j], b[n0 + c0 + j]);
      }
    }
  }
}

int launch_f32(const void* x, const float* ls, const float* lb, const void* w,
               const float* b, void* out, long long V, int C, int N, float eps,
               cudaStream_t s) {
  const int nc = f32_chunk(C, N);
  const int smem = (C * nc + F_ROWS * C) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(ln_head_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (V + F_ROWS - 1) / F_ROWS;
  ln_head_f32_kernel<<<(unsigned)blocks, F_THREADS, smem, s>>>(
      static_cast<const float*>(x), ls, lb, static_cast<const float*>(w), b,
      static_cast<float*>(out), V, C, N, nc, eps);
  return (int)cudaGetLastError();
}

// The kernel a launch at (dtype, C, N) takes, by name ("" where none takes
// the operands): the one decision the entry point and the route query share
const char* head_route(int dtype, int C, int N) {
  static char name[64];
  const int nt = nt_of(N);
  if (N < 1 || C < 8 || C > 256 || C % 8 != 0 || (dtype != SKOOTS_F32 && dtype != SKOOTS_BF16))
    name[0] = 0;
  else if (dtype == SKOOTS_F32)
    snprintf(name, sizeof name, "ln_head_f32_kernel");
  else if ((C == 16 || C == 32 || C == 64 || C == 128) && nt)
    snprintf(name, sizeof name, "ln_head_tc_kernel<%d,%d>", C, nt);
  else
    snprintf(name, sizeof name, "ln_head_class_kernel<%d,8>",
             C <= 32 ? 32 : C <= 64 ? 64 : C <= 128 ? 128 : 256);
  return name;
}

}  // namespace

// x: [V, C] of `dtype` (C % 8 == 0, 8 <= C <= 256; 16-byte aligned: the
// bf16 tensor-core kernels copy 16-byte rows); w: [C, N] of `dtype` (any
// N >= 1); ln_scale, ln_bias: f32 [C]; b: f32 [N] (the kernels round
// the three to `dtype`); out: [V, N] of `dtype`.
extern "C" int skoots_ln_head(int dtype, const void* x, const void* ln_scale,
                              const void* ln_bias, const void* w,
                              const void* b, void* out, long long V, int C,
                              int N, float eps, void* stream) {
  const char* route = head_route(dtype, C, N);
  if (!route[0]) return (int)cudaErrorInvalidValue;
  if (V == 0) return 0;
  const float* ls = static_cast<const float*>(ln_scale);
  const float* lb = static_cast<const float*>(ln_bias);
  const float* fb = static_cast<const float*>(b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == SKOOTS_F32) return launch_f32(x, ls, lb, w, fb, out, V, C, N, eps, s);
  if (!strncmp(route, "ln_head_tc_kernel", 17)) {
    switch (C) {
      case 16: return dispatch_n<16>(x, ls, lb, w, fb, out, V, N, eps, s);
      case 32: return dispatch_n<32>(x, ls, lb, w, fb, out, V, N, eps, s);
      case 64: return dispatch_n<64>(x, ls, lb, w, fb, out, V, N, eps, s);
      default: return dispatch_n<128>(x, ls, lb, w, fb, out, V, N, eps, s);
    }
  }
  if (C <= 32) return launch_class<32>(x, ls, lb, w, fb, out, V, C, N, eps, s);
  if (C <= 64) return launch_class<64>(x, ls, lb, w, fb, out, V, C, N, eps, s);
  if (C <= 128) return launch_class<128>(x, ls, lb, w, fb, out, V, C, N, eps, s);
  return launch_class<256>(x, ls, lb, w, fb, out, V, C, N, eps, s);
}

// The kernel skoots_ln_head takes at (dtype, C, N), by name
// ("ln_head_tc_kernel<32,4>", "ln_head_class_kernel<64,8>",
// "ln_head_f32_kernel"), or null where it refuses the operands.
extern "C" const char* skoots_ln_head_route(int dtype, int C, int N) {
  const char* route = head_route(dtype, C, N);
  return route[0] ? route : nullptr;
}
