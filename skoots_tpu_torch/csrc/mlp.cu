// Fused ConvNeXt block tail on [V, C] rows (channels-last voxels):
//     out = shortcut + gamma * (pw2(GELU_erf(pw1(LN(x))))),   C -> 4C -> C.
//
// Replaces skoots_tpu/kernels/mlp.py::_mlp_call (body `_kernel`). Same
// rounding points to the storage type T (bf16 on the main path): after the
// LayerNorm affine, after each matmul (f32 accumulation), after each bias
// add, after GELU, after the layer-scale multiply and after the residual add.
// GELU uses erff (the Pallas kernel's A&S polynomial differs by <= 1.5e-7).
//
// What bounds it on the H100: the [V, 4C] hidden activation never leaves
// the SM, so traffic is 6*C bytes per voxel at bf16 (read x and shortcut,
// write out); the two GEMMs are 8*C^2 FMAs per voxel, and the epilogues
// (LayerNorm, 4C erf-GELUs and 5 roundings per hidden value) run on the
// FP32 pipe. At C = 32 the erf epilogue, not the products or the bytes, is
// expected to set the pace.
//
// Widths: JAX's fused tail takes every C % 8 == 0 up to 256. The
// tensor-core template runs C = 16, 32, 64 and 128 at bf16, the f32
// template 32, 64 and 128; every other width, either type, runs
// `tail_any_kernel` (below).
//
// bf16 (the main path, `tail_tc_kernel`): both GEMMs on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 accumulation: the products of bf16
// values are exact, so this is the same arithmetic as the FP32 FMAs in
// another summation order). A persistent grid of 4-8 warp blocks walks row
// tiles of 16 rows a warp; w1 and w2 sit in shared memory once a block
// (C = 128: 256 KB do not fit, so 128-hidden-column chunks of both stream
// through a ring of two buffers; C = 16: one chunk of all 64), padded so `ldmatrix` reads them without
// bank conflicts. Row tiles of x and the shortcut arrive by cp.async,
// double-buffered. A warp normalises its 16 rows at once (`layer_norm16`:
// common.cuh::warp_layer_norm's arithmetic, its fold as one reduce-scatter
// of the same butterfly, 16 shuffles for 16 rows instead of 80) and goes
// through shared memory once, into GEMM1's A fragments. GEMM1 runs 16
// hidden columns at a time, one step ahead of its epilogue so the products
// overlap the FP32 work; the epilogue stays in registers, and the two
// rounded n8 tiles, packed to bf16 pairs, are directly GEMM2's A fragment
// for that k-step, so the hidden activation never touches shared memory.
// GEMM2's [16, C] sums stay in registers across the chunks; the final
// epilogue stages y through shared memory and stores 16-byte rows.
//
// f32 (`tail_f32_kernel`, only the card-vs-CPU f32 check runs it): scalar
// FP32 FMAs, a block of 32 rows, the hidden chunk through shared memory.
// The tensor cores would round f32 operands to TF32, which is not the
// function.
#include "common.cuh"

namespace {

constexpr int T_ROWS = 32;
constexpr int THREADS = 256;
constexpr int HC = 128;  // hidden columns per chunk

template <typename T>
__device__ __forceinline__ void load8(const T* p, float* v);
template <>
__device__ __forceinline__ void load8<float>(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <typename T>
__device__ __forceinline__ void load4(const T* p, float* v) {
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = to_f32<T>(p[i]);
}

template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
tail_f32_kernel(const T* __restrict__ x, const T* __restrict__ sc,
                const float* __restrict__ ls, const float* __restrict__ lb,
                const T* __restrict__ w1, const float* __restrict__ b1,
                const T* __restrict__ w2, const float* __restrict__ b2,
                const float* __restrict__ gamma, T* __restrict__ out,
                long long V, float eps) {
  constexpr int H = 4 * C;
  constexpr int RM = C / 32;  // GEMM2 rows per thread
  __shared__ float hs[T_ROWS][C];
  __shared__ float as[T_ROWS][HC];
  const long long row0 = (long long)blockIdx.x * T_ROWS;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;

  for (int r = warp; r < T_ROWS; r += THREADS / 32) {
    const long long g = row0 + r;
    warp_layer_norm<T, C>(x + (g < V ? g : 0) * C, g < V, ls, lb, eps, hs[r]);
  }
  __syncthreads();

  // GEMM1 tile: 2 rows x 8 hidden columns per thread
  const int g1c = (tid % 16) * 8;
  const int g1r = (tid / 16) * 2;
  // GEMM2 tile: RM rows x 4 output columns per thread
  const int g2c = (tid % (C / 4)) * 4;
  const int g2r = (tid / (C / 4)) * RM;
  float acc2[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc2[i][j] = 0.f;

  for (int j0 = 0; j0 < H; j0 += HC) {
    float acc1[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc1[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < C; ++k) {
      float wv[8];
      load8<T>(w1 + (long long)k * H + j0 + g1c, wv);
      const float h0 = hs[g1r][k], h1 = hs[g1r + 1][k];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc1[0][j] = fmaf(h0, wv[j], acc1[0][j]);
        acc1[1][j] = fmaf(h1, wv[j], acc1[1][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float a = rnd<T>(rnd<T>(acc1[i][j]) + b1[j0 + g1c + j]);
        as[g1r + i][g1c + j] =
            rnd<T>(0.5f * a * (1.0f + erff(a * 0.70710678118654752f)));
      }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < HC; ++k) {
      float wv[4];
      load4<T>(w2 + (long long)(j0 + k) * C + g2c, wv);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float a = as[g2r + i][k];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc2[i][j] = fmaf(a, wv[j], acc2[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const long long g = row0 + g2r + i;
    if (g >= V) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = g2c + j;
      float y = rnd<T>(rnd<T>(acc2[i][j]) + b2[c]);
      y = rnd<T>(y * gamma[c]);
      out[g * C + c] = from_f32<T>(to_f32<T>(sc[g * C + c]) + y);
    }
  }
}

// ---- bf16 on the tensor cores ----------------------------------------------

using bf16 = __nv_bfloat16;

template <int C>
struct Tail {
  static constexpr int H = 4 * C;
  static constexpr int HC = H < 128 ? H : 128;  // hidden columns per chunk
  static constexpr int NCH = H / HC;            // 1, 1, 2, 4
  static constexpr bool STREAM = C == 128;  // w1 + w2 > 227 KB: ring of 2 chunks
  static constexpr int NBUF = STREAM ? 2 : NCH;
  static constexpr int WARPS = C == 128 ? 4 : 8;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int ROWS = WARPS * 16;   // rows of a block tile
  // padded row strides (elements): 16-byte rows at an odd multiple of 16
  // bytes apart, so the 8 rows of an ldmatrix fall in distinct banks
  static constexpr int W1S = HC + 8;        // w1 chunk [C][HC]
  static constexpr int W2S = C + 8;         // w2 chunk [HC][C]
  static constexpr int HS = C + 8;          // a warp's LN output / y [16][C]
  static constexpr int W1_BYTES = C * W1S * 2;
  static constexpr int CHUNK_BYTES = W1_BYTES + HC * W2S * 2;
  static constexpr int TILE_BYTES = ROWS * C * 2;
  static constexpr int OFF_X = NBUF * CHUNK_BYTES;  // x tiles [2][ROWS][C]
  static constexpr int OFF_S = OFF_X + 2 * TILE_BYTES;  // shortcut tiles
  static constexpr int OFF_H = OFF_S + 2 * TILE_BYTES;
  static constexpr int OFF_V = OFF_H + WARPS * 16 * HS * 2;  // b1, b2, gamma
  static constexpr int SMEM = OFF_V + (H + 2 * C) * 4;
};

// chunk `ch` of both weights (hidden columns ch*HC ...) into `buf`
template <int C>
__device__ __forceinline__ void load_chunk(unsigned char* buf, const bf16* w1,
                                           const bf16* w2, int ch) {
  using K = Tail<C>;
  bf16* w1s = reinterpret_cast<bf16*>(buf);
  bf16* w2s = reinterpret_cast<bf16*>(buf + K::W1_BYTES);
  for (int i = threadIdx.x; i < C * (K::HC / 8); i += K::THREADS) {
    const int k = i / (K::HC / 8), j = i % (K::HC / 8);
    cp_async16(w1s + k * K::W1S + j * 8, w1 + (long long)k * K::H + ch * K::HC + j * 8, 16);
  }
  for (int i = threadIdx.x; i < K::HC * (C / 8); i += K::THREADS) {
    const int r = i / (C / 8), j = i % (C / 8);
    cp_async16(w2s + r * K::W2S + j * 8, w2 + (long long)(ch * K::HC + r) * C + j * 8, 16);
  }
}

// rows row0 ... row0 + ROWS - 1 of x and the shortcut (zeros past V)
template <int C>
__device__ __forceinline__ void load_tile(unsigned char* xs, unsigned char* ss,
                                          const bf16* x, const bf16* sc,
                                          long long row0, long long V) {
  using K = Tail<C>;
  bf16* xd = reinterpret_cast<bf16*>(xs);
  bf16* sd = reinterpret_cast<bf16*>(ss);
  for (int i = threadIdx.x; i < K::ROWS * (C / 8); i += K::THREADS) {
    const int r = i / (C / 8), j = i % (C / 8);
    const long long g = row0 + r;
    const long long off = (g < V ? g : 0) * C + j * 8;
    const int bytes = g < V ? 16 : 0;
    cp_async16(xd + r * C + j * 8, x + off, bytes);
    cp_async16(sd + r * C + j * 8, sc + off, bytes);
  }
}

__device__ __forceinline__ float gelu_erf(float a) {
  return 0.5f * a * (1.0f + erff(a * 0.70710678118654752f));
}

// (a, b) rounded to bf16 and back, one conversion for the pair
__device__ __forceinline__ void rnd_pair(float& a, float& b) {
  const float2 f = __bfloat1622float2(__floats2bfloat162_rn(a, b));
  a = f.x;
  b = f.y;
}

// common.cuh::warp_fold_sum of 16 rows at once: s[r] is this lane's
// partial sum of row r. A reduce-scatter over the same butterfly (lane l
// pairs with l ^ 16, then l ^ 8, ...), so every row's total is the same
// tree of the same additions, bit for bit, in 16 shuffles instead of 80.
// Returns the total of row (lane / 2) % 16.
__device__ __forceinline__ float fold_sum16(const float (&s)[16]) {
  const int lane = threadIdx.x & 31;
  float t8[8], t4[4], t2[2];
  bool hi = lane & 16;  // keep rows 8..15, send rows 0..7
#pragma unroll
  for (int j = 0; j < 8; ++j)
    t8[j] = __fadd_rn(hi ? s[8 + j] : s[j], __shfl_xor_sync(0xffffffffu, hi ? s[j] : s[8 + j], 16));
  hi = lane & 8;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    t4[j] = __fadd_rn(hi ? t8[4 + j] : t8[j], __shfl_xor_sync(0xffffffffu, hi ? t8[j] : t8[4 + j], 8));
  hi = lane & 4;
#pragma unroll
  for (int j = 0; j < 2; ++j)
    t2[j] = __fadd_rn(hi ? t4[2 + j] : t4[j], __shfl_xor_sync(0xffffffffu, hi ? t4[j] : t4[2 + j], 4));
  hi = lane & 2;
  const float t1 = __fadd_rn(hi ? t2[1] : t2[0], __shfl_xor_sync(0xffffffffu, hi ? t2[0] : t2[1], 2));
  return __fadd_rn(t1, __shfl_xor_sync(0xffffffffu, t1, 1));
}

// common.cuh::warp_layer_norm of the warp's 16 rows (xs: [16][C], rows
// row0 ... of V; out: [16][HS]), every step the same IEEE operation in
// the same order, so the result is that function's bit for bit. At C = 16
// lanes 16-31 hold zeros, as the plain version pads its fold.
template <int C, int HS>
__device__ __forceinline__ void layer_norm16(const bf16* xs, long long row0, long long V,
                                             const float* __restrict__ ls,
                                             const float* __restrict__ lb, float eps,
                                             bf16* out) {
  constexpr int PER = (C + 31) / 32;
  constexpr bool PAD = C % 32 != 0;
  const int lane = threadIdx.x & 31;
  float v[16][PER], s[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
#pragma unroll
    for (int i = 0; i < PER; ++i)
      v[r][i] = row0 + r < V && (!PAD || lane + 32 * i < C)
                    ? __bfloat162float(xs[r * C + lane + 32 * i]) : 0.f;
    s[r] = v[r][0];
#pragma unroll
    for (int i = 1; i < PER; ++i) s[r] = __fadd_rn(s[r], v[r][i]);
  }
  const float mu_own = __fdiv_rn(fold_sum16(s), (float)C);
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const float mu = __shfl_sync(0xffffffffu, mu_own, 2 * r);
#pragma unroll
    for (int i = 0; i < PER; ++i)
      v[r][i] = !PAD || lane + 32 * i < C ? __fsub_rn(v[r][i], mu) : 0.f;
    s[r] = __fmul_rn(v[r][0], v[r][0]);
#pragma unroll
    for (int i = 1; i < PER; ++i) s[r] = __fadd_rn(s[r], __fmul_rn(v[r][i], v[r][i]));
  }
  const float var = __fdiv_rn(fold_sum16(s), (float)C);
  const float inv_own = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
  float sc[PER], bi[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const bool in = !PAD || lane + 32 * i < C;
    sc[i] = in ? ls[lane + 32 * i] : 0.f;
    bi[i] = in ? lb[lane + 32 * i] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const float inv = __shfl_sync(0xffffffffu, inv_own, 2 * r);
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if (!PAD || lane + 32 * i < C)
        out[r * HS + lane + 32 * i] =
          __float2bfloat16_rn(__fadd_rn(__fmul_rn(__fmul_rn(v[r][i], inv), sc[i]), bi[i]));
  }
}

template <int C>
__global__ void __launch_bounds__(Tail<C>::THREADS)
tail_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ sc,
               const float* __restrict__ ls, const float* __restrict__ lb,
               const bf16* __restrict__ w1, const float* __restrict__ b1,
               const bf16* __restrict__ w2, const float* __restrict__ b2,
               const float* __restrict__ gamma, bf16* __restrict__ out,
               long long V, float eps) {
  using K = Tail<C>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  float* b1s = reinterpret_cast<float*>(smem + K::OFF_V);
  float* b2s = b1s + K::H;
  float* gms = b2s + C;
  for (int i = tid; i < K::H; i += K::THREADS) b1s[i] = b1[i];
  for (int i = tid; i < C; i += K::THREADS) {
    b2s[i] = b2[i];
    gms[i] = gamma[i];
  }
  const long long ntiles = (V + K::ROWS - 1) / K::ROWS;
  long long tile = blockIdx.x;
  if (tile >= ntiles) return;
  if (K::STREAM) {
    load_chunk<C>(smem, w1, w2, 0);
  } else {
    for (int ch = 0; ch < K::NCH; ++ch) load_chunk<C>(smem + ch * K::CHUNK_BYTES, w1, w2, ch);
  }
  load_tile<C>(smem + K::OFF_X, smem + K::OFF_S, x, sc, tile * K::ROWS, V);
  cp_async_commit();

  bf16* hs = reinterpret_cast<bf16*>(smem + K::OFF_H) + warp * 16 * K::HS;
  uint32_t a1[C / 16][4];  // GEMM1's A: the warp's 16 LayerNorm rows
  float acc2[C / 8][4];    // GEMM2's [16, C] sums
  int step = 0;            // chunk steps so far (STREAM: buffer step & 1)
  for (int it = 0; tile < ntiles; ++it, tile += gridDim.x) {
    const int xb = it & 1;
    const bf16* xs = reinterpret_cast<const bf16*>(smem + K::OFF_X + xb * K::TILE_BYTES);
    const bf16* ss = reinterpret_cast<const bf16*>(smem + K::OFF_S + xb * K::TILE_BYTES);
    const long long row0 = tile * K::ROWS + warp * 16;  // the warp's rows
    const long long next = tile + gridDim.x;
    for (int ch = 0; ch < K::NCH; ++ch, ++step) {
      // this step's operands have landed and every warp is done with the
      // buffers the prefetch below overwrites
      cp_async_wait_all();
      __syncthreads();
      if (ch == 0 && next < ntiles)
        load_tile<C>(smem + K::OFF_X + (xb ^ 1) * K::TILE_BYTES,
                     smem + K::OFF_S + (xb ^ 1) * K::TILE_BYTES, x, sc, next * K::ROWS, V);
      if (K::STREAM && (ch + 1 < K::NCH || next < ntiles))
        load_chunk<C>(smem + ((step + 1) & 1) * K::CHUNK_BYTES, w1, w2, (ch + 1) % K::NCH);
      cp_async_commit();
      const unsigned char* wb = smem + (K::STREAM ? (step & 1) : ch) * K::CHUNK_BYTES;
      const bf16* w1s = reinterpret_cast<const bf16*>(wb);
      const bf16* w2s = reinterpret_cast<const bf16*>(wb + K::W1_BYTES);

      if (ch == 0) {
        layer_norm16<C, K::HS>(xs + warp * 16 * C, row0, V, ls, lb, eps, hs);
        __syncwarp();
#pragma unroll
        for (int ks = 0; ks < C / 16; ++ks)
          ldmatrix_x4(a1[ks], hs + (lane & 15) * K::HS + ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int n = 0; n < C / 8; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc2[n][i] = 0.f;
      }

      // ldmatrix.trans lane addresses: row (k) lane % 8 (+8 for matrices 1
      // and 3), column (n) +8 for matrices 2 and 3
      const int kr = (lane & 7) + ((lane >> 3) & 1) * 8;
      const int nc = (lane >> 4) * 8;
      // GEMM1 of 16 hidden columns (n8 tiles 2p, 2p+1)
      auto gemm1 = [&](int p, float (&d)[2][4]) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) d[nt][i] = 0.f;
#pragma unroll
        for (int ks = 0; ks < C / 16; ++ks) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, w1s + (ks * 16 + kr) * K::W1S + p * 16 + nc);
          mma_bf16_16816(d[0], a1[ks], b[0], b[1]);
          mma_bf16_16816(d[1], a1[ks], b[2], b[3]);
        }
      };
      // software-pipelined: the products of columns p + 1 are in flight on
      // the tensor cores while the FP32 pipe runs the epilogue of p
      float d[2][2][4];
      gemm1(0, d[0]);
#pragma unroll
      for (int p = 0; p < K::HC / 16; ++p) {
        if (p + 1 < K::HC / 16) gemm1(p + 1, d[(p + 1) & 1]);
        // GEMM1 epilogue in registers: round, + b1, round, GELU, round;
        // the rounded n8 tiles 2p, 2p+1, packed to bf16 pairs, are GEMM2's
        // A fragment of k-step p
        uint32_t a2[4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 bb =
                *reinterpret_cast<const float2*>(b1s + ch * K::HC + p * 16 + nt * 8 + 2 * q);
            float u = d[p & 1][nt][2 * h], w = d[p & 1][nt][2 * h + 1];
            rnd_pair(u, w);
            u += bb.x;
            w += bb.y;
            rnd_pair(u, w);
            a2[2 * nt + h] = pack_bf16x2(gelu_erf(u), gelu_erf(w));
          }
#pragma unroll
        for (int n2 = 0; n2 < C / 16; ++n2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, w2s + (p * 16 + kr) * K::W2S + n2 * 16 + nc);
          mma_bf16_16816(acc2[2 * n2], a2, b[0], b[1]);
          mma_bf16_16816(acc2[2 * n2 + 1], a2, b[2], b[3]);
        }
      }

      if (ch == K::NCH - 1) {
        // y = round(round(round(acc + b2) * gamma)), exact in bf16 -> hs
        __syncwarp();  // every lane's A fragments are out of hs
#pragma unroll
        for (int n = 0; n < C / 8; ++n) {
          const int c = n * 8 + 2 * q;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float y0 = rnd<bf16>(rnd<bf16>(rnd<bf16>(acc2[n][2 * h]) + b2s[c]) * gms[c]);
            const float y1 =
                rnd<bf16>(rnd<bf16>(rnd<bf16>(acc2[n][2 * h + 1]) + b2s[c + 1]) * gms[c + 1]);
            *reinterpret_cast<uint32_t*>(hs + (g + 8 * h) * K::HS + c) = pack_bf16x2(y0, y1);
          }
        }
        __syncwarp();
        // out = round(shortcut + y), 16-byte rows
        for (int i = lane; i < 16 * (C / 8); i += 32) {
          const int r = i / (C / 8), j = i % (C / 8);
          if (row0 + r >= V) continue;
          const uint4 yv = *reinterpret_cast<const uint4*>(hs + r * K::HS + j * 8);
          const uint4 sv = *reinterpret_cast<const uint4*>(ss + (warp * 16 + r) * C + j * 8);
          const __nv_bfloat162* yh = reinterpret_cast<const __nv_bfloat162*>(&yv);
          const __nv_bfloat162* sh = reinterpret_cast<const __nv_bfloat162*>(&sv);
          uint4 o;
          uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 yf = __bfloat1622float2(yh[e]);
            const float2 sf = __bfloat1622float2(sh[e]);
            ow[e] = pack_bf16x2(sf.x + yf.x, sf.y + yf.y);
          }
          *reinterpret_cast<uint4*>(out + (row0 + r) * C + j * 8) = o;
        }
        __syncwarp();  // hs is the next tile's LayerNorm buffer
      }
    }
  }
}

template <int C>
int launch_tc(const void* x, const void* sc, const float* ls, const float* lb,
              const void* w1, const float* b1, const void* w2, const float* b2,
              const float* gamma, void* out, long long V, float eps, cudaStream_t s) {
  using K = Tail<C>;
  cudaError_t e = cudaFuncSetAttribute(tail_tc_kernel<C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tail_tc_kernel<C>,
                                                         K::THREADS, K::SMEM)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = (V + K::ROWS - 1) / K::ROWS;
  const long long grid = tiles < (long long)sms * per_sm ? tiles : (long long)sms * per_sm;
  tail_tc_kernel<C><<<(unsigned)grid, K::THREADS, K::SMEM, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(sc), ls, lb,
      static_cast<const bf16*>(w1), b1, static_cast<const bf16*>(w2), b2, gamma,
      static_cast<bf16*>(out), V, eps);
  return (int)cudaGetLastError();
}

template <int C>
int launch_f32(const void* x, const void* sc, const float* ls, const float* lb,
               const void* w1, const float* b1, const void* w2, const float* b2,
               const float* gamma, void* out, long long V, float eps, cudaStream_t s) {
  const long long blocks = (V + T_ROWS - 1) / T_ROWS;
  tail_f32_kernel<float, C><<<(unsigned)blocks, THREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(sc), ls, lb,
      static_cast<const float*>(w1), b1, static_cast<const float*>(w2), b2, gamma,
      static_cast<float*>(out), V, eps);
  return (int)cudaGetLastError();
}

// ---- every other width: FP32 FMAs ------------------------------------------
//
// JAX's fused tail takes every C % 8 == 0 up to 256; the templates above
// instantiate 16 (bf16), 32, 64 and 128. Every other width (and either
// type) runs `tail_any_kernel`: C a run-time value, a block of G_ROWS rows,
// the LayerNorm a warp a row (common.cuh::warp_layer_norm_any), GEMM1 into
// the block's whole [G_ROWS, 4C] hidden activation in shared memory (160 KB
// at C = 256), rounded where the plain version rounds, then GEMM2 from
// there. A thread owns one column of G_RG rows, so each weight it reads
// feeds G_RG FMAs; the weights are read through the cache, not staged (at
// C = 256 w1 + w2 are 1 MB at bf16, more than shared memory holds). Sums in
// f32, in k order.
constexpr int G_ROWS = 32;
constexpr int G_RG = 8;  // rows a thread sums

template <typename T>
__global__ void __launch_bounds__(THREADS)
tail_any_kernel(const T* __restrict__ x, const T* __restrict__ sc,
                const float* __restrict__ ls, const float* __restrict__ lb,
                const T* __restrict__ w1, const float* __restrict__ b1,
                const T* __restrict__ w2, const float* __restrict__ b2,
                const float* __restrict__ gamma, T* __restrict__ out, long long V, int C,
                float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = 4 * C;
  float* hs = reinterpret_cast<float*>(smem);  // [G_ROWS][C]
  float* as = hs + G_ROWS * C;                 // [G_ROWS][H]
  const long long row0 = (long long)blockIdx.x * G_ROWS;
  const int tid = threadIdx.x;
  for (int r = tid >> 5; r < G_ROWS; r += THREADS / 32) {
    const long long g = row0 + r;
    warp_layer_norm_any<T>(x + (g < V ? g : 0) * C, g < V, ls, lb, eps, C, hs + r * C);
  }
  __syncthreads();
  for (int i = tid; i < (G_ROWS / G_RG) * H; i += THREADS) {
    const int j = i % H, r0 = (i / H) * G_RG;
    float acc[G_RG];
#pragma unroll
    for (int r = 0; r < G_RG; ++r) acc[r] = 0.f;
    for (int k = 0; k < C; ++k) {
      const float w = to_f32<T>(w1[(long long)k * H + j]);
#pragma unroll
      for (int r = 0; r < G_RG; ++r) acc[r] = fmaf(hs[(r0 + r) * C + k], w, acc[r]);
    }
    const float bj = b1[j];
#pragma unroll
    for (int r = 0; r < G_RG; ++r)
      as[(r0 + r) * H + j] = rnd<T>(gelu_erf(rnd<T>(rnd<T>(acc[r]) + bj)));
  }
  __syncthreads();
  for (int i = tid; i < (G_ROWS / G_RG) * C; i += THREADS) {
    const int c = i % C, r0 = (i / C) * G_RG;
    float acc[G_RG];
#pragma unroll
    for (int r = 0; r < G_RG; ++r) acc[r] = 0.f;
    for (int k = 0; k < H; ++k) {
      const float w = to_f32<T>(w2[(long long)k * C + c]);
#pragma unroll
      for (int r = 0; r < G_RG; ++r) acc[r] = fmaf(as[(r0 + r) * H + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < G_RG; ++r) {
      const long long g = row0 + r0 + r;
      if (g >= V) continue;
      const float y = rnd<T>(rnd<T>(rnd<T>(acc[r]) + b2[c]) * gamma[c]);
      out[g * C + c] = from_f32<T>(to_f32<T>(sc[g * C + c]) + y);
    }
  }
}

template <typename T>
int launch_any_t(const void* x, const void* sc, const float* ls, const float* lb,
                 const void* w1, const float* b1, const void* w2, const float* b2,
                 const float* gamma, void* out, long long V, int C, float eps,
                 cudaStream_t s) {
  const int smem = G_ROWS * 5 * C * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(tail_any_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (V + G_ROWS - 1) / G_ROWS;
  tail_any_kernel<T><<<(unsigned)blocks, THREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(sc), ls, lb, static_cast<const T*>(w1),
      b1, static_cast<const T*>(w2), b2, gamma, static_cast<T*>(out), V, C, eps);
  return (int)cudaGetLastError();
}

int launch_any(int dtype, const void* x, const void* sc, const float* ls, const float* lb,
               const void* w1, const float* b1, const void* w2, const float* b2,
               const float* gamma, void* out, long long V, int C, float eps, cudaStream_t s) {
  if (V == 0) return 0;
  if (dtype == SKOOTS_BF16)
    return launch_any_t<bf16>(x, sc, ls, lb, w1, b1, w2, b2, gamma, out, V, C, eps, s);
  if (dtype == SKOOTS_F32)
    return launch_any_t<float>(x, sc, ls, lb, w1, b1, w2, b2, gamma, out, V, C, eps, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core kernel copies 16-byte rows of x, the shortcut, out and
// the weights: the caller passes them on 16-byte boundaries.
template <int C>
int launch(int dtype, const void* x, const void* sc, const float* ls, const float* lb,
           const void* w1, const float* b1, const void* w2, const float* b2,
           const float* gamma, void* out, long long V, float eps, cudaStream_t s) {
  if (V == 0) return 0;
  if (dtype == SKOOTS_BF16)
    return launch_tc<C>(x, sc, ls, lb, w1, b1, w2, b2, gamma, out, V, eps, s);
  if constexpr (C >= 32) {
    if (dtype == SKOOTS_F32)
      return launch_f32<C>(x, sc, ls, lb, w1, b1, w2, b2, gamma, out, V, eps, s);
  }
  return launch_any(dtype, x, sc, ls, lb, w1, b1, w2, b2, gamma, out, V, C, eps, s);
}

}  // namespace

// x, shortcut, out: [V, C] of `dtype` (C % 8 == 0, 8 <= C <= 256); w1:
// [C, 4C], w2: [4C, C] of `dtype`; all four on 16-byte boundaries;
// ln_scale, ln_bias, b2, gamma: f32 [C]; b1: f32 [4C]. The f32 vectors hold
// values already rounded to `dtype` (the TPU kernel casts them the same way).
extern "C" int skoots_mlp_tail(int dtype, const void* x, const void* shortcut,
                               const void* ln_scale, const void* ln_bias,
                               const void* w1, const void* b1, const void* w2,
                               const void* b2, const void* gamma, void* out,
                               long long V, int C, float eps, void* stream) {
  const float* ls = static_cast<const float*>(ln_scale);
  const float* lb = static_cast<const float*>(ln_bias);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fb2 = static_cast<const float*>(b2);
  const float* g = static_cast<const float*>(gamma);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16: return launch<16>(dtype, x, shortcut, ls, lb, w1, fb1, w2, fb2, g, out, V, eps, s);
    case 32: return launch<32>(dtype, x, shortcut, ls, lb, w1, fb1, w2, fb2, g, out, V, eps, s);
    case 64: return launch<64>(dtype, x, shortcut, ls, lb, w1, fb1, w2, fb2, g, out, V, eps, s);
    case 128: return launch<128>(dtype, x, shortcut, ls, lb, w1, fb1, w2, fb2, g, out, V, eps, s);
    default:
      if (C < 8 || C > 256 || C % 8 != 0) return (int)cudaErrorInvalidValue;
      return launch_any(dtype, x, shortcut, ls, lb, w1, fb1, w2, fb2, g, out, V, C, eps, s);
  }
}
