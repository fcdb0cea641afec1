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
// Widths: JAX's fused tail takes every C % 8 == 0 up to 256, and so does
// every kernel here; `skoots_mlp_tail_route` names the one a launch takes.
//
// bf16, C = 16, 32, 64, 128 (the main path, `tail_tc_kernel<C>`): both GEMMs
// on the tensor cores (mma.sync m16n8k16, bf16 operands, f32 accumulation:
// the products of bf16 values are exact, so this is the same arithmetic as
// the FP32 FMAs in another summation order). A persistent grid of 4-8 warp
// blocks walks row tiles of 16 rows a warp; w1 and w2 sit in shared memory
// once a block (C = 128: 256 KB do not fit, so 128-hidden-column chunks of
// both stream through a ring of two buffers; C = 16: one chunk of all 64),
// padded so `ldmatrix` reads them without bank conflicts. Row tiles of x
// and the shortcut arrive by cp.async, double-buffered. A warp normalises
// its 16 rows at once (`layer_norm16`: common.cuh::warp_layer_norm_any's
// arithmetic, its fold as one reduce-scatter of the same butterfly, 16
// shuffles for 16 rows instead of 80) and goes through shared memory once,
// into GEMM1's A fragments. GEMM1 runs 16 hidden columns at a time, one step
// ahead of its epilogue so the products overlap the FP32 work; the epilogue
// stays in registers, and the two rounded n8 tiles, packed to bf16 pairs,
// are directly GEMM2's A fragment for that k-step, so the hidden activation
// never touches shared memory. GEMM2's [16, C] sums stay in registers across
// the chunks; the final epilogue stages y through shared memory and stores
// 16-byte rows.
//
// bf16, every other C <= 128 (`tail_class_kernel<CMAX>`): the same design
// with C a run-time value inside a width class C in (CMAX / 2, CMAX], CMAX =
// 32, 64, 128 (register arrays sized by CMAX, loops unrolled to it and
// guarded by C). GEMM1's K is C padded to the 16-wide k-step: the LayerNorm
// output and w1's rows carry zeros there (zero products add nothing, so the
// sums are the unpadded ones), while the LayerNorm divides by the true C.
// GEMM2's N = C is whole n8 tiles (an odd count reads an x4 pair whose
// second tile is skipped). The weights are resident when they fit beside
// the tiles (C <= 96), else 64-column chunks stream through a ring of two;
// the hidden chunk loop runs the software pipeline two 16-column steps a
// turn, so the double-buffered GEMM1 sums keep constant register indices.
// Every class runs 8 warps a block (a warp 16 rows): shared memory holds
// the weights and x's tiles only, the shortcut and the vectors are read
// from global memory (L1) where they are used.
//
// bf16, C > 128 (`tail_staged_kernel<256>`): GEMM2's [16, C] sums would take
// C / 2 registers a lane beside GEMM1's fragments, so two warps share a
// 16-row group: a block of 8 warps owns 64 rows, the LayerNorm output of all
// of them stays in shared memory (GEMM1's A fragments by ldmatrix a k-step),
// and each 64-column hidden chunk is computed half by each warp of a pair,
// rounded, passed through a staged [64, 64] bf16 buffer, and multiplied by
// both into their halves of the n8 output tiles. Both GEMMs sum at most
// four k-steps on the tensor cores from zero and add those sums in f32:
// the tensor cores align their addends to the largest and truncate, and
// the long single accumulations of C > 128 flipped the output's roundings
// often enough to reach 3 bf16 ulps of the plain version on the card
// (tests/test_torch_infer_cuda.py, C = 168).
// w1 and w2 (576 KB at C = 192, 1 MB at 256) stream in chunks through a
// ring of two cp.async buffers.
// Every 64-row tile re-reads them from L2 (8x the tile's own bytes at C =
// 192): the 2.7 C rows that would pay them back hold a LayerNorm output of
// 350 KB at C = 256, more than shared memory.
//
// f32 (`tail_f32_kernel`, only the card-vs-CPU f32 check runs it): C a
// run-time value, scalar FP32 FMAs in k order, a block of 32 rows; GEMM1 in
// 256-column hidden chunks through shared memory, a thread 8 rows x 4
// columns of each product (the warp's lanes on neighbouring columns, so the
// weights are read as coalesced 16-byte loads that the block's warps share
// in L1, and each feeds 8 FMAs; the rows' values 4 k at a time, broadcast).
// The tensor cores would round f32 operands to TF32, which is not the
// function.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float gelu_erf(float a) {
  return 0.5f * a * (1.0f + erff(a * 0.70710678118654752f));
}

// ---- f32: FP32 FMAs at any width -------------------------------------------

constexpr int F_ROWS = 32;     // rows a block
constexpr int F_THREADS = 256;
constexpr int F_HC = 256;      // hidden columns a chunk

// acc[8][4] += rows r0 ... r0 + 7 of a (stride `as`, k = 0 ... K - 1, K a
// multiple of 8) @ rows k of w (stride `ws`, columns c0 ... c0 + 3), in k
// order: a thread's 8 x 4 block of a product, the rows' values read 4 k at
// a time as float4s (all lanes of a warp on the same rows: broadcasts), the
// weights' as one coalesced 16-byte load a k, loaded 8 k ahead into two
// alternating register groups (a block's 8 warps are all the latency hiding
// an SM has here, and a weight row often comes from L2)
__device__ __forceinline__ void fma_block(float (&acc)[8][4], const float* a, int as,
                                          const float* __restrict__ w, long long ws, int K) {
  float4 buf[2][4];
  auto load = [&](float4 (&b)[4], int k) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (k < K) b[kk] = __ldg(reinterpret_cast<const float4*>(w + (k + kk) * ws));
  };
  auto use = [&](const float4 (&wv)[4], int k) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 h = *reinterpret_cast<const float4*>(a + i * as + k);
      const float hk[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc[i][0] = fmaf(hk[kk], wv[kk].x, acc[i][0]);
        acc[i][1] = fmaf(hk[kk], wv[kk].y, acc[i][1]);
        acc[i][2] = fmaf(hk[kk], wv[kk].z, acc[i][2]);
        acc[i][3] = fmaf(hk[kk], wv[kk].w, acc[i][3]);
      }
    }
  };
  load(buf[0], 0);
  load(buf[1], 4);
  for (int k = 0; k < K; k += 8) {
    float4 wv[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wv[kk] = buf[0][kk];
    load(buf[0], k + 8);
    use(wv, k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wv[kk] = buf[1][kk];
    load(buf[1], k + 12);
    use(wv, k + 4);
  }
}

__global__ void __launch_bounds__(F_THREADS)
tail_f32_kernel(const float* __restrict__ x, const float* __restrict__ sc,
                const float* __restrict__ ls, const float* __restrict__ lb,
                const float* __restrict__ w1, const float* __restrict__ b1,
                const float* __restrict__ w2, const float* __restrict__ b2,
                const float* __restrict__ gamma, float* __restrict__ out,
                long long V, int C, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = 4 * C;
  float* hs = reinterpret_cast<float*>(smem);  // [F_ROWS][C]
  float* as = hs + F_ROWS * C;                 // [F_ROWS][F_HC]
  const long long row0 = (long long)blockIdx.x * F_ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < F_ROWS; r += F_THREADS / 32) {
    const long long g = row0 + r;
    warp_layer_norm_any<float>(x + (g < V ? g : 0) * C, g < V, ls, lb, eps, C, hs + r * C);
  }
  __syncthreads();
  // a thread 8 rows x 4 columns (of the hidden chunk in GEMM1, of the
  // output in GEMM2): a warp's rows r0 ..., its lanes on neighbouring
  // column quads
  const int r0 = (warp & 3) * 8, c0 = ((warp >> 2) * 32 + lane) * 4;
  float acc2[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc2[i][j] = 0.f;
  for (int j0 = 0; j0 < H; j0 += F_HC) {
    const int hc = min(F_HC, H - j0);  // a multiple of 32
    if (c0 < hc) {
      float acc1[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc1[i][j] = 0.f;
      fma_block(acc1, hs + r0 * C, C, w1 + j0 + c0, H, C);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          as[(r0 + i) * F_HC + c0 + j] = gelu_erf(acc1[i][j] + b1[j0 + c0 + j]);
    }
    __syncthreads();
    if (c0 < C) fma_block(acc2, as + r0 * F_HC, F_HC, w2 + (long long)j0 * C + c0, C, hc);
    __syncthreads();
  }
  if (c0 >= C) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long g = row0 + r0 + i;
    if (g >= V) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + j;
      out[g * C + c] = sc[g * C + c] + (acc2[i][j] + b2[c]) * gamma[c];
    }
  }
}

int launch_f32(const void* x, const void* sc, const float* ls, const float* lb,
               const void* w1, const float* b1, const void* w2, const float* b2,
               const float* gamma, void* out, long long V, int C, float eps, cudaStream_t s) {
  const int smem = F_ROWS * (C + F_HC) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(tail_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (V + F_ROWS - 1) / F_ROWS;
  tail_f32_kernel<<<(unsigned)blocks, F_THREADS, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(sc), ls, lb,
      static_cast<const float*>(w1), b1, static_cast<const float*>(w2), b2, gamma,
      static_cast<float*>(out), V, C, eps);
  return (int)cudaGetLastError();
}

// ---- bf16 on the tensor cores ----------------------------------------------

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

// common.cuh::warp_layer_norm_any of the warp's 16 rows (xs: [16][C], rows
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
  long long grid = 0;
  const int e = persistent_grid(tail_tc_kernel<C>, K::THREADS, K::SMEM,
                                (V + K::ROWS - 1) / K::ROWS, &grid);
  if (e) return e;
  tail_tc_kernel<C><<<(unsigned)grid, K::THREADS, K::SMEM, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(sc), ls, lb,
      static_cast<const bf16*>(w1), b1, static_cast<const bf16*>(w2), b2, gamma,
      static_cast<bf16*>(out), V, eps);
  return (int)cudaGetLastError();
}

// ---- bf16, every other width on the tensor cores -----------------------------

// The run-time shared-memory layout of `tail_class_kernel` (bytes unless
// named a stride, strides in elements): C, its k-step padding Cp, the hidden
// chunk and its count, resident (one chunk of all 4C columns) or streamed
// (64-column chunks through a ring of two).
struct ClassLayout {
  int C, Cp, H, hc, nch, stream;
  int w1s, w2s, hs;  // strides: w1 chunk [Cp][w1s], w2 chunk [hc][w2s], LN / y [16][hs]
  int w1_bytes, chunk_bytes, tile_bytes, off_x, off_h, smem;
};

ClassLayout class_layout(int C, int warps, bool stream) {
  ClassLayout L;
  L.C = C;
  L.Cp = (C + 15) / 16 * 16;
  L.H = 4 * C;
  L.stream = stream;
  L.hc = stream ? 64 : L.H;
  L.nch = (L.H + L.hc - 1) / L.hc;
  // 16-byte rows an odd multiple of 16 bytes apart (Cp / 8 and hc / 8 are
  // even), so the 8 rows of an ldmatrix fall in distinct banks
  L.w1s = L.hc + 8;
  L.w2s = L.Cp + 8;
  L.hs = L.Cp + 8;
  L.w1_bytes = L.Cp * L.w1s * 2;
  L.chunk_bytes = L.w1_bytes + L.hc * L.w2s * 2;
  L.tile_bytes = warps * 16 * C * 2;
  L.off_x = (stream ? 2 : 1) * L.chunk_bytes;  // x tiles [2][rows][C]
  L.off_h = L.off_x + 2 * L.tile_bytes;
  L.smem = L.off_h + warps * 16 * L.hs * 2;
  return L;
}

template <int CMAX>
struct TailClass {
  static constexpr int KSM = CMAX / 16;  // GEMM1 k-steps, at most
  static constexpr int NTM = CMAX / 8;   // GEMM2 n8 tiles, at most
  static constexpr int PER = CMAX / 32;  // a lane's LayerNorm values a row
  static constexpr int WARPS = 8;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int ROWS = WARPS * 16;
};

// hidden columns c0 ... c0 + hcc - 1 of both weights into shared memory:
// w1's into w1s [Cp][w1_stride] (rows C ... Cp - 1 zeros: GEMM1's padded
// k), w2's into w2s [hcc][w2_stride]
__device__ __forceinline__ void load_weights(bf16* w1s, int w1_stride, bf16* w2s, int w2_stride,
                                             const bf16* w1, const bf16* w2, int c0, int hcc,
                                             int C, int Cp, int threads) {
  const int H = 4 * C, p1 = hcc / 8, p2 = C / 8;  // 16-byte pieces a row
  for (int i = threadIdx.x; i < Cp * p1; i += threads) {
    const int k = i / p1, j = i - k * p1;
    const bool in = k < C;
    cp_async16(w1s + k * w1_stride + j * 8, w1 + (long long)(in ? k : 0) * H + c0 + j * 8,
               in ? 16 : 0);
  }
  for (int i = threadIdx.x; i < hcc * p2; i += threads) {
    const int r = i / p2, j = i - r * p2;
    cp_async16(w2s + r * w2_stride + j * 8, w2 + (long long)(c0 + r) * C + j * 8, 16);
  }
}

// chunk `ch` of the class layout's both weights into `buf`
__device__ __forceinline__ void load_chunk_rt(unsigned char* buf, const bf16* w1, const bf16* w2,
                                              int ch, const ClassLayout& L, int threads) {
  load_weights(reinterpret_cast<bf16*>(buf), L.w1s, reinterpret_cast<bf16*>(buf + L.w1_bytes),
               L.w2s, w1, w2, ch * L.hc, min(L.hc, L.H - ch * L.hc), L.C, L.Cp, threads);
}

// rows row0 ... row0 + rows - 1 of x (zeros past V)
__device__ __forceinline__ void load_tile_rt(unsigned char* xs, const bf16* x, long long row0,
                                             long long V, int C, int rows, int threads) {
  bf16* xd = reinterpret_cast<bf16*>(xs);
  const int p = C / 8;
  for (int i = threadIdx.x; i < rows * p; i += threads) {
    const int r = i / p, j = i - r * p;
    const long long g = row0 + r;
    cp_async16(xd + r * C + j * 8, x + (g < V ? g : 0) * C + j * 8, g < V ? 16 : 0);
  }
}

// layer_norm16 at a run-time C <= 32 PER: lane l owns columns l, l + 32,
// ... below C; the last 32-column block is the plain fold's zero pad and
// the sums run over the ceil(C / 32) blocks only, so the result is
// warp_layer_norm_any's bit for bit. Columns C ... Cp - 1 of `out` get
// zeros: GEMM1's padded k.
template <int PER>
__device__ __forceinline__ void layer_norm16_rt(const bf16* xs, long long row0, long long V,
                                                const float* __restrict__ ls,
                                                const float* __restrict__ lb, float eps,
                                                int C, int Cp, int HS, bf16* out) {
  const int lane = threadIdx.x & 31;
  const int per = (C + 31) / 32;
  float v[16][PER], s[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
#pragma unroll
    for (int i = 0; i < PER; ++i)
      v[r][i] = row0 + r < V && lane + 32 * i < C
                    ? __bfloat162float(xs[r * C + lane + 32 * i]) : 0.f;
    s[r] = v[r][0];
#pragma unroll
    for (int i = 1; i < PER; ++i)
      if (i < per) s[r] = __fadd_rn(s[r], v[r][i]);
  }
  const float mu_own = __fdiv_rn(fold_sum16(s), (float)C);
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const float mu = __shfl_sync(0xffffffffu, mu_own, 2 * r);
#pragma unroll
    for (int i = 0; i < PER; ++i)
      v[r][i] = lane + 32 * i < C ? __fsub_rn(v[r][i], mu) : 0.f;
    s[r] = __fmul_rn(v[r][0], v[r][0]);
#pragma unroll
    for (int i = 1; i < PER; ++i)
      if (i < per) s[r] = __fadd_rn(s[r], __fmul_rn(v[r][i], v[r][i]));
  }
  const float var = __fdiv_rn(fold_sum16(s), (float)C);
  const float inv_own = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
  float sc[PER], bi[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const bool in = lane + 32 * i < C;
    sc[i] = in ? ls[lane + 32 * i] : 0.f;
    bi[i] = in ? lb[lane + 32 * i] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const float inv = __shfl_sync(0xffffffffu, inv_own, 2 * r);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = lane + 32 * i;
      if (c < C)
        out[r * HS + c] =
            __float2bfloat16_rn(__fadd_rn(__fmul_rn(__fmul_rn(v[r][i], inv), sc[i]), bi[i]));
      else if (c < Cp)
        out[r * HS + c] = __float2bfloat16_rn(0.f);
    }
  }
}

template <int CMAX>
__global__ void __launch_bounds__(TailClass<CMAX>::THREADS)
tail_class_kernel(const bf16* __restrict__ x, const bf16* __restrict__ sc,
                  const float* __restrict__ ls, const float* __restrict__ lb,
                  const bf16* __restrict__ w1, const float* __restrict__ b1,
                  const bf16* __restrict__ w2, const float* __restrict__ b2,
                  const float* __restrict__ gamma, bf16* __restrict__ out,
                  long long V, float eps, const ClassLayout L) {
  using K = TailClass<CMAX>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = L.C;
  const int KS = L.Cp / 16, NT2 = C / 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const long long ntiles = (V + K::ROWS - 1) / K::ROWS;
  long long tile = blockIdx.x;
  if (tile >= ntiles) return;
  load_chunk_rt(smem, w1, w2, 0, L, K::THREADS);  // resident: the only chunk
  load_tile_rt(smem + L.off_x, x, tile * K::ROWS, V, C, K::ROWS, K::THREADS);
  cp_async_commit();

  bf16* hs = reinterpret_cast<bf16*>(smem + L.off_h) + warp * 16 * L.hs;
  uint32_t a1[K::KSM][4];  // GEMM1's A: the warp's 16 LayerNorm rows
  float acc2[K::NTM][4];   // GEMM2's [16, C] sums
  int step = 0;            // chunk steps so far (streamed: buffer step & 1)
  // ldmatrix.trans lane addresses: row (k) lane % 8 (+8 for matrices 1 and
  // 3), column (n) +8 for matrices 2 and 3
  const int kr = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int nc = (lane >> 4) * 8;
  for (int it = 0; tile < ntiles; ++it, tile += gridDim.x) {
    const int xb = it & 1;
    const bf16* xs = reinterpret_cast<const bf16*>(smem + L.off_x + xb * L.tile_bytes);
    const long long row0 = tile * K::ROWS + warp * 16;  // the warp's rows
    const long long next = tile + gridDim.x;
    for (int ch = 0; ch < L.nch; ++ch, ++step) {
      // this step's operands have landed and every warp is done with the
      // buffers the prefetch below overwrites
      cp_async_wait_all();
      __syncthreads();
      if (ch == 0 && next < ntiles)
        load_tile_rt(smem + L.off_x + (xb ^ 1) * L.tile_bytes, x, next * K::ROWS, V, C, K::ROWS,
                     K::THREADS);
      if (L.stream && (ch + 1 < L.nch || next < ntiles))
        load_chunk_rt(smem + ((step + 1) & 1) * L.chunk_bytes, w1, w2, (ch + 1) % L.nch, L,
                      K::THREADS);
      cp_async_commit();
      const unsigned char* wb = smem + (L.stream ? (step & 1) : 0) * L.chunk_bytes;
      const bf16* w1s = reinterpret_cast<const bf16*>(wb);
      const bf16* w2s = reinterpret_cast<const bf16*>(wb + L.w1_bytes);

      if (ch == 0) {
        layer_norm16_rt<K::PER>(xs + warp * 16 * C, row0, V, ls, lb, eps, C, L.Cp, L.hs, hs);
        __syncwarp();
#pragma unroll
        for (int ks = 0; ks < K::KSM; ++ks)
          if (ks < KS)
            ldmatrix_x4(a1[ks], hs + (lane & 15) * L.hs + ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int n = 0; n < K::NTM; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc2[n][i] = 0.f;
      }

      // GEMM1 of 16 hidden columns (n8 tiles 2p, 2p+1)
      auto gemm1 = [&](int p, float (&d)[2][4]) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) d[nt][i] = 0.f;
#pragma unroll
        for (int ks = 0; ks < K::KSM; ++ks) {
          if (ks < KS) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, w1s + (ks * 16 + kr) * L.w1s + p * 16 + nc);
            mma_bf16_16816(d[0], a1[ks], b[0], b[1]);
            mma_bf16_16816(d[1], a1[ks], b[2], b[3]);
          }
        }
      };
      // GEMM1's epilogue of columns p in registers (round, + b1, round,
      // GELU, round): the rounded n8 tiles 2p, 2p+1 packed to bf16 pairs are
      // GEMM2's A fragment of k-step p
      auto gemm2 = [&](int p, const float (&d)[2][4]) {
        uint32_t a2[4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 bb =
                __ldg(reinterpret_cast<const float2*>(b1 + ch * L.hc + p * 16 + nt * 8 + 2 * q));
            float u = d[nt][2 * h], w = d[nt][2 * h + 1];
            rnd_pair(u, w);
            u += bb.x;
            w += bb.y;
            rnd_pair(u, w);
            a2[2 * nt + h] = pack_bf16x2(gelu_erf(u), gelu_erf(w));
          }
#pragma unroll
        for (int n2 = 0; n2 < K::NTM / 2; ++n2) {
          if (2 * n2 < NT2) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, w2s + (p * 16 + kr) * L.w2s + n2 * 16 + nc);
            mma_bf16_16816(acc2[2 * n2], a2, b[0], b[1]);
            if (2 * n2 + 1 < NT2) mma_bf16_16816(acc2[2 * n2 + 1], a2, b[2], b[3]);
          }
        }
      };
      // software-pipelined two steps a turn (a chunk's steps are even): the
      // products of the next 16 columns are in flight on the tensor cores
      // while the FP32 pipe runs the epilogue of these
      const int np = min(L.hc, L.H - ch * L.hc) / 16;
      float d0[2][4], d1[2][4];
      gemm1(0, d0);
#pragma unroll 1
      for (int p = 0; p < np; p += 2) {
        gemm1(p + 1, d1);
        gemm2(p, d0);
        if (p + 2 < np) gemm1(p + 2, d0);
        gemm2(p + 1, d1);
      }

      if (ch == L.nch - 1) {
        // y = round(round(round(acc + b2) * gamma)), exact in bf16 -> hs
        __syncwarp();  // every lane's A fragments are out of hs
#pragma unroll
        for (int n = 0; n < K::NTM; ++n) {
          if (n < NT2) {
            const int c = n * 8 + 2 * q;
            const float2 bb = __ldg(reinterpret_cast<const float2*>(b2 + c));
            const float2 gg = __ldg(reinterpret_cast<const float2*>(gamma + c));
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float y0 = rnd<bf16>(rnd<bf16>(rnd<bf16>(acc2[n][2 * h]) + bb.x) * gg.x);
              const float y1 = rnd<bf16>(rnd<bf16>(rnd<bf16>(acc2[n][2 * h + 1]) + bb.y) * gg.y);
              *reinterpret_cast<uint32_t*>(hs + (g + 8 * h) * L.hs + c) = pack_bf16x2(y0, y1);
            }
          }
        }
        __syncwarp();
        // out = round(shortcut + y), 16-byte rows
        for (int i = lane; i < 16 * NT2; i += 32) {
          const int r = i / NT2, j = i - r * NT2;
          if (row0 + r >= V) continue;
          const uint4 yv = *reinterpret_cast<const uint4*>(hs + r * L.hs + j * 8);
          const uint4 sv = __ldg(reinterpret_cast<const uint4*>(sc + (row0 + r) * C + j * 8));
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

// ---- bf16, C > 128: two warps a row group, the hidden chunk staged ------------

// The run-time layout of `tail_staged_kernel` (bytes; strides in elements)
struct StagedLayout {
  int C, Cp, H, nch;
  int w1s, w2s, hs, hid;  // w1 chunk [Cp][w1s], w2 chunk [HC][w2s], LN / y [64][hs], [64][hid]
  int w1_bytes, chunk_bytes, off_h, off_hid, off_v, smem;
};

template <int CMAX>
struct TailStaged {
  static constexpr int WARPS = 8;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int ROWS = WARPS / 2 * 16;  // two warps a 16-row group
  static constexpr int HC = 64;                // hidden columns a chunk
  static constexpr int KSM = CMAX / 16;        // GEMM1 k-steps, at most
  static constexpr int NTM = CMAX / 16;        // a warp's GEMM2 n8 tiles, at most

  static StagedLayout layout(int C) {
    StagedLayout L;
    L.C = C;
    L.Cp = (C + 15) / 16 * 16;
    L.H = 4 * C;
    L.nch = (L.H + HC - 1) / HC;
    L.w1s = HC + 8;
    L.w2s = L.Cp + 8;
    L.hs = L.Cp + 8;
    L.hid = HC + 8;
    L.w1_bytes = L.Cp * L.w1s * 2;
    L.chunk_bytes = L.w1_bytes + HC * L.w2s * 2;
    L.off_h = 2 * L.chunk_bytes;
    L.off_hid = L.off_h + ROWS * L.hs * 2;
    L.off_v = L.off_hid + ROWS * L.hid * 2;  // b1, b2, gamma
    L.smem = L.off_v + (L.H + 2 * C) * 4;
    return L;
  }
};

template <int CMAX>
__global__ void __launch_bounds__(TailStaged<CMAX>::THREADS)
tail_staged_kernel(const bf16* __restrict__ x, const bf16* __restrict__ sc,
                   const float* __restrict__ ls, const float* __restrict__ lb,
                   const bf16* __restrict__ w1, const float* __restrict__ b1,
                   const bf16* __restrict__ w2, const float* __restrict__ b2,
                   const float* __restrict__ gamma, bf16* __restrict__ out,
                   long long V, float eps, const StagedLayout L) {
  using K = TailStaged<CMAX>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = L.C, KS = L.Cp / 16, NT2 = C / 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int grp = warp >> 1, part = warp & 1;  // the row group, and which half
  // this warp's n8 output tiles: [t0, t0 + nt)
  const int half = (NT2 + 1) / 2;
  const int t0 = part ? half : 0, nt = part ? NT2 - half : half;
  float* b1s = reinterpret_cast<float*>(smem + L.off_v);
  float* b2s = b1s + L.H;
  float* gms = b2s + C;
  bf16* hs = reinterpret_cast<bf16*>(smem + L.off_h);
  bf16* hid = reinterpret_cast<bf16*>(smem + L.off_hid);
  for (int i = tid; i < L.H; i += K::THREADS) b1s[i] = b1[i];
  for (int i = tid; i < C; i += K::THREADS) {
    b2s[i] = b2[i];
    gms[i] = gamma[i];
  }
  const long long ntiles = (V + K::ROWS - 1) / K::ROWS;
  long long tile = blockIdx.x;
  if (tile >= ntiles) return;
  // the chunks stream through a ring of two buffers (the sizes of a whole
  // K::HC chunk; the last one may be 32 columns)
  auto load_chunk = [&](int buf, int ch) {
    unsigned char* b = smem + buf * L.chunk_bytes;
    load_weights(reinterpret_cast<bf16*>(b), L.w1s, reinterpret_cast<bf16*>(b + L.w1_bytes),
                 L.w2s, w1, w2, ch * K::HC, min(K::HC, L.H - ch * K::HC), C, L.Cp, K::THREADS);
  };
  load_chunk(0, 0);
  cp_async_commit();

  const int kr = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int nc = (lane >> 4) * 8;
  const bf16* hrow = hs + (grp * 16 + (lane & 15)) * L.hs + (lane >> 4) * 8;
  const bf16* drow = hid + (grp * 16 + (lane & 15)) * L.hid + (lane >> 4) * 8;
  float acc2[K::NTM][4];
  int step = 0;
  for (; tile < ntiles; tile += gridDim.x) {
    const long long row0 = tile * K::ROWS;
    __syncthreads();  // the previous tile's stores are done with hs
    // the LayerNorm, a warp a row: rows 8 warp ... 8 warp + 7
    for (int r = warp * 8; r < warp * 8 + 8; ++r) {
      const long long gr = row0 + r;
      warp_layer_norm_any<bf16, bf16>(x + (gr < V ? gr : 0) * C, gr < V, ls, lb, eps, C,
                                      hs + r * L.hs, L.Cp);
    }
#pragma unroll
    for (int n = 0; n < K::NTM; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc2[n][i] = 0.f;
    for (int ch = 0; ch < L.nch; ++ch, ++step) {
      // chunk ch has landed, the LayerNorm rows are in place, and every
      // warp is done with the buffer the prefetch overwrites and with hid
      cp_async_wait_all();
      __syncthreads();
      if (ch + 1 < L.nch || tile + gridDim.x < ntiles)
        load_chunk((step + 1) & 1, (ch + 1) % L.nch);
      cp_async_commit();
      const unsigned char* wb = smem + (step & 1) * L.chunk_bytes;
      const bf16* w1s = reinterpret_cast<const bf16*>(wb);
      const bf16* w2s = reinterpret_cast<const bf16*>(wb + L.w1_bytes);
      const int hcc = min(K::HC, L.H - ch * K::HC);
      // GEMM1: the group's 16 rows x this warp's half of the chunk's
      // columns, 16 at a time; the epilogue's bf16 pairs into hid
      for (int pg = 0; pg < hcc / 32; ++pg) {
        const int col = part * (hcc / 2) + pg * 16;
        // four k-steps at a time from zero, added in f32 (as GEMM2 below)
        float d[2][4] = {};
#pragma unroll
        for (int k4 = 0; k4 < K::KSM; k4 += 4) {
          if (k4 < KS) {
            float part[2][4] = {};
#pragma unroll
            for (int ks = k4; ks < k4 + 4; ++ks) {
              if (ks < KS) {
                uint32_t a[4], b[4];
                ldmatrix_x4(a, hrow + ks * 16);
                ldmatrix_x4_trans(b, w1s + (ks * 16 + kr) * L.w1s + col + nc);
                mma_bf16_16816(part[0], a, b[0], b[1]);
                mma_bf16_16816(part[1], a, b[2], b[3]);
              }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              d[0][i] += part[0][i];
              d[1][i] += part[1][i];
            }
          }
        }
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = col + t * 8 + 2 * q;
            const float2 bb = *reinterpret_cast<const float2*>(b1s + ch * K::HC + c);
            float u = d[t][2 * h], w = d[t][2 * h + 1];
            rnd_pair(u, w);
            u += bb.x;
            w += bb.y;
            rnd_pair(u, w);
            *reinterpret_cast<uint32_t*>(hid + (grp * 16 + g + 8 * h) * L.hid + c) =
                pack_bf16x2(gelu_erf(u), gelu_erf(w));
          }
      }
      __syncthreads();  // the chunk's hidden values are in hid
      // GEMM2: acc2 += hid[group rows][0, hcc) @ w2 chunk[:, this warp's
      // tiles], the chunk's products summed from zero, added in f32
      uint32_t a[K::HC / 16][4];
#pragma unroll
      for (int k2 = 0; k2 < K::HC / 16; ++k2)
        if (k2 < hcc / 16) ldmatrix_x4(a[k2], drow + k2 * 16);
#pragma unroll
      for (int n2 = 0; n2 < K::NTM / 2; ++n2) {
        if (2 * n2 < nt) {
          float part[2][4] = {};
#pragma unroll
          for (int k2 = 0; k2 < K::HC / 16; ++k2) {
            if (k2 < hcc / 16) {
              uint32_t b[4];
              ldmatrix_x4_trans(b, w2s + (k2 * 16 + kr) * L.w2s + (t0 + 2 * n2) * 8 + nc);
              mma_bf16_16816(part[0], a[k2], b[0], b[1]);
              mma_bf16_16816(part[1], a[k2], b[2], b[3]);
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc2[2 * n2][i] += part[0][i];
            acc2[2 * n2 + 1][i] += part[1][i];
          }
        }
      }
    }
    // y = round(round(round(acc + b2) * gamma)) -> hs (GEMM1 is done with
    // it: the barrier after the last chunk's GEMM1)
#pragma unroll
    for (int j = 0; j < K::NTM; ++j) {
      if (j < nt) {
        const int c = (t0 + j) * 8 + 2 * q;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float y0 = rnd<bf16>(rnd<bf16>(rnd<bf16>(acc2[j][2 * h]) + b2s[c]) * gms[c]);
          const float y1 =
              rnd<bf16>(rnd<bf16>(rnd<bf16>(acc2[j][2 * h + 1]) + b2s[c + 1]) * gms[c + 1]);
          *reinterpret_cast<uint32_t*>(hs + (grp * 16 + g + 8 * h) * L.hs + c) =
              pack_bf16x2(y0, y1);
        }
      }
    }
    __syncthreads();
    // out = round(shortcut + y), 16-byte rows
    for (int i = tid; i < K::ROWS * NT2; i += K::THREADS) {
      const int r = i / NT2, j = i - r * NT2;
      const long long gr = row0 + r;
      if (gr >= V) continue;
      const uint4 yv = *reinterpret_cast<const uint4*>(hs + r * L.hs + j * 8);
      const uint4 sv = __ldg(reinterpret_cast<const uint4*>(sc + gr * C + j * 8));
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
      *reinterpret_cast<uint4*>(out + gr * C + j * 8) = o;
    }
  }
}

template <int CMAX>
int launch_class(const void* x, const void* sc, const float* ls, const float* lb,
                 const void* w1, const float* b1, const void* w2, const float* b2,
                 const float* gamma, void* out, long long V, int C, float eps, cudaStream_t s) {
  using K = TailClass<CMAX>;
  ClassLayout L = class_layout(C, K::WARPS, false);
  if (L.smem > SMEM_OPTIN) L = class_layout(C, K::WARPS, true);
  if (L.smem > SMEM_OPTIN) return (int)cudaErrorInvalidValue;
  long long grid = 0;
  const int e = persistent_grid(tail_class_kernel<CMAX>, K::THREADS, L.smem,
                                       (V + K::ROWS - 1) / K::ROWS, &grid);
  if (e) return e;
  tail_class_kernel<CMAX><<<(unsigned)grid, K::THREADS, L.smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(sc), ls, lb,
      static_cast<const bf16*>(w1), b1, static_cast<const bf16*>(w2), b2, gamma,
      static_cast<bf16*>(out), V, eps, L);
  return (int)cudaGetLastError();
}

int launch_staged(const void* x, const void* sc, const float* ls, const float* lb,
                  const void* w1, const float* b1, const void* w2, const float* b2,
                  const float* gamma, void* out, long long V, int C, float eps,
                  cudaStream_t s) {
  using K = TailStaged<256>;
  const StagedLayout L = K::layout(C);
  long long grid = 0;
  const int e = persistent_grid(tail_staged_kernel<256>, K::THREADS, L.smem,
                                       (V + K::ROWS - 1) / K::ROWS, &grid);
  if (e) return e;
  tail_staged_kernel<256><<<(unsigned)grid, K::THREADS, L.smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(sc), ls, lb,
      static_cast<const bf16*>(w1), b1, static_cast<const bf16*>(w2), b2, gamma,
      static_cast<bf16*>(out), V, eps, L);
  return (int)cudaGetLastError();
}

// The kernel a launch at (dtype, C) takes: the one decision the entry point
// and the route query share
enum Route {
  R_NONE, R_TC16, R_TC32, R_TC64, R_TC128, R_CLASS32, R_CLASS64, R_CLASS128, R_STAGED, R_F32
};
const char* const ROUTE_NAMES[] = {
    nullptr, "tail_tc_kernel<16>", "tail_tc_kernel<32>", "tail_tc_kernel<64>",
    "tail_tc_kernel<128>", "tail_class_kernel<32>", "tail_class_kernel<64>",
    "tail_class_kernel<128>", "tail_staged_kernel<256>", "tail_f32_kernel"};

Route tail_route(int dtype, int C) {
  if (C < 8 || C > 256 || C % 8 != 0) return R_NONE;
  if (dtype == SKOOTS_F32) return R_F32;
  if (dtype != SKOOTS_BF16) return R_NONE;
  switch (C) {
    case 16: return R_TC16;
    case 32: return R_TC32;
    case 64: return R_TC64;
    case 128: return R_TC128;
  }
  return C <= 32 ? R_CLASS32 : C <= 64 ? R_CLASS64 : C <= 128 ? R_CLASS128 : R_STAGED;
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
  const Route route = tail_route(dtype, C);
  if (route == R_NONE) return (int)cudaErrorInvalidValue;
  if (V == 0) return 0;
  const float* ls = static_cast<const float*>(ln_scale);
  const float* lb = static_cast<const float*>(ln_bias);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fb2 = static_cast<const float*>(b2);
  const float* g = static_cast<const float*>(gamma);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (route) {
    case R_TC16: return launch_tc<16>(x, shortcut, ls, lb, w1, fb1, w2, fb2, g, out, V, eps, s);
    case R_TC32: return launch_tc<32>(x, shortcut, ls, lb, w1, fb1, w2, fb2, g, out, V, eps, s);
    case R_TC64: return launch_tc<64>(x, shortcut, ls, lb, w1, fb1, w2, fb2, g, out, V, eps, s);
    case R_TC128: return launch_tc<128>(x, shortcut, ls, lb, w1, fb1, w2, fb2, g, out, V, eps, s);
    case R_CLASS32:
      return launch_class<32>(x, shortcut, ls, lb, w1, fb1, w2, fb2, g, out, V, C, eps, s);
    case R_CLASS64:
      return launch_class<64>(x, shortcut, ls, lb, w1, fb1, w2, fb2, g, out, V, C, eps, s);
    case R_CLASS128:
      return launch_class<128>(x, shortcut, ls, lb, w1, fb1, w2, fb2, g, out, V, C, eps, s);
    case R_STAGED:
      return launch_staged(x, shortcut, ls, lb, w1, fb1, w2, fb2, g, out, V, C, eps, s);
    default: return launch_f32(x, shortcut, ls, lb, w1, fb1, w2, fb2, g, out, V, C, eps, s);
  }
}

// The kernel skoots_mlp_tail takes at (dtype, C), by name ("tail_tc_kernel<32>",
// "tail_class_kernel<64>", "tail_staged_kernel<256>", "tail_f32_kernel"), or
// null where it refuses the operands.
extern "C" const char* skoots_mlp_tail_route(int dtype, int C) {
  return ROUTE_NAMES[tail_route(dtype, C)];
}
