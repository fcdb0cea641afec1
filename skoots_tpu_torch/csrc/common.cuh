// Shared helpers for the hand-written Hopper kernels of skoots_tpu_torch.
//
// Every kernel is templated on its storage type T (float or __nv_bfloat16)
// and computes in float32. `rnd<T>` rounds a float32 value to T's precision
// and back: it marks the points where the TPU kernels this port replaces
// cast to the model dtype, so the CUDA kernels round at the same points.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes shared with the Python wrappers (kernels/_build.py)
#define SKOOTS_F32 0
#define SKOOTS_BF16 1

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f32<T>(from_f32<T>(v));
}

// Sum over the 32 lanes of a warp in a fixed order: halving folds, lane l
// adding lane l + 16, then l + 8, ... (a butterfly, so every lane ends with
// the sum). The plain versions fold in the same order
// (kernels/mlp.py::fold_sum), so the two agree bit for bit.
__device__ __forceinline__ float warp_fold_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  return s;
}

// Row LayerNorm of one [C] row held by one warp, any C up to
// 32 * LN_MAX_PER: lane l owns elements l, l + 32, ... below C, and the last
// 32-column block is zero-padded, as the plain version pads its fold
// (kernels/mlp.py::fold_sum). Statistics in float32 as the TPU kernels
// compute them: mu = mean(x), var = mean((x - mu)^2),
// h = (x - mu) * (1 / sqrt(var + eps)) * scale + bias, then one rounding to
// T, stored as O; columns C ... pad_to - 1 of `hrow` get zeros. Every step
// is an IEEE-rounded intrinsic (no contraction into FMAs) in the plain
// version's order, so kernel and plain version agree exactly.
constexpr int LN_MAX_PER = 8;

template <typename T, typename O = float>
__device__ __forceinline__ void warp_layer_norm_any(const T* __restrict__ xrow, bool valid,
                                                    const float* __restrict__ ls,
                                                    const float* __restrict__ lb, float eps,
                                                    int C, O* hrow, int pad_to = 0) {
  const int lane = threadIdx.x & 31;
  const int per = (C + 31) / 32;
  float v[LN_MAX_PER];
#pragma unroll
  for (int i = 0; i < LN_MAX_PER; ++i) {
    const int c = lane + 32 * i;
    v[i] = valid && c < C ? to_f32<T>(xrow[c]) : 0.f;
  }
  float s = v[0];
#pragma unroll
  for (int i = 1; i < LN_MAX_PER; ++i)
    if (i < per) s = __fadd_rn(s, v[i]);
  const float mu = __fdiv_rn(warp_fold_sum(s), (float)C);
#pragma unroll
  for (int i = 0; i < LN_MAX_PER; ++i) v[i] = lane + 32 * i < C ? __fsub_rn(v[i], mu) : 0.f;
  float q = __fmul_rn(v[0], v[0]);
#pragma unroll
  for (int i = 1; i < LN_MAX_PER; ++i)
    if (i < per) q = __fadd_rn(q, __fmul_rn(v[i], v[i]));
  const float var = __fdiv_rn(warp_fold_sum(q), (float)C);
  const float inv = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
#pragma unroll
  for (int i = 0; i < LN_MAX_PER; ++i) {
    const int c = lane + 32 * i;
    if (c < C)
      hrow[c] = from_f32<O>(rnd<T>(__fadd_rn(__fmul_rn(__fmul_rn(v[i], inv), ls[c]), lb[c])));
    else if (c < pad_to)
      hrow[c] = from_f32<O>(0.f);
  }
}

// ---- Hopper building blocks (inline PTX, sm_80+ instructions) -------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; `bytes` < 16 zero-fills the
// rest (0: the destination becomes 16 zero bytes, the source is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// all but the newest N committed groups of this thread have landed
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory: lane l gives the address of row
// l % 8 of matrix l / 8; register i holds matrix i (lane t: row t / 4,
// elements 2 (t % 4) and 2 (t % 4) + 1; with .trans, column t / 4 and rows
// 2 (t % 4), 2 (t % 4) + 1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Two 8x8 b16 matrices, transposed: lanes 0-7 give the row addresses of
// matrix 0, lanes 8-15 of matrix 1 (lanes 16-31 are not read).
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// d += a * b on the tensor cores: A 16x16 bf16 (row), B 16x8 bf16 (col),
// D 16x8 f32. Fragments (g = lane / 4, q = lane % 4): a0 (row g, k 2q, 2q+1),
// a1 (row g+8, same k), a2 (row g, k 2q+8, 2q+9), a3 (row g+8, k 2q+8, 2q+9);
// b0 (k 2q, 2q+1; col g), b1 (k 2q+8, 2q+9; col g); d0, d1 (row g, cols 2q,
// 2q+1), d2, d3 (row g+8, same cols). The lower k / column is the low half.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats (exact in bf16, or rounded to nearest even) as one bf16 pair,
// `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The stems' GEMMs (csrc/dwconv.cu, csrc/dwconv_wgrad.cu) hold a chunk of
// `units` 8-channel groups as a compile-time class of 2, 4, 6 or 8 n8 tiles;
// a row of the class's columns is padded by 8 to an odd number of 16-byte
// units (conflict-free ldmatrix rows).
inline int stem_nt_class(int units) { return units <= 2 ? 2 : (units + 1) / 2 * 2; }
inline int stem_row_stride(int nt) { return 8 * nt + 8; }

// A block's shared memory on the H100 (227 KB), the most a launch may ask.
constexpr int SMEM_OPTIN = 232448;

// The X split of the depthwise kernels that stream x planes (csrc/dwconv.cu's
// big-k forward, csrc/dwconv_wgrad.cu's tensor-core weight gradients): `cols`
// units a range of X, dealt in turn to `target` blocks; a unit of xt planes
// costs xt + k - 1 planes streamed and about two more of prologue, so the
// split whose blocks finish soonest. Ranges of at least `min_xt` planes but
// the last, nxs ranges of xt planes, `units` in all, at most `per_block` a
// block. False where no split keeps the units under 2^31.
struct XSplit {
  int nxs, xt;
  long long units, per_block;
};

inline bool split_x(long long cols, int X, long long target, int k, int min_xt, XSplit* s) {
  long long best = -1;
  for (int nxs = 1; nxs <= (X + min_xt - 1) / min_xt; ++nxs) {
    const int xt = (X + nxs - 1) / nxs;
    if ((X + xt - 1) / xt != nxs) continue;
    const long long units = cols * nxs;
    if (units > 0x7fffffffLL) break;
    const long long per_block = (units + target - 1) / target;
    const long long cost = per_block * (xt + k - 1 + 2);
    if (best < 0 || cost < best) {
      best = cost;
      *s = {nxs, xt, units, per_block};
    }
  }
  return best >= 0;
}

// The grid of a persistent kernel: at most the blocks of `threads` threads
// and `smem` bytes the current card holds at once, at most `tiles`.
// Returns a CUDA error code (0: none). The shared-memory opt-in and the
// occupancy query cost about as much as a small launch, so each (kernel,
// threads, smem, device) is asked once (from one host thread, as every
// launcher here).
template <typename Kernel>
int persistent_grid(Kernel kernel, int threads, int smem, long long tiles, long long* grid) {
  struct Known {
    const void* fn;
    int threads, smem, dev;
    long long cap;
  };
  static Known known[256];
  static int n_known = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  long long cap = 0;
  for (int i = 0; i < n_known && !cap; ++i)
    if (known[i].fn == (const void*)kernel && known[i].threads == threads &&
        known[i].smem == smem && known[i].dev == dev)
      cap = known[i].cap;
  if (!cap) {
    int sms = 0, per_sm = 0;
    // the opt-in at its most, so launches of other sizes stay allowed
    if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  SMEM_OPTIN)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
            cudaSuccess)
      return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cap = (long long)sms * per_sm;
    if (n_known < 256) known[n_known++] = {(const void*)kernel, threads, smem, dev, cap};
  }
  *grid = tiles < cap ? tiles : cap;
  return 0;
}
