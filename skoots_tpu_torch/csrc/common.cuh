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

// Row LayerNorm of one [C] row held by one warp: lane l owns elements
// l, l + 32, ... (C / 32 of them, C % 32 == 0). Statistics in float32 as
// the TPU kernels compute them: mu = mean(x), var = mean((x - mu)^2),
// h = (x - mu) * (1 / sqrt(var + eps)) * scale + bias, then one rounding to
// T. Every step is an IEEE-rounded intrinsic (no contraction into FMAs) in
// the plain version's order, so kernel and plain version agree exactly.
template <typename T, int C>
__device__ __forceinline__ void warp_layer_norm(const T* __restrict__ xrow,
                                                bool valid,
                                                const float* __restrict__ ls,
                                                const float* __restrict__ lb,
                                                float eps, float* hrow) {
  constexpr int PER = C / 32;
  const int lane = threadIdx.x & 31;
  float v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i)
    v[i] = valid ? to_f32<T>(xrow[lane + 32 * i]) : 0.f;
  float s = v[0];
#pragma unroll
  for (int i = 1; i < PER; ++i) s = __fadd_rn(s, v[i]);
  const float mu = __fdiv_rn(warp_fold_sum(s), (float)C);
#pragma unroll
  for (int i = 0; i < PER; ++i) v[i] = __fsub_rn(v[i], mu);
  float q = __fmul_rn(v[0], v[0]);
#pragma unroll
  for (int i = 1; i < PER; ++i) q = __fadd_rn(q, __fmul_rn(v[i], v[i]));
  const float var = __fdiv_rn(warp_fold_sum(q), (float)C);
  const float inv = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = lane + 32 * i;
    hrow[c] = rnd<T>(__fadd_rn(__fmul_rn(__fmul_rn(v[i], inv), ls[c]), lb[c]));
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
