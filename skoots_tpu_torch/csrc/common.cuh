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
