// Fused ConvNeXt block tail on [V, C] rows (channels-last voxels):
//     out = shortcut + gamma * (pw2(GELU_erf(pw1(LN(x))))),   C -> 4C -> C.
//
// Replaces skoots_tpu/kernels/mlp.py::_mlp_call (body `_kernel`). Same
// rounding points to the storage type T (bf16 on the main path): after the
// LayerNorm affine, after each matmul (f32 accumulation), after each bias
// add, after GELU, after the layer-scale multiply and after the residual add.
// GELU uses erff (the Pallas kernel's A&S polynomial differs by <= 1.5e-7).
//
// What bounds it on the H100: the XLA composition writes the [V, 4C] hidden
// activation to device memory twice; here it never leaves the SM, so traffic
// is 4*C bytes per voxel (read x and shortcut, write out) and the two GEMMs
// (8*C^2 FMAs per voxel) bound the kernel. This first version runs them as
// register-blocked scalar FP32 FMAs on bf16 operands (exact products, f32
// sums -- the same arithmetic as the tensor cores' bf16 path, in another
// order). A block owns 32 voxel rows; the hidden activation is produced in
// chunks of 128 columns into shared memory and immediately consumed by the
// second GEMM, whose [32, C] accumulators stay in registers across chunks.
// Moving both GEMMs to mma.sync / wgmma is the next step.
#include "common.cuh"

namespace {

constexpr int T_ROWS = 32;
constexpr int THREADS = 256;
constexpr int HC = 128;  // hidden columns per chunk

template <typename T>
__device__ __forceinline__ void load8(const T* p, float* v);
template <>
__device__ __forceinline__ void load8<__nv_bfloat16>(const __nv_bfloat16* p,
                                                     float* v) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
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
mlp_tail_kernel(const T* __restrict__ x, const T* __restrict__ sc,
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

template <typename T, int C>
int launch(const void* x, const void* sc, const float* ls, const float* lb,
           const void* w1, const float* b1, const void* w2, const float* b2,
           const float* gamma, void* out, long long V, float eps,
           cudaStream_t s) {
  const long long blocks = (V + T_ROWS - 1) / T_ROWS;
  mlp_tail_kernel<T, C><<<(unsigned)blocks, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(sc), ls, lb,
      static_cast<const T*>(w1), b1, static_cast<const T*>(w2), b2, gamma,
      static_cast<T*>(out), V, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_c(int C, const void* x, const void* sc, const float* ls,
               const float* lb, const void* w1, const float* b1,
               const void* w2, const float* b2, const float* gamma,
               void* out, long long V, float eps, cudaStream_t s) {
  switch (C) {
    case 32: return launch<T, 32>(x, sc, ls, lb, w1, b1, w2, b2, gamma, out, V, eps, s);
    case 64: return launch<T, 64>(x, sc, ls, lb, w1, b1, w2, b2, gamma, out, V, eps, s);
    case 128: return launch<T, 128>(x, sc, ls, lb, w1, b1, w2, b2, gamma, out, V, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, shortcut, out: [V, C] of `dtype`; w1: [C, 4C], w2: [4C, C] of `dtype`;
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
  if (dtype == SKOOTS_BF16)
    return dispatch_c<__nv_bfloat16>(C, x, shortcut, ls, lb, w1, fb1, w2, fb2, g, out, V, eps, s);
  if (dtype == SKOOTS_F32)
    return dispatch_c<float>(C, x, shortcut, ls, lb, w1, fb1, w2, fb2, g, out, V, eps, s);
  return (int)cudaErrorInvalidValue;
}
