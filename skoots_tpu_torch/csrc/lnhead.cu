// Fused LayerNorm + 1x1 head on [V, C] rows: out = LN(x) @ W + b, C -> N.
//
// Replaces skoots_tpu/kernels/lnhead.py::_ln_head_call (body `_kernel`).
// Same numerics: LN statistics in f32 (eps 1e-6), the affine result rounded
// to the storage type T, the matmul accumulated in f32 and rounded to T, then
// the bias added and rounded once more. The LayerNorm and the dot products
// run in the plain version's order with IEEE-rounded, unfused steps
// (kernels/lnhead.py::ln_head_ref), so the two agree bit for bit: three
// rounding points in a row would otherwise turn one upstream tie into two
// ulps at the output.
//
// What bounds it on the H100: read C and write N values per voxel (128 B at
// C = N = 32 in bf16) against C*N FMAs -- a memory-bound pass. The design
// makes it a single pass: a block LayerNorms 32 rows (one warp per row) into
// shared memory, keeps W in shared memory as f32, and writes the N outputs
// of each row with consecutive threads on consecutive columns.
#include "common.cuh"

namespace {

constexpr int T_ROWS = 32;
constexpr int THREADS = 256;

template <typename T, int C>
__global__ void __launch_bounds__(THREADS)
ln_head_kernel(const T* __restrict__ x, const float* __restrict__ ls,
               const float* __restrict__ lb, const T* __restrict__ w,
               const float* __restrict__ b, T* __restrict__ out, long long V,
               int N, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                   // [C][N]
  float* hs = smem + C * N;           // [T_ROWS][C]
  const long long row0 = (long long)blockIdx.x * T_ROWS;
  const int tid = threadIdx.x;
  for (int i = tid; i < C * N; i += THREADS) ws[i] = to_f32<T>(w[i]);
  for (int r = tid >> 5; r < T_ROWS; r += THREADS / 32) {
    const long long g = row0 + r;
    warp_layer_norm<T, C>(x + (g < V ? g : 0) * C, g < V, ls, lb, eps,
                          hs + r * C);
  }
  __syncthreads();
  for (int i = tid; i < T_ROWS * N; i += THREADS) {
    const int r = i / N, n = i % N;
    const long long g = row0 + r;
    if (g >= V) continue;
    const float* h = hs + r * C;
    float acc = __fmul_rn(h[0], ws[n]);
#pragma unroll 8
    for (int k = 1; k < C; ++k) acc = __fadd_rn(acc, __fmul_rn(h[k], ws[k * N + n]));
    out[g * N + n] = from_f32<T>(rnd<T>(acc) + b[n]);
  }
}

template <typename T, int C>
int launch(const void* x, const float* ls, const float* lb, const void* w,
           const float* b, void* out, long long V, int N, float eps,
           cudaStream_t s) {
  const int smem = (C * N + T_ROWS * C) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      ln_head_kernel<T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (V + T_ROWS - 1) / T_ROWS;
  ln_head_kernel<T, C><<<(unsigned)blocks, THREADS, smem, s>>>(
      static_cast<const T*>(x), ls, lb, static_cast<const T*>(w), b,
      static_cast<T*>(out), V, N, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_c(int C, const void* x, const float* ls, const float* lb,
               const void* w, const float* b, void* out, long long V, int N,
               float eps, cudaStream_t s) {
  switch (C) {
    case 32: return launch<T, 32>(x, ls, lb, w, b, out, V, N, eps, s);
    case 64: return launch<T, 64>(x, ls, lb, w, b, out, V, N, eps, s);
    case 128: return launch<T, 128>(x, ls, lb, w, b, out, V, N, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: [V, C] of `dtype`; w: [C, N] of `dtype`; ln_scale, ln_bias: f32 [C];
// b: f32 [N] (values already rounded to `dtype`); out: [V, N] of `dtype`.
extern "C" int skoots_ln_head(int dtype, const void* x, const void* ln_scale,
                              const void* ln_bias, const void* w,
                              const void* b, void* out, long long V, int C,
                              int N, float eps, void* stream) {
  const float* ls = static_cast<const float*>(ln_scale);
  const float* lb = static_cast<const float*>(ln_bias);
  const float* fb = static_cast<const float*>(b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == SKOOTS_BF16)
    return dispatch_c<__nv_bfloat16>(C, x, ls, lb, w, fb, out, V, N, eps, s);
  if (dtype == SKOOTS_F32)
    return dispatch_c<float>(C, x, ls, lb, w, fb, out, V, N, eps, s);
  return (int)cudaErrorInvalidValue;
}
