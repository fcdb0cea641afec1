// Depthwise k^3 SAME correlation plus bias, channels-last [B, X, Y, Z, C].
//
// Replaces skoots_tpu/kernels/dwconv.py::dwconv3d_pallas_v4 (and the two
// older TPU layouts dwconv3d_pallas / dwconv3d_pallas_v6, which compute the
// same function). Same numerics: f32 accumulation of the k^3 taps, the bias
// added in f32, ONE rounding to the storage type at the end.
//
// What bounds it on the H100: at k = 7 every output costs 343 FMAs, so a
// [256, 256, 96, 32] bf16 layer is ~69 GFMA against ~0.8 GB of traffic --
// arithmetic (FP32 pipe), not HBM. The design therefore spends its effort on
// operand reuse: a block stages a (TX+k-1) x (TY+k-1) x (TZ+k-1) halo tile of
// CC channels in shared memory once, each thread owns one (x, y, channel)
// column of TZ outputs in registers, and for every (dx, dy) tap pair it loads
// the TZ+k-1 input values of its column once and reuses each for k dz taps.
// The stem (a dense 1 -> C conv) reads the single input channel with a
// channel stride of 0 instead of materialising the broadcast.
#include "common.cuh"

namespace {

constexpr int CC = 8;   // channels per block
constexpr int TX = 8;   // output tile
constexpr int TY = 8;
constexpr int TZ = 16;
constexpr int THREADS = CC * TX * TY;  // one thread per (x, y, channel) column

template <int K>
constexpr int smem_bytes(int elem) {
  return K * K * K * CC * 4 + (TX + K - 1) * (TY + K - 1) * (TZ + K - 1) * CC * elem;
}

template <typename T, int K>
__global__ void __launch_bounds__(THREADS)
dwconv3d_kernel(const T* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ b, T* __restrict__ out, int X, int Y,
                int Z, int C, long long x_vstride, long long x_cstride) {
  constexpr int P = (K - 1) / 2;
  constexpr int SX = TX + K - 1, SY = TY + K - 1, SZ = TZ + K - 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ws = reinterpret_cast<float*>(smem_raw);  // [K^3][CC]
  T* xs = reinterpret_cast<T*>(ws + K * K * K * CC);  // [SX][SY][SZ][CC]

  const int nzb = (Z + TZ - 1) / TZ;
  const int z0 = (blockIdx.x % nzb) * TZ;
  const int y0 = (blockIdx.x / nzb) * TY;
  const int x0 = blockIdx.y * TX;
  const int nchunk = (C + CC - 1) / CC;
  const int bi = blockIdx.z / nchunk;
  const int c0 = (blockIdx.z % nchunk) * CC;
  const int tid = threadIdx.x;

  for (int i = tid; i < K * K * K * CC; i += THREADS) {
    const int c = c0 + i % CC;
    ws[i] = c < C ? w[(long long)(i / CC) * C + c] : 0.f;
  }
  const T* xb = x + (long long)bi * X * Y * Z * x_vstride;
  for (int i = tid; i < SX * SY * SZ * CC; i += THREADS) {
    const int cc = i % CC;
    int r = i / CC;
    const int sz = r % SZ;
    r /= SZ;
    const int sy = r % SY;
    const int sx = r / SY;
    const int gx = x0 + sx - P, gy = y0 + sy - P, gz = z0 + sz - P;
    const int c = c0 + cc;
    T v = from_f32<T>(0.f);
    if (gx >= 0 && gx < X && gy >= 0 && gy < Y && gz >= 0 && gz < Z && c < C)
      v = xb[(((long long)gx * Y + gy) * Z + gz) * x_vstride + c * x_cstride];
    xs[i] = v;
  }
  __syncthreads();

  const int cc = tid % CC;
  const int ty = (tid / CC) % TY;
  const int tx = tid / (CC * TY);
  float acc[TZ];
#pragma unroll
  for (int o = 0; o < TZ; ++o) acc[o] = 0.f;

  for (int dx = 0; dx < K; ++dx) {
#pragma unroll 1
    for (int dy = 0; dy < K; ++dy) {
      const T* col = xs + ((tx + dx) * SY + (ty + dy)) * SZ * CC + cc;
      float v[SZ];
#pragma unroll
      for (int s = 0; s < SZ; ++s) v[s] = to_f32<T>(col[s * CC]);
      const float* wt = ws + (dx * K + dy) * K * CC + cc;
#pragma unroll
      for (int dz = 0; dz < K; ++dz) {
        const float wv = wt[dz * CC];
#pragma unroll
        for (int o = 0; o < TZ; ++o) acc[o] = fmaf(v[o + dz], wv, acc[o]);
      }
    }
  }

  const int c = c0 + cc;
  const int gx = x0 + tx, gy = y0 + ty;
  if (c >= C || gx >= X || gy >= Y) return;
  const float bias = b[c];
  T* ob = out + ((((long long)bi * X + gx) * Y + gy) * Z) * C + c;
#pragma unroll
  for (int o = 0; o < TZ; ++o)
    if (z0 + o < Z) ob[(long long)(z0 + o) * C] = from_f32<T>(acc[o] + bias);
}

template <typename T, int K>
int launch(const void* x, const float* w, const float* b, void* out, int B,
           int X, int Y, int Z, int C, long long x_vstride,
           long long x_cstride, cudaStream_t stream) {
  const int smem = smem_bytes<K>(sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(
      dwconv3d_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(((Z + TZ - 1) / TZ) * ((Y + TY - 1) / TY), (X + TX - 1) / TX,
            B * ((C + CC - 1) / CC));
  dwconv3d_kernel<T, K><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), w, b, static_cast<T*>(out), X, Y, Z, C,
      x_vstride, x_cstride);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_k(int k, const void* x, const float* w, const float* b,
               void* out, int B, int X, int Y, int Z, int C,
               long long x_vstride, long long x_cstride, cudaStream_t s) {
  switch (k) {
    case 3: return launch<T, 3>(x, w, b, out, B, X, Y, Z, C, x_vstride, x_cstride, s);
    case 5: return launch<T, 5>(x, w, b, out, B, X, Y, Z, C, x_vstride, x_cstride, s);
    case 7: return launch<T, 7>(x, w, b, out, B, X, Y, Z, C, x_vstride, x_cstride, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: [B, X, Y, Z, *] of `dtype`, element (v, c) at v * x_vstride + c *
// x_cstride (x_cstride = 0 broadcasts one input channel to all C outputs).
// w: f32 [k, k, k, C]; b: f32 [C]; out: [B, X, Y, Z, C] of `dtype`.
extern "C" int skoots_dwconv3d(int dtype, const void* x, const void* w,
                               const void* b, void* out, int B, int X, int Y,
                               int Z, int C, int k, long long x_vstride,
                               long long x_cstride, void* stream) {
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == SKOOTS_BF16)
    return dispatch_k<__nv_bfloat16>(k, x, wf, bf, out, B, X, Y, Z, C, x_vstride, x_cstride, s);
  if (dtype == SKOOTS_F32)
    return dispatch_k<float>(k, x, wf, bf, out, B, X, Y, Z, C, x_vstride, x_cstride, s);
  return (int)cudaErrorInvalidValue;
}
