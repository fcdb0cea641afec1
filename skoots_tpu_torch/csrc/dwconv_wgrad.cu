// Weight gradient of the depthwise k^3 SAME correlation, channels-last:
//   dw[dx, dy, dz, c] = sum_{b, p} xpad[b, p + (dx, dy, dz), c] * g[b, p, c]
// with xpad the input zero-padded by (k - 1) / 2 on every side; f32 sums.
//
// Replaces skoots_tpu/kernels/dwconv.py::dwconv3d_wgrad_pallas_v2 (the TPU
// default) and dwconv3d_wgrad_pallas (same function, full-block reduce).
//
// What bounds it on the H100: V voxels reduce into k^3 * C outputs with
// k^3 = 343 FMAs per (voxel, channel) -- at the training crop's C = 32 level
// (96 x 96 x 32) that is ~3.2 GFMA against ~38 MB of bf16 traffic, so it is
// FP32-FMA bound like the forward. The TPU kernel carries the sums across
// its sequential grid in VMEM; here blocks run in parallel, so:
//  * a block stages an (TX+k-1) x (TY+k-1) x (TZ+k-1) x halo tile and the
//    matching TX x TY x TZ cotangent tile of CC channels in shared memory;
//  * each thread owns one (dx, dy, channel) and the k dz taps of it in
//    registers; per tile column (x, y) it loads the TZ+k-1 inputs and TZ
//    cotangents of its column once and reuses each for k taps;
//  * each block writes its k^3 x CC partial sums to [n_blocks, k^3, C] f32,
//    and a second launch sums the blocks in a fixed order -- no float
//    atomics, so the result is the same from run to run;
//  * the batch is a grid axis (its blocks are more partials), and the stem's
//    single input channel is read with a channel stride of 0, as in the
//    forward kernel (csrc/dwconv.cu).
#include "common.cuh"

namespace {

constexpr int CC = 8;   // channels per block
constexpr int TX = 8;   // voxel tile
constexpr int TY = 8;
constexpr int TZ = 16;

template <int K>
constexpr int smem_bytes(int elem) {
  return ((TX + K - 1) * (TY + K - 1) * (TZ + K - 1) + TX * TY * TZ) * CC * elem;
}

int n_tiles(int B, int X, int Y, int Z) {
  return B * ((X + TX - 1) / TX) * ((Y + TY - 1) / TY) * ((Z + TZ - 1) / TZ);
}

template <typename T, int K>
__global__ void __launch_bounds__(K * K * CC)
dwconv3d_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      float* __restrict__ partial, int X, int Y, int Z, int C,
                      long long x_vstride, long long x_cstride) {
  constexpr int P = (K - 1) / 2;
  constexpr int SX = TX + K - 1, SY = TY + K - 1, SZ = TZ + K - 1;
  constexpr int NT = K * K * CC;  // one thread per (dx, dy, channel)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // [SX][SY][SZ][CC]
  T* gs = xs + SX * SY * SZ * CC;          // [TX][TY][TZ][CC]

  const int nzb = (Z + TZ - 1) / TZ;
  const int nyb = (Y + TY - 1) / TY;
  const int nxb = (X + TX - 1) / TX;
  const int z0 = (blockIdx.x % nzb) * TZ;
  const int y0 = (blockIdx.x / nzb) * TY;
  const int x0 = blockIdx.y * TX;
  const int nchunk = (C + CC - 1) / CC;
  const int bi = blockIdx.z / nchunk;
  const int c0 = (blockIdx.z % nchunk) * CC;
  const int tid = threadIdx.x;

  const T* xb = x + (long long)bi * X * Y * Z * x_vstride;
  for (int i = tid; i < SX * SY * SZ * CC; i += NT) {
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
  const T* gb = g + (long long)bi * X * Y * Z * C;
  for (int i = tid; i < TX * TY * TZ * CC; i += NT) {
    const int cc = i % CC;
    int r = i / CC;
    const int tz = r % TZ;
    r /= TZ;
    const int ty = r % TY;
    const int tx = r / TY;
    const int gx = x0 + tx, gy = y0 + ty, gz = z0 + tz;
    const int c = c0 + cc;
    T v = from_f32<T>(0.f);  // cotangent 0 outside the volume: no contribution
    if (gx < X && gy < Y && gz < Z && c < C)
      v = gb[(((long long)gx * Y + gy) * Z + gz) * C + c];
    gs[i] = v;
  }
  __syncthreads();

  const int cc = tid % CC;
  const int dy = (tid / CC) % K;
  const int dx = tid / (CC * K);
  float acc[K];
#pragma unroll
  for (int d = 0; d < K; ++d) acc[d] = 0.f;

  for (int tx = 0; tx < TX; ++tx) {
#pragma unroll 1
    for (int ty = 0; ty < TY; ++ty) {
      const T* col = xs + ((tx + dx) * SY + (ty + dy)) * SZ * CC + cc;
      const T* gcol = gs + (tx * TY + ty) * TZ * CC + cc;
      float v[SZ];
#pragma unroll
      for (int s = 0; s < SZ; ++s) v[s] = to_f32<T>(col[s * CC]);
#pragma unroll
      for (int z = 0; z < TZ; ++z) {
        const float gv = to_f32<T>(gcol[z * CC]);
#pragma unroll
        for (int dz = 0; dz < K; ++dz) acc[dz] = fmaf(v[z + dz], gv, acc[dz]);
      }
    }
  }

  const int c = c0 + cc;
  if (c >= C) return;
  const long long blk =
      ((long long)bi * nxb + blockIdx.y) * ((long long)nyb * nzb) + blockIdx.x;
  float* out = partial + blk * (K * K * K) * C + c;
#pragma unroll
  for (int dz = 0; dz < K; ++dz)
    out[(long long)((dx * K + dy) * K + dz) * C] = acc[dz];
}

// out[i] = sum over blocks b = 0, 1, ... of partial[b, i], in that order.
__global__ void wgrad_reduce_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int n_blocks,
                                    int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += partial[(long long)b * n + i];
  out[i] = s;
}

template <typename T, int K>
int launch(const void* x, const void* g, float* partial, float* out, int B,
           int X, int Y, int Z, int C, long long x_vstride,
           long long x_cstride, cudaStream_t stream) {
  const int smem = smem_bytes<K>(sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(
      dwconv3d_wgrad_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(((Z + TZ - 1) / TZ) * ((Y + TY - 1) / TY), (X + TX - 1) / TX,
            B * ((C + CC - 1) / CC));
  dwconv3d_wgrad_kernel<T, K><<<grid, K * K * CC, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partial, X, Y, Z, C,
      x_vstride, x_cstride);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n = K * K * K * C;
  wgrad_reduce_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      partial, out, n_tiles(B, X, Y, Z), n);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_k(int k, const void* x, const void* g, float* partial, float* out,
               int B, int X, int Y, int Z, int C, long long x_vstride,
               long long x_cstride, cudaStream_t s) {
  switch (k) {
    case 3: return launch<T, 3>(x, g, partial, out, B, X, Y, Z, C, x_vstride, x_cstride, s);
    case 5: return launch<T, 5>(x, g, partial, out, B, X, Y, Z, C, x_vstride, x_cstride, s);
    case 7: return launch<T, 7>(x, g, partial, out, B, X, Y, Z, C, x_vstride, x_cstride, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Number of voxel tiles (= rows of the partial-sum buffer) for a
// [B, X, Y, Z] volume; the wrapper allocates [tiles, k^3, C] f32.
extern "C" int skoots_dwconv3d_wgrad_tiles(int B, int X, int Y, int Z) {
  return n_tiles(B, X, Y, Z);
}

// x: [B, X, Y, Z, *] of `dtype`, element (v, c) at v * x_vstride + c *
// x_cstride (x_cstride = 0: one input channel read for all C, the stem);
// g: [B, X, Y, Z, C] of `dtype`; partial: f32 scratch [tiles, k^3, C];
// out: f32 [k, k, k, C].
extern "C" int skoots_dwconv3d_wgrad(int dtype, const void* x, const void* g,
                                     void* partial, void* out, int B, int X,
                                     int Y, int Z, int C, int k,
                                     long long x_vstride, long long x_cstride,
                                     void* stream) {
  float* pf = static_cast<float*>(partial);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == SKOOTS_BF16)
    return dispatch_k<__nv_bfloat16>(k, x, g, pf, of, B, X, Y, Z, C, x_vstride, x_cstride, s);
  if (dtype == SKOOTS_F32)
    return dispatch_k<float>(k, x, g, pf, of, B, X, Y, Z, C, x_vstride, x_cstride, s);
  return (int)cudaErrorInvalidValue;
}
