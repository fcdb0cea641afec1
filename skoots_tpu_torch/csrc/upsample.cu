// 2x trilinear upsample of channels-last volumes: [B, X, Y, Z, C] ->
// [B, 2X, 2Y, 2Z, C], half-pixel centres, edge clamp.
//
// Replaces skoots_tpu/kernels/upsample.py::_upsample2x_call (the Pallas
// kernel that DMAs an edge-padded halo block into VMEM and runs the three
// separable cascades there). The Pallas design's 128-lane channel padding,
// pre-stacked z chunks and VMEM block picker exist for Mosaic and are not
// carried over.
//
// Numerics, as the plain version (kernels/upsample.py::upsample2x_ref): along
// x, then y, then z, every output is 0.75 * centre + 0.25 * neighbour in
// float32, each product and the sum rounded on its own (__fmul_rn /
// __fadd_rn: nvcc would otherwise contract them into an FMA), neighbour
// indices clamped to [0, n - 1]; one rounding to T at the end. The kernel
// therefore equals the plain version bit for bit.
//
// Design: one thread per input element (voxel, channel), consecutive threads
// on consecutive channels, so every load and store of a warp is coalesced
// along C. The thread reads the 3x3x3 neighbourhood of its voxel (mostly
// from L1: neighbouring threads of other voxels read the same values) and
// writes the 2x2x2 outputs it is the centre of.
//
// What bounds it on the H100: bytes. It reads the input once and writes the
// output, 8x larger, once (at the bench tile's [1, 64, 64, 24, 128] bf16:
// 226.5 MB, 0.068 ms at 3.35 TB/s); its 114 float operations per input
// element (the separable cascade needs 42) are far below the FP32 rate. The
// 27 loads per thread are served by L1/L2.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float blend(float centre, float nbr) {
  return __fadd_rn(__fmul_rn(0.75f, centre), __fmul_rn(0.25f, nbr));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
upsample2x_kernel(const T* __restrict__ x, T* __restrict__ out, int B, int X,
                  int Y, int Z, int C) {
  const long long n = (long long)B * X * Y * Z * C;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < n;
       e += stride) {
    const int c = (int)(e % C);
    long long r = e / C;
    const int k = (int)(r % Z);
    r /= Z;
    const int j = (int)(r % Y);
    r /= Y;
    const int i = (int)(r % X);
    const long long b = r / X;
    const int ii[3] = {max(i - 1, 0), i, min(i + 1, X - 1)};
    const int jj[3] = {max(j - 1, 0), j, min(j + 1, Y - 1)};
    const int kk[3] = {max(k - 1, 0), k, min(k + 1, Z - 1)};

    float v[3][3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int s = 0; s < 3; ++s)
          v[a][q][s] = to_f32<T>(
              x[(((b * X + ii[a]) * Y + jj[q]) * Z + kk[s]) * C + c]);

    // x step: [even (i-1 side), odd (i+1 side)] at the 3x3 (y, z) points
    float t1[2][3][3];
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        t1[0][q][s] = blend(v[1][q][s], v[0][q][s]);
        t1[1][q][s] = blend(v[1][q][s], v[2][q][s]);
      }
    // y step on the x step's values
    float t2[2][2][3];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        t2[a][0][s] = blend(t1[a][1][s], t1[a][0][s]);
        t2[a][1][s] = blend(t1[a][1][s], t1[a][2][s]);
      }
    // z step, one rounding to T, eight outputs
    const long long oy = 2LL * Y, oz = 2LL * Z;
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const long long row =
            (((b * 2 * X + 2 * i + a) * oy + 2 * j + q) * oz + 2 * k) * C + c;
        out[row] = from_f32<T>(blend(t2[a][q][1], t2[a][q][0]));
        out[row + C] = from_f32<T>(blend(t2[a][q][1], t2[a][q][2]));
      }
  }
}

template <typename T>
int launch(const void* x, void* out, int B, int X, int Y, int Z, int C,
           cudaStream_t stream) {
  const long long n = (long long)B * X * Y * Z * C;
  const long long blocks = std::min((n + THREADS - 1) / THREADS, 1LL << 20);
  upsample2x_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), B, X, Y, Z, C);
  return (int)cudaGetLastError();
}

}  // namespace

// x: T [B, X, Y, Z, C] contiguous; out: T [B, 2X, 2Y, 2Z, C].
extern "C" int skoots_upsample2x(int dtype, const void* x, void* out, int B,
                                 int X, int Y, int Z, int C, void* stream) {
  if (B <= 0 || X <= 0 || Y <= 0 || Z <= 0 || C <= 0)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == SKOOTS_F32) return launch<float>(x, out, B, X, Y, Z, C, s);
  if (dtype == SKOOTS_BF16)
    return launch<__nv_bfloat16>(x, out, B, X, Y, Z, C, s);
  return (int)cudaErrorInvalidValue;
}
