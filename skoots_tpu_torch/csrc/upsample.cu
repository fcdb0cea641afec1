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
// What bounds it on the H100: bytes, if the instructions a value stay few.
// It reads the input once and writes the output, 8x larger, once (at the
// bench tile's [1, 128, 128, 48, 64] bf16: 906 MB, 0.27 ms at 3.35 TB/s);
// the separable cascade needs 14 blends (42 FP32 operations) an input
// value, far below the FP32 rate, but one thread per value with its own
// index arithmetic and 27 scalar loads is not (that design took 1.5 ms).
//
// Design: a z-march. A thread owns V channels (16 bytes: 8 bf16 or 4 f32;
// fewer where C or the pointers allow no more) of one (b, i, j) column and
// walks a segment of S input planes along z. For each plane k it loads the
// 3x3 (x, y) neighbourhood (9 vector loads, mostly L1/L2 hits: neighbouring
// threads read the same columns), blends along x (6) and y (4) into the
// plane's four (x, y) outputs P_k, and with the previous plane's P_{k-1}
// (held in registers) writes output planes 2k - 1 and 2k (8 z-blends, eight
// vector stores): 18 blends a value, the x blends of the neighbouring y
// columns computed again rather than exchanged. A segment starts by re-reading the plane below it (the
// first: plane 0 itself, the clamp) and the last segment also writes plane
// 2Z - 1 (its neighbour clamped to itself). The grid gives (b X + i) and j
// directly: index arithmetic is 32-bit and paid once a thread; the loop adds
// C a plane to nine column offsets and divides nothing.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float blend(float centre, float nbr) {
  return __fadd_rn(__fmul_rn(0.75f, centre), __fmul_rn(0.25f, nbr));
}

// V values of T as one load or store of V * sizeof(T) bytes
template <int BYTES>
struct Raw;
template <>
struct Raw<16> { using type = uint4; };
template <>
struct Raw<8> { using type = uint2; };
template <>
struct Raw<4> { using type = unsigned int; };
template <>
struct Raw<2> { using type = unsigned short; };

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]) {
  using R = typename Raw<V * sizeof(T)>::type;
  const R r = __ldg(reinterpret_cast<const R*>(p));
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = to_f32<T>(e[i]);
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  using R = typename Raw<V * sizeof(T)>::type;
  R r;
  T* e = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int i = 0; i < V; ++i) e[i] = from_f32<T>(v[i]);
  *reinterpret_cast<R*>(p) = r;
}

// block: `cpb` channel vectors x `jb` columns j; grid: x = b X + i,
// y = (j block, channel block), z = segment of S planes
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
upsample2x_kernel(const T* __restrict__ x, T* __restrict__ out, int X, int Y, int Z, int C,
                  int S, int cpb, int jb, int ncb) {
  const int t = threadIdx.x;
  const int cv = (blockIdx.y % ncb) * cpb + t % cpb;
  const int j = (blockIdx.y / ncb) * jb + t / cpb;
  if (t >= cpb * jb || cv * V >= C || j >= Y) return;
  const int bi = blockIdx.x;  // b X + i
  const int i = bi % X;
  const int k0 = blockIdx.z * S;
  const int k1 = min(k0 + S, Z);
  const int c = cv * V;

  // the 3x3 input columns (i + a - 1, j + q - 1), edge-clamped, and the four
  // output columns (2i + a, 2j + q)
  const T* col[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int ii = min(max(i + a - 1, 0), X - 1);
      const int jj = min(max(j + q - 1, 0), Y - 1);
      col[a][q] = x + ((long long)(bi - i + ii) * Y + jj) * Z * C + c;
    }
  T* ocol[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int q = 0; q < 2; ++q)
      ocol[a][q] = out + ((2LL * bi + a) * (2 * Y) + 2 * j + q) * (2LL * Z) * C + c;

  // P_k: the x then y blends of plane k at the four (x, y) outputs
  auto plane = [&](int k, float (&p)[2][2][V]) {
    const int off = k * C;
    float v[3][3][V];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int q = 0; q < 3; ++q) load_vec<T, V>(col[a][q] + off, v[a][q]);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float t1[2][3];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        t1[0][q] = blend(v[1][q][e], v[0][q][e]);
        t1[1][q] = blend(v[1][q][e], v[2][q][e]);
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        p[a][0][e] = blend(t1[a][1], t1[a][0]);
        p[a][1][e] = blend(t1[a][1], t1[a][2]);
      }
    }
  };
  // output plane z of column (a, q): blend(centre, neighbour)
  auto emit = [&](int z, const float (&ctr)[2][2][V], const float (&nbr)[2][2][V]) {
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float o[V];
#pragma unroll
        for (int e = 0; e < V; ++e) o[e] = blend(ctr[a][q][e], nbr[a][q][e]);
        store_vec<T, V>(ocol[a][q] + z * C, o);
      }
  };

  float prev[2][2][V], cur[2][2][V];
  plane(max(k0 - 1, 0), prev);
  for (int k = k0; k < k1; ++k) {
    plane(k, cur);
    if (k > 0) emit(2 * k - 1, prev, cur);  // plane k - 1's odd output
    emit(2 * k, cur, prev);                 // plane k's even output
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < V; ++e) prev[a][q][e] = cur[a][q][e];
  }
  if (k1 == Z) emit(2 * Z - 1, prev, prev);
}

// the widest vector of at most 16 bytes that divides C and both pointers'
// alignment
template <typename T>
int pick_vec(const void* x, const void* out, int C) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out);
  for (int v = 16 / (int)sizeof(T); v > 1; v /= 2)
    if (C % v == 0 && a % (v * sizeof(T)) == 0) return v;
  return 1;
}

template <typename T, int V>
int launch_v(const void* x, void* out, int B, int X, int Y, int Z, int C, int S,
             cudaStream_t stream) {
  const int cvs = C / V;                      // channel vectors a voxel
  const int cpb = cvs < THREADS ? cvs : THREADS;
  const int jb = THREADS / cpb;
  const int ncb = (cvs + cpb - 1) / cpb;
  const long long gy = (long long)((Y + jb - 1) / jb) * ncb;
  const long long gz = (Z + S - 1) / S;
  if ((long long)B * X > 0x7fffffffLL || gy > 65535 || gz > 65535 ||
      (long long)Z * C > 0x3fffffffLL)
    return (int)cudaErrorInvalidValue;
  upsample2x_kernel<T, V><<<dim3((unsigned)(B * X), (unsigned)gy, (unsigned)gz), THREADS, 0,
                            stream>>>(static_cast<const T*>(x), static_cast<T*>(out), X, Y, Z,
                                      C, S, cpb, jb, ncb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, void* out, int B, int X, int Y, int Z, int C, int S,
           cudaStream_t stream) {
  const int v = pick_vec<T>(x, out, C);
  if constexpr (sizeof(T) == 2) {
    if (v == 8) return launch_v<T, 8>(x, out, B, X, Y, Z, C, S, stream);
  }
  if (v == 4) return launch_v<T, 4>(x, out, B, X, Y, Z, C, S, stream);
  if (v == 2) return launch_v<T, 2>(x, out, B, X, Y, Z, C, S, stream);
  return launch_v<T, 1>(x, out, B, X, Y, Z, C, S, stream);
}

}  // namespace

// x: T [B, X, Y, Z, C] contiguous; out: T [B, 2X, 2Y, 2Z, C]; a thread
// marches over `planes` input planes along z.
extern "C" int skoots_upsample2x(int dtype, const void* x, void* out, int B,
                                 int X, int Y, int Z, int C, int planes, void* stream) {
  if (B <= 0 || X <= 0 || Y <= 0 || Z <= 0 || C <= 0 || planes <= 0)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == SKOOTS_F32) return launch<float>(x, out, B, X, Y, Z, C, planes, s);
  if (dtype == SKOOTS_BF16)
    return launch<__nv_bfloat16>(x, out, B, X, Y, Z, C, planes, s);
  return (int)cudaErrorInvalidValue;
}
