// Two microbenchmarks of the card's arithmetic rates, the Hopper
// counterparts of the JAX package's TPU tools:
//
//  * FMA rate (replaces tools/bench_vpu_pallas.py::kernel, a VPU chain
//    x <- x * a + b of 512 x 16 dependent steps over a VMEM-resident
//    (rows, 128) array): here a dependent fmaf chain per element, in f32, or
//    __hfma2 on bf16 pairs. A thread runs CH independent chains, so CH > 1
//    hides the FMA latency at full occupancy. Bound: FP32 (or packed bf16)
//    FMA throughput, nothing else; the only memory traffic is one load of a
//    and b and one store per element.
//
//  * Load + FMA (replaces tools/bench_loadfma.py::k_static / k_dynamic /
//    k_static_chains / k_dynamic_chains): the depthwise conv's access
//    pattern, 343 taps per output column, each tap one shared-memory load of
//    the [72, 16, 128] f32 source buffer and one FMA with a broadcast weight
//    w[t % 128]; output [64, 16, 128]. The static variant reads row t % 64,
//    the dynamic one row i + t % 8 of output column i; 1 or 8 accumulator
//    chains (8 chains: tap t into chain t % 8, then a pairwise tree, as the
//    tool's Python loop builds it). The buffer (576 KB) does not fit one
//    block's shared memory, so a block stages a 128-lane slice of it (36 KB)
//    and 16 blocks cover the 2048 lanes; `reps` independent copies of the
//    grid (grid.y) fill all 132 SMs. Bound: shared-memory loads and FP32
//    FMA throughput, one of each per tap.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 16;  // as the TPU tool: N_ITER x 16 dependent steps

template <int CH>
__global__ void __launch_bounds__(THREADS)
fma_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ out, long long T, int iters) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= T) return;
  float x[CH], av[CH], bv[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    av[c] = a[t + c * T];
    bv[c] = b[t + c * T];
    x[c] = av[c];
  }
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int c = 0; c < CH; ++c) x[c] = fmaf(x[c], av[c], bv[c]);
  }
#pragma unroll
  for (int c = 0; c < CH; ++c) out[t + c * T] = x[c];
}

template <int CH>
__global__ void __launch_bounds__(THREADS)
fma_bf16_kernel(const __nv_bfloat162* __restrict__ a,
                const __nv_bfloat162* __restrict__ b,
                __nv_bfloat162* __restrict__ out, long long T, int iters) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= T) return;
  __nv_bfloat162 x[CH], av[CH], bv[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    av[c] = a[t + c * T];
    bv[c] = b[t + c * T];
    x[c] = av[c];
  }
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int c = 0; c < CH; ++c) x[c] = __hfma2(x[c], av[c], bv[c]);
  }
#pragma unroll
  for (int c = 0; c < CH; ++c) out[t + c * T] = x[c];
}

template <int CH>
int launch_fma(int dtype, const void* a, const void* b, void* out,
               long long n, int iters, cudaStream_t s) {
  const long long per = dtype == SKOOTS_BF16 ? 2LL * CH : (long long)CH;
  if (n % per) return (int)cudaErrorInvalidValue;
  const long long T = n / per;
  const long long blocks = (T + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (dtype == SKOOTS_F32)
    fma_f32_kernel<CH><<<(unsigned)blocks, THREADS, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(out), T, iters);
  else if (dtype == SKOOTS_BF16)
    fma_bf16_kernel<CH><<<(unsigned)blocks, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat162*>(a),
        static_cast<const __nv_bfloat162*>(b),
        static_cast<__nv_bfloat162*>(out), T, iters);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

constexpr int TAPS = 343;
constexpr int COLS = 64;
constexpr int ROWS = COLS + 8;
constexpr int LANES = 16 * 128;
constexpr int SL = 128;  // lanes per block
constexpr int NW = 128;  // weights

template <bool DYNAMIC, int CHAINS>
__global__ void __launch_bounds__(THREADS)
loadfma_kernel(const float* __restrict__ buf, const float* __restrict__ w,
               float* __restrict__ out, int zero) {
  extern __shared__ float smem[];
  float* sbuf = smem;               // [ROWS, SL]
  float* sw = smem + ROWS * SL;     // [NW]
  const int l0 = blockIdx.x * SL;
  for (int e = threadIdx.x; e < ROWS * SL; e += THREADS)
    sbuf[e] = buf[(e / SL) * LANES + l0 + e % SL];
  for (int e = threadIdx.x; e < NW; e += THREADS) sw[e] = w[e];
  __syncthreads();

  const int lane = threadIdx.x % SL;
  constexpr int G = THREADS / SL;
  float* o = out + (long long)blockIdx.y * COLS * LANES;
  for (int i = threadIdx.x / SL; i < COLS; i += G) {
    // the static variant's sum does not depend on i: a base that moves by
    // i * zero (zero is 0 at run time, unknown to the compiler) and the
    // barrier keep it from computing the sum once and storing it 32 times
    asm volatile("" ::: "memory");
    const float* col = sbuf + (DYNAMIC ? i : i * zero) * SL + lane;
    float acc[CHAINS];
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) acc[c] = 0.f;
#pragma unroll
    for (int t = 0; t < TAPS; ++t) {
      const int row = DYNAMIC ? t % 8 : t % COLS;
      acc[t % CHAINS] = fmaf(col[row * SL], sw[t % NW], acc[t % CHAINS]);
    }
#pragma unroll
    for (int width = CHAINS; width > 1; width /= 2)
#pragma unroll
      for (int n = 0; n < width / 2; ++n)
        acc[n] = __fadd_rn(acc[2 * n], acc[2 * n + 1]);
    o[(long long)i * LANES + l0 + lane] = acc[0];
  }
}

template <bool DYNAMIC, int CHAINS>
int launch_loadfma(const void* buf, const void* w, void* out, int reps,
                   cudaStream_t s) {
  const dim3 grid(LANES / SL, reps);
  const size_t shmem = (ROWS * SL + NW) * sizeof(float);
  loadfma_kernel<DYNAMIC, CHAINS><<<grid, THREADS, shmem, s>>>(
      static_cast<const float*>(buf), static_cast<const float*>(w),
      static_cast<float*>(out), 0);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b, out: n elements of dtype; every element runs iters * 16 steps of
// x <- fma(x, a, b) from x = a; chains: independent chains per thread (1 or 8).
extern "C" int skoots_fma_chain(int dtype, const void* a, const void* b,
                                void* out, long long n, int iters, int chains,
                                void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
  if (chains == 1) return launch_fma<1>(dtype, a, b, out, n, iters, s);
  if (chains == 8) return launch_fma<8>(dtype, a, b, out, n, iters, s);
  return (int)cudaErrorInvalidValue;
}

// buf: f32 [72, 16, 128]; w: f32 [128]; out: f32 [reps, 64, 16, 128].
extern "C" int skoots_loadfma(const void* buf, const void* w, void* out,
                              int dynamic, int chains, int reps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (reps <= 0 || reps > 65535) return (int)cudaErrorInvalidValue;
  if (dynamic && chains == 1) return launch_loadfma<true, 1>(buf, w, out, reps, s);
  if (dynamic && chains == 8) return launch_loadfma<true, 8>(buf, w, out, reps, s);
  if (!dynamic && chains == 1) return launch_loadfma<false, 1>(buf, w, out, reps, s);
  if (!dynamic && chains == 8) return launch_loadfma<false, 8>(buf, w, out, reps, s);
  return (int)cudaErrorInvalidValue;
}
