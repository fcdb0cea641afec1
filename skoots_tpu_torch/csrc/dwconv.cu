// Depthwise k^3 SAME correlation plus bias, channels-last [B, X, Y, Z, C].
//
// Replaces skoots_tpu/kernels/dwconv.py::dwconv3d_pallas_v4 (and the two
// older TPU layouts dwconv3d_pallas / dwconv3d_pallas_v6, which compute the
// same function). Same numerics: f32 accumulation of the k^3 taps, the bias
// added in f32, ONE rounding to the storage type at the end.
//
// What bounds it on the H100: at k = 7 every output costs 343 FMAs, a
// [256, 256, 96, 32] layer ~69 GFMA against ~0.8 GB of traffic. On the FP32
// pipe that is 2.06 ms at the published peak; at bf16 every product of two
// bf16 values is exact in f32, so the tensor cores (f32 accumulation) do the
// same work, and then the bytes bind (0.24 ms).
//
// bf16 (`dwconv3d_tc_kernel`): the z taps of one channel and one (dx, dy)
// form a 16x8 banded matrix T[i][j] = w[dx, dy, i - j] (0 <= i - j < k), so
// 16 y rows x 8 output z of one x plane are D += A[16 y][16 z window] * T,
// one mma.sync m16n8k16 (bf16, f32 sums; 7 of the 16 K lanes useful at
// k = 7). A warp owns one channel and one 16 y x 8 z output column and
// streams the input x planes: one A fragment (ldmatrix.x4) feeds the k dx
// taps, whose outputs lie in the k planes xi + P - dx, kept as k register
// accumulators, a ring indexed at compile time (the plane loop is unrolled
// by k); the k^2 B fragments are built once in registers from the weights
// (k = 7: 98 of the thread's 255 registers, so one block of 8 warps = 8
// channels an SM). Each input plane is staged in shared memory
// channel-major with z contiguous (16-byte loads of 8 channels,
// transposed), starting at z0 - k/2 so every window starts on a 16-byte
// boundary; each thread copies its items of the plane three ahead with
// cp.async into a ring and transposes its own items once they land.
// Output planes are staged through shared memory (double-
// buffered: one barrier a step) and stored as 16-byte channel groups. At
// one block an SM the step is bound by its instructions (staging, barrier,
// output) as much as by the products, so per-step work is hoisted out of
// the loop.
// tests/test_torch_dwconv_banded.py states this indexing (the band, the
// window start, the masks on ragged X, Y, Z) in torch and holds it against
// the plain version.
//
// The stem at 32 channels and k = 3, 5, 7 (`stem_gemm_kernel`): an
// implicit GEMM, M = 16 output z, N = the 32 channels, K = the k^2 (dx, dy)
// groups of 8 dz lanes, half the products of the banded form, which the
// card ran slower for the stem (PERF.md); its indexing is stated in the same
// test file. Every other bf16 stem with C % 8 == 0, 8 <= C <= 256 and odd
// k <= 15 (`stem_gemm_chunk_kernel`): the same GEMM with N in chunks of at
// most 64 channels and 16 dz lanes a group at k >= 9 (below;
// tests/test_torch_stem_gemm.py states it). `route` below is the one
// choice of kernel, shared with the route query `skoots_dwconv3d_route`.
//
// bf16 depthwise layers with 16-byte channel groups at k = 9, 11, 13, 15
// (`dwconv3d_big_kernel`): the banded product in one or two bands, the taps
// from a weight panel in shared memory, below.
//
// Any other odd k (`dwconv3d_any_kernel`: f32, bf16 without 16-byte channel
// groups, k > 15): a thread an output value, below.
//
// f32 and bf16 with C % 8 != 0 at k = 3, 5, 7 (`dwconv3d_kernel`): FP32
// FMAs. A block
// stages a (TX+k-1) x (TY+k-1) x (TZ+k-1) halo tile of CC channels in
// shared memory, each thread owns one (x, y, channel) column of TZ outputs
// and reuses each loaded input for the k dz taps. The tensor cores would
// round f32 operands to TF32, which is not the function.
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

// ---- bf16 on the tensor cores ----------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int TC_WARPS = 8;  // = the channels of a block
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int TC_YT = 16;  // output y of a block: the mma's M
constexpr int TC_ZT = 8;   // output z of a block: the mma's N
constexpr int TC_ZW = 16;  // input z window: the mma's K
constexpr int TC_ZP = 24;  // padded window row: 48 bytes, so the 8 rows of
                           // an ldmatrix fall in distinct banks
constexpr int TC_AHEAD = 3;  // input planes in flight ahead of the one computed
constexpr int TC_DEPTH = TC_AHEAD + 1;  // ring of planes as loaded

template <int K>
struct DwTc {
  static constexpr int P = K / 2;
  static constexpr int YS = TC_YT + K - 1;      // staged input rows
  static constexpr int PLANE = YS * TC_ZP;      // one channel's staged plane
  static constexpr int BUF = TC_WARPS * PLANE;  // one staged x plane
  static constexpr int ITEMS = (YS * TC_ZW + TC_THREADS - 1) / TC_THREADS;
  static constexpr int OUT = TC_WARPS * TC_YT * TC_ZT;  // [ch][y][z]
  static constexpr int RAW = ITEMS * TC_THREADS * 8;   // one plane as loaded (16 B an item)
  static constexpr int SMEM = (2 * BUF + 2 * OUT + TC_DEPTH * RAW) * 2;
};

template <int K>
__global__ void __launch_bounds__(TC_THREADS, 1)
dwconv3d_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ b, bf16* __restrict__ out, int X, int Y,
                   int Z, int C, int nxs, int xt) {
  using D = DwTc<K>;
  constexpr int P = D::P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* buf = reinterpret_cast<bf16*>(smem_raw);  // [2][8 ch][YS][ZP]
  bf16* osm0 = buf + 2 * D::BUF;                  // [2][8 ch][YT][ZT]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;

  // block: (batch, x range, y block, z block, channel group), channels fastest
  int r = blockIdx.x;
  const int ncg = C / TC_WARPS, nzb = (Z + TC_ZT - 1) / TC_ZT, nyb = (Y + TC_YT - 1) / TC_YT;
  const int cg = r % ncg;
  r /= ncg;
  const int zb = r % nzb;
  r /= nzb;
  const int yb = r % nyb;
  r /= nyb;
  const int xsp = r % nxs, bi = r / nxs;
  const int c0 = cg * TC_WARPS, z0 = zb * TC_ZT, y0 = yb * TC_YT;
  const int xs = xsp * xt, xe = min(X, xs + xt);
  const int c = c0 + warp;

  // the k^2 banded B fragments of channel c: b0 = T[2q, 2q+1][g],
  // b1 = T[2q+8, 2q+9][g], T[i][j] = w[dx, dy, i - j, c]
  uint32_t bfr[K * K][2];
#pragma unroll
  for (int t = 0; t < K * K; ++t) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dz = 2 * q + (e & 1) + (e >> 1) * 8 - g;
      v[e] = dz >= 0 && dz < K ? w[(long long)(t * K + dz) * C + c] : 0.f;
    }
    bfr[t][0] = pack_bf16x2(v[0], v[1]);
    bfr[t][1] = pack_bf16x2(v[2], v[3]);
  }
  const float bias = b[c];

  // staging: the thread's items are window row i / 16 (y0 - P + row) and
  // column i % 16 (z0 - P + column) of every x plane, 8 channels of one
  // voxel. Each thread copies its items of
  // plane xi + AHEAD into a ring (cp.async) and later transposes the same
  // items into the channel planes, so the ring needs no barrier. Sources
  // advance one x plane a step; an item outside the volume (ok false) is
  // never read and stages zeros.
  const long long plane_stride = (long long)Y * Z * C;
  const int nsteps = xe - xs + K - 1;
  uint4* raw0 = reinterpret_cast<uint4*>(osm0 + 2 * D::OUT);  // [DEPTH][ITEMS][THREADS]
  const bf16* src[D::ITEMS];  // the item in the next plane to fetch (step 0: xs - P)
  bool ok[D::ITEMS];
  int dst_off[D::ITEMS];      // the item in a staged plane
#pragma unroll
  for (int j = 0; j < D::ITEMS; ++j) {
    const int i = tid + j * TC_THREADS;
    const int gy = y0 - P + i / TC_ZW, gz = z0 - P + i % TC_ZW;
    ok[j] = i < D::YS * TC_ZW && gy >= 0 && gy < Y && gz >= 0 && gz < Z;
    src[j] = x + (((long long)bi * X + xs - P) * Y * Z + (long long)gy * Z + gz) * C + c0;
    dst_off[j] = i < D::YS * TC_ZW ? (i / TC_ZW) * TC_ZP + i % TC_ZW : -1;
  }
  // copy plane xi (step t) into its ring slot and advance the sources; one
  // commit group a step
  auto fetch = [&](int xi, int t) {
    uint4* raw = raw0 + (t % TC_DEPTH) * D::ITEMS * TC_THREADS + tid;
    const bool in = t < nsteps && xi >= 0 && xi < X;
#pragma unroll
    for (int j = 0; j < D::ITEMS; ++j) {
      if (in && ok[j]) cp_async16(raw + j * TC_THREADS, src[j], 16);
      src[j] += plane_stride;
    }
    cp_async_commit();
  };
  // plane xi (step t), landed, into the channel planes of `dst`
  auto stage = [&](int xi, int t, bf16* dst) {
    const uint4* raw = raw0 + (t % TC_DEPTH) * D::ITEMS * TC_THREADS + tid;
    const bool in = xi >= 0 && xi < X;
    unsigned short* d0 = reinterpret_cast<unsigned short*>(dst);
#pragma unroll
    for (int j = 0; j < D::ITEMS; ++j) {
      if (dst_off[j] < 0) continue;
      unsigned short* d = d0 + dst_off[j];
      const uint4 v = in && ok[j] ? raw[j * TC_THREADS] : make_uint4(0, 0, 0, 0);
      const unsigned short* h = reinterpret_cast<const unsigned short*>(&v);
#pragma unroll
      for (int ch = 0; ch < TC_WARPS; ++ch) d[ch * D::PLANE] = h[ch];
    }
  };
  // the thread's output voxel (y, z) = (tid / 8, tid % 8) in output plane xs
  const int oy = y0 + tid / TC_ZT, oz = z0 + tid % TC_ZT;
  const bool o_ok = tid < TC_YT * TC_ZT && oy < Y && oz < Z;
  bf16* dst_out = out + ((((long long)bi * X + xs) * Y + oy) * Z + oz) * C + c0;
  const long long out_plane = (long long)Y * Z * C;

  // acc[s]: the output plane xo with (xo - xs) mod K == s. Input plane xi
  // adds into the planes xi + P - dx; planes outside [xs, xe) take their
  // sums too but are never stored, and every slot is zeroed when its plane
  // is complete, before the plane K further on first adds into it.
  float acc[K][4];
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int t = 0; t < TC_AHEAD; ++t) fetch(xs - P + t, t);
  cp_async_wait_group<TC_AHEAD - 1>();
  stage(xs - P, 0, buf);
  __syncthreads();
  // unrolled by K, so the slots are compile-time register indices
  for (int t0 = 0; t0 < nsteps; t0 += K) {
#pragma unroll
    for (int rr = 0; rr < K; ++rr) {
      const int t = t0 + rr;
      if (t >= nsteps) break;
      const int xi = xs - P + t;
      bf16* osm = osm0 + (t & 1) * D::OUT;
      fetch(xi + TC_AHEAD, t + TC_AHEAD);
      if (xi >= 0 && xi < X) {
        const bf16* plane = buf + (t & 1) * D::BUF + warp * D::PLANE;
#pragma unroll
        for (int dy = 0; dy < K; ++dy) {
          uint32_t a[4];
          ldmatrix_x4(a, plane + (dy + (lane & 15)) * TC_ZP + (lane >> 4) * 8);
#pragma unroll
          for (int dx = 0; dx < K; ++dx)
            mma_bf16_16816(acc[(rr - dx + K) % K], a, bfr[dx * K + dy][0], bfr[dx * K + dy][1]);
        }
      }
      // output plane xo = xi - P is complete: + bias, one rounding
      float(&done)[4] = acc[(rr + 1) % K];
      const int xo = xi - P;
      if (xo >= xs) {
        bf16* o = osm + warp * TC_YT * TC_ZT;
        *reinterpret_cast<uint32_t*>(o + g * TC_ZT + 2 * q) =
            pack_bf16x2(done[0] + bias, done[1] + bias);
        *reinterpret_cast<uint32_t*>(o + (g + 8) * TC_ZT + 2 * q) =
            pack_bf16x2(done[2] + bias, done[3] + bias);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) done[e] = 0.f;
      cp_async_wait_group<TC_AHEAD - 1>();  // this thread's copies of plane xi + 1
      stage(xi + 1, t + 1, buf + ((t + 1) & 1) * D::BUF);
      // one barrier a step: plane xi + 1 and output plane xo are staged,
      // and every warp is done with plane xi and with the output stage of
      // step t - 1, which the next step overwrites
      __syncthreads();
      // 16-byte channel groups of the output plane, a voxel a thread
      if (xo >= xs) {
        if (o_ok) {
          uint4 v;
          unsigned short* e = reinterpret_cast<unsigned short*>(&v);
          const unsigned short* os = reinterpret_cast<const unsigned short*>(osm);
#pragma unroll
          for (int ch = 0; ch < TC_WARPS; ++ch) e[ch] = os[ch * TC_YT * TC_ZT + tid];
          *reinterpret_cast<uint4*>(dst_out) = v;
        }
        dst_out += out_plane;
      }
    }
  }
}

// ---- the stem (1 -> 32) as an implicit GEMM on the tensor cores -----------
//
// out[v, c] = sum_t x[v + t] w[t, c]: M = 16 output z of one (x, y), N = the
// 32 channels, K = the k^2 (dx, dy) groups of 8 dz lanes (dz >= k zero),
// two groups a k-step. A block of 8 warps (8 y rows) walks (x, y, z) tiles
// of a persistent grid; w sits in shared memory once a block. The input's
// halo is staged twice, the second copy shifted by one element, so that
// every lane's pair of dz values is one aligned 4-byte load.
constexpr int SG_WARPS = 8;
constexpr int SG_THREADS = SG_WARPS * 32;
constexpr int SG_C = 32;   // output channels
constexpr int SG_ZT = 16;  // output z of a tile (the mma's M)
constexpr int SG_NS = SG_C + 8;  // padded row of w (80 bytes)

template <int K>
struct StemGemm {
  static constexpr int P = K / 2;
  static constexpr int KSTEPS = (K * K + 1) / 2;
  static constexpr int KP = KSTEPS * 16;          // padded taps
  static constexpr int HY = SG_WARPS + K - 1;     // halo rows
  static constexpr int HZ = SG_ZT + 8;            // halo row: 16 + 7 z, + 1 shift
  static constexpr int HALO = K * HY * HZ;        // one copy (elements)
  static constexpr int OUTS = SG_C + 8;           // padded output row
  static constexpr int SMEM = (KP * SG_NS + 2 * HALO + SG_WARPS * SG_ZT * OUTS) * 2;
};

template <int K>
__global__ void __launch_bounds__(SG_THREADS)
stem_gemm_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, bf16* __restrict__ out, int B, int X, int Y,
                 int Z) {
  using S = StemGemm<K>;
  constexpr int P = S::P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);  // [KP][NS]: row group*8 + dz
  bf16* halo = ws + S::KP * SG_NS;                // [2][K][HY][HZ]
  bf16* os = halo + 2 * S::HALO;                  // [warps][16 z][OUTS]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  for (int i = tid; i < S::KP * SG_C; i += SG_THREADS) {
    const int k = i / SG_C, c = i % SG_C, grp = k / 8, dz = k % 8;
    ws[k * SG_NS + c] = __float2bfloat16_rn(
        grp < K * K && dz < K ? w[((long long)grp * K + dz) * SG_C + c] : 0.f);
  }
  // the halo's columns past 16 + k - 1 z (read as dz >= k lanes, whose w
  // rows are 0) stay zero, never garbage
  for (int i = tid; i < 2 * S::HALO; i += SG_THREADS) halo[i] = __float2bfloat16_rn(0.f);
  const float2 bias[4] = {
      make_float2(b[2 * q], b[2 * q + 1]), make_float2(b[8 + 2 * q], b[9 + 2 * q]),
      make_float2(b[16 + 2 * q], b[17 + 2 * q]), make_float2(b[24 + 2 * q], b[25 + 2 * q])};
  // the lane's dz pair (2q, 2q+1) of rows g and g + 8 starts at halo z
  // g + 2q: even in copy 0, odd ones aligned in copy 1 (shifted by one)
  const bf16* hsrc = halo + (g & 1) * S::HALO + (g & 1);
  const int kr = (lane & 7) + ((lane >> 3) & 1) * 8, nc = (lane >> 4) * 8;

  const int nzt = (Z + SG_ZT - 1) / SG_ZT, nyt = (Y + SG_WARPS - 1) / SG_WARPS;
  const long long ntiles = (long long)B * X * nyt * nzt;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    long long r = tile;
    const int zt = (int)(r % nzt);
    r /= nzt;
    const int yt = (int)(r % nyt);
    r /= nyt;
    const int xo = (int)(r % X);
    const int bi = (int)(r / X);
    const int z0 = zt * SG_ZT, y0 = yt * SG_WARPS;
    __syncthreads();  // the last tile's halo and output stage are read
    for (int i = tid; i < K * S::HY * (SG_ZT + K - 1); i += SG_THREADS) {
      const int hz = i % (SG_ZT + K - 1);
      const int rest = i / (SG_ZT + K - 1);
      const int hy = rest % S::HY, hx = rest / S::HY;
      const int gx = xo - P + hx, gy = y0 - P + hy, gz = z0 - P + hz;
      bf16 v = __float2bfloat16_rn(0.f);
      if (gx >= 0 && gx < X && gy >= 0 && gy < Y && gz >= 0 && gz < Z)
        v = x[(((long long)bi * X + gx) * Y + gy) * Z + gz];
      const int o = (hx * S::HY + hy) * S::HZ + hz;
      halo[o] = v;
      halo[S::HALO + o + 1] = v;
    }
    __syncthreads();
    float acc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
    for (int s = 0; s < S::KSTEPS; ++s) {
      uint32_t a[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // group 2s (a0, a1) and 2s + 1 (a2, a3)
        const int grp = 2 * s + h;
        const int gg = grp < K * K ? grp : 0;  // a zero group: its w rows are 0
        const bf16* row = hsrc + ((gg / K) * S::HY + warp + gg % K) * S::HZ + g + 2 * q;
        a[2 * h] = *reinterpret_cast<const uint32_t*>(row);
        a[2 * h + 1] = *reinterpret_cast<const uint32_t*>(row + 8);
      }
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, ws + (s * 16 + kr) * SG_NS + nb * 16 + nc);
        mma_bf16_16816(acc[2 * nb], a, bb[0], bb[1]);
        mma_bf16_16816(acc[2 * nb + 1], a, bb[2], bb[3]);
      }
    }
    // + bias, one rounding; 64-byte voxel rows through shared memory
    bf16* o = os + warp * SG_ZT * S::OUTS;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      *reinterpret_cast<uint32_t*>(o + g * S::OUTS + n * 8 + 2 * q) =
          pack_bf16x2(acc[n][0] + bias[n].x, acc[n][1] + bias[n].y);
      *reinterpret_cast<uint32_t*>(o + (g + 8) * S::OUTS + n * 8 + 2 * q) =
          pack_bf16x2(acc[n][2] + bias[n].x, acc[n][3] + bias[n].y);
    }
    __syncwarp();
    const int gy = y0 + warp;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = lane + 32 * j;  // 16 voxels x 4 pieces of 16 bytes
      const int m = i / 4, piece = i % 4;
      if (gy < Y && z0 + m < Z)
        *reinterpret_cast<uint4*>(out + ((((long long)bi * X + xo) * Y + gy) * Z + z0 + m) *
                                            SG_C + piece * 8) =
            *reinterpret_cast<const uint4*>(o + m * S::OUTS + piece * 8);
    }
  }
}

template <int K>
int launch_stem_gemm(const void* x, const float* w, const float* b, void* out, int B, int X,
                     int Y, int Z, cudaStream_t stream) {
  using S = StemGemm<K>;
  cudaError_t e = cudaFuncSetAttribute(stem_gemm_kernel<K>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_gemm_kernel<K>,
                                                         SG_THREADS, S::SMEM)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = (long long)B * X * ((Y + SG_WARPS - 1) / SG_WARPS) *
                          ((Z + SG_ZT - 1) / SG_ZT);
  const long long cap = (long long)sms * per_sm;
  stem_gemm_kernel<K><<<(unsigned)(tiles < cap ? tiles : cap), SG_THREADS, S::SMEM, stream>>>(
      static_cast<const bf16*>(x), w, b, static_cast<bf16*>(out), B, X, Y, Z);
  return (int)cudaGetLastError();
}

// ---- every other bf16 stem (C % 8 == 0, 8 <= C <= 256, odd k <= 15) -------
//
// The implicit GEMM of stem_gemm_kernel with N and k free. M = 16 output z
// of one (x, y); a warp holds MT of them (8 warps; at k <= 7 MT = 2 y rows,
// since there the weight panel's shared-memory reads bound the product and
// each B fragment then feeds two; 1 at k >= 9). N = a chunk of at most 64
// channels as NT = 2, 4, 6 or 8 n8 tiles, a compile-time count, so the
// k-step loop is straight-line code (a chunk narrower than its class has
// zero weight columns, computed and not stored); the grid's blocks split
// among the chunks, a block holding one chunk's weight panel and walking
// tiles of a persistent grid. K = the k^2 (dx, dy) groups of G dz lanes:
// G = 8 for k <= 7 (two groups a k-step), G = 16 for k >= 9 (one). The
// panel holds only w's k^3 taps, one row a (dx, dy, dz), and one zero row:
// a lane whose dz >= k (or whose group is the padding past k^2) gives
// ldmatrix the zero row's address, so the panel is k^3 + 1 rows, not
// 16 k^2 (k = 9: 730 rows, not 1296). Its row stride is an odd number of
// 16-byte units (conflict-free ldmatrix rows). The chunk's class is the
// widest whose panel, halo and output stage fit a block's shared memory
// (stem_chunk below: 64 channels to k = 9, 16 at k = 15), the chunks of a
// C as even as 8-channel units allow. The halo is staged twice, the second
// copy shifted by one element, so that a lane's dz pair is one aligned
// 4-byte load; its rows are 16 + 7 z + 1 (G = 8) or 16 + 15 z + 1 (G = 16)
// long, and the columns past the 16 + k - 1 staged z stay zero (lanes
// dz >= k read them against zero weights). At G = 16 a lane's A registers
// a1 and a2 are the same pair (row g + 8, lanes 2q; row g, lanes 2q + 8:
// both z = g + 2q + 8).
constexpr int SC_WARPS = 8;
constexpr int SC_THREADS = SC_WARPS * 32;
constexpr int SC_ZT = 16;     // output z of a tile (the mma's M)
constexpr int SC_NT = 8;      // n8 tiles of a chunk at most (64 channels)

template <int K>
struct StemChunk {
  static constexpr int P = K / 2;
  static constexpr int G = K <= 7 ? 8 : 16;      // dz lanes of a group
  static constexpr int GPS = 16 / G;             // groups a k-step
  static constexpr int KSTEPS = (K * K + GPS - 1) / GPS;
  // y rows a warp (each B fragment feeds MT products: the panel's shared-
  // memory reads, which bound the k <= 7 stem, a tile's output apart)
  static constexpr int MT = G == 8 ? 2 : 1;
  static constexpr int YT = SC_WARPS * MT;       // y rows of a tile
  static constexpr int HY = YT + K - 1;          // halo rows
  static constexpr int HZ = G == 8 ? 24 : 32;    // halo row: 16 + G - 1 z, + 1 shift
  static constexpr int HW = SC_ZT + K - 1;       // staged z of a halo row
  // one copy; the second starts 16 banks on, so the two copies' pairs of
  // one load do not share banks
  static constexpr int COPY = (K * HY * HZ + 63) / 64 * 64 + 32;
  static constexpr int ROWS = K * K * K + 1;     // panel rows: the taps, then zeros
  static constexpr int HN = K * HY * HW;         // staged halo values a tile
  static constexpr int ITEMS = (HN + SC_THREADS - 1) / SC_THREADS;  // a thread's
  static int smem(int stride) { return (ROWS * stride + 2 * COPY + SC_WARPS * SC_ZT * stride) * 2; }
};

// acc[m] += A[m] B over the chunk's NT n8 tiles: A[m] the k-step's fragment
// of the warp's y row m, B from the panel rows the lane addresses (bp: its
// row, at its column group), one load for the MT rows
template <int MT, int NT>
__device__ __forceinline__ void chunk_step(float (&acc)[MT][NT][4], const uint32_t (&a)[MT][4],
                                           const bf16* bp) {
#pragma unroll
  for (int nb = 0; nb < NT / 2; ++nb) {
    uint32_t bb[4];
    ldmatrix_x4_trans(bb, bp + nb * 16);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      mma_bf16_16816(acc[m][2 * nb], a[m], bb[0], bb[1]);
      mma_bf16_16816(acc[m][2 * nb + 1], a[m], bb[2], bb[3]);
    }
  }
}

// blocks an SM the registers must allow (at most 128 a thread; at 80 the
// k <= 7 kernels spill, and the k = 7, C = 48 stem ran 11% slower on the card)
constexpr int SC_MIN_BLOCKS = 2;

// the thread's halo values of `tile` (items tid, tid + 256, ... of its
// K x HY x HW staged values; zero outside the volume) into registers
template <int K>
__device__ __forceinline__ void fetch_halo(bf16 (&pre)[StemChunk<K>::ITEMS],
                                           const bf16* __restrict__ x, long long tile, int X,
                                           int Y, int Z, int nyt, int nzt) {
  using T = StemChunk<K>;
  long long r = tile;
  const int zt = (int)(r % nzt);
  r /= nzt;
  const int yt = (int)(r % nyt);
  r /= nyt;
  const int xo = (int)(r % X);
  const long long bi = r / X;
#pragma unroll
  for (int j = 0; j < T::ITEMS; ++j) {
    const int i = threadIdx.x + j * SC_THREADS;
    const int hz = i % T::HW, rest = i / T::HW;
    const int hy = rest % T::HY, hx = rest / T::HY;
    const int gx = xo - T::P + hx, gy = yt * T::YT - T::P + hy, gz = zt * SC_ZT - T::P + hz;
    bf16 v = __float2bfloat16_rn(0.f);
    if (i < T::HN && gx >= 0 && gx < X && gy >= 0 && gy < Y && gz >= 0 && gz < Z)
      v = x[((bi * X + gx) * Y + gy) * Z + gz];
    pre[j] = v;
  }
}

template <int K, int NT>
__global__ void __launch_bounds__(SC_THREADS, SC_MIN_BLOCKS)
stem_gemm_chunk_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ b, bf16* __restrict__ out, int B, int X,
                       int Y, int Z, int C, int chunk, int S) {
  using T = StemChunk<K>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);  // [ROWS][S]: row (dx k + dy) k + dz
  bf16* halo = ws + T::ROWS * S;                 // [2][COPY]: [K][HY][HZ] each
  bf16* os = halo + 2 * T::COPY;                 // [warps][16 z][S]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int nch = (C + chunk - 1) / chunk;
  const int c0 = (blockIdx.x % nch) * chunk, cn = min(chunk, C - c0), nt = cn / 8;
  const int per = gridDim.x / nch;  // blocks of this chunk
  for (int i = tid; i < T::ROWS * S; i += SC_THREADS) {
    const int r = i / S, c = i % S;
    ws[i] = __float2bfloat16_rn(r < K * K * K && c < cn ? w[(long long)r * C + c0 + c] : 0.f);
  }
  for (int i = tid; i < 2 * T::COPY; i += SC_THREADS) halo[i] = __float2bfloat16_rn(0.f);
  // the lane's dz pair (2q, 2q+1) of rows g and g + 8 starts at halo z
  // g + 2q: even in copy 0, odd ones aligned in copy 1 (shifted by one)
  const bf16* hsrc = halo + (g & 1) * (T::COPY + 1) + warp * T::MT * T::HZ + g + 2 * q;
  // ldmatrix.trans lanes: row kr of the k-step's 16 K lanes, columns nc
  const int kr = (lane & 7) + ((lane >> 3) & 1) * 8, nc = (lane >> 4) * 8;
  const int h = kr / T::G, dz = kr % T::G;  // the lane's group of the k-step, its dz
  const bf16* zrow = ws + (T::ROWS - 1) * S + nc;
  // the lane's panel row at k-step 0 and its advance a k-step (0: the zero row)
  const bf16* b0 = dz < K ? ws + (h * K + dz) * S + nc : zrow;
  const int badv = dz < K ? T::GPS * K * S : 0;

  const int nzt = (Z + SC_ZT - 1) / SC_ZT, nyt = (Y + T::YT - 1) / T::YT;
  const long long ntiles = (long long)B * X * nyt * nzt;
  for (long long tile = blockIdx.x / nch; tile < ntiles; tile += per) {
    // the thread's halo values of the tile, all loads in flight at once,
    // staged once every warp is done with the last tile
    bf16 pre[T::ITEMS];
    fetch_halo<K>(pre, x, tile, X, Y, Z, nyt, nzt);
    long long r = tile;
    const int zt = (int)(r % nzt);
    r /= nzt;
    const int yt = (int)(r % nyt);
    r /= nyt;
    const int xo = (int)(r % X);
    const int bi = (int)(r / X);
    const int z0 = zt * SC_ZT, y0 = yt * T::YT;
    __syncthreads();  // the last tile's halo and output stage are read
#pragma unroll
    for (int j = 0; j < T::ITEMS; ++j) {
      const int i = tid + j * SC_THREADS;
      if (i < T::HN) {
        const int o = (i / T::HW) * T::HZ + i % T::HW;  // halo (hx, hy) row, hz
        halo[o] = pre[j];
        halo[T::COPY + o + 1] = pre[j];
      }
    }
    __syncthreads();
    __syncthreads();
    float acc[T::MT][NT][4];
#pragma unroll
    for (int m = 0; m < T::MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
    const bf16* bp = b0;
    if constexpr (T::G == 8) {
#pragma unroll
      for (int s = 0; s < T::KSTEPS; ++s) {
        uint32_t a[T::MT][4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {  // group 2s (a0, a1) and 2s + 1 (a2, a3)
          const int grp = 2 * s + hh;
          const int gg = grp < K * K ? grp : 0;  // the padding group: zero rows
          const bf16* row = hsrc + ((gg / K) * T::HY + gg % K) * T::HZ;
#pragma unroll
          for (int m = 0; m < T::MT; ++m) {
            a[m][2 * hh] = *reinterpret_cast<const uint32_t*>(row + m * T::HZ);
            a[m][2 * hh + 1] = *reinterpret_cast<const uint32_t*>(row + m * T::HZ + 8);
          }
        }
        chunk_step<T::MT, NT>(acc, a, 2 * s + 1 >= K * K && h ? zrow : bp);
        bp += badv;
      }
    } else {
#pragma unroll 1
      for (int dx = 0; dx < K; ++dx) {
        const bf16* plane = hsrc + dx * T::HY * T::HZ;
#pragma unroll
        for (int dy = 0; dy < K; ++dy) {
          uint32_t a[T::MT][4];
#pragma unroll
          for (int m = 0; m < T::MT; ++m) {
            const bf16* row = plane + (dy + m) * T::HZ;
            a[m][0] = *reinterpret_cast<const uint32_t*>(row);
            a[m][1] = a[m][2] = *reinterpret_cast<const uint32_t*>(row + 8);
            a[m][3] = *reinterpret_cast<const uint32_t*>(row + 16);
          }
          chunk_step<T::MT, NT>(acc, a, bp);
          bp += badv;
        }
      }
    }
    // + bias, one rounding; 16-byte channel groups through the warp's stage,
    // a y row at a time
    bf16* o = os + warp * SC_ZT * S;
#pragma unroll
    for (int m = 0; m < T::MT; ++m) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if (n >= nt) break;
        const float2 bias = __ldg(reinterpret_cast<const float2*>(b + c0 + n * 8 + 2 * q));
        *reinterpret_cast<uint32_t*>(o + g * S + n * 8 + 2 * q) =
            pack_bf16x2(acc[m][n][0] + bias.x, acc[m][n][1] + bias.y);
        *reinterpret_cast<uint32_t*>(o + (g + 8) * S + n * 8 + 2 * q) =
            pack_bf16x2(acc[m][n][2] + bias.x, acc[m][n][3] + bias.y);
      }
      __syncwarp();
      const int gy = y0 + warp * T::MT + m;
      for (int i = lane; i < SC_ZT * nt; i += 32) {  // 16 voxels x nt pieces of 16 bytes
        const int v = i / nt, piece = i % nt;
        if (gy < Y && z0 + v < Z)
          *reinterpret_cast<uint4*>(out + ((((long long)bi * X + xo) * Y + gy) * Z + z0 + v) * C +
                                    c0 + piece * 8) =
              *reinterpret_cast<const uint4*>(o + v * S + piece * 8);
      }
      __syncwarp();  // the stage is read before the next row writes it
    }
  }
}

// The chunk of channels a block of stem_gemm_chunk_kernel<K, NT> holds at
// C: the widest class (at most 64 channels) whose block fits, then C split
// into that many chunks as even as 8-channel units allow; NT the chunk's
// class, the panel's row stride and the block's shared memory from it
struct Chunks {
  int chunk, nt, stride, smem;
};
template <int K>
Chunks stem_chunk(int C) {
  int cmax = SC_NT;
  while (cmax > 2 && StemChunk<K>::smem(stem_row_stride(cmax)) > SMEM_OPTIN) cmax -= 2;
  const int units = C / 8, n = (units + cmax - 1) / cmax;
  const int chunk = 8 * ((units + n - 1) / n), nt = stem_nt_class(chunk / 8);
  return {chunk, nt, stem_row_stride(nt), StemChunk<K>::smem(stem_row_stride(nt))};
}

template <int K>
int launch_stem_chunk(const void* x, const float* w, const float* b, void* out, int B, int X,
                      int Y, int Z, int C, cudaStream_t stream) {
  const Chunks ch = stem_chunk<K>(C);
  const auto kernel = ch.nt == 2   ? stem_gemm_chunk_kernel<K, 2>
                      : ch.nt == 4 ? stem_gemm_chunk_kernel<K, 4>
                      : ch.nt == 6 ? stem_gemm_chunk_kernel<K, 6>
                                   : stem_gemm_chunk_kernel<K, 8>;
  const int nch = (C + ch.chunk - 1) / ch.chunk;
  const long long tiles = (long long)B * X * ((Y + StemChunk<K>::YT - 1) / StemChunk<K>::YT) *
                          ((Z + SC_ZT - 1) / SC_ZT);
  long long cap = 0;
  const int e = persistent_grid(kernel, SC_THREADS, ch.smem, 1LL << 40, &cap);
  if (e) return e;
  // blocks a chunk: a wave of the card shared among the chunks, at most a tile each
  long long per = cap / nch;
  per = per < 1 ? 1 : (per > tiles ? tiles : per);
  kernel<<<(unsigned)(per * nch), SC_THREADS, ch.smem, stream>>>(
      static_cast<const bf16*>(x), w, b, static_cast<bf16*>(out), B, X, Y, Z, C, ch.chunk,
      ch.stride);
  return (int)cudaGetLastError();
}

template <int K>
int launch_tc(const void* x, const float* w, const float* b, void* out, int B, int X,
              int Y, int Z, int C, cudaStream_t stream) {
  using D = DwTc<K>;
  cudaError_t e = cudaFuncSetAttribute(dwconv3d_tc_kernel<K>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, D::SMEM);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  // split X so the grid covers the SMs about twice (each split re-reads
  // k - 1 halo planes)
  const long long base = (long long)B * ((Y + TC_YT - 1) / TC_YT) *
                         ((Z + TC_ZT - 1) / TC_ZT) * (C / TC_WARPS);
  long long nxs = (2LL * sms + base - 1) / base;
  const long long max_split = (X + 7) / 8;
  nxs = nxs < 1 ? 1 : (nxs > max_split ? max_split : nxs);
  const int xt = (int)((X + nxs - 1) / nxs);
  nxs = (X + xt - 1) / xt;
  dwconv3d_tc_kernel<K><<<(unsigned)(base * nxs), TC_THREADS, D::SMEM, stream>>>(
      static_cast<const bf16*>(x), w, b, static_cast<bf16*>(out), X, Y, Z, C, (int)nxs, xt);
  return (int)cudaGetLastError();
}

// k = 3, 5, 7 off the stems' kernels: bf16 depthwise layers whose 16-byte
// channel groups exist on the tensor cores, the rest on the FP32 pipe
template <typename T, int K>
int launch(const void* x, const float* w, const float* b, void* out, int B,
           int X, int Y, int Z, int C, long long x_vstride,
           long long x_cstride, cudaStream_t stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (sizeof(T) == 2 && aligned && x_cstride == 1 && x_vstride == C && C % TC_WARPS == 0)
    return launch_tc<K>(x, w, b, out, B, X, Y, Z, C, stream);
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

// ---- bf16 depthwise layers at k = 9, 11, 13, 15 on the tensor cores ----------
//
// `dwconv3d_big_kernel<K>`: the banded product of dwconv3d_tc_kernel (D[16 y,
// 8 z] += A[16 y, 16 window z] T, T[i][j] = w[dx, dy, i - j, c], one
// mma.sync m16n8k16, bf16 operands, f32 sums; the x planes streamed through
// a cp.async ring; the k output planes an input plane adds into kept as a
// ring of accumulators indexed at compile time). What changes past k = 7:
//  * one band (8 output z over a 16-column window) holds k - 1 + 8 <= 16,
//    so k <= 9. k = 9 is one band over the window z0 - P ... z0 - P + 15;
//    k = 11 to 15 take two: band 0 the taps dz 0-7 over that window, band 1
//    the taps dz 8 ... k - 1 over the window from z0 - P + 8. Both windows
//    start on 16-byte boundaries (ldmatrix rows), and a staged row holds 24
//    window columns (48 bytes: three 16-byte units, an odd count, so the 8
//    rows of an ldmatrix fall in distinct banks);
//  * the k^2 (x bands) B fragments no longer fit the registers (k = 9: 162
//    of 255 beside the accumulators, k = 11: 484), so they come from a
//    weight panel in shared memory. A band's taps of one (dx, dy) are a row
//    of 16 bf16: tap dz at element dz - 8 band + 8, zeros elsewhere, the rows
//    packed back to back (a lane's reads stray at most 8 elements past its
//    row, into the next row's leading zeros; k = 9's tap 8 sits at the next
//    row's element 0, which that row never reads). Lane (g, q) needs the
//    pairs T[2q, 2q + 1][g] and T[2q + 8, 2q + 9][g], elements 2q - g + 8
//    and 2q - g + 16 of its row: the panel is stored twice, the second copy
//    shifted by one element, so each pair is one aligned 32-bit load from
//    copy g & 1 (the copies 16 banks apart: conflict-free);
//  * a warp covers 32 y rows (two m16 tiles), so each B fragment feeds two
//    products; the accumulator ring is k x 2 x 4 f32 (k = 15: 120);
//  * a block holds CB channels (8 to k = 11, 4 at 13 and 15, the warps of
//    a channel stacked in y), so that the panel (k^2 x bands x 64 bytes a
//    channel), the two staged planes, the output stage and a ring of three
//    planes as loaded fit the 227 KB of shared memory; items are one
//    voxel's CB channels (16 or 8 bytes), copied with cp.async and
//    transposed channel-major by the thread that copied them;
//  * the dy loop is not unrolled (the rr and dx loops are, as the ring
//    slots must be compile-time): k^2 x bands x 2 products a step, about
//    900 at k = 15, not k^3 of them.
// Same function: f32 sums of the k^3 exact products, + bias in f32, one
// rounding. tests/test_torch_dwconv_bigk.py states this indexing in torch.
constexpr int BG_WARPS = 8;
constexpr int BG_THREADS = BG_WARPS * 32;
constexpr int BG_MT = 2;        // m16 tiles (16 y rows each) of a warp
constexpr int BG_ZT = 8;        // output z of a block: the mma's N
constexpr int BG_ZP = 24;       // staged window row (48 bytes)
constexpr int BG_ROW = 16;      // a band's tap row in the weight panel
constexpr int BG_AHEAD = 2;     // input planes in flight ahead of the one computed
constexpr int BG_DEPTH = BG_AHEAD + 1;

template <int K>
struct DwBig {
  static constexpr int P = K / 2;
  static constexpr int NB = K <= 9 ? 1 : 2;       // bands
  static constexpr int ZW = 8 + 8 * NB;           // staged window columns
  static constexpr int CB = K <= 11 ? 8 : 4;      // channels of a block
  static constexpr int WPC = BG_WARPS / CB;       // warps of a channel, stacked in y
  static constexpr int YT = 16 * BG_MT * WPC;     // output y of a block
  static constexpr int YS = YT + K - 1;           // staged input rows
  static constexpr int PLANE = YS * BG_ZP;        // one channel's staged plane
  static constexpr int BUF = CB * PLANE;          // one staged x plane
  static constexpr int OUT = CB * YT * BG_ZT;     // one output plane's stage [ch][y][z]
  static constexpr int OV = YT * BG_ZT / BG_THREADS;  // output voxels a thread a step
  static constexpr int NITEM = YS * ZW;           // staged voxels of a plane
  static constexpr int ITEMS = (NITEM + BG_THREADS - 1) / BG_THREADS;
  static constexpr int ROWS = CB * K * K * NB + 1;    // panel rows, then a zero row
  // one copy of the panel (elements); the second starts 16 banks on
  static constexpr int COPY = (ROWS * BG_ROW + 1 + 63) / 64 * 64 + 32;
  static constexpr int SMEM =
      (2 * BUF + 2 * OUT + 2 * COPY) * 2 + BG_DEPTH * ITEMS * BG_THREADS * CB * 2;
};

// one voxel's CB bf16 channels, as loaded
template <int CB>
struct BigItem;
template <>
struct BigItem<8> {
  using type = uint4;
  static __device__ __forceinline__ void copy(void* dst, const void* src) {
    cp_async16(dst, src, 16);
  }
};
template <>
struct BigItem<4> {
  using type = uint2;
  static __device__ __forceinline__ void copy(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)), "l"(src));
  }
};

// w's tap of panel row `rho` (band, (dx, dy), channel c0 + its block
// channel) at element m of that row, 0 off the band
template <int K>
__device__ __forceinline__ float big_tap(const float* __restrict__ w, int C, int c0, int rho,
                                         int m) {
  using D = DwBig<K>;
  if (rho < 0 || rho >= D::ROWS - 1) return 0.f;
  const int band = rho % D::NB, t = (rho / D::NB) % (K * K), c = rho / (D::NB * K * K);
  const int dz = m - 8 + 8 * band;
  const int end = D::NB == 1 || band == 1 ? K : 8;
  return dz >= 8 * band && dz < end ? w[(long long)(t * K + dz) * C + c0 + c] : 0.f;
}

template <int K>
__global__ void __launch_bounds__(BG_THREADS, 1)
dwconv3d_big_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, bf16* __restrict__ out, int X, int Y, int Z,
                    int C, int nxs, int xt) {
  using D = DwBig<K>;
  using I = BigItem<D::CB>;
  using Item = typename I::type;
  constexpr int P = D::P, NB = D::NB, CB = D::CB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* buf = reinterpret_cast<bf16*>(smem_raw);  // [2][CB][YS][ZP]
  bf16* osm0 = buf + 2 * D::BUF;                  // [2][CB][YT][ZT]
  bf16* panel = osm0 + 2 * D::OUT;                // [2 copies][COPY]
  Item* raw0 = reinterpret_cast<Item*>(panel + 2 * D::COPY);  // [DEPTH][ITEMS][THREADS]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int cl = warp % CB, wy = warp / CB;  // the warp's channel of the block, its 32 rows

  // block: (batch, x range, y block, z block, channel group), channels fastest
  int r = blockIdx.x;
  const int ncg = C / CB, nzb = (Z + BG_ZT - 1) / BG_ZT, nyb = (Y + D::YT - 1) / D::YT;
  const int cg = r % ncg;
  r /= ncg;
  const int zb = r % nzb;
  r /= nzb;
  const int yb = r % nyb;
  r /= nyb;
  const int xsp = r % nxs, bi = r / nxs;
  const int c0 = cg * CB, z0 = zb * BG_ZT, y0 = yb * D::YT;
  const int xs = xsp * xt, xe = min(X, xs + xt);

  // the weight panel, both copies (copy 1 element e + 1 = copy 0 element e)
  for (int e = tid; e < D::ROWS * BG_ROW; e += BG_THREADS) {
    const int rho = e / BG_ROW, m = e % BG_ROW;
    const bf16 v = __float2bfloat16_rn(big_tap<K>(w, C, c0, rho, m) +
                                       big_tap<K>(w, C, c0, rho - 1, m + BG_ROW));
    panel[e] = v;
    panel[D::COPY + e + 1] = v;
  }
  const float bias = b[c0 + cl];
  // the lane's pair T[2q, 2q + 1][g] of its channel's first row: element
  // 2q - g + 8, aligned in copy g & 1
  const bf16* wl = panel + ((g & 1) ? D::COPY + 1 : 0) + 2 * q - g + 8 +
                   cl * (K * K * NB * BG_ROW);

  // staging: item i is window row i / ZW (y0 - P + row) and column i % ZW
  // (z0 - P + column) of every x plane, CB channels of one voxel; each
  // thread copies its items of plane xi + AHEAD into the ring and later
  // transposes the same items, so the ring needs no barrier
  const long long plane_stride = (long long)Y * Z * C;
  const int nsteps = xe - xs + K - 1;
  const bf16* src[D::ITEMS];
  bool ok[D::ITEMS];
  int dst_off[D::ITEMS];
#pragma unroll
  for (int j = 0; j < D::ITEMS; ++j) {
    const int i = tid + j * BG_THREADS;
    const int gy = y0 - P + i / D::ZW, gz = z0 - P + i % D::ZW;
    ok[j] = i < D::NITEM && gy >= 0 && gy < Y && gz >= 0 && gz < Z;
    src[j] = x + (((long long)bi * X + xs - P) * Y * Z + (long long)gy * Z + gz) * C + c0;
    dst_off[j] = i < D::NITEM ? (i / D::ZW) * BG_ZP + i % D::ZW : -1;
  }
  auto fetch = [&](int xi, int t) {
    Item* raw = raw0 + (t % BG_DEPTH) * D::ITEMS * BG_THREADS + tid;
    const bool in = t < nsteps && xi >= 0 && xi < X;
#pragma unroll
    for (int j = 0; j < D::ITEMS; ++j) {
      if (in && ok[j]) I::copy(raw + j * BG_THREADS, src[j]);
      src[j] += plane_stride;
    }
    cp_async_commit();
  };
  auto stage = [&](int xi, int t, bf16* dst) {
    const Item* raw = raw0 + (t % BG_DEPTH) * D::ITEMS * BG_THREADS + tid;
    const bool in = xi >= 0 && xi < X;
    unsigned short* d0 = reinterpret_cast<unsigned short*>(dst);
#pragma unroll
    for (int j = 0; j < D::ITEMS; ++j) {
      if (dst_off[j] < 0) continue;
      Item v = {};
      if (in && ok[j]) v = raw[j * BG_THREADS];
      const unsigned short* h = reinterpret_cast<const unsigned short*>(&v);
#pragma unroll
      for (int ch = 0; ch < CB; ++ch) d0[ch * D::PLANE + dst_off[j]] = h[ch];
    }
  };
  // the thread's output voxels (y, z) = (v / 8, v % 8), v = tid + 256 o
  bf16* dst_out[D::OV];
  bool o_ok[D::OV];
#pragma unroll
  for (int o = 0; o < D::OV; ++o) {
    const int v = tid + o * BG_THREADS, oy = y0 + v / BG_ZT, oz = z0 + v % BG_ZT;
    o_ok[o] = oy < Y && oz < Z;
    dst_out[o] = out + ((((long long)bi * X + xs) * Y + oy) * Z + oz) * C + c0;
  }

  // acc[s]: the output plane xo with (xo - xs) mod K == s (see
  // dwconv3d_tc_kernel); [m16 tile][fragment]
  float acc[K][BG_MT][4];
#pragma unroll
  for (int s = 0; s < K; ++s)
#pragma unroll
    for (int m = 0; m < BG_MT; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][m][e] = 0.f;
#pragma unroll
  for (int t = 0; t < BG_AHEAD; ++t) fetch(xs - P + t, t);
  cp_async_wait_group<BG_AHEAD - 1>();
  stage(xs - P, 0, buf);
  __syncthreads();
  for (int t0 = 0; t0 < nsteps; t0 += K) {
#pragma unroll
    for (int rr = 0; rr < K; ++rr) {
      const int t = t0 + rr;
      if (t >= nsteps) break;
      const int xi = xs - P + t;
      bf16* osm = osm0 + (t & 1) * D::OUT;
      fetch(xi + BG_AHEAD, t + BG_AHEAD);
      if (xi >= 0 && xi < X) {
        const bf16* pl = buf + (t & 1) * D::BUF + cl * D::PLANE +
                         (wy * 16 * BG_MT + (lane & 15)) * BG_ZP + (lane >> 4) * 8;
#pragma unroll 1
        for (int dy = 0; dy < K; ++dy) {
          uint32_t a[BG_MT][NB][4];
#pragma unroll
          for (int m = 0; m < BG_MT; ++m)
#pragma unroll
            for (int band = 0; band < NB; ++band)
              ldmatrix_x4(a[m][band], pl + (dy + 16 * m) * BG_ZP + 8 * band);
          const bf16* wd = wl + dy * NB * BG_ROW;
#pragma unroll
          for (int dx = 0; dx < K; ++dx) {
#pragma unroll
            for (int band = 0; band < NB; ++band) {
              const bf16* wb = wd + (dx * K * NB + band) * BG_ROW;
              const uint32_t b0 = *reinterpret_cast<const uint32_t*>(wb);
              const uint32_t b1 = *reinterpret_cast<const uint32_t*>(wb + 8);
#pragma unroll
              for (int m = 0; m < BG_MT; ++m)
                mma_bf16_16816(acc[(rr - dx + K) % K][m], a[m][band], b0, b1);
            }
          }
        }
      }
      // output plane xo = xi - P is complete: + bias, one rounding
      float(&done)[BG_MT][4] = acc[(rr + 1) % K];
      const int xo = xi - P;
      if (xo >= xs) {
        bf16* o = osm + cl * D::YT * BG_ZT;
#pragma unroll
        for (int m = 0; m < BG_MT; ++m) {
          const int row = wy * 16 * BG_MT + 16 * m + g;
          *reinterpret_cast<uint32_t*>(o + row * BG_ZT + 2 * q) =
              pack_bf16x2(done[m][0] + bias, done[m][1] + bias);
          *reinterpret_cast<uint32_t*>(o + (row + 8) * BG_ZT + 2 * q) =
              pack_bf16x2(done[m][2] + bias, done[m][3] + bias);
        }
      }
#pragma unroll
      for (int m = 0; m < BG_MT; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) done[m][e] = 0.f;
      cp_async_wait_group<BG_AHEAD - 1>();  // this thread's copies of plane xi + 1
      stage(xi + 1, t + 1, buf + ((t + 1) & 1) * D::BUF);
      // one barrier a step (see dwconv3d_tc_kernel)
      __syncthreads();
      // CB-channel groups of the output plane, a voxel a thread at a time
      if (xo >= xs) {
        const unsigned short* os = reinterpret_cast<const unsigned short*>(osm);
#pragma unroll
        for (int o = 0; o < D::OV; ++o) {
          if (o_ok[o]) {
            Item v;
            unsigned short* e = reinterpret_cast<unsigned short*>(&v);
#pragma unroll
            for (int ch = 0; ch < CB; ++ch)
              e[ch] = os[ch * D::YT * BG_ZT + tid + o * BG_THREADS];
            *reinterpret_cast<Item*>(dst_out[o]) = v;
          }
          dst_out[o] += plane_stride;
        }
      }
    }
  }
}

template <int K>
int launch_big(const void* x, const float* w, const float* b, void* out, int B, int X, int Y,
               int Z, int C, cudaStream_t stream) {
  using D = DwBig<K>;
  cudaError_t e = cudaFuncSetAttribute(dwconv3d_big_kernel<K>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, D::SMEM);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  // X split: one block an SM (the shared memory allows no second), so the
  // blocks a wave are the SMs (filling the panel is the prologue); ranges of
  // at least 8 planes but the last
  const long long base = (long long)B * ((Y + D::YT - 1) / D::YT) *
                         ((Z + BG_ZT - 1) / BG_ZT) * (C / D::CB);
  XSplit s;
  if (!split_x(base, X, sms, K, 8, &s)) return (int)cudaErrorInvalidValue;
  dwconv3d_big_kernel<K><<<(unsigned)s.units, BG_THREADS, D::SMEM, stream>>>(
      static_cast<const bf16*>(x), w, b, static_cast<bf16*>(out), X, Y, Z, C, s.nxs, s.xt);
  return (int)cudaGetLastError();
}

// ---- any other odd k: a thread an output value ---------------------------------
//
// JAX's schema takes any odd KERNEL_SIZE >= 3; the depthwise kernels above
// instantiate 3 to 15 (bf16 16-byte channel groups past 7), the stems' GEMMs
// take bf16 stems to k = 15. Every other case of an odd k > 7 (f32, bf16
// without 16-byte channel groups, k > 15) runs `dwconv3d_any_kernel`: k a
// run-time value, one thread an output value (channels fastest, so a warp
// reads neighbouring channels of one voxel), its k^3 taps read through the
// cache and summed in f32 in (dx, dy, dz) order, the bias added in f32 and
// one rounding, the plain version's function.
constexpr int ANY_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(ANY_THREADS)
dwconv3d_any_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, T* __restrict__ out, long long n, int X,
                    int Y, int Z, int C, int k, long long x_vstride, long long x_cstride) {
  const long long o = (long long)blockIdx.x * ANY_THREADS + threadIdx.x;
  if (o >= n) return;
  const int c = (int)(o % C);
  long long v = o / C;
  const int z = (int)(v % Z);
  v /= Z;
  const int y = (int)(v % Y);
  v /= Y;
  const int xi = (int)(v % X);
  const long long bi = v / X;
  const int P = k / 2;
  const T* xb = x + bi * X * Y * Z * x_vstride + c * x_cstride;
  float acc = 0.f;
  for (int dx = 0; dx < k; ++dx) {
    const int gx = xi + dx - P;
    if (gx < 0 || gx >= X) continue;
    for (int dy = 0; dy < k; ++dy) {
      const int gy = y + dy - P;
      if (gy < 0 || gy >= Y) continue;
      const T* col = xb + ((long long)gx * Y + gy) * Z * x_vstride;
      const float* wr = w + (long long)(dx * k + dy) * k * C + c;
      for (int dz = 0; dz < k; ++dz) {
        const int gz = z + dz - P;
        if (gz >= 0 && gz < Z) acc = fmaf(to_f32<T>(col[gz * x_vstride]), wr[dz * C], acc);
      }
    }
  }
  out[o] = from_f32<T>(acc + b[c]);
}

template <typename T>
int launch_any(int k, const void* x, const float* w, const float* b, void* out, int B, int X,
               int Y, int Z, int C, long long x_vstride, long long x_cstride,
               cudaStream_t stream) {
  const long long n = (long long)B * X * Y * Z * C;
  if (n == 0) return 0;
  dwconv3d_any_kernel<T><<<(unsigned)((n + ANY_THREADS - 1) / ANY_THREADS), ANY_THREADS, 0,
                           stream>>>(static_cast<const T*>(x), w, b, static_cast<T*>(out), n,
                                     X, Y, Z, C, k, x_vstride, x_cstride);
  return (int)cudaGetLastError();
}

// The kernel a launch takes: the one decision the entry point and the route
// query share. A bf16 stem (one input channel read for all C) with C % 8 ==
// 0, 8 <= C <= 256 and k <= 15 runs a stem GEMM on the tensor cores (the 32-
// channel templates at k = 3, 5, 7); every other k = 3, 5, 7 runs `launch`
// above (the depthwise tensor-core kernel for 16-byte-aligned bf16 channel
// groups, else the FP32 kernel: the name given is for aligned operands); a
// bf16 depthwise layer with C % 8 == 0 at k = 9 to 15 `dwconv3d_big_kernel`
// (16-byte-aligned operands, else the launch raises); every other odd k the
// run-time-k kernel.
enum Route { R_NONE, R_STEM32, R_STEM_CHUNK, R_TC, R_FP32, R_BIG, R_ANY };

Route route(int dtype, long long x_cstride, int C, int k) {
  if (k < 3 || k % 2 == 0 || C < 1 || (dtype != SKOOTS_BF16 && dtype != SKOOTS_F32))
    return R_NONE;
  if (dtype == SKOOTS_BF16 && x_cstride == 0 && C % 8 == 0 && C >= 8 && C <= 256 && k <= 15)
    return C == SG_C && k <= 7 ? R_STEM32 : R_STEM_CHUNK;
  if (k > 7)
    return dtype == SKOOTS_BF16 && x_cstride == 1 && C % 8 == 0 && k <= 15 ? R_BIG : R_ANY;
  return dtype == SKOOTS_BF16 && x_cstride == 1 && C % TC_WARPS == 0 ? R_TC : R_FP32;
}

const char* route_name(Route r, int dtype, int C, int k) {
  static const char* const stem32[] = {"stem_gemm_kernel<3>", "stem_gemm_kernel<5>",
                                       "stem_gemm_kernel<7>"};
#define SKOOTS_CHUNK_NAMES(K)                                                        \
  {"stem_gemm_chunk_kernel<" #K ",2>", "stem_gemm_chunk_kernel<" #K ",4>",                \
   "stem_gemm_chunk_kernel<" #K ",6>", "stem_gemm_chunk_kernel<" #K ",8>"}
  static const char* const chunk[7][4] = {SKOOTS_CHUNK_NAMES(3),  SKOOTS_CHUNK_NAMES(5),
                                          SKOOTS_CHUNK_NAMES(7),  SKOOTS_CHUNK_NAMES(9),
                                          SKOOTS_CHUNK_NAMES(11), SKOOTS_CHUNK_NAMES(13),
                                          SKOOTS_CHUNK_NAMES(15)};
#undef SKOOTS_CHUNK_NAMES
  static const char* const tc[] = {"dwconv3d_tc_kernel<3>", "dwconv3d_tc_kernel<5>",
                                   "dwconv3d_tc_kernel<7>"};
  static const char* const fp32[2][3] = {
      {"dwconv3d_kernel<float,3>", "dwconv3d_kernel<float,5>", "dwconv3d_kernel<float,7>"},
      {"dwconv3d_kernel<bf16,3>", "dwconv3d_kernel<bf16,5>", "dwconv3d_kernel<bf16,7>"}};
  static const char* const big[] = {"dwconv3d_big_kernel<9>", "dwconv3d_big_kernel<11>",
                                    "dwconv3d_big_kernel<13>", "dwconv3d_big_kernel<15>"};
  static const char* const any[2] = {"dwconv3d_any_kernel<float>", "dwconv3d_any_kernel<bf16>"};
  const int ki = (k - 3) / 2;
  switch (r) {
    case R_STEM32: return stem32[ki];
    case R_STEM_CHUNK: {
      int nt = 0;
      switch (k) {
        case 3: nt = stem_chunk<3>(C).nt; break;
        case 5: nt = stem_chunk<5>(C).nt; break;
        case 7: nt = stem_chunk<7>(C).nt; break;
        case 9: nt = stem_chunk<9>(C).nt; break;
        case 11: nt = stem_chunk<11>(C).nt; break;
        case 13: nt = stem_chunk<13>(C).nt; break;
        default: nt = stem_chunk<15>(C).nt;
      }
      return chunk[ki][nt / 2 - 1];
    }
    case R_TC: return tc[ki];
    case R_FP32: return fp32[dtype == SKOOTS_BF16][ki];
    case R_BIG: return big[ki - 3];
    case R_ANY: return any[dtype == SKOOTS_BF16];
    default: return nullptr;
  }
}

template <typename T>
int dispatch(Route r, int k, const void* x, const float* w, const float* b, void* out, int B,
             int X, int Y, int Z, int C, long long x_vstride, long long x_cstride,
             cudaStream_t s) {
  if (r == R_STEM32 || r == R_STEM_CHUNK) {
    // the stems read x as single bf16 values and write 16-byte channel
    // groups: no other kernel takes them
    if (x_vstride != 1 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    if (r == R_STEM32) {
      switch (k) {
        case 3: return launch_stem_gemm<3>(x, w, b, out, B, X, Y, Z, s);
        case 5: return launch_stem_gemm<5>(x, w, b, out, B, X, Y, Z, s);
        default: return launch_stem_gemm<7>(x, w, b, out, B, X, Y, Z, s);
      }
    }
    switch (k) {
      case 3: return launch_stem_chunk<3>(x, w, b, out, B, X, Y, Z, C, s);
      case 5: return launch_stem_chunk<5>(x, w, b, out, B, X, Y, Z, C, s);
      case 7: return launch_stem_chunk<7>(x, w, b, out, B, X, Y, Z, C, s);
      case 9: return launch_stem_chunk<9>(x, w, b, out, B, X, Y, Z, C, s);
      case 11: return launch_stem_chunk<11>(x, w, b, out, B, X, Y, Z, C, s);
      case 13: return launch_stem_chunk<13>(x, w, b, out, B, X, Y, Z, C, s);
      default: return launch_stem_chunk<15>(x, w, b, out, B, X, Y, Z, C, s);
    }
  }
  if (r == R_BIG) {
    // 16-byte channel groups of x and out, or no launch
    if (x_vstride != C || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(out) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    switch (k) {
      case 9: return launch_big<9>(x, w, b, out, B, X, Y, Z, C, s);
      case 11: return launch_big<11>(x, w, b, out, B, X, Y, Z, C, s);
      case 13: return launch_big<13>(x, w, b, out, B, X, Y, Z, C, s);
      default: return launch_big<15>(x, w, b, out, B, X, Y, Z, C, s);
    }
  }
  if (r == R_ANY) return launch_any<T>(k, x, w, b, out, B, X, Y, Z, C, x_vstride, x_cstride, s);
  switch (k) {
    case 3: return launch<T, 3>(x, w, b, out, B, X, Y, Z, C, x_vstride, x_cstride, s);
    case 5: return launch<T, 5>(x, w, b, out, B, X, Y, Z, C, x_vstride, x_cstride, s);
    default: return launch<T, 7>(x, w, b, out, B, X, Y, Z, C, x_vstride, x_cstride, s);
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
  const Route r = route(dtype, x_cstride, C, k);
  if (r == R_NONE) return (int)cudaErrorInvalidValue;
  if ((long long)B * X * Y * Z * C == 0) return 0;
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == SKOOTS_BF16)
    return dispatch<__nv_bfloat16>(r, k, x, wf, bf, out, B, X, Y, Z, C, x_vstride, x_cstride, s);
  return dispatch<float>(r, k, x, wf, bf, out, B, X, Y, Z, C, x_vstride, x_cstride, s);
}

// The kernel skoots_dwconv3d takes at (dtype, x_cstride, C, k) for
// contiguous 16-byte-aligned operands, by name ("stem_gemm_chunk_kernel<9,2>",
// "dwconv3d_tc_kernel<7>", "dwconv3d_big_kernel<11>", "dwconv3d_any_kernel<bf16>",
// ...), or null where it refuses them. A pure function of its integers.
extern "C" const char* skoots_dwconv3d_route(int dtype, int x_cstride, int C, int k) {
  return route_name(route(dtype, x_cstride, C, k), dtype, C, k);
}
